"""LM serving launcher: ``python -m repro_torch.launch.serve_lm --arch <id> ...``

The port's counterpart of ``examples/serve_lm.py``, for every family
(dense, MoE, SSM, hybrid, encdec, vlm): random parameters from a seeded
generator (no weights are downloaded), a batch of seeded random prompts
(and, for encdec and vlm, seeded stub frames or image features in the
model's dtype), one ``generate`` call (prefill, then the decode loop).
Without ``--full`` it serves the reduced config (same family and
topology, tiny widths); ``--full`` the full config on one card. The SSM
and hybrid families take prompts of a multiple of their chunk (16
reduced, 256 full). ``--device`` defaults to ``cuda``; ``cpu`` runs the
plain PyTorch path. On the card it also prints the least time a decode
step could take: the bytes it must move (``decode_step_bytes``) at
``launch/roofline.py``'s HBM rate, and for encdec and vlm the FLOPs of
the cross K/V it recomputes (``decode_step_cross_flops``) at the bf16
tensor peak.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, list_configs, reduced
from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from ..models import build_model, make_generator
from ..models.common import DTYPES, count_params
from ..serve import ServeConfig, generate
from .roofline import HW


def _weights_read(cfg: ArchConfig, batch: int) -> int:
    """Parameters a decode step reads: all but the untied head's and the
    encoder's (prefill only), the embedding table only at the batch's rows
    (the head reads all of it where tied)."""
    api = build_model(cfg)
    n = api.n_params()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    if cfg.family == "encdec":
        n -= sum(count_params(api.layout[k]) for k in ("enc_layers", "enc_norm"))
    return n + batch * cfg.d_model


def decode_step_bytes(cfg: ArchConfig, batch: int, max_seq: int) -> int:
    """The HBM bytes one decode step must move as the code runs it: every
    weight it applies read once (the embedding table only at the batch's
    rows, unless the head is tied to it; every expert of an MoE layer,
    since the batched expert products read them all; the hybrid family's
    shared block once, though a step applies it after every group; not
    the encoder's, which only the prefill runs) and the logits written
    once. Dense, MoE, encdec and vlm: the whole max_seq cache of every
    self-attention layer read once, the new k/v written; encdec: ``enc_out``
    read by each decoder layer's cross-attention; vlm: ``img_feats`` read
    by each cross layer (the cross K/V are recomputed every step). SSM and
    hybrid: every f32 recurrent state (mLSTM S and n, sLSTM c, n and h;
    Mamba S and n) and the conv tails read once and written once; hybrid:
    the shared block's whole max_seq cache of every group read once, the
    new k/v written."""
    item = DTYPES[cfg.dtype].itemsize
    total = item * (_weights_read(cfg, batch) + batch * cfg.vocab_size)
    nh = cfg.ssm_heads_
    if cfg.family in ("dense", "moe"):
        caches = cfg.n_layers
    elif cfg.family == "encdec":
        caches = cfg.n_layers
        total += item * cfg.n_layers * batch * cfg.enc_seq * cfg.d_model
    elif cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        caches = cfg.n_layers - n_cross
        total += item * n_cross * batch * cfg.n_img_tokens * cfg.d_model
    elif cfg.family == "hybrid":
        caches = cfg.n_layers // cfg.attn_every
        stt, dh = cfg.ssm_state, cfg.d_inner // nh
        state = 4 * cfg.n_layers * batch * nh * (stt * dh + stt)
        tails = item * cfg.n_layers * batch * 3 * (cfg.d_inner + 2 * stt)  # kernel 4: 3 inputs
        total += 2 * (state + tails)
    elif cfg.family == "ssm":
        caches = 0
        n_s = cfg.n_layers // cfg.slstm_every
        dk = cfg.d_inner // nh
        state = 4 * batch * ((cfg.n_layers - n_s) * nh * (dk * dk + dk) + n_s * 3 * cfg.d_model)
        total += 2 * state
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    kv_per_pos = 2 * caches * batch * cfg.n_kv_heads * cfg.head_dim_
    return total + item * kv_per_pos * (max_seq + 1)


def decode_step_cross_flops(cfg: ArchConfig, batch: int) -> int:
    """The FLOPs of the cross K/V that one decode step recomputes from
    ``enc_out`` (encdec, every decoder layer) or ``img_feats`` (vlm, every
    cross layer): two (B x S, d) x (d, KV x hd) products, 2 FLOPs a
    multiply-add. A floor on the step's operations (the rest of its
    products come on top); 0 for the families without cross-attention."""
    if cfg.family == "encdec":
        layers, src = cfg.n_layers, cfg.enc_seq
    elif cfg.family == "vlm":
        layers, src = cfg.n_layers // cfg.cross_attn_every, cfg.n_img_tokens
    else:
        return 0
    return layers * 2 * (batch * src) * cfg.d_model * (cfg.n_kv_heads * cfg.head_dim_) * 2


def extras_for(cfg: ArchConfig, batch: int, generator: torch.Generator, dtype,
               device) -> dict:
    """The family's seeded stub inputs beside the tokens, in the model's
    dtype: encdec ``frames``, vlm ``img_feats`` (std 0.02, as
    ``data.batch_for_step`` draws them); {} for the other families."""
    shape = {"encdec": (batch, cfg.enc_seq, cfg.d_model),
             "vlm": (batch, cfg.n_img_tokens, cfg.d_model)}.get(cfg.family)
    if shape is None:
        return {}
    name = "frames" if cfg.family == "encdec" else "img_feats"
    draw = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return {name: (draw * 0.02).to(dtype)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true", help="the full config, on one card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced(get_config(args.arch))
    api = build_model(cfg)
    params = api.init_params(make_generator(args.seed, dev))
    print(f"arch={cfg.name} family={cfg.family} params={api.n_params():,} full={args.full} "
          f"device={dev}")
    gen = make_generator(args.seed + 1, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts, **extras_for(cfg, args.batch, gen, api.dtype, dev)}
    sc = ServeConfig(max_new_tokens=args.new_tokens, temperature=args.temperature)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    out = generate(api, params, batch, sc, generator=gen)
    sync()
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, prefill included)")
    if dev.type == "cuda":
        bound = decode_step_bytes(cfg, args.batch, args.prompt_len + args.new_tokens)
        print(f"decode step bound: {bound / HW['hbm_bw'] * 1e3:.4f} ms ({bound:,} bytes at "
              f"{HW['hbm_bw'] / 1e12:.2f} TB/s)")
        flops = decode_step_cross_flops(cfg, args.batch)
        if flops:
            print(f"decode step cross K/V floor: {flops / HW['peak_flops'] * 1e3:.4f} ms "
                  f"({flops:,} FLOPs at {HW['peak_flops'] / 1e12:.0f} TFLOP/s)")
    for i in range(min(args.batch, 2)):
        print(f"  seq {i}: ...{out[i, args.prompt_len - 4:].tolist()}")


if __name__ == "__main__":
    main()
