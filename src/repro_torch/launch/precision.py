"""How far rounding alone moves the SSM and hybrid models' logits:
``python -m repro_torch.launch.precision``

Seeded random weights and prompts (batch 8 x 512, as ``chip_smoke.py``'s
phase 9). For zamba2-2.7b and xlstm-1.3b it prints, per row of logits
(the largest ||d|| / ||ref|| over the rows):

* teacher-forced decode of the 16 positions after a one-chunk prefill
  against the full forward, in bf16 and in f32 (TF32 off), beside the
  bf16 forward's distance from the f32 forward (the same weights): what
  bf16 rounding alone does at full depth; and the bf16 distance at a few
  cut depths;
* one group of each at full width in f32 (zamba2: 6 Mamba blocks and the
  shared block; xlstm: 7 mLSTM and 1 sLSTM) on the device against the
  host CPU (``card_vs_host``, the check ``chip_smoke.py`` makes), over
  ``PROMPT_SEEDS``, beside the host against itself on one thread
  (another order of f32 sums).

It runs on the card. Every number is a distance of logits, not a time.
The helpers are what ``chip_smoke.py`` and the tests share.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import get_config
from ..kernels.common import resolve_device
from ..models import build_model, make_generator
from ..serve import ServeConfig, generate, prefill_cache

TF_STEPS = 16
NEW_TOKENS = 8  # greedy tokens of the card-against-host check
PROMPT_SEEDS = (2, 3, 4, 5, 6, 7)  # of the card-against-host prompts
# (model, Mamba or xLSTM blocks of one group, cut depths of the bf16 sweep)
MODELS = (("zamba2-2.7b", 6, (6, 18, 36)), ("xlstm-1.3b", 8, (8, 24)))


def rows_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-row ||got - want|| / ||want|| over the last axis."""
    d = got.double() - want.double()
    return float((d.norm(dim=-1) / want.double().norm(dim=-1).clamp_min(1e-30)).max())


@torch.no_grad()
def decode_vs_forward(api, params, prompts: torch.Tensor, t0: int, steps: int = TF_STEPS,
                      extras: dict | None = None):
    """(logits of positions t0 .. t0+steps-1 decoded teacher-forced after a
    t0-token prefill, the full forward's logits of those positions);
    ``extras`` are the family's inputs beside the tokens (frames, image
    features)."""
    extras = extras or {}
    full = api.forward(params, {"tokens": prompts, **extras})[:, t0:t0 + steps].clone()
    _, cache = prefill_cache(api, params, {"tokens": prompts[:, :t0], **extras}, t0 + steps)
    forced = []
    for pos in range(t0, t0 + steps):
        lg, cache = api.decode(params, prompts[:, pos:pos + 1], cache, pos)
        forced.append(lg)
    return torch.cat(forced, dim=1), full


@torch.no_grad()
def as_f32(api, params, dev):
    """The same model and weights in f32, copied a tensor at a time (no
    second f32 copy of the model is ever held)."""
    api32 = build_model(dataclasses.replace(api.cfg, dtype="float32"))
    p32 = api32.empty_params(dev)
    src = dict(params.named_parameters())
    for k, t in p32.named_parameters():
        t.copy_(src[k])
    return api32, p32


def host_copy(api, params):
    """The same weights on the host CPU."""
    host = api.empty_params("cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    return host


@torch.no_grad()
def card_vs_host(api, params, host, prompts: torch.Tensor, extras: dict | None = None) -> dict:
    """One model on the device (``params``) and on the host CPU (``host``):
    the NEW_TOKENS greedy tokens of ``generate`` on each, and the
    per-row distances of the prefill's logits and of one decode step's
    (the host's next token fed to both); ``extras`` (on the device) are the
    family's inputs beside the tokens."""
    T = prompts.shape[1]
    sc = ServeConfig(max_new_tokens=NEW_TOKENS)
    dev_batch = {"tokens": prompts, **(extras or {})}
    host_batch = {k: v.cpu() for k, v in dev_batch.items()}
    got = generate(api, params, dev_batch, sc).cpu()
    want = generate(api, host, host_batch, sc)
    lg_d, c_d = prefill_cache(api, params, dev_batch, T + 1)
    lg_h, c_h = prefill_cache(api, host, host_batch, T + 1)
    nxt = lg_h[:, -1:].argmax(-1)
    step = rows_err(api.decode(params, nxt.to(prompts.device), c_d, T)[0].cpu(),
                    api.decode(host, nxt, c_h, T)[0])
    return {"tokens": got, "host_tokens": want, "prefill_row_err": rows_err(lg_d.cpu(), lg_h),
            "decode_row_err": step}


def depth_report(cfg, dev, batch: int, prompt_len: int, cuts) -> None:
    api = build_model(cfg)
    params = api.init_params(make_generator(0, dev))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=make_generator(1, dev), dtype=torch.int32)
    d16, f16 = decode_vs_forward(api, params, prompts, cfg.chunk)
    api32, p32 = as_f32(api, params, dev)
    del params
    d32, f32 = decode_vs_forward(api32, p32, prompts, cfg.chunk)
    del p32
    same = float((f16.argmax(-1) == f32.argmax(-1)).float().mean())
    print(f"{cfg.name} ({cfg.n_layers} layers), teacher-forced decode against the forward: bf16 "
          f"{rows_err(d16, f16):.3e}, f32 {rows_err(d32, f32):.3e}; the bf16 forward against the "
          f"f32 forward {rows_err(f16, f32):.3e} (argmax equal at {same:.4f})", flush=True)
    for n in cuts:
        cut = build_model(dataclasses.replace(cfg, n_layers=n))
        p = cut.init_params(make_generator(0, dev))
        print(f"  {n} layers, bf16: teacher-forced decode against the forward "
              f"{rows_err(*decode_vs_forward(cut, p, prompts, cfg.chunk)):.3e}", flush=True)
        del p


def host_report(cfg, dev) -> None:
    api = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = api.init_params(make_generator(0, dev))
    host = host_copy(api, params)
    for seed in PROMPT_SEEDS:
        prompts = torch.randint(0, cfg.vocab_size, (2, cfg.chunk), device=dev,
                                generator=make_generator(seed, dev), dtype=torch.int32)
        r = card_vs_host(api, params, host, prompts)
        same = "equal" if torch.equal(r["tokens"], r["host_tokens"]) else "DIFFER"
        line = (f"{cfg.name} ({cfg.n_layers} layers) f32, prompt seed {seed}: device against "
                f"host, tokens {same}, prefill {r['prefill_row_err']:.3e}, one decode step "
                f"{r['decode_row_err']:.3e}")
        if seed == PROMPT_SEEDS[0]:
            n = torch.get_num_threads()
            batch = {"tokens": prompts.cpu()}
            with torch.no_grad():
                many = api.prefill(host, batch)[0]
                torch.set_num_threads(1)
                try:
                    one = api.prefill(host, batch)[0]
                finally:
                    torch.set_num_threads(n)
            line += f"; host on 1 thread against {n} threads, prefill {rows_err(one, many):.3e}"
        print(line, flush=True)


def main() -> None:
    dev = resolve_device(None)  # the card: full width is no size for the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, group, cuts in MODELS:
        cfg = get_config(name)
        depth_report(cfg, dev, 8, 2 * cfg.chunk, cuts)
        host_report(dataclasses.replace(cfg, n_layers=group), dev)


if __name__ == "__main__":
    main()
