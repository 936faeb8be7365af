"""Whisper-style encoder-decoder backbone (whisper-tiny), as the JAX
package's ``models/encdec.py``.

The conv/mel frontend is a stub: the batch carries precomputed frame
embeddings (B, enc_seq, d) in the model's dtype. Sinusoidal positions are
added on both sides (computed in f32, then cast), and the self-attention
of both sides goes through ``attention``, so RoPE is applied on top of
them, as in JAX. The encoder is bidirectional and never remat-wrapped;
each decoder layer is. LayerNorm, GELU MLP, biased MHA.

Decode reads the self-attention caches and writes every layer's current
k/v after the layer loop (``transformer.write_cache``); the cross K/V
are recomputed from ``enc_out`` at every step, as JAX does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from .attention import KVCache, attention, attn_params, cross_attention, init_kv_cache
from .common import apply_norm, make_norm_params, require_dtype
from .mlp import gelu_mlp, gelu_mlp_params
from .transformer import (
    _stack_kv,
    check_remat,
    embed_params,
    embed_tokens,
    remat_call,
    unembed,
    write_cache,
)

__all__ = [
    "EncDecCache",
    "sinusoidal",
    "sinusoidal_at",
    "encdec_layout",
    "encdec_encode",
    "encdec_forward",
    "encdec_init_cache",
    "encdec_decode",
]


class EncDecCache(NamedTuple):
    self_kv: KVCache       # (L_dec, B, S, KV, hd)
    enc_out: torch.Tensor  # (B, T_enc, d)


def _inv_freq(d: int, device) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d)


def sinusoidal(T: int, d: int, dtype, device=None) -> torch.Tensor:
    """(T, d): sin then cos of pos / 10000^(2i/d), in f32, cast to dtype."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal_at(pos: int, d: int, dtype, device=None) -> torch.Tensor:
    """(d,): row ``pos`` of ``sinusoidal``, bit for bit."""
    ang = torch.full((), pos, dtype=torch.float32, device=device) / _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_layer_params(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": make_norm_params(cfg.d_model, cfg.norm),
        "attn": attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "mlp": gelu_mlp_params(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_params(cfg: ArchConfig) -> dict:
    p = _enc_layer_params(cfg)
    p["cross_norm"] = make_norm_params(cfg.d_model, cfg.norm)
    p["cross"] = attn_params(cfg)
    return p


def encdec_layout(cfg: ArchConfig) -> dict:
    return {
        **embed_params(cfg),
        "enc_layers": [_enc_layer_params(cfg) for _ in range(cfg.n_enc_layers)],
        "enc_norm": make_norm_params(cfg.d_model, cfg.norm),
        "dec_layers": [_dec_layer_params(cfg) for _ in range(cfg.n_layers)],
    }


def encdec_encode(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, T_enc, d), the stub frontend's output in the model's
    dtype -> encoder states (B, T_enc, d)."""
    require_dtype("frames", frames, params["embedding"].dtype)
    x = frames + sinusoidal(frames.shape[1], cfg.d_model, frames.dtype, frames.device)[None]
    for lp in params["enc_layers"]:
        h = apply_norm(x, lp["attn_norm"], cfg.norm)
        a, _ = attention(lp["attn"], h, cfg, causal=False)
        x = x + a
        h = apply_norm(x, lp["mlp_norm"], cfg.norm)
        x = x + gelu_mlp(lp["mlp"], h)
    return apply_norm(x, params["enc_norm"], cfg.norm)


def _dec_layer(lp, x: torch.Tensor, enc_out: torch.Tensor, cfg: ArchConfig, *,
               cache: KVCache | None = None, cache_pos=None):
    h = apply_norm(x, lp["attn_norm"], cfg.norm)
    a, kv = attention(lp["attn"], h, cfg, cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(x, lp["cross_norm"], cfg.norm)
    x = x + cross_attention(lp["cross"], h, enc_out, cfg)
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    return x + gelu_mlp(lp["mlp"], h), kv


def encdec_forward(params, tokens: torch.Tensor, frames: torch.Tensor, cfg: ArchConfig, *,
                   remat=False, return_cache: bool = False):
    """Teacher-forced decoder over the whole token sequence (train /
    prefill): logits (B, T, V); ``return_cache=True`` also returns
    ((k, v) stacked to (L_dec, B, T, KV, hd), enc_out)."""
    check_remat(remat, return_cache)
    enc_out = encdec_encode(params, frames, cfg)
    x = embed_tokens(params, tokens, cfg)
    x = x + sinusoidal(tokens.shape[1], cfg.d_model, x.dtype, x.device)[None]
    kvs = []
    for lp in params["dec_layers"]:
        if remat:
            x = remat_call(lambda h, e, lp=lp: _dec_layer(lp, h, e, cfg)[0], remat, x, enc_out)
        else:
            x, kv = _dec_layer(lp, x, enc_out, cfg)
            if return_cache:
                kvs.append(kv)
    logits = unembed(params, x, cfg)
    if return_cache:
        return logits, (_stack_kv(kvs), enc_out)
    return logits


def encdec_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                      device=None) -> EncDecCache:
    """Zero self caches of max_seq positions and a zero ``enc_out`` on
    ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    return EncDecCache(
        self_kv=init_kv_cache(cfg, batch, max_seq, cfg.n_layers, dtype, dev),
        enc_out=torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype, device=dev),
    )


def encdec_decode(params, token: torch.Tensor, cache: EncDecCache, pos: int, cfg: ArchConfig):
    """One token (B, 1) at position ``pos``: (logits (B, 1, V), the cache
    with this token's k/v written at ``pos`` in place)."""
    x = embed_tokens(params, token, cfg)
    x = x + sinusoidal_at(pos, cfg.d_model, x.dtype, x.device)[None, None, :]
    kvs = []
    for i, lp in enumerate(params["dec_layers"]):
        x, kv = _dec_layer(lp, x, cache.enc_out, cfg,
                           cache=KVCache(cache.self_kv.k[i], cache.self_kv.v[i]), cache_pos=pos)
        kvs.append(kv)
    logits = unembed(params, x, cfg)
    write_cache(cache.self_kv, *_stack_kv(kvs), pos)
    return logits, cache
