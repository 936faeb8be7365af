"""Dense decoder-only LM (qwen2.5 / qwen3 / stablelm / internlm2), as the
JAX package's ``models/transformer.py``.

The JAX package scans one stacked layer body; here the layers are a
``ModuleList`` walked in a Python loop, and ``remat`` wraps each layer in
``torch.utils.checkpoint`` where JAX uses ``jax.checkpoint``.

Cached decode: every layer reads its slice of the (L, B, S, KV, hd)
cache, never writes it, and returns its current-token k/v; after the
layer loop ``write_cache`` writes all of them at ``pos``. Where JAX
returns a new cache array, ``write_cache`` updates the preallocated
cache in place (PyTorch's idiom) and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import KVCache, attention, attn_params
from .common import ParamSpec, apply_norm, make_norm_params
from .mlp import swiglu, swiglu_params

__all__ = [
    "embed_params",
    "dense_layer_params",
    "dense_layer_apply",
    "dense_lm_layout",
    "dense_lm_forward",
    "dense_lm_decode",
    "write_cache",
    "embed_tokens",
    "unembed",
]


def embed_params(cfg: ArchConfig) -> dict:
    p = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    p["final_norm"] = make_norm_params(cfg.d_model, cfg.norm)
    return p


def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), params["embedding"])


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm)
    head = params["embedding"].t() if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def dense_layer_params(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": make_norm_params(cfg.d_model, cfg.norm),
        "attn": attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "mlp": swiglu_params(cfg.d_model, cfg.d_ff),
    }


def dense_layer_apply(lp, x: torch.Tensor, cfg: ArchConfig, *, cache: KVCache | None = None,
                      cache_pos=None):
    h = apply_norm(x, lp["attn_norm"], cfg.norm)
    a, new_kv = attention(lp["attn"], h, cfg, cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    x = x + swiglu(lp["mlp"], h)
    return x, new_kv


def dense_lm_layout(cfg: ArchConfig) -> dict:
    return {
        **embed_params(cfg),
        "layers": [dense_layer_params(cfg) for _ in range(cfg.n_layers)],
    }


def _stack_kv(kvs: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer (k, v) pairs stacked to (L, B, T, KV, hd) each."""
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def dense_lm_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, remat: bool = False,
                     return_cache: bool = False):
    """Causal forward over full sequences (train / prefill); logits (B, T, V)
    in the parameters' dtype. ``return_cache=True`` also returns the
    per-layer (k, v) stacked to (L, B, T, KV, hd) for the prefill -> decode
    hand-off."""
    if remat not in (False, True):
        raise ValueError(f"remat must be True or False, got {remat!r}")
    if remat and return_cache:
        raise ValueError("return_cache needs remat=False")
    x = embed_tokens(params, tokens, cfg)
    kvs = []
    for lp in params["layers"]:
        if remat:
            x = checkpoint(lambda h, lp=lp: dense_layer_apply(lp, h, cfg)[0], x,
                           use_reentrant=False)
        else:
            x, kv = dense_layer_apply(lp, x, cfg)
            if return_cache:
                kvs.append(kv)
    logits = unembed(params, x, cfg)
    if return_cache:
        return logits, _stack_kv(kvs)
    return logits


@torch.no_grad()
def write_cache(cache: KVCache, k_toks: torch.Tensor, v_toks: torch.Tensor, pos: int) -> KVCache:
    """Write every layer's current-token k/v (L, B, 1, KV, hd) at position
    ``pos`` of the cache, in place (one copy per tensor); returns the cache."""
    cache.k[:, :, pos:pos + 1] = k_toks
    cache.v[:, :, pos:pos + 1] = v_toks
    return cache


def dense_lm_decode(params, token: torch.Tensor, cache: KVCache, pos: int, cfg: ArchConfig):
    """One decode step. token (B, 1) int; cache (L, B, S, KV, hd) pair; pos
    the write index. Returns (logits (B, 1, V), cache), the cache updated in
    place at ``pos`` after the layer loop."""
    x = embed_tokens(params, token, cfg)
    kvs = []
    for i, lp in enumerate(params["layers"]):
        x, kv = dense_layer_apply(lp, x, cfg, cache=KVCache(cache.k[i], cache.v[i]),
                                  cache_pos=pos)
        kvs.append(kv)
    logits = unembed(params, x, cfg)
    return logits, write_cache(cache, *_stack_kv(kvs), pos)
