"""Dense decoder-only LM (qwen2.5 / qwen3 / stablelm / internlm2), as the
JAX package's ``models/transformer.py``.

The JAX package scans one stacked layer body; here the layers are a
``ModuleList`` walked in a Python loop, and ``remat`` wraps each layer in
``torch.utils.checkpoint`` where JAX uses ``jax.checkpoint``.
Cached decode (``dense_lm_decode``, ``write_cache``) waits for the LM
serving slice (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import attention, attn_params
from .common import ParamSpec, apply_norm, make_norm_params
from .mlp import swiglu, swiglu_params

__all__ = [
    "embed_params",
    "dense_layer_params",
    "dense_layer_apply",
    "dense_lm_layout",
    "dense_lm_forward",
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


def dense_layer_apply(lp, x: torch.Tensor, cfg: ArchConfig):
    h = apply_norm(x, lp["attn_norm"], cfg.norm)
    a, new_kv = attention(lp["attn"], h, cfg)
    x = x + a
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    x = x + swiglu(lp["mlp"], h)
    return x, new_kv


def dense_lm_layout(cfg: ArchConfig) -> dict:
    return {
        **embed_params(cfg),
        "layers": [dense_layer_params(cfg) for _ in range(cfg.n_layers)],
    }


def dense_lm_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *,
                     remat: bool = False) -> torch.Tensor:
    """Causal forward over full sequences (train / prefill); logits (B, T, V)
    in the parameters' dtype."""
    if remat not in (False, True):
        raise ValueError(f"remat must be True or False, got {remat!r}")
    x = embed_tokens(params, tokens, cfg)
    for lp in params["layers"]:
        if remat:
            x = checkpoint(lambda h, lp=lp: dense_layer_apply(lp, h, cfg)[0], x,
                           use_reentrant=False)
        else:
            x, _ = dense_layer_apply(lp, x, cfg)
    return unembed(params, x, cfg)
