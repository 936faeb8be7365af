"""GQA self-attention for training and prefill, as the JAX package's
``models/attention.py``.

Weights stay in fused (d_model, n_heads*head_dim) form. The score
product takes its inputs in f32 (JAX's ``preferred_element_type=f32``),
the softmax runs in f32 and is cast to q's dtype before the product with
v, as in JAX. The forward keeps this einsum softmax; the CUDA
``flash_attn`` kernel has no backward, in either package, and no caller.

``KVCache``, cached decode and ``cross_attention`` wait for the LM
serving slice (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ArchConfig
from .common import ParamSpec, apply_rope, causal_mask_bias, rmsnorm, rope_angles

__all__ = ["attn_params", "attention"]


def attn_params(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hd = cfg.head_dim_
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {
        "wq": ParamSpec((d, qd)),
        "wk": ParamSpec((d, kvd)),
        "wv": ParamSpec((d, kvd)),
        "wo": ParamSpec((qd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((qd,), init="zeros")
        p["bk"] = ParamSpec((kvd,), init="zeros")
        p["bv"] = ParamSpec((kvd,), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), init="ones")
        p["k_norm"] = ParamSpec((hd,), init="ones")
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    hd = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, T = x.shape[0], x.shape[1]
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def _sdpa(q, k, v, bias: Optional[torch.Tensor], n_rep: int) -> torch.Tensor:
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd); returns (B,Tq,H,hd)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, Tq, KV, n_rep, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg.to(f32), k.to(f32))
    scores = scores / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias  # broadcast (.., Tq, Tk)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", w, v)
    return out.reshape(B, Tq, H, hd)


def _sdpa_blocked(q, k, v, n_rep: int, q_tile: int) -> torch.Tensor:
    """Blocked-causal attention (the ``attn_chunk`` path): a loop over Q
    tiles, each attending only to its KV prefix, with the probabilities
    stored in the compute dtype."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    if Tq % q_tile:
        raise ValueError(f"Tq={Tq} is not a multiple of the tile {q_tile}")
    f32 = torch.float32
    qg = q.reshape(B, Tq, KV, n_rep, hd)
    outs = []
    for i in range(Tq // q_tile):
        hi = (i + 1) * q_tile
        qt = qg[:, i * q_tile: hi]
        kt, vt = k[:, :hi], v[:, :hi]
        s = torch.einsum("bqgrh,bkgh->bgrqk", qt.to(f32), kt.to(f32))
        s = s / math.sqrt(hd)
        s = s + causal_mask_bias(q_tile, hi, q_offset=i * q_tile, device=q.device)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bgrqk,bkgh->bqgrh", p, vt)
        outs.append(o.reshape(B, q_tile, H, hd))
    return torch.cat(outs, dim=1)


def attention(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True):
    """Self-attention over full sequences (train / prefill), positions
    0..T-1; returns (out, (k, v))."""
    B, T, _ = x.shape
    hd = cfg.head_dim_
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_chunk > 0 and causal and T % cfg.attn_chunk == 0 and T > cfg.attn_chunk:
        out = _sdpa_blocked(q, k, v, n_rep, cfg.attn_chunk)
    else:
        bias = causal_mask_bias(T, T, device=x.device) if causal else None
        out = _sdpa(q, k, v, bias, n_rep)
    out = out.reshape(B, T, cfg.n_heads * hd)
    return out @ p["wo"], (k, v)
