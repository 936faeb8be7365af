"""GQA attention (train / prefill / cached decode) and cross-attention,
as the JAX package's ``models/attention.py``.

Weights stay in fused (d_model, n_heads*head_dim) form. The score
product takes its inputs in f32 (JAX's ``preferred_element_type=f32``),
the softmax runs in f32 and is cast to q's dtype before the product with
v, as in JAX. The forward and the decode keep this einsum softmax; the
CUDA ``flash_attn`` kernel has no backward, in either package, and no
caller.

In decode the layer reads the cache and never writes it: one token
attends over ``cache[< pos]`` plus its own k/v as an explicit extra
column, and the caller writes every layer's k/v at ``pos`` after the
layer loop (``transformer.write_cache``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from .common import ParamSpec, apply_rope, causal_mask_bias, rmsnorm, rope_angles, shard_hint

__all__ = ["attn_params", "cross_attn_params", "attention", "cross_attention", "KVCache",
           "init_kv_cache"]


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, n_kv, hd); one layer's is (B, S, n_kv, hd)
    v: torch.Tensor


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, n_layers: int, dtype,
                  device=None) -> KVCache:
    """A zero cache of ``n_layers`` x (batch, max_seq, n_kv, hd) on
    ``device`` (``None`` means CUDA)."""
    shape = (n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    dev = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def attn_params(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hd = cfg.head_dim_
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {
        "wq": ParamSpec((d, qd), ("embed", "heads_flat")),
        "wk": ParamSpec((d, kvd), ("embed", "kv_flat")),
        "wv": ParamSpec((d, kvd), ("embed", "kv_flat")),
        "wo": ParamSpec((qd, d), ("heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((qd,), ("heads_flat",), init="zeros")
        p["bk"] = ParamSpec((kvd,), ("kv_flat",), init="zeros")
        p["bv"] = ParamSpec((kvd,), ("kv_flat",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        p["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return p


def cross_attn_params(cfg: ArchConfig) -> dict:
    p = attn_params(cfg)
    p["gate"] = ParamSpec((1,), (None,), init="zeros")  # llama-vision tanh gate
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, kv_src: Optional[torch.Tensor] = None):
    hd = cfg.head_dim_
    kv_in = x if kv_src is None else kv_src
    q = x @ p["wq"]
    k = kv_in @ p["wk"]
    v = kv_in @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, Tq, Tk = x.shape[0], x.shape[1], kv_in.shape[1]
    q = q.reshape(B, Tq, cfg.n_heads, hd)
    k = k.reshape(B, Tk, cfg.n_kv_heads, hd)
    v = v.reshape(B, Tk, cfg.n_kv_heads, hd)
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


def _sdpa_decode(q, k_cur, v_cur, cache: KVCache, cache_pos: int, n_rep: int) -> torch.Tensor:
    """One-token attention over a read-only cache plus the current token.

    q (B,1,H,hd); k_cur/v_cur (B,1,KV,hd); cache.k/.v (B,S,KV,hd). A joint
    softmax over [cache[<pos], current]; the normalised probabilities are
    cast to q's dtype before each product with v, as in JAX."""
    B, _, H, hd = q.shape
    S, KV = cache.k.shape[1], cache.k.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, 1, KV, n_rep, hd).to(f32)
    scale = 1.0 / math.sqrt(hd)
    s_c = torch.einsum("bqgrh,bkgh->bgrqk", qg, cache.k.to(f32)) * scale
    kv_pos = torch.arange(S, device=q.device)
    s_c = s_c + torch.where(kv_pos < cache_pos, 0.0, -1e30)  # strictly past
    s_s = torch.einsum("bqgrh,bqgh->bgrq", qg, k_cur.to(f32)) * scale
    m = torch.maximum(s_c.amax(dim=-1), s_s)  # (B,KV,rep,1)
    p_c = torch.exp(s_c - m[..., None])
    p_s = torch.exp(s_s - m)
    denom = p_c.sum(dim=-1) + p_s
    out = torch.einsum("bgrqk,bkgh->bqgrh", (p_c / denom[..., None]).to(q.dtype), cache.v)
    out = out + (p_s / denom).to(q.dtype).permute(0, 3, 1, 2)[..., None] * v_cur.reshape(
        B, 1, KV, 1, hd)
    return out.reshape(B, 1, H, hd)


def attention(p, x: torch.Tensor, cfg: ArchConfig, *, positions: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None, cache_pos: Optional[int] = None,
              causal: bool = True):
    """Self-attention.

    Train/prefill (``cache=None``): a causal pass over positions 0..T-1;
    returns (out, (k, v)). Decode: x is (B, 1, d), ``cache`` one layer's
    (B, S, KV, hd) pair and ``cache_pos`` the write index (the token's
    RoPE position); returns (out, (k, v)) of the current token, which the
    caller writes into the cache.
    """
    B, T, _ = x.shape
    hd = cfg.head_dim_
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        if cache is None:
            positions = torch.arange(T, device=x.device)[None, :]
        else:
            positions = torch.full((B, 1), int(cache_pos), device=x.device)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        out = _sdpa_decode(q, k, v, cache, cache_pos, n_rep)
    else:
        q = shard_hint(q, ("batch", None, "heads", None))
        if cfg.attn_chunk > 0 and causal and T % cfg.attn_chunk == 0 and T > cfg.attn_chunk:
            out = _sdpa_blocked(q, k, v, n_rep, cfg.attn_chunk)
        else:
            bias = causal_mask_bias(T, T, device=x.device) if causal else None
            out = _sdpa(q, k, v, bias, n_rep)
    out = out.reshape(B, T, cfg.n_heads * hd)
    return out @ p["wo"], (k, v)


def cross_attention(p, x: torch.Tensor, kv_feats: torch.Tensor, cfg: ArchConfig,
                    gated: bool = False) -> torch.Tensor:
    """Cross-attention: queries from x (B,T,d), keys/values from kv_feats
    (B,S,d). No RoPE, no causality (the encoder side is fully visible)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, kv_src=kv_feats)
    out = _sdpa(q, k, v, None, n_rep)
    B, T = x.shape[0], x.shape[1]
    out = out.reshape(B, T, cfg.n_heads * cfg.head_dim_) @ p["wo"]
    if gated:
        out = torch.tanh(p["gate"].to(torch.float32)).to(out.dtype) * out
    return out
