"""Mamba-2 (SSD) blocks and the Zamba2 hybrid LM, as the JAX package's
``models/mamba.py``.

Mamba-2's SSD layer is scalar-decay linear attention: per-head decay
a_t = exp(-softplus(dt_t) * exp(A_log)) and input scale dt_t, with shared
B/C projections playing k/q, on the chunked GLA engine (``gla.py``). A
causal depthwise conv (kernel 4) precedes the SSM input, with a conv-tail
state for decode.

Zamba2 (``cfg.attn_every`` = k): groups of k Mamba-2 blocks, each
followed by ONE shared attention block, whose weights every group reuses
(per-application LoRA deltas omitted, as in JAX). The shared block keeps
one KV cache per application.

Decode updates the state in place (JAX returns a new one): each Mamba
block's S, n and conv tail in the stacked tensors, and the shared block's
k/v through ``transformer.write_cache`` after the layer loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from .attention import KVCache, attention, attn_params, init_kv_cache
from .common import ParamSpec, apply_norm, make_norm_params, rmsnorm
from .gla import GLAState, gla_chunked, gla_step
from .mlp import swiglu, swiglu_params
from .transformer import (
    check_remat,
    embed_params,
    embed_tokens,
    remat_call,
    unembed,
    write_cache,
)

__all__ = [
    "ZambaState",
    "mamba_block_params",
    "mamba_apply",
    "zamba_layout",
    "zamba_forward",
    "zamba_decode",
    "zamba_init_state",
]

_CONV_K = 4


class ZambaState(NamedTuple):
    ssm: GLAState          # stacked (L_mamba, B, H, dk, dv), f32
    conv: torch.Tensor     # (L_mamba, B, _CONV_K - 1, conv_channels)
    attn_kv: KVCache       # (n_groups, B, S, KV, hd): the shared block's caches
    pos: torch.Tensor      # 0-dim int32: the next position


def mamba_block_params(cfg: ArchConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_heads_
    st = cfg.ssm_state
    conv_ch = din + 2 * st  # x, B, C go through the conv
    return {
        "norm": make_norm_params(d, cfg.norm),
        "w_in": ParamSpec((d, 2 * din + 2 * st + nh), ("embed", "mlp")),
        "conv_w": ParamSpec((_CONV_K, conv_ch), (None, "mlp"), scale=0.5),
        "A_log": ParamSpec((nh,), (None,), init="zeros"),
        "D": ParamSpec((nh,), (None,), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "out_norm": {"scale": ParamSpec((din,), ("mlp",), init="ones")},
        "w_out": ParamSpec((din, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv, kernel K. x (B, T, C); w (K, C); tail
    (B, K-1, C) the previous K-1 inputs (zeros if None). Returns (y,
    new_tail); new_tail never aliases ``tail``."""
    B, T, C = x.shape
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xt = torch.cat([tail, x], dim=1)  # (B, T+K-1, C)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xt[:, i:i + T] * w[i]
    return y, xt[:, -(K - 1):]


def mamba_apply(lp, x: torch.Tensor, cfg: ArchConfig, state: GLAState | None, conv_tail,
                *, step: bool):
    """One Mamba-2 block over x (B, T, d), chunked, or over one token
    (T = 1) when ``step``, which updates ``state`` in place. Returns
    (x + block(x), state, new conv tail)."""
    B, T, d = x.shape
    din = cfg.d_inner
    nh = cfg.ssm_heads_
    stt = cfg.ssm_state
    dh = din // nh

    h = apply_norm(x, lp["norm"], cfg.norm)
    z, xbc, dt_raw = torch.split(h @ lp["w_in"], [din, din + 2 * stt, nh], dim=-1)
    xbc, new_tail = _causal_conv(xbc, lp["conv_w"], conv_tail)
    xs, Bp, Cp = torch.split(F.silu(xbc), [din, stt, stt], dim=-1)

    dt = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])            # (B, T, nh)
    log_a = -torch.exp(lp["A_log"].to(torch.float32)) * dt               # (B, T, nh)

    # q = C, k = B shared across heads; v = x per head; the input gate is dt
    q = Cp[:, :, None, :].expand(B, T, nh, stt)
    k = Bp[:, :, None, :].expand(B, T, nh, stt)
    v = xs.reshape(B, T, nh, dh)
    if step:
        y, new_state = gla_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], dt[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = gla_chunked(q, k, v, log_a, dt, cfg.chunk, state=state)
    y = y + v * lp["D"].to(x.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(B, T, din) * F.silu(z), lp["out_norm"]["scale"])
    return x + y @ lp["w_out"], new_state, new_tail


def _shared_block_params(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": make_norm_params(cfg.d_model, cfg.norm),
        "attn": attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "mlp": swiglu_params(cfg.d_model, cfg.d_ff),
    }


def _n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def zamba_layout(cfg: ArchConfig) -> dict:
    # n_layers counts Mamba blocks; the shared block follows every
    # ``attn_every`` of them (9 applications for 54 / 6)
    return {
        **embed_params(cfg),
        "mamba": [mamba_block_params(cfg) for _ in range(cfg.n_layers)],
        "shared_attn": _shared_block_params(cfg),  # ONE set of weights
    }


def _shared_block_apply(sp, x: torch.Tensor, cfg: ArchConfig, *, cache=None, cache_pos=None):
    h = apply_norm(x, sp["attn_norm"], cfg.norm)
    a, kv = attention(sp["attn"], h, cfg, cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(x, sp["mlp_norm"], cfg.norm)
    return x + swiglu(sp["mlp"], h), kv


def zamba_init_state(cfg: ArchConfig, batch: int, max_seq: int, dtype, device=None) -> ZambaState:
    """A zero state with a max_seq KV cache on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    nh = cfg.ssm_heads_
    stt = cfg.ssm_state
    L = cfg.n_layers
    f32 = torch.float32
    return ZambaState(
        ssm=GLAState(S=torch.zeros((L, batch, nh, stt, cfg.d_inner // nh), dtype=f32, device=dev),
                     n=torch.zeros((L, batch, nh, stt), dtype=f32, device=dev)),
        conv=torch.zeros((L, batch, _CONV_K - 1, cfg.d_inner + 2 * stt), dtype=dtype, device=dev),
        attn_kv=init_kv_cache(cfg, batch, max_seq, _n_groups(cfg), dtype, dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
    )


def zamba_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, remat=False,
                  return_state: bool = False):
    """Logits (B, T, V); ``return_state=True`` also returns the ZambaState
    after the T tokens, its KV cache T positions deep. ``remat`` wraps each
    Mamba-2 block, not the shared block, as JAX does; no block tags a value,
    so "save_collectives" recomputes each whole."""
    check_remat(remat, return_state)
    x = embed_tokens(params, tokens, cfg)
    B, T = tokens.shape
    k = cfg.attn_every
    if return_state:
        state = zamba_init_state(cfg, B, T, x.dtype, x.device)
        state.pos.fill_(T)
    for g in range(_n_groups(cfg)):
        for j in range(k):
            li = g * k + j
            if remat:
                x = remat_call(lambda h, lp=params["mamba"][li]: mamba_apply(
                    lp, h, cfg, None, None, step=False)[0], remat, x)
            else:
                x, st, tail = mamba_apply(params["mamba"][li], x, cfg, None, None, step=False)
                if return_state:
                    state.ssm.S[li], state.ssm.n[li], state.conv[li] = st.S, st.n, tail
        x, (kc, vc) = _shared_block_apply(params["shared_attn"], x, cfg)
        if return_state:
            state.attn_kv.k[g], state.attn_kv.v[g] = kc, vc
    logits = unembed(params, x, cfg)
    return (logits, state) if return_state else logits


def zamba_decode(params, token: torch.Tensor, state: ZambaState, pos: int, cfg: ArchConfig):
    """One token (B, 1) at position ``pos``: (logits (B, 1, V), ``state``
    updated in place: S, n and conv tails, the k/v at ``pos``, pos + 1)."""
    x = embed_tokens(params, token, cfg)
    k = cfg.attn_every
    kvs = []
    for g in range(_n_groups(cfg)):
        for j in range(k):
            li = g * k + j
            st = GLAState(S=state.ssm.S[li], n=state.ssm.n[li])
            x, _, tail = mamba_apply(params["mamba"][li], x, cfg, st, state.conv[li], step=True)
            state.conv[li] = tail
        cache = KVCache(k=state.attn_kv.k[g], v=state.attn_kv.v[g])
        x, kv = _shared_block_apply(params["shared_attn"], x, cfg, cache=cache, cache_pos=pos)
        kvs.append(kv)
    logits = unembed(params, x, cfg)
    write_cache(state.attn_kv, torch.stack([kv[0] for kv in kvs]),
                torch.stack([kv[1] for kv in kvs]), pos)
    state.pos.fill_(pos + 1)
    return logits, state
