"""Chunked gated linear attention, the engine under the SSM and hybrid
families, as the JAX package's ``models/gla.py``.

mLSTM (xLSTM) and Mamba-2's SSD layer are both scalar-decay linear
attention:

    S_t = a_t * S_{t-1} + b_t * k_t v_t^T          (state (dk, dv) per head)
    n_t = a_t * n_{t-1} + b_t * k_t                (normalizer, optional)
    y_t = q_t @ S_t [ / max(|q_t @ n_t|, 1) ]

with per-(head, step) scalars a_t (decay, in (0, 1]) and b_t (input
gate). ``gla_chunked`` computes each chunk's interactions as a masked
(L, L) quadratic and carries the state across chunks in a Python loop
(JAX's ``lax.scan``); ``gla_step`` is the one-token recurrence, which
updates the state in place (JAX returns a new one).

Shapes: q, k (B, T, H, dk); v (B, T, H, dv); log_a, b (B, T, H). The
sums run in f32 and the output is cast to v's dtype, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GLAState", "gla_init_state", "gla_chunked", "gla_step"]


class GLAState(NamedTuple):
    S: torch.Tensor  # (B, H, dk, dv) f32; stacked (L, B, H, dk, dv) in a model state
    n: torch.Tensor  # (B, H, dk) f32


def gla_init_state(batch: int, heads: int, dk: int, dv: int, device,
                   dtype=torch.float32) -> GLAState:
    return GLAState(S=torch.zeros((batch, heads, dk, dv), dtype=dtype, device=device),
                    n=torch.zeros((batch, heads, dk), dtype=dtype, device=device))


def gla_chunked(q, k, v, log_a, b, chunk: int, *, state: GLAState | None = None,
                normalize: bool = False):
    """Full-sequence chunkwise pass. Returns (y (B, T, H, dv), final
    GLAState). T must be a multiple of ``chunk``: nothing is padded."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    L = chunk
    if T % L:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {L}")
    f32 = torch.float32
    kb = k.to(f32) * b.to(f32)[..., None]  # fold the input gate into k
    qf, vf, af = q.to(f32), v.to(f32), log_a.to(f32)
    if state is None:
        S = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=f32, device=q.device)
    else:
        S, n = state.S.to(f32), state.n.to(f32)
    # s > t: -inf before the exp (JAX masks after it, where exp may overflow)
    future = ~torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    ys, dens = [], []
    for c in range(T // L):
        part = slice(c * L, (c + 1) * L)
        qq, kk, vv = qf[:, part], kb[:, part], vf[:, part]
        A = torch.cumsum(af[:, part], dim=1)  # (B, L, H): sum_{j<=t} log a_j
        # inter-chunk: e^{A_t} q_t S_prev
        q_sc = qq * torch.exp(A)[..., None]
        y = torch.einsum("blhk,bhkv->blhv", q_sc, S)
        # intra-chunk: D[t, s] = e^{A_t - A_s} for s <= t
        D = torch.exp((A[:, :, None, :] - A[:, None, :, :]).masked_fill(future, float("-inf")))
        scores = torch.einsum("blhk,bmhk->blmh", qq, kk) * D
        ys.append(y + torch.einsum("blmh,bmhv->blhv", scores, vv))
        if normalize:
            dens.append(torch.einsum("blhk,bhk->blh", q_sc, n) + scores.sum(dim=2))
        # S_new = e^{A_L} S + sum_s e^{A_L - A_s} k_s v_s^T
        e_tot = torch.exp(A[:, -1])  # (B, H)
        k_sc = kk * torch.exp(A[:, -1:] - A)[..., None]
        S = S * e_tot[..., None, None] + torch.einsum("blhk,blhv->bhkv", k_sc, vv)
        n = n * e_tot[..., None] + k_sc.sum(dim=1)
    y = torch.cat(ys, dim=1)
    if normalize:
        y = y / torch.clamp(torch.cat(dens, dim=1).abs(), min=1.0)[..., None]
    return y.to(v.dtype), GLAState(S=S, n=n)


def gla_step(q, k, v, log_a, b, state: GLAState, *, normalize: bool = False):
    """One-token recurrence. q, k (B, H, dk); v (B, H, dv); log_a, b (B, H).
    Updates ``state`` (f32) in place and returns (y (B, H, dv), state)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None]  # (B, H, 1)
    kb = k.to(f32) * b.to(f32)[..., None]
    S = state.S.mul_(a[..., None]).addcmul_(kb[..., :, None], v.to(f32)[..., None, :])
    n = state.n.mul_(a).add_(kb)
    qf = q.to(f32)
    y = torch.einsum("bhk,bhkv->bhv", qf, S)
    if normalize:
        den = torch.einsum("bhk,bhk->bh", qf, n)
        y = y / torch.clamp(den.abs(), min=1.0)[..., None]
    return y.to(v.dtype), state
