"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch,
as the JAX package's ``models/moe.py`` (``moe_ffn``).

GShard-style "dropping" dispatch: each token's top-k assignments are
ranked within their expert (earlier tokens first) and written into an
(E, C, d) buffer; an assignment ranked C or later is dropped. The SwiGLU
experts are batched matrix products over the buffer, and the combine
weights each kept assignment's output by its gate.

The JAX package's ``moe_ffn_sharded`` (a ``shard_map`` over a ``model``
mesh axis) has no one-card counterpart; on one device JAX's MoE layer
takes ``moe_ffn`` too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec

__all__ = ["moe_params", "moe_ffn", "moe_capacity", "top_k_stable"]


def moe_params(d: int, f: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d, n_experts)),
        "w_gate": ParamSpec((n_experts, d, f)),
        "w_up": ParamSpec((n_experts, d, f)),
        "w_down": ParamSpec((n_experts, f, d)),
    }


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    c = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, in descending order, the
    lower index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` gives no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
            norm_topk: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d), aux_loss scalar f32).

    aux_loss is the Switch load-balancing loss: E times the sum over
    experts of (share of tokens whose first choice it is) x (mean router
    probability). The capacity C is computed per call from T, so a prefill
    and a decode step of one prompt may drop different assignments, as in
    JAX.
    """
    T, d = x.shape
    E = p["router"].shape[-1]
    logits = (x @ p["router"]).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_stable(probs, top_k)  # (T, k)
    if norm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    C = moe_capacity(T, top_k, E, capacity_factor)
    A = T * top_k
    dev = x.device
    flat_e = expert_idx.reshape(A)  # assignment -> expert
    tok_of = torch.arange(A, device=dev) // top_k  # assignment -> token

    # rank each assignment within its expert (stable: earlier tokens first)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")  # (E,)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(A, device=dev) - first[sorted_e]
    keep = pos < C

    # dispatch: an (E, C + 1, d) buffer whose last slot takes every dropped
    # assignment (JAX drops the write out of bounds; index_put would raise)
    slot = flat_e * (C + 1) + torch.where(keep, pos, C)
    buf = x.new_zeros((E * (C + 1), d))
    buf[slot] = x[tok_of]
    buf = buf.view(E, C + 1, d)[:, :C]

    # the experts: (E, C, d) x (E, d, f) batched products
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_e = torch.bmm(h, p["w_down"])  # (E, C, d)

    # combine: gather each kept assignment's output, weight by its gate
    y_a = out_e[flat_e, torch.clamp(pos, max=C - 1)]  # (A, d)
    wts = gate_vals.reshape(A).to(x.dtype) * keep.to(x.dtype)
    y = (y_a * wts[:, None]).reshape(T, top_k, d).sum(dim=1)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    # (one_hot as a comparison: F.one_hot reads the indices' range on the host)
    first_choice = expert_idx[:, :1] == torch.arange(E, device=dev)
    f_e = first_choice.to(torch.float32).mean(dim=0)
    P_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * P_e)
    return y, aux
