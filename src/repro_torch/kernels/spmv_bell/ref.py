"""Plain PyTorch version of the Block-ELLPACK SPMV:
y[i] = sum_r vals[i, r] * x[cols[i, r]].

Accumulates in at least float32 (bf16 storage is upcast per product)
and returns x's dtype, as the JAX package's ``spmv_bell_ref`` does.
"""
from __future__ import annotations

import torch


def spmv_bell_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` is (n,) or carries leading lane axes, (k, n)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return (vals.to(acc) * x[..., cols].to(acc)).sum(dim=-1).to(x.dtype)


def spmv_bell_batched_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                          active: torch.Tensor | None = None) -> torch.Tensor:
    """The lane-batched SPMV: y[l] = A x[l] for x of shape (k, n), float32;
    a lane whose ``active`` flag is False gets 0, as the kernel writes."""
    y = spmv_bell_ref(cols, vals, x)
    return y if active is None else torch.where(active[:, None], y, torch.zeros_like(y))
