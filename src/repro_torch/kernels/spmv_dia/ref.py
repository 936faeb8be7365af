"""Plain PyTorch version of the banded (DIA) SPMV:
y[i] = sum_j data[j, i] * x[i + off[j]], zero outside [0, n).

Accumulates in at least float32 (bf16 storage is upcast per product)
and returns ``out_dtype`` (default: x's dtype). For float32 inputs it is
the same sequence of operations as ``repro_torch.sparse.spmv.spmv_dia``.
"""
from __future__ import annotations

import torch


def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x shifted by a static offset with zero fill: out[i] = x[i+offset]."""
    if offset == 0:
        return x
    if offset > 0:
        return torch.cat([x[offset:], x.new_zeros(offset)])
    return torch.cat([x.new_zeros(-offset), x[:offset]])


def spmv_dia_ref(data: torch.Tensor, offsets: tuple[int, ...], x: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros(x.shape, dtype=acc, device=x.device)
    for j, o in enumerate(offsets):
        y = y + data[j].to(acc) * shifted(x, o).to(acc)
    return y.to(out_dtype or x.dtype)
