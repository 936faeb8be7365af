"""Plain PyTorch version of the banded (DIA) SPMV:
y[i] = sum_j data[j, i] * x[i + off[j]], zero outside [0, n).

Accumulates in at least float32 (bf16 storage is upcast per product)
and returns ``out_dtype`` (default: x's dtype). For float32 inputs it is
the same sequence of operations as ``repro_torch.sparse.spmv.spmv_dia``.
``x`` may carry leading lane axes, ``(k, n)``: every lane is multiplied
by the same band, with the same operations as a lane alone.
"""
from __future__ import annotations

import torch


def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x shifted along its last axis by a static offset with zero fill:
    out[..., i] = x[..., i + offset]."""
    if offset == 0:
        return x
    if offset > 0:
        return torch.cat([x[..., offset:], x.new_zeros(*x.shape[:-1], offset)], dim=-1)
    return torch.cat([x.new_zeros(*x.shape[:-1], -offset), x[..., :offset]], dim=-1)


def spmv_dia_ref(data: torch.Tensor, offsets: tuple[int, ...], x: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros(x.shape, dtype=acc, device=x.device)
    for j, o in enumerate(offsets):
        y = y + data[j].to(acc) * shifted(x, o).to(acc)
    return y.to(out_dtype or x.dtype)


def spmv_dia_batched_ref(data: torch.Tensor, offsets: tuple[int, ...], x: torch.Tensor,
                         active: torch.Tensor | None = None) -> torch.Tensor:
    """The lane-batched SPMV: y[l] = A x[l] for x of shape (k, n), float32;
    a lane whose ``active`` flag is False gets 0, as the kernel writes."""
    y = spmv_dia_ref(data, offsets, x)
    return y if active is None else torch.where(active[:, None], y, torch.zeros_like(y))


def spmv_dia_batched_bf16_ref(data: torch.Tensor, offsets: tuple[int, ...], x: torch.Tensor,
                              active: torch.Tensor | None = None) -> torch.Tensor:
    """The lane-batched mixed-precision SPMV: bf16 data and x of shape
    (k, n), every product summed in f32, y float32; a lane whose
    ``active`` flag is False gets 0, as the kernel writes."""
    y = spmv_dia_ref(data, offsets, x, torch.float32)
    return y if active is None else torch.where(active[:, None], y, torch.zeros_like(y))
