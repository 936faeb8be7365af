"""Public wrapper for the Block-ELLPACK SPMV kernel."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..common import check_active, stream_ptr
from . import kernel
from .ref import spmv_bell_ref

if TYPE_CHECKING:  # the sparse package imports the kernels package
    from ...sparse.formats import BellMatrix

__all__ = ["spmv_bell_cuda"]


def spmv_bell_cuda(A: BellMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    """y = A @ x for a Block-ELLPACK matrix through the hand-written CUDA kernel.

    ``vals`` and ``x`` are both float32 or both bf16; the kernel
    accumulates in f32 and writes x's dtype. Any row count. ``active`` is
    None or a solver loop's 0-d bool device flag; when it is False the
    solve has converged and y is 0, for the cost of writing it. On a CPU
    tensor this runs the plain version; on a CUDA tensor it launches the
    kernel or raises. The column indices are checked to lie in [0, n)
    once per operator. ``spmv_bell_cuda.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        y = spmv_bell_ref(A.cols, A.vals, x)
        return y if active is None else torch.where(active, y, torch.zeros_like(y))
    if x.device.type != "cuda":
        raise ValueError(f"spmv_bell_cuda takes CPU or CUDA tensors, got {x.device}")
    n = A.n
    if A.vals.device != x.device or A.cols.device != x.device:
        raise ValueError(f"cols on {A.cols.device}, vals on {A.vals.device}, x on {x.device}")
    if A.vals.dtype != x.dtype or not kernel.supported(x.dtype):
        raise TypeError(
            f"spmv_bell kernel takes f32 or bf16 vals and x of one dtype, got "
            f"vals {A.vals.dtype}, x {x.dtype}"
        )
    if A.cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {A.cols.dtype}")
    if (x.shape != (n,) or A.cols.dim() != 2 or A.cols.shape[0] != n
            or A.vals.shape != A.cols.shape or A.slots_per_row < 1):
        raise ValueError(f"shapes: cols {tuple(A.cols.shape)}, vals {tuple(A.vals.shape)}, "
                         f"x {tuple(x.shape)}, n {n}")
    if not (A.cols.is_contiguous() and A.vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("cols, vals and x must be contiguous")
    if not A.columns_in_range:
        raise ValueError(f"a column index lies outside [0, {n})")
    active = check_active(active, x.device)
    y = torch.empty_like(x)
    if n:
        kernel.launch(A.cols, A.vals, x, active, y, stream_ptr(x.device))
        spmv_bell_cuda.launches += 1
    return y


spmv_bell_cuda.launches = 0
