"""Public wrapper for the Block-ELLPACK SPMV kernel."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..common import LANE_CHUNK, check_active, check_lane_active, count_launch, stream_ptr
from . import kernel
from .ref import spmv_bell_batched_ref, spmv_bell_ref

if TYPE_CHECKING:  # the sparse package imports the kernels package
    from ...sparse.formats import BellMatrix

__all__ = ["spmv_bell_cuda", "spmv_bell_batched"]


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
        if x.dtype == torch.float32:  # the lane entry, one lane
            kernel.launch_lanes(A.cols, A.vals, x, active, y, 1, 0, stream_ptr(x.device))
        else:
            kernel.launch(A.cols, A.vals, x, active, y, stream_ptr(x.device))
        count_launch(spmv_bell_cuda)
    return y


spmv_bell_cuda.launches = 0


def spmv_bell_batched(A: BellMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    """Y[l] = A @ x[l] for k right-hand sides, x of shape (k, n), float32
    (the TPU kernel under ``jax.vmap``). ``cols`` and ``vals`` are read
    once for up to 8 lanes; a larger k runs in chunks of 8, one launch
    each. The kernel keeps a window of x around each tile of rows in
    shared memory, sized by ``A.column_span`` (computed on first use);
    columns outside it are gathered from x, with the same result.
    ``active`` is None or a (k,) bool device tensor; a lane whose flag is
    False gathers nothing and gets 0. On a CPU tensor this runs the plain
    version; on a CUDA tensor it launches the kernel or raises.
    ``spmv_bell_batched.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return spmv_bell_batched_ref(A.cols, A.vals, x, active)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_bell_batched takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"spmv_bell_batched takes (k, n) vectors, got shape {tuple(x.shape)}")
    k, n = x.shape
    if A.vals.device != x.device or A.cols.device != x.device:
        raise ValueError(f"cols on {A.cols.device}, vals on {A.vals.device}, x on {x.device}")
    if A.vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"the batched spmv_bell kernel takes f32 vals and x, got vals "
                        f"{A.vals.dtype}, x {x.dtype}")
    if A.cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {A.cols.dtype}")
    if (n != A.n or A.cols.dim() != 2 or A.cols.shape[0] != n
            or A.vals.shape != A.cols.shape or A.slots_per_row < 1):
        raise ValueError(f"shapes: cols {tuple(A.cols.shape)}, vals {tuple(A.vals.shape)}, "
                         f"x {tuple(x.shape)}, n {A.n}")
    if not (A.cols.is_contiguous() and A.vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("cols, vals and x must be contiguous")
    if not A.columns_in_range:
        raise ValueError(f"a column index lies outside [0, {n})")
    active = check_lane_active(active, k, x.device)
    y = torch.empty_like(x)
    if n:
        for lo in range(0, k, LANE_CHUNK):
            sl = slice(lo, min(k, lo + LANE_CHUNK))
            kernel.launch_lanes(A.cols, A.vals, x[sl], None if active is None else active[sl],
                                y[sl], sl.stop - sl.start, A.column_span, stream_ptr(x.device))
            count_launch(spmv_bell_batched)
    return y


spmv_bell_batched.launches = 0
