"""Public wrapper for the banded SPMV kernel."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..common import LANE_CHUNK, MAX_DIAGS, check_lane_active, count_launch, stream_ptr
from . import kernel
from .ref import spmv_dia_batched_bf16_ref, spmv_dia_batched_ref, spmv_dia_ref

if TYPE_CHECKING:  # the sparse package imports the kernels package
    from ...sparse.formats import DIAMatrix

__all__ = ["spmv_dia_cuda", "spmv_dia_batched", "spmv_dia_batched_bf16"]


def spmv_dia_cuda(A: DIAMatrix, x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = A @ x for a DIA matrix through the hand-written CUDA kernel.

    ``data`` and ``x`` are both float32 or both bf16; the kernel always
    accumulates in f32, so bf16 inputs with ``out_dtype=torch.float32``
    are the mixed-precision SPMV. On a CPU tensor this runs the plain
    version; on a CUDA tensor it launches the kernel or raises.
    ``spmv_dia_cuda.launches`` counts kernel launches.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return spmv_dia_ref(A.data, A.offsets, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_dia_cuda takes CPU or CUDA tensors, got {x.device}")
    n = x.shape[0]
    if A.data.device != x.device:
        raise ValueError(f"data on {A.data.device}, x on {x.device}")
    if A.data.dtype != x.dtype or not kernel.supported(x.dtype, out_dtype):
        raise TypeError(
            f"spmv_dia kernel takes f32 or bf16 data/x with an f32 or bf16 output, got "
            f"data {A.data.dtype}, x {x.dtype}, out {out_dtype}"
        )
    if x.dim() != 1 or A.data.shape != (len(A.offsets), n):
        raise ValueError(f"shapes: data {tuple(A.data.shape)}, x {tuple(x.shape)}")
    if not (A.data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    if len(A.offsets) > MAX_DIAGS:
        raise ValueError(f"the kernel takes at most {MAX_DIAGS} diagonals, got {len(A.offsets)}")
    y = torch.empty(n, dtype=out_dtype, device=x.device)
    if n:
        if x.dtype == torch.float32:  # the lane entry, one lane
            kernel.launch_lanes(A.offsets, A.data, x, None, y, 1, n, stream_ptr(x.device))
        else:
            kernel.launch(A.offsets, A.data, x, y, stream_ptr(x.device))
        count_launch(spmv_dia_cuda)
    return y


spmv_dia_cuda.launches = 0


def spmv_dia_batched(A: DIAMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    """Y[l] = A @ x[l] for k right-hand sides, x of shape (k, n), float32
    (the TPU kernel under ``jax.vmap``). One launch takes up to 8 lanes and
    reads the band from device memory once for all of them (2 to 8 lanes:
    the tile kernel, 1024 rows a block with windows of x in shared memory;
    one lane: the single-vector kernel); a larger k runs in chunks of 8,
    one launch each. Lane l is bit for bit ``spmv_dia_cuda(A, x[l])``.
    ``active`` is None or a (k,) bool device tensor; a lane whose flag is
    False reads nothing and gets 0. On a CPU tensor this runs the plain
    version; on a CUDA tensor it launches the kernel or raises.
    ``spmv_dia_batched.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return spmv_dia_batched_ref(A.data, A.offsets, x, active)
    return _launch_lanes(spmv_dia_batched, A, x, active, torch.float32)


spmv_dia_batched.launches = 0


def spmv_dia_batched_bf16(A: DIAMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    """The mixed-precision SPMV for k right-hand sides: bf16 ``A.data`` and
    x of shape (k, n), every product summed in f32, Y float32 (the "bf16"
    engine's ``spmv_dia_bf16`` under ``jax.vmap``), launched as
    :func:`spmv_dia_batched` is, its windows of x kept in bf16. Lane l is
    bit for bit ``spmv_dia_cuda(A, x[l], out_dtype=torch.float32)``.
    ``active`` as in :func:`spmv_dia_batched`. On a CPU tensor this runs
    the plain version; on a CUDA tensor it launches the kernel or raises.
    ``spmv_dia_batched_bf16.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return spmv_dia_batched_bf16_ref(A.data, A.offsets, x, active)
    return _launch_lanes(spmv_dia_batched_bf16, A, x, active, torch.bfloat16)


spmv_dia_batched_bf16.launches = 0


def _launch_lanes(wrapper, A: DIAMatrix, x: torch.Tensor, active, dtype) -> torch.Tensor:
    name = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes (k, n) vectors, got shape {tuple(x.shape)}")
    k, n = x.shape
    if A.data.device != x.device:
        raise ValueError(f"data on {A.data.device}, x on {x.device}")
    if A.data.dtype != dtype or x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype} data and x, got data {A.data.dtype}, x {x.dtype}")
    if A.data.shape != (len(A.offsets), n):
        raise ValueError(f"shapes: data {tuple(A.data.shape)}, x {tuple(x.shape)}")
    if not (A.data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    if len(A.offsets) > MAX_DIAGS:
        raise ValueError(f"the kernel takes at most {MAX_DIAGS} diagonals, got {len(A.offsets)}")
    active = check_lane_active(active, k, x.device)
    y = torch.empty(k, n, dtype=torch.float32, device=x.device)
    if n:
        for lo in range(0, k, LANE_CHUNK):
            sl = slice(lo, min(k, lo + LANE_CHUNK))
            kernel.launch_lanes(A.offsets, A.data, x[sl], None if active is None else active[sl],
                                y[sl], sl.stop - sl.start, n, stream_ptr(x.device))
            count_launch(wrapper)
    return y
