"""Public wrapper for the banded SPMV kernel."""
from __future__ import annotations

import torch

from ...sparse.formats import DIAMatrix
from ..common import MAX_DIAGS, stream_ptr
from . import kernel
from .ref import spmv_dia_ref

__all__ = ["spmv_dia_cuda"]


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
        kernel.launch(A.offsets, A.data, x, y, stream_ptr(x.device))
        spmv_dia_cuda.launches += 1
    return y


spmv_dia_cuda.launches = 0
