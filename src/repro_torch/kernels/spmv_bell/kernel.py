"""ctypes binding of the Block-ELLPACK SPMV kernel (``csrc/spmv_bell.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

_ENTRIES = {torch.float32: "spmv_bell_f32", torch.bfloat16: "spmv_bell_bf16"}
_ARGTYPES = [
    ctypes.c_void_p,  # cols (n, R) int32
    ctypes.c_void_p,  # vals (n, R)
    ctypes.c_void_p,  # x (n,)
    ctypes.c_void_p,  # active: 0-d bool, or NULL
    ctypes.c_void_p,  # y (n,)
    ctypes.c_int64,   # n
    ctypes.c_int,     # R
    ctypes.c_void_p,  # stream
]


def supported(dtype: torch.dtype) -> bool:
    return dtype in _ENTRIES


def launch(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, active, y: torch.Tensor,
           stream: int) -> None:
    """Launch on ``stream``; shapes and types are checked by the wrapper.
    ``active`` may be None."""
    fn = getattr(library(), _ENTRIES[x.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
             None if active is None else active.data_ptr(), y.data_ptr(), cols.shape[0],
             cols.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"spmv_bell kernel launch failed: CUDA error {err}")
