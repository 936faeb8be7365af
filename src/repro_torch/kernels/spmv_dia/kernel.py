"""ctypes binding of the banded SPMV kernel (``csrc/spmv_dia.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

_ENTRIES = {
    (torch.float32, torch.float32): "spmv_dia_f32_f32",
    (torch.bfloat16, torch.float32): "spmv_dia_bf16_f32",
    (torch.bfloat16, torch.bfloat16): "spmv_dia_bf16_bf16",
}
_ARGTYPES = [
    ctypes.c_void_p,  # host int32 offsets
    ctypes.c_int,     # k
    ctypes.c_void_p,  # data (k, n)
    ctypes.c_void_p,  # x (n,)
    ctypes.c_void_p,  # y (n,)
    ctypes.c_int64,   # n
    ctypes.c_void_p,  # stream
]


def supported(dtype: torch.dtype, out_dtype: torch.dtype) -> bool:
    return (dtype, out_dtype) in _ENTRIES


def launch(offsets: tuple[int, ...], data: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           stream: int) -> None:
    """Launch on ``stream``; shapes and types are checked by the wrapper."""
    fn = getattr(library(), _ENTRIES[(x.dtype, y.dtype)])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(ctypes.cast(offs, ctypes.c_void_p), len(offsets), data.data_ptr(), x.data_ptr(),
             y.data_ptr(), x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"spmv_dia kernel launch failed: CUDA error {err}")
