"""ctypes binding of the banded SPMV kernel (``csrc/spmv_dia.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

# bf16 storage; f32 goes through the lane entry (one vector is one lane)
_ENTRIES = {
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
    return (dtype, out_dtype) in _ENTRIES or dtype == out_dtype == torch.float32


def launch(offsets: tuple[int, ...], data: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           stream: int) -> None:
    """The bf16 entry on one vector, on ``stream``; shapes and types are
    checked by the wrapper."""
    fn = getattr(library(), _ENTRIES[(x.dtype, y.dtype)])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(ctypes.cast(offs, ctypes.c_void_p), len(offsets), data.data_ptr(), x.data_ptr(),
             y.data_ptr(), x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"spmv_dia kernel launch failed: CUDA error {err}")


_LANES_ARGTYPES = [
    ctypes.c_void_p,  # host int32 offsets
    ctypes.c_int,     # k
    ctypes.c_int,     # lanes
    ctypes.c_void_p,  # data (k, n)
    ctypes.c_void_p,  # x (lanes, n)
    ctypes.c_void_p,  # active: (lanes,) bool, or NULL
    ctypes.c_void_p,  # y (lanes, n)
    ctypes.c_int64,   # n
    ctypes.c_void_p,  # stream
]


# the lane entries: f32 or bf16 data and x, f32 sums and y
_LANES_ENTRIES = {torch.float32: "spmv_dia_lanes_f32", torch.bfloat16: "spmv_dia_lanes_bf16_f32"}


def launch_lanes(offsets: tuple[int, ...], data: torch.Tensor, x: torch.Tensor, active,
                 y: torch.Tensor, lanes: int, n: int, stream: int) -> None:
    """The lane entry of x's dtype (f32 or bf16; y is f32) on ``lanes``
    rows of n, lanes <= 8 (one 1-D vector is one lane); checked by the
    wrapper."""
    fn = getattr(library(), _LANES_ENTRIES[x.dtype])
    fn.argtypes = _LANES_ARGTYPES
    fn.restype = ctypes.c_int
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(ctypes.cast(offs, ctypes.c_void_p), len(offsets), lanes, data.data_ptr(),
             x.data_ptr(), None if active is None else active.data_ptr(), y.data_ptr(), n,
             stream)
    if err != 0:
        raise RuntimeError(f"spmv_dia kernel launch failed: CUDA error {err}")
