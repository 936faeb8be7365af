"""ctypes binding of the Block-ELLPACK SPMV kernel (``csrc/spmv_bell.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

# bf16; f32 goes through the lane entry (one vector is one lane)
_ENTRIES = {torch.bfloat16: "spmv_bell_bf16"}
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
    return dtype in _ENTRIES or dtype == torch.float32


def launch(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, active, y: torch.Tensor,
           stream: int) -> None:
    """The bf16 entry on one vector, on ``stream``; shapes and types are
    checked by the wrapper. ``active`` may be None."""
    fn = getattr(library(), _ENTRIES[x.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
             None if active is None else active.data_ptr(), y.data_ptr(), cols.shape[0],
             cols.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"spmv_bell kernel launch failed: CUDA error {err}")


_LANES_ARGTYPES = [
    ctypes.c_int,     # lanes
    ctypes.c_void_p,  # cols (n, R) int32
    ctypes.c_void_p,  # vals (n, R) f32
    ctypes.c_void_p,  # x (lanes, n)
    ctypes.c_void_p,  # active: (lanes,) bool, or NULL
    ctypes.c_void_p,  # y (lanes, n)
    ctypes.c_int64,   # n
    ctypes.c_int,     # R
    ctypes.c_int,     # column span (sizes the window of x)
    ctypes.c_void_p,  # stream
]


def launch_lanes(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, active,
                 y: torch.Tensor, lanes: int, span: int, stream: int) -> None:
    """The f32 entry on ``lanes`` rows of n, lanes <= 8 (one 1-D vector is
    one lane); ``span`` is the operator's ``column_span``. Checked by the
    wrapper."""
    fn = library().spmv_bell_lanes_f32
    fn.argtypes = _LANES_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(lanes, cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
             None if active is None else active.data_ptr(), y.data_ptr(), cols.shape[0],
             cols.shape[1], min(span, 2**31 - 1), stream)
    if err != 0:
        raise RuntimeError(f"spmv_bell kernel launch failed: CUDA error {err}")
