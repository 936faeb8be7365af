"""ctypes binding of the fused triple-dot kernel (``csrc/fused_dot.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

_ENTRIES = {torch.float32: "fused_dots_f32", torch.bfloat16: "fused_dots_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]


def supported(dtype: torch.dtype) -> bool:
    return dtype in _ENTRIES


def launch(r, u, w, partials, dots, stream: int) -> None:
    """Launch on ``stream``; shapes and types are checked by the wrapper."""
    fn = getattr(library(), _ENTRIES[r.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), u.data_ptr(), w.data_ptr(), partials.data_ptr(), dots.data_ptr(),
             r.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"fused_dots kernel launch failed: CUDA error {err}")
