"""ctypes binding of the flash attention kernel (``csrc/flash_attn.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

_ENTRIES = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
MAX_HEAD_DIM = 128  # csrc/flash_attn.cu: FA_MAX_HD


def supported(dtype: torch.dtype) -> bool:
    return dtype in _ENTRIES


def launch(q, k, v, o, causal: bool, sm_scale: float, stream: int) -> None:
    """Launch on ``stream``; shapes and types are checked by the wrapper."""
    fn = getattr(library(), _ENTRIES[q.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Tq, Tk, H, KV, hd,
             sm_scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
