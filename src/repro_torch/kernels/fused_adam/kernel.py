"""ctypes binding of the fused AdamW kernel (``csrc/fused_adam.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

_ENTRIES = {
    (torch.float32, torch.float32): "fused_adamw_f32",
    (torch.bfloat16, torch.bfloat16): "fused_adamw_bf16",
    (torch.bfloat16, torch.float32): "fused_adamw_bf16_f32grad",
}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]
_FNS: dict = {}


def supported(p_dtype: torch.dtype, g_dtype: torch.dtype) -> bool:
    return (p_dtype, g_dtype) in _ENTRIES


def _entry(key):
    # bound once: a training step launches the kernel once per parameter tensor
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(), _ENTRIES[key])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def launch(hyper, p, g, m, v, stream: int) -> None:
    """Launch on ``stream``; shapes and types are checked by the wrapper."""
    err = _entry((p.dtype, g.dtype))(hyper.data_ptr(), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                     v.data_ptr(), p.numel(), stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error {err}")
