"""ctypes binding of the whole-iteration kernel (``csrc/fused_iter.cu``)."""
from __future__ import annotations

import ctypes

from ..common import library

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int]   # host int32 offsets, k
    + [ctypes.c_void_p] * 17          # data, m_in, m_out, 8 vectors, inv, alpha, beta, active, partials, dots
    + [ctypes.c_int64, ctypes.c_void_p]
)


def launch(offsets, data, m_in, m_out, vecs, inv, alpha, beta, active, partials, dots,
           stream: int) -> None:
    """vecs = (z, q, s, p, x, r, u, w), updated in place; m_out receives
    the new m. Shapes and types are checked by the wrapper."""
    fn = library().fused_iter_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(
        ctypes.cast(offs, ctypes.c_void_p), len(offsets), data.data_ptr(), m_in.data_ptr(),
        m_out.data_ptr(), *(v.data_ptr() for v in vecs), inv.data_ptr(), alpha.data_ptr(),
        beta.data_ptr(), None if active is None else active.data_ptr(), partials.data_ptr(),
        dots.data_ptr(), m_in.shape[0], stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_iter kernel launch failed: CUDA error {err}")
