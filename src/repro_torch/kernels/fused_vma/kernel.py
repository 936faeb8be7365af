"""ctypes binding of the fused VMA kernel (``csrc/fused_vma.cu``)."""
from __future__ import annotations

import ctypes

from ..common import library

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int64, ctypes.c_void_p]


def launch(vecs, n_vec, m, inv, alpha, beta, active, partials, dots, stream: int) -> None:
    """vecs = (z, q, s, p, x, r, u, w), updated in place with m; shapes
    and types are checked by the wrapper. ``active`` may be None."""
    fn = library().fused_vma_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(
        *(v.data_ptr() for v in vecs), n_vec.data_ptr(), m.data_ptr(), inv.data_ptr(),
        alpha.data_ptr(), beta.data_ptr(), None if active is None else active.data_ptr(),
        partials.data_ptr(), dots.data_ptr(), m.shape[0], stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_vma kernel launch failed: CUDA error {err}")
