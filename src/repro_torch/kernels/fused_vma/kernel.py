"""ctypes binding of the fused VMA kernel (``csrc/fused_vma.cu``)."""
from __future__ import annotations

import ctypes

from ..common import library

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int64, ctypes.c_void_p]


def launch(vecs, n_vec, m, inv, alpha, beta, active, partials, dots, lanes: int, n: int,
           stream: int) -> None:
    """The core on ``lanes`` rows of n (a single solve's 1-D vectors are one
    lane); vecs = (z, q, s, p, x, r, u, w), updated in place with m. alpha,
    beta and active (may be None) hold one entry a lane, partials (lanes,
    blocks, 3) and dots (lanes, 3) entries. Checked by the wrapper."""
    fn = library().fused_vma_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(
        lanes, *(v.data_ptr() for v in vecs), n_vec.data_ptr(), m.data_ptr(),
        inv.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
        None if active is None else active.data_ptr(), partials.data_ptr(), dots.data_ptr(),
        n, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_vma kernel launch failed: CUDA error {err}")
