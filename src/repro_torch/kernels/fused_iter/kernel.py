"""ctypes binding of the whole-iteration kernel (``csrc/fused_iter.cu``)."""
from __future__ import annotations

import ctypes

import torch

from ..common import library

# the band's dtype -> entry; the vectors and sums are f32 in both
ENTRIES = {torch.float32: "fused_iter_f32", torch.bfloat16: "fused_iter_bf16band_f32"}

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # host int32 offsets, k, lanes
    + [ctypes.c_void_p] * 17                       # data, m_in, m_out, 8 vectors, inv, alpha, beta, active, partials, dots
    + [ctypes.c_int64, ctypes.c_void_p]
)


def launch(offsets, data, m_in, m_out, vecs, inv, alpha, beta, active, partials, dots,
           lanes: int, n: int, stream: int) -> None:
    """One iteration on ``lanes`` rows of n (lanes <= 8; a single solve's
    1-D vectors are one lane); vecs = (z, q, s, p, x, r, u, w), updated in
    place, and m_out receives the new m. alpha, beta and active (may be
    None) hold one entry a lane, partials (lanes, blocks, 3) and dots
    (lanes, 3) entries; data is f32 or bf16 (the entry of its dtype).
    Checked by the wrapper."""
    fn = getattr(library(), ENTRIES[data.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(
        ctypes.cast(offs, ctypes.c_void_p), len(offsets), lanes, data.data_ptr(),
        m_in.data_ptr(), m_out.data_ptr(), *(v.data_ptr() for v in vecs), inv.data_ptr(),
        alpha.data_ptr(), beta.data_ptr(), None if active is None else active.data_ptr(),
        partials.data_ptr(), dots.data_ptr(), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_iter kernel launch failed: CUDA error {err}")
