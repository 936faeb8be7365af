"""Public wrapper for the whole-iteration fused PIPECG kernel."""
from __future__ import annotations

import torch

from ..common import (
    BLOCK,
    MAX_DIAGS,
    ceil_to,
    check_active,
    check_distinct,
    check_vectors,
    device_scalar,
    stream_ptr,
)
from . import kernel
from .ref import fused_iter_ref

__all__ = ["fused_iter_step"]

_NAMES = ("z", "q", "s", "p", "x", "r", "u", "w", "m", "m_out", "inv_diag")


def fused_iter_step(data, offsets, z, q, s, p, x, r, u, w, m, m_out, inv_diag,
                    alpha, beta, active=None):
    """One fused PIPECG iteration: SPMV n = A m + 8 VMAs + Jacobi PC + dots.

    ``data`` is (k, len) float32 with the DIA zero convention; the 8
    vectors z..w are updated in place and the new m is written to
    ``m_out``, a second buffer (the kernel reads m's halo across blocks,
    so m cannot be updated in place). Returns (z, q, s, p, x, r, u, w,
    m_out, dots) with dots = float32 [(r',u'), (w',u'), (u',u')]. When the
    0-d bool device tensor ``active`` is False, only m is copied to
    m_out and the dots are 0. On CPU tensors this runs the plain
    version; on CUDA tensors it launches the kernel or raises.
    ``fused_iter_step.launches`` counts kernel launches.
    """
    vecs = (z, q, s, p, x, r, u, w)
    dev = z.device
    if dev.type == "cpu":
        if active is not None and not bool(active):
            m_out.copy_(m)
            return (*vecs, m_out, torch.zeros(3, dtype=torch.float32))
        *new, (g, d, nn) = fused_iter_ref(data, offsets, *vecs, m, inv_diag, alpha, beta)
        for old, upd in zip((*vecs, m_out), new):
            old.copy_(upd)
        return (*vecs, m_out, torch.stack([g, d, nn]).to(torch.float32))
    if dev.type != "cuda":
        raise ValueError(f"fused_iter_step takes CPU or CUDA tensors, got {dev}")
    length = z.shape[0]
    all_vecs = (*vecs, m, m_out, inv_diag)
    check_vectors(_NAMES, all_vecs, length=length, device=dev)
    check_distinct(_NAMES, all_vecs)
    if data.device != dev or data.dtype != torch.float32:
        raise TypeError(f"data must be float32 on {dev}, got {data.dtype} on {data.device}")
    if data.shape != (len(offsets), length) or not data.is_contiguous():
        raise ValueError(f"data must be contiguous ({len(offsets)}, {length}), got {tuple(data.shape)}")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"the kernel takes at most {MAX_DIAGS} diagonals, got {len(offsets)}")
    alpha = device_scalar(alpha, dev)
    beta = device_scalar(beta, dev)
    active = check_active(active, dev)
    partials = torch.empty(ceil_to(length, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    dots = torch.empty(3, dtype=torch.float32, device=dev)
    kernel.launch(offsets, data, m, m_out, vecs, inv_diag, alpha, beta, active, partials, dots,
                  stream_ptr(dev))
    fused_iter_step.launches += 1
    return (*vecs, m_out, dots)


fused_iter_step.launches = 0
