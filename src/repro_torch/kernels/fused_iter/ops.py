"""Public wrapper for the whole-iteration fused PIPECG kernel."""
from __future__ import annotations

import torch

from ..common import (
    BLOCK,
    LANE_CHUNK,
    MAX_DIAGS,
    ceil_to,
    check_active,
    check_distinct,
    check_lane_active,
    check_lanes,
    check_vectors,
    count_launch,
    device_scalar,
    lane_scalars,
    stream_ptr,
)
from . import kernel
from .ref import fused_iter_batched_ref, fused_iter_ref

__all__ = ["fused_iter_step", "fused_iter_batched"]

_NAMES = ("z", "q", "s", "p", "x", "r", "u", "w", "m", "m_out", "inv_diag")


def fused_iter_step(data, offsets, z, q, s, p, x, r, u, w, m, m_out, inv_diag,
                    alpha, beta, active=None):
    """One fused PIPECG iteration: SPMV n = A m + 8 VMAs + Jacobi PC + dots.

    ``data`` is (k, len) float32 or bfloat16 (each entry upcast to f32
    before its product) with the DIA zero convention; the 8 float32
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
    _check_band(data, offsets, length, dev)
    alpha = device_scalar(alpha, dev)
    beta = device_scalar(beta, dev)
    active = check_active(active, dev)
    partials = torch.empty(ceil_to(length, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    dots = torch.empty(3, dtype=torch.float32, device=dev)
    kernel.launch(offsets, data, m, m_out, vecs, inv_diag, alpha, beta, active, partials, dots,
                  1, length, stream_ptr(dev))  # the kernel's one-lane case
    count_launch(fused_iter_step)
    return (*vecs, m_out, dots)


fused_iter_step.launches = 0


def _check_band(data, offsets, length, dev) -> None:
    if data.device != dev or data.dtype not in kernel.ENTRIES:
        raise TypeError(f"data must be float32 or bfloat16 on {dev}, got {data.dtype} on "
                        f"{data.device}")
    if data.shape != (len(offsets), length) or not data.is_contiguous():
        raise ValueError(f"data must be contiguous ({len(offsets)}, {length}), got {tuple(data.shape)}")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"the kernel takes at most {MAX_DIAGS} diagonals, got {len(offsets)}")


def fused_iter_batched(data, offsets, z, q, s, p, x, r, u, w, m, m_out, inv_diag,
                       alpha, beta, active=None):
    """The fused iteration for k right-hand sides at once (the TPU kernel
    under ``jax.vmap``): vectors are (k, len) float32, ``data`` float32 or
    bfloat16 as in :func:`fused_iter_step`, ``inv_diag`` (len,) is shared,
    ``alpha``/``beta`` are (k,) and ``active`` None or a (k,) bool device
    tensor. The band is read once for up to 8 lanes; a larger
    k runs in chunks of 8, one launch each. A lane whose flag is False is
    left untouched (only its m is copied to m_out) and its dots are 0.
    Returns (z, ..., w, m_out, dots) with dots (k, 3). On CPU tensors this
    runs the plain version; on CUDA tensors it launches the kernel or
    raises. ``fused_iter_batched.launches`` counts kernel launches.
    """
    vecs = (z, q, s, p, x, r, u, w)
    dev = z.device
    if dev.type == "cpu":
        *new, dots = fused_iter_batched_ref(data, offsets, *vecs, m, inv_diag, alpha, beta)
        if active is not None:
            keep = active[:, None]
            new = [torch.where(keep, upd, old) for upd, old in zip(new, (*vecs, m))]
            dots = torch.where(keep, dots, torch.zeros_like(dots))
        for old, upd in zip((*vecs, m_out), new):
            old.copy_(upd)
        return (*vecs, m_out, dots)
    if dev.type != "cuda":
        raise ValueError(f"fused_iter_batched takes CPU or CUDA tensors, got {dev}")
    if z.dim() != 2:
        raise ValueError(f"fused_iter_batched takes (k, n) vectors, got shape {tuple(z.shape)}")
    k, length = z.shape
    check_lanes(_NAMES[:10], (*vecs, m, m_out), shape=(k, length), device=dev)
    check_vectors(_NAMES[10:], (inv_diag,), length=length, device=dev)
    check_distinct(_NAMES, (*vecs, m, m_out, inv_diag))
    _check_band(data, offsets, length, dev)
    alpha = lane_scalars(alpha, k, dev)
    beta = lane_scalars(beta, k, dev)
    active = check_lane_active(active, k, dev)
    partials = torch.empty(k, ceil_to(length, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    dots = torch.empty(k, 3, dtype=torch.float32, device=dev)
    for lo in range(0, k, LANE_CHUNK):
        sl = slice(lo, min(k, lo + LANE_CHUNK))
        kernel.launch(offsets, data, m[sl], m_out[sl], [v[sl] for v in vecs], inv_diag,
                      alpha[sl], beta[sl], None if active is None else active[sl],
                      partials[sl], dots[sl], sl.stop - sl.start, length, stream_ptr(dev))
        count_launch(fused_iter_batched)
    return (*vecs, m_out, dots)


fused_iter_batched.launches = 0
