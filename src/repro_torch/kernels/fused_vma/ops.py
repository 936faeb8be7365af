"""Public wrapper for the fused PIPECG iteration core (8 VMAs + Jacobi PC
+ dot partials, Alg. 2 lines 10-21)."""
from __future__ import annotations

import torch

from ..common import (
    BLOCK,
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
from .ref import fused_vma_dots_batched_ref, fused_vma_dots_ref

__all__ = ["fused_vma_dots", "fused_vma_dots_batched"]

_NAMES = ("z", "q", "s", "p", "x", "r", "u", "w", "n", "m", "inv_diag")


def fused_vma_dots(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    """One pass of the PIPECG core, updating z q s p x r u w m in place.

    Returns (z, q, s, p, x, r, u, w, m, dots) — the same tensors, now
    updated — with dots = float32 [(r',u'), (w',u'), (u',u')]. ``alpha``
    and ``beta`` are 0-d tensors on the vectors' device (or numbers).
    ``active`` is None or a 0-d bool device tensor; when it is False
    nothing changes and the dots are 0. On CPU tensors this runs the
    plain version; on CUDA tensors it launches the kernel or raises.
    ``fused_vma_dots.launches`` counts kernel launches.
    """
    vecs = (z, q, s, p, x, r, u, w)
    dev = z.device
    if dev.type == "cpu":
        if active is not None and not bool(active):
            return (*vecs, m, torch.zeros(3, dtype=torch.float32))
        *new, dots = fused_vma_dots_ref(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta)
        for old, upd in zip((*vecs, m), new):
            old.copy_(upd)
        return (*vecs, m, dots)
    if dev.type != "cuda":
        raise ValueError(f"fused_vma_dots takes CPU or CUDA tensors, got {dev}")
    length = z.shape[0]
    all_vecs = (*vecs, n, m, inv_diag)
    check_vectors(_NAMES, all_vecs, length=length, device=dev)
    check_distinct(_NAMES, all_vecs)
    alpha = device_scalar(alpha, dev)
    beta = device_scalar(beta, dev)
    active = check_active(active, dev)
    partials = torch.empty(ceil_to(length, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    dots = torch.empty(3, dtype=torch.float32, device=dev)
    kernel.launch(vecs, n, m, inv_diag, alpha, beta, active, partials, dots, 1, length,
                  stream_ptr(dev))  # the kernel's one-lane case
    count_launch(fused_vma_dots)
    return (*vecs, m, dots)


fused_vma_dots.launches = 0


def fused_vma_dots_batched(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    """The core for k right-hand sides at once (the TPU kernel under
    ``jax.vmap``): vectors are (k, len) float32 and updated in place with m,
    ``inv_diag`` (len,) is shared, ``alpha``/``beta`` are (k,) and
    ``active`` None or a (k,) bool device tensor. A lane whose flag is
    False is left untouched and its dots are 0. Returns (z, ..., w, m,
    dots) with dots (k, 3). On CPU tensors this runs the plain version; on
    CUDA tensors it launches the kernel (one launch for any k) or raises.
    ``fused_vma_dots_batched.launches`` counts kernel launches.
    """
    vecs = (z, q, s, p, x, r, u, w)
    dev = z.device
    if dev.type == "cpu":
        *new, dots = fused_vma_dots_batched_ref(z, q, s, p, x, r, u, w, n, m, inv_diag,
                                                alpha, beta)
        if active is not None:
            keep = active[:, None]
            new = [torch.where(keep, upd, old) for upd, old in zip(new, (*vecs, m))]
            dots = torch.where(keep, dots, torch.zeros_like(dots))
        for old, upd in zip((*vecs, m), new):
            old.copy_(upd)
        return (*vecs, m, dots)
    if dev.type != "cuda":
        raise ValueError(f"fused_vma_dots_batched takes CPU or CUDA tensors, got {dev}")
    if z.dim() != 2:
        raise ValueError(f"fused_vma_dots_batched takes (k, n) vectors, got shape {tuple(z.shape)}")
    k, length = z.shape
    check_lanes(_NAMES[:10], (*vecs, n, m), shape=(k, length), device=dev)
    check_vectors(_NAMES[10:], (inv_diag,), length=length, device=dev)
    check_distinct(_NAMES, (*vecs, n, m, inv_diag))
    alpha = lane_scalars(alpha, k, dev)
    beta = lane_scalars(beta, k, dev)
    active = check_lane_active(active, k, dev)
    partials = torch.empty(k, ceil_to(length, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    dots = torch.empty(k, 3, dtype=torch.float32, device=dev)
    if k:
        kernel.launch(vecs, n, m, inv_diag, alpha, beta, active, partials, dots, k, length,
                      stream_ptr(dev))
        count_launch(fused_vma_dots_batched)
    return (*vecs, m, dots)


fused_vma_dots_batched.launches = 0
