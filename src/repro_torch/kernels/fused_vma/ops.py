"""Public wrapper for the fused PIPECG iteration core (8 VMAs + Jacobi PC
+ dot partials, Alg. 2 lines 10-21)."""
from __future__ import annotations

import torch

from ..common import (
    BLOCK,
    ceil_to,
    check_active,
    check_distinct,
    check_vectors,
    device_scalar,
    stream_ptr,
)
from . import kernel
from .ref import fused_vma_dots_ref

__all__ = ["fused_vma_dots"]

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
    kernel.launch(vecs, n, m, inv_diag, alpha, beta, active, partials, dots, stream_ptr(dev))
    fused_vma_dots.launches += 1
    return (*vecs, m, dots)


fused_vma_dots.launches = 0
