"""Plain PyTorch version of the whole-iteration fused kernel.

Delegates to the two implementations the rest of the port runs —
``spmv_dia_ref`` for n = A m and ``core.iteration.pipecg_vma_core`` for
the recurrence — so the kernel is held against the math of the unfused
path.
"""
from __future__ import annotations

import torch

from ..spmv_dia.ref import spmv_dia_ref


def fused_iter_ref(data, offsets, z, q, s, p, x, r, u, w, m, inv_diag, alpha, beta):
    """n = A m, then the PIPECG recurrence on it.

    Returns (z', q', s', p', x', r', u', w', m', (gamma, delta, ||u||^2)).
    """
    from ...core.iteration import pipecg_vma_core  # lazy: core imports kernels

    alpha = torch.as_tensor(alpha, dtype=z.dtype, device=z.device)
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device)
    n_vec = spmv_dia_ref(data, offsets, m)
    return pipecg_vma_core(z, q, s, p, x, r, u, w, n_vec, m, inv_diag, alpha, beta)


def fused_iter_batched_ref(data, offsets, z, q, s, p, x, r, u, w, m, inv_diag, alpha, beta):
    """The whole iteration over (k, n) vectors with per-lane (k,) alpha and
    beta: n = A m per lane, then the recurrence. Returns (z', ..., m',
    dots) with dots (k, 3)."""
    from ..fused_vma.ref import fused_vma_dots_batched_ref

    n_vec = spmv_dia_ref(data, offsets, m)
    return fused_vma_dots_batched_ref(z, q, s, p, x, r, u, w, n_vec, m, inv_diag, alpha, beta)
