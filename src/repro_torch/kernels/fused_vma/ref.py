"""Plain PyTorch version of the fused PIPECG iteration core.

Delegates to the one recurrence (``core.iteration.pipecg_vma_core``),
so the kernel is held against exactly the math the solver runs; this
module only adapts the dots to the kernel's stacked-float32 output.
"""
from __future__ import annotations

import torch


def fused_vma_dots_ref(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta):
    from ...core.iteration import pipecg_vma_core  # lazy: core imports kernels

    alpha = torch.as_tensor(alpha, dtype=z.dtype, device=z.device)
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device)
    *vecs, (g, d, nn) = pipecg_vma_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta)
    return (*vecs, torch.stack([g, d, nn]).to(torch.float32))


def fused_vma_dots_batched_ref(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta):
    """The core over (k, n) vectors with per-lane (k,) alpha and beta; the
    dots come back as (k, 3)."""
    from ...core.iteration import pipecg_vma_core

    alpha = torch.as_tensor(alpha, dtype=z.dtype, device=z.device)[:, None]
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device)[:, None]
    *vecs, (g, d, nn) = pipecg_vma_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta)
    return (*vecs, torch.stack([g, d, nn], dim=-1).to(torch.float32))
