"""Plain PyTorch version of the fused AdamW update (one flat tensor), in the
kernel's order of operations: the JAX package's ``fused_adamw_ref``, with
its scalars read from ``hyper`` = f32[7] = (lr, b1, b2, eps, wd, 1-b1^t,
1-b2^t) as the kernels read them."""
from __future__ import annotations

import torch


def fused_adamw_ref(p, g, m, v, hyper):
    """Returns new (p in p's dtype, m f32, v f32); computes in f32."""
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.to(torch.float32).unbind()
    gf = g.to(torch.float32)
    mf = b1 * m + (1.0 - b1) * gf
    vf = b2 * v + (1.0 - b2) * gf * gf
    mhat = mf / bc1
    vhat = vf / bc2
    pf = p.to(torch.float32)
    update = mhat / (torch.sqrt(vhat) + eps) + wd * pf
    return (pf - lr * update).to(p.dtype), mf, vf
