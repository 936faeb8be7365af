"""Plain PyTorch version of the fused triple dot product (PIPECG lines
18-20): float32 [(r, u), (w, u), (u, u)], as the JAX package's
``fused_dots_ref``."""
from __future__ import annotations

import torch


def fused_dots_ref(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    rf, uf, wf = (a.to(torch.float32) for a in (r, u, w))
    return torch.stack([torch.sum(rf * uf), torch.sum(wf * uf), torch.sum(uf * uf)])
