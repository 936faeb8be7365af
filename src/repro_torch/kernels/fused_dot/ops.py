"""Public wrapper for the fused triple dot product."""
from __future__ import annotations

import torch

from ..common import BLOCK, ceil_to, count_launch, stream_ptr
from . import kernel
from .ref import fused_dots_ref

__all__ = ["fused_dots"]


def fused_dots(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 [(r, u), (w, u), (u, u)] in a single memory pass.

    ``r``, ``u`` and ``w`` are 1-D, of one length and one dtype (float32
    or bf16, accumulated in f32). The sums are taken in a fixed order, so
    every run gives the same bits. On CPU tensors this runs the plain
    version; on CUDA tensors it launches the kernel or raises.
    ``fused_dots.launches`` counts kernel launches.
    """
    dev = r.device
    if dev.type == "cpu":
        return fused_dots_ref(r, u, w)
    if dev.type != "cuda":
        raise ValueError(f"fused_dots takes CPU or CUDA tensors, got {dev}")
    for name, v in (("r", r), ("u", u), ("w", w)):
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, expected {dev}")
        if v.dtype != r.dtype or not kernel.supported(v.dtype):
            raise TypeError(f"fused_dots takes float32 or bf16 vectors of one dtype, "
                            f"got {name} {v.dtype}")
        if v.dim() != 1 or v.shape != r.shape:
            raise ValueError(f"{name} must have shape {tuple(r.shape)}, got {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = r.shape[0]
    if n == 0:
        return torch.zeros(3, dtype=torch.float32, device=dev)
    dots = torch.empty(3, dtype=torch.float32, device=dev)
    partials = torch.empty(ceil_to(n, BLOCK) // BLOCK, 3, dtype=torch.float32, device=dev)
    kernel.launch(r, u, w, partials, dots, stream_ptr(dev))
    count_launch(fused_dots)
    return dots


fused_dots.launches = 0
