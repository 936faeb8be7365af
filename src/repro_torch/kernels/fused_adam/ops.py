"""Public wrapper: fused AdamW over one parameter tensor, in place."""
from __future__ import annotations

import torch

from ..common import count_launch, stream_ptr
from . import kernel
from .ref import fused_adamw_ref

__all__ = ["adamw_hyper", "fused_adamw"]


def adamw_hyper(lr, b1: float, b2: float, eps: float, wd: float, step) -> torch.Tensor:
    """``hyper`` = f32[7] = (lr, b1, b2, eps, wd, 1-b1^t, 1-b2^t) on the
    device of ``step``, a 0-d tensor holding the 1-based step count t;
    ``lr`` is a float or a 0-d tensor on that device. Built from device
    ops only, so it never waits for the device."""
    hyper = torch.empty(7, dtype=torch.float32, device=step.device)
    hyper[0] = lr
    hyper[1], hyper[2], hyper[3], hyper[4] = b1, b2, eps, wd
    hyper[5:] = 1.0 - torch.pow(hyper[1:3], step.to(torch.float32))
    return hyper


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                hyper: torch.Tensor):
    """One AdamW step of one tensor, IN PLACE: p, m and v are overwritten
    (the JAX package's ``fused_adamw`` returns new arrays; updating in place
    saves a second copy of the parameters and optimizer state). Returns
    (p, m, v).

    p and g share a shape and are f32/f32, bf16/bf16 or bf16/f32 (p/g);
    m and v are f32; ``hyper`` is ``adamw_hyper(...)`` on p's device. On
    CPU tensors this runs the plain version; on CUDA tensors it launches
    the kernel or raises. ``fused_adamw.launches`` counts kernel launches.
    """
    dev = p.device
    if dev.type == "cpu":
        pn, mn, vn = fused_adamw_ref(p, g, m, v, hyper)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return p, m, v
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw takes CPU or CUDA tensors, got {dev}")
    for name, t in (("g", g), ("m", m), ("v", v), ("hyper", hyper)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not kernel.supported(p.dtype, g.dtype):
        raise TypeError(f"fused_adamw takes p/g of f32/f32, bf16/bf16 or bf16/f32, "
                        f"got {p.dtype}/{g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or hyper.dtype != torch.float32:
        raise TypeError(f"m, v and hyper must be float32, got {m.dtype}, {v.dtype}, {hyper.dtype}")
    if not (g.shape == m.shape == v.shape == p.shape) or hyper.shape != (7,):
        raise ValueError(f"shapes: p {tuple(p.shape)}, g {tuple(g.shape)}, m {tuple(m.shape)}, "
                         f"v {tuple(v.shape)}, hyper {tuple(hyper.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v, hyper)):
        raise ValueError("p, g, m, v and hyper must be contiguous")
    ptrs = {t.data_ptr() for t in (p, g, m, v)}
    if p.numel() and len(ptrs) != 4:
        raise ValueError("p, g, m and v must be distinct buffers")
    if p.numel():
        kernel.launch(hyper, p, g, m, v, stream_ptr(dev))
        count_launch(fused_adamw)
    return p, m, v


fused_adamw.launches = 0
