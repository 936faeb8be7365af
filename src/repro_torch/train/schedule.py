"""LR schedules: functions of a 0-d device step tensor that return a 0-d
f32 tensor on its device, so reading the lr never waits for the device
(the JAX package's ``train/schedule.py``)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos).to(torch.float32)

    return f
