"""Shared solver types."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SolveResult:
    """Result of a CG-family solve.

    ``history`` holds the preconditioned residual norm sqrt((u,u)) per
    iteration (the paper's convergence criterion), float32, padded with
    NaN past convergence. Shape (maxiter+1,). ``steps`` is the number
    of host loop steps taken: the iterations plus the no-op steps that
    ran on the device between convergence and the next convergence poll.
    """

    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual_norm: torch.Tensor  # float scalar
    converged: torch.Tensor  # bool scalar
    history: torch.Tensor  # (maxiter+1,) float32
    steps: int
