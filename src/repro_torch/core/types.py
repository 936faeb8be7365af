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
    A batched solve of k right-hand sides gives every tensor field a
    leading lane axis: x (k, n), iterations/residual_norm/converged (k,),
    history (k, maxiter+1); ``steps`` is shared by the lanes.
    """

    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual_norm: torch.Tensor  # float scalar
    converged: torch.Tensor  # bool scalar
    history: torch.Tensor  # (maxiter+1,) float32
    steps: int
