"""Preconditioners.

The paper (§V-A) uses the Jacobi (diagonal) preconditioner: cheap
setup, and an elementwise apply that fuses into the vector-update
kernels. Block-Jacobi is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["JacobiPC", "IdentityPC", "jacobi", "identity", "apply_pc"]


@dataclass(frozen=True)
class JacobiPC:
    inv_diag: torch.Tensor  # (n,)


@dataclass(frozen=True)
class IdentityPC:
    pass


def jacobi(A) -> JacobiPC:
    d = A.diagonal()
    return JacobiPC(inv_diag=torch.where(d != 0, 1.0 / d, 1.0).to(d.dtype))


def identity(A=None) -> IdentityPC:
    return IdentityPC()


def apply_pc(M, r: torch.Tensor) -> torch.Tensor:
    if isinstance(M, JacobiPC):
        return M.inv_diag * r
    if isinstance(M, IdentityPC):
        return r
    raise TypeError(f"unsupported preconditioner {type(M).__name__}")
