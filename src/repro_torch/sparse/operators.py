"""Linear operators — what the solvers require of ``A``.

The CG family never inspects matrix entries; it only applies ``A`` to a
vector. That contract is the :class:`LinearOperator` protocol (``shape``
/ ``dtype`` / ``device`` / ``matvec``), and every solver method accepts
anything satisfying it:

* the materialized formats — ``DIAMatrix`` / ``BellMatrix`` /
  ``CSRMatrix`` (and a dense tensor) — through the ``sparse.spmv``
  engine registry;
* :class:`FunctionOperator` — a matrix-free operator wrapping a callable
  (a stencil applied on the fly, a Jacobian-vector product). Pass
  ``diag`` when the Jacobi preconditioner should be available.

``as_operator`` adapts plain callables to the protocol.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, Tuple, runtime_checkable

import torch

from ..kernels.common import resolve_device

__all__ = ["LinearOperator", "FunctionOperator", "as_operator"]


@runtime_checkable
class LinearOperator(Protocol):
    """Structural contract every solver method accepts for ``A``."""

    @property
    def shape(self) -> Tuple[int, int]: ...

    @property
    def dtype(self) -> Any: ...

    def matvec(self, x: torch.Tensor) -> torch.Tensor: ...


@dataclass(frozen=True)
class FunctionOperator:
    """Matrix-free SPD operator: ``y = fn(x)`` with no materialized matrix.

    ``fn`` must be an ``(n,) -> (n,)`` map that is linear and symmetric
    positive definite (the solvers assume, not check, this). ``diag`` is
    the operator diagonal, required only when a Jacobi preconditioner is
    requested. ``device`` is where ``fn`` runs: ``diag``'s device when
    given, else CUDA unless the caller names the CPU.
    """

    fn: Callable[[torch.Tensor], torch.Tensor]
    n: int
    out_dtype: torch.dtype = torch.float32
    diag: Optional[torch.Tensor] = None
    device: Any = None

    def __post_init__(self):
        dev = self.device if self.device is not None else (
            self.diag.device if self.diag is not None else None)
        object.__setattr__(self, "device", resolve_device(dev))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.out_dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def diagonal(self) -> torch.Tensor:
        if self.diag is None:
            raise ValueError(
                "matrix-free FunctionOperator has no diagonal; pass diag= at "
                "construction, or solve with M='identity' / an explicit "
                "preconditioner object"
            )
        return self.diag


def as_operator(A, n: int | None = None, dtype=None, diag=None, *, device=None):
    """Adapt ``A`` to the :class:`LinearOperator` protocol.

    Matrix containers and dense tensors pass through unchanged (the spmv
    registry already dispatches on them); a bare callable is wrapped
    into a :class:`FunctionOperator` (``n`` is then required).
    """
    if hasattr(A, "matvec") and hasattr(A, "shape"):
        return A
    if isinstance(A, torch.Tensor):
        return A
    if callable(A):
        if n is None:
            raise ValueError("as_operator(callable) needs n= (operator size)")
        return FunctionOperator(fn=A, n=n, out_dtype=dtype or torch.float32, diag=diag,
                                device=device)
    raise TypeError(f"cannot adapt {type(A).__name__} to a LinearOperator")
