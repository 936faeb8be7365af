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
* :class:`CountingOperator` — wraps any of these and counts its
  applications (serving and benchmark accounting).

``as_operator`` adapts plain callables to the protocol.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, Tuple, runtime_checkable

import torch

from ..kernels.common import resolve_device

__all__ = ["LinearOperator", "FunctionOperator", "CountingOperator", "as_operator"]


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
    positive definite (the solvers assume, not check, this); a batched
    solve calls it once per application with all k lanes, ``(k, n) ->
    (k, n)``. ``diag`` is
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


class CountingOperator:
    """Matvec-counting wrapper: serve/benchmark accounting for operator cost.

    Wraps any :class:`LinearOperator` (or dense tensor / matrix container)
    and counts its applications on the host:

        C = CountingOperator(A)
        res = repro_torch.plan(C, method="pipecg", M="jacobi").solve(b)
        C.calls                    # matvec calls this solve made
        C.applications(res)        # operator applications it needed

    The port runs eagerly, so every application is a call: ``calls``
    counts each one as it runs, three set-up matvecs (pipecg: A x0, A u,
    A m) plus one per step of the loop (``result.steps``, which counts the
    no-op steps up to the host's poll), and a batched solve's application
    of all k lanes is one call. The JAX package's ``trace_calls`` (call
    sites seen under a trace) has no counterpart. ``applications(result)``
    is the JAX package's per-solve count: the set-up matvecs once per
    right-hand side plus one per iteration of each. The fingerprint of a
    wrapper is process-local (``id:``), so it pools but does not
    warm-start across processes.
    """

    def __init__(self, base):
        self.base = base
        self.calls = 0  # matvec invocations

    @property
    def shape(self) -> Tuple[int, int]:
        return self.base.shape

    @property
    def dtype(self):
        return getattr(self.base, "dtype", torch.float32)

    @property
    def device(self) -> torch.device:
        return self.base.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        from .spmv import spmv  # routes formats/dense/protocol alike

        return spmv(self.base, x)

    def diagonal(self) -> torch.Tensor:
        if not hasattr(self.base, "diagonal"):
            raise ValueError(
                f"{type(self.base).__name__} has no diagonal(); use "
                "M='identity' or an explicit preconditioner"
            )
        return self.base.diagonal()

    def reset(self) -> None:
        self.calls = 0

    def applications(self, result, setup: int = 3) -> int:
        """Operator applications one solve needed, as the JAX package counts
        them: ``setup`` (pipecg 3, chronopoulos 2, pcg 1) once per
        right-hand side plus one per iteration of each; a batched result
        multiplies ``setup`` by its k lanes and sums their iterations. The
        no-op steps up to the host's poll are not applications
        (:attr:`calls` counts them)."""
        iters = torch.as_tensor(result.iterations).reshape(-1)
        return int(setup * max(iters.numel(), 1) + int(iters.sum()))


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
