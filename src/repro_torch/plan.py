"""Plan/execute solver API: ``repro_torch.plan(A, ...) -> SolverPlan``.

PIPECG is pay-setup-once, iterate-many: the preconditioner and the
operator-pinned fused core are built once per plan and reused by every
right-hand side:

    p = repro_torch.plan(A, method="pipecg", M="jacobi")   # pay once
    res = p.solve(b)
    p.describe()          # method / engine / core / spmv_engine / ...

Engine names (the JAX package's in brackets): "torch" [jnp], "cuda"
[pallas], "fused_iter" [fused_iter], "auto" [auto]. A plan runs on its
operator's device; "auto" takes the kernels on a CUDA operator and the
plain path only for an operator the caller put on the CPU.

Ported so far: single-device ``method="pipecg"`` on a ``DIAMatrix``.
Not yet: ``solve_batched``, ``config``, ``operator_fingerprint``,
``trace_count``, telemetry, pcg/chronopoulos and the distributed methods.
"""
from __future__ import annotations

import sys as _sys
from collections import OrderedDict
from typing import Tuple

import torch

from .core.pipecg import _resolve_config, pin_pipecg_core, pipecg
from .core.preconditioners import IdentityPC, JacobiPC, identity, jacobi
from .core.types import SolveResult

__all__ = [
    "plan",
    "SolverPlan",
    "solver_names",
    "get_plan",
    "plan_cache_stats",
    "clear_plan_cache",
]

_METHODS = ("pipecg",)
_PIPECG_KWARGS = ("replace_every", "spmv_engine")


def solver_names() -> Tuple[str, ...]:
    return _METHODS


def _resolve_pc(M, A):
    if M is None or M == "identity" or M == "none":
        return identity()
    if M == "jacobi":
        return jacobi(A)
    if isinstance(M, (JacobiPC, IdentityPC)):
        return M
    raise ValueError(f"unsupported preconditioner {M!r} (use 'jacobi'/'identity')")


class SolverPlan:
    """A pinned, reusable solver: setup done, only iteration remains."""

    def __init__(self, A, *, method="pipecg", engine="auto", M="jacobi",
                 atol=1e-5, rtol=0.0, maxiter=10000, **kwargs):
        if method not in _METHODS:
            raise ValueError(f"method {method!r} is not ported yet; have {solver_names()}")
        unknown = set(kwargs) - set(_PIPECG_KWARGS)
        if unknown:
            raise TypeError(
                f"method {method!r} does not accept {sorted(unknown)}; "
                f"it takes {sorted(_PIPECG_KWARGS)}"
            )
        self.A = A
        self.method = method
        self.engine = engine
        self.atol = float(atol)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        self.n = int(A.shape[0])
        self.distributed = False
        self.kwargs = dict(kwargs)
        self.M = _resolve_pc(M, A)
        # resolve once: raises here for a bad engine or operator, not per solve
        self._core_name, self._spmv_engine, self._replace_every = _resolve_config(
            A, engine, kwargs.get("spmv_engine"), kwargs.get("replace_every"), None
        )
        # plan-time pinning: the operator-bound fused_iter core (padded
        # diagonals and all) is built once here and reused by every solve
        self._core = pin_pipecg_core(A, engine, kwargs.get("spmv_engine"),
                                     kwargs.get("replace_every"))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None,
              atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve ``A x = b`` on the operator's device."""
        return pipecg(
            self.A, b, M=self.M, x0=x0,
            atol=self.atol if atol is None else atol,
            rtol=self.rtol if rtol is None else rtol,
            maxiter=self.maxiter, engine=self.engine,
            spmv_engine=self.kwargs.get("spmv_engine"),
            replace_every=self.kwargs.get("replace_every"),
            core=self._core,
        )

    def describe(self) -> dict:
        """What this plan pinned at setup (the JAX package's keys, plus
        ``device``)."""
        d = {
            "method": self.method,
            "engine": self.engine,
            "n": self.n,
            "dtype": str(self.A.dtype).removeprefix("torch."),
            "operator": type(self.A).__name__,
            "preconditioner": type(self.M).__name__,
            "atol": self.atol,
            "rtol": self.rtol,
            "maxiter": self.maxiter,
            "distributed": self.distributed,
            "device": str(self.A.device),
        }
        d.update({k: v for k, v in self.kwargs.items() if v is not None})
        d.update(core=self._core_name, spmv_engine=self._spmv_engine,
                 replace_every=self._replace_every)
        return d

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.describe().items())
        return f"SolverPlan({cfg})"


def plan(A, method: str = "pipecg", engine: str = "auto", M="jacobi",
         *, atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
         **kwargs) -> SolverPlan:
    """Build a reusable :class:`SolverPlan` for ``A`` (see module docstring).

    ``replace_every``/``spmv_engine`` are pipecg's keyword arguments.
    ``atol``/``rtol`` are the plan's defaults; ``plan.solve(b, atol=...)``
    overrides them per call.
    """
    return SolverPlan(A, method=method, engine=engine, M=M,
                      atol=atol, rtol=rtol, maxiter=maxiter, **kwargs)


# ---------------------------------------------------------------------------
# the keyed plan cache behind one-shot ``repro_torch.solve``
# ---------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, SolverPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 16
_CACHE_STATS = {"hits": 0, "misses": 0, "uncachable": 0}


def _plan_key(A, method, engine, M, maxiter, kwargs):
    Mk = M if (M is None or isinstance(M, str)) else ("id", id(M))
    items = tuple((k, kwargs[k]) for k in sorted(kwargs))
    key = (id(A), method, engine, Mk, int(maxiter), items)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def get_plan(A, *, method="pipecg", engine="auto", M="jacobi",
             maxiter: int = 10000, **kwargs) -> SolverPlan:
    """Fetch-or-build a cached plan keyed on operator identity x config.

    Identity keys are safe because the cached plan holds the operator
    (and preconditioner) it was built for; a hit is verified with ``is``.
    Eviction is LRU at 16 entries.
    """
    key = _plan_key(A, method, engine, M, maxiter, kwargs)
    if key is not None:
        cached = _PLAN_CACHE.get(key)
        if cached is not None and cached.A is A:
            _PLAN_CACHE.move_to_end(key)
            _CACHE_STATS["hits"] += 1
            return cached
        _CACHE_STATS["misses"] += 1
    else:
        _CACHE_STATS["uncachable"] += 1
    p = plan(A, method=method, engine=engine, M=M, maxiter=maxiter, **kwargs)
    if key is not None:
        _PLAN_CACHE[key] = p
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return p


def plan_cache_stats() -> dict:
    """Hit/miss/uncachable counters + current size of the plan cache."""
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0


# ``repro_torch.plan`` names both this module and the entry-point
# function; ``import repro_torch.plan`` sets the package attribute to the
# module. Making the module callable keeps ``repro_torch.plan(A, ...)``
# working under every import order.
class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(plan)


_sys.modules[__name__].__class__ = _CallableModule
