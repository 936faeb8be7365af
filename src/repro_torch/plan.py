"""Plan/execute solver API: ``repro_torch.plan(A, ...) -> SolverPlan``.

PIPECG is pay-setup-once, iterate-many: the preconditioner and the
operator-pinned fused core are built once per plan and reused by every
right-hand side:

    p = repro_torch.plan(A, method="pipecg", M="jacobi")   # pay once
    res = p.solve(b)
    p.describe()          # method / engine / core / spmv / ...

Methods: "pipecg" (Algorithm 2), and the baselines "pcg" (Algorithm 1)
and "chronopoulos" (Chronopoulos–Gear), through the registry
``register_solver``. ``A`` may be a ``DIAMatrix``, ``BellMatrix`` or
``CSRMatrix``, a dense tensor, or a matrix-free ``FunctionOperator``.

Engine names (the JAX package's in brackets): "torch" [jnp], "cuda"
[pallas], "fused_iter" [fused_iter], "auto" [auto]. A plan runs on its
operator's device; "auto" takes the kernels on a CUDA operator and the
plain path only for an operator the caller put on the CPU. The baselines
take "auto"/"torch" only (their SPMV goes through ``spmv(A, ·)``, so on
the card it is the format's kernel); the CUDA engines apply to pipecg.

Not ported yet: ``solve_batched``, ``config``, ``operator_fingerprint``,
``trace_count``, telemetry and the distributed methods.
"""
from __future__ import annotations

import inspect
import sys as _sys
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from .core import chronopoulos_cg, identity, jacobi, pcg, pipecg
from .core.pipecg import _resolve_config, pin_pipecg_core
from .core.types import SolveResult
from .sparse.spmv import resolve_engine

__all__ = [
    "plan",
    "SolverPlan",
    "register_solver",
    "solver_names",
    "get_plan",
    "plan_cache_stats",
    "clear_plan_cache",
]


def _resolve_pc(M, A):
    if M is None or M == "identity" or M == "none":
        return identity()
    if M == "jacobi":
        return jacobi(A)  # needs A.diagonal(); matrix-free operators must pass diag=
    if isinstance(M, str):
        raise ValueError(f"unknown preconditioner name {M!r} (use 'jacobi'/'identity')")
    return M


def _require_torch_engine(method: str, engine: str) -> None:
    # an honest failure instead of running plain PyTorch under a kernel label
    if engine not in ("auto", "torch"):
        raise ValueError(
            f"method {method!r} has no {engine!r} backend (the CUDA engines apply "
            "to pipecg); use engine='torch'/'auto'"
        )


def _solve_pcg(A, b, *, M, x0, atol, rtol, maxiter, engine):
    _require_torch_engine("pcg", engine)
    return pcg(A, b, M=M, x0=x0, atol=atol, rtol=rtol, maxiter=maxiter)


def _solve_chronopoulos(A, b, *, M, x0, atol, rtol, maxiter, engine):
    _require_torch_engine("chronopoulos", engine)
    return chronopoulos_cg(A, b, M=M, x0=x0, atol=atol, rtol=rtol, maxiter=maxiter)


def _solve_pipecg(A, b, *, M, x0, atol, rtol, maxiter, engine,
                  replace_every=None, spmv_engine=None, core=None):
    return pipecg(A, b, M=M, x0=x0, atol=atol, rtol=rtol, maxiter=maxiter, engine=engine,
                  spmv_engine=spmv_engine, replace_every=replace_every, core=core)


SolverFn = Callable[..., SolveResult]

_SOLVERS: Dict[str, SolverFn] = {
    "pcg": _solve_pcg,
    "chronopoulos": _solve_chronopoulos,
    "pipecg": _solve_pipecg,
}


def register_solver(name: str, fn: SolverFn, *, overwrite: bool = False) -> None:
    """Register a solve method: ``fn(A, b, *, M, x0, atol, rtol, maxiter,
    engine, ...) -> SolveResult``. Raises ValueError if ``name`` is
    already registered, unless ``overwrite=True``."""
    if name in _SOLVERS and not overwrite:
        raise ValueError(
            f"solver {name!r} already registered; pass overwrite=True to replace it"
        )
    _SOLVERS[name] = fn


def solver_names() -> Tuple[str, ...]:
    """All method names, each exactly once, sorted."""
    return tuple(sorted(_SOLVERS))


class SolverPlan:
    """A pinned, reusable solver: setup done, only iteration remains."""

    def __init__(self, A, *, method="pipecg", engine="auto", M="jacobi",
                 atol=1e-5, rtol=0.0, maxiter=10000, **kwargs):
        if method not in _SOLVERS:
            raise ValueError(f"method {method!r} is not ported; have {solver_names()}")
        fn = _SOLVERS[method]
        params = inspect.signature(fn).parameters
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
            unknown = set(kwargs) - set(params)
            if unknown:
                raise TypeError(
                    f"method {method!r} does not accept {sorted(unknown)}; "
                    f"it takes {sorted(k for k in params if k not in ('A', 'b'))}"
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
        self._fn = fn
        self._call_kwargs = dict(kwargs)
        self._pipecg = None
        spmv_engine = "auto"
        if method == "pipecg" and kwargs.get("core") is None:
            # resolve once: raises here for a bad engine or operator, not per
            # solve; then pin the operator-bound fused_iter core (padded
            # diagonals and all), built once and reused by every solve
            self._pipecg = _resolve_config(A, self.M, engine, kwargs.get("spmv_engine"),
                                           kwargs.get("replace_every"), None)
            spmv_engine = self._pipecg[1]
            self._call_kwargs["core"] = pin_pipecg_core(
                A, self.M, engine, kwargs.get("spmv_engine"), kwargs.get("replace_every"))
        self._spmv = resolve_engine(A, spmv_engine)

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None,
              atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve ``A x = b`` on the operator's device."""
        return self._fn(
            self.A, b, M=self.M, x0=x0,
            atol=self.atol if atol is None else atol,
            rtol=self.rtol if rtol is None else rtol,
            maxiter=self.maxiter, engine=self.engine, **self._call_kwargs,
        )

    def describe(self) -> dict:
        """What this plan pinned at setup: the JAX package's keys, plus
        ``device`` and ``spmv``, the SPMV engine its solves run (for the
        fused_iter core, the one of init and residual replacement)."""
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
        if self._pipecg is not None:
            d.update(zip(("core", "spmv_engine", "replace_every"), self._pipecg))
        d["spmv"] = self._spmv
        return d

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.describe().items())
        return f"SolverPlan({cfg})"


def plan(A, method: str = "pipecg", engine: str = "auto", M="jacobi",
         *, atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
         **kwargs) -> SolverPlan:
    """Build a reusable :class:`SolverPlan` for ``A`` (see module docstring).

    ``replace_every``/``spmv_engine`` are pipecg's keyword arguments; a
    method given an argument it does not take raises TypeError.
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
