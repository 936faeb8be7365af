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

``plan.solve_batched(B)`` solves k right-hand sides, ``B`` of shape
(k, n), as one lane-batched loop (the JAX package's ``jax.vmap`` of the
solve): on the card it launches the kernels' batched entries, which read
the operator once for up to 8 lanes. It never falls back to per-lane
single solves or to the CPU. A plan builds one *runner* per entry point,
the single-rhs solve and the batched solve of each batch size k;
``trace_count`` counts them (the JAX package counts traced programs), so
steady-state serving sits at 1 for ``solve`` plus 1 per bucket size.
``operator_fingerprint`` and ``config()`` are the serving tier's keys.

Not ported yet: the obs-enabled solve reports and the distributed
methods.
"""
from __future__ import annotations

import hashlib
import inspect
import sys as _sys
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from .core import chronopoulos_cg, identity, jacobi, pcg, pipecg
from .core.pipecg import _resolve_config, pin_pipecg_core
from .core.preconditioners import IdentityPC, JacobiPC
from .core.types import SolveResult
from .obs import metrics as _metrics
from .obs.trace import span as _span
from .sparse.formats import BellMatrix, CSRMatrix, DIAMatrix
from .sparse.spmv import resolve_engine

__all__ = [
    "plan",
    "SolverPlan",
    "register_solver",
    "solver_names",
    "get_plan",
    "operator_fingerprint",
    "plan_cache_stats",
    "clear_plan_cache",
]

_HASH_CHUNK = 1 << 26  # elements copied to the host per hash update
_JAX_DENSE_TYPE = "ArrayImpl"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")  # "float32", as numpy and JAX name it


def _hash_tensor(h, t: torch.Tensor) -> None:
    """Feed ``t``'s little-endian bytes in C order to ``h``, a chunk at a
    time through the host (the device data is copied once, not kept)."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.element_size() == 2:  # numpy has no bf16: hash the raw 16-bit words
        flat = flat.view(torch.int16)
    for part in flat.split(_HASH_CHUNK):
        h.update(part.cpu().numpy().data)


def operator_fingerprint(A) -> str:
    """Stable content hash of an operator, for cross-process plan keying.

    Digests the operator's type, static metadata and data bytes, so two
    processes (or the JAX package) that build the same matrix derive the
    same fingerprint: for a ``DIAMatrix`` and a dense tensor it is the JAX
    package's string for the same contents (``repr((n, offsets,
    "float32"))`` and the f32 bytes). Bell and CSR operators hash the
    port's own fields. The data is hashed once on the host, a chunk at a
    time; the serving tier memoises the result per live object. Operators
    whose identity lives in Python objects (a matrix-free
    ``FunctionOperator``'s ``fn``, a ``CountingOperator``) get an
    ``id:``-prefixed process-local fingerprint: poolable, not
    manifest-portable.
    """
    h = hashlib.sha256()
    # a dense tensor hashes the type name the JAX package hashes for a dense
    # operator (jax.Array's concrete type), so the two fingerprints agree
    h.update((_JAX_DENSE_TYPE if isinstance(A, torch.Tensor) else type(A).__name__).encode())
    if isinstance(A, DIAMatrix):
        h.update(repr((int(A.n), tuple(int(o) for o in A.offsets),
                       _dtype_name(A.dtype))).encode())
        _hash_tensor(h, A.data)
    elif isinstance(A, torch.Tensor):
        h.update(repr((tuple(int(d) for d in A.shape), _dtype_name(A.dtype))).encode())
        _hash_tensor(h, A)
    elif isinstance(A, BellMatrix):
        h.update(repr((int(A.n), int(A.slots_per_row), _dtype_name(A.dtype))).encode())
        _hash_tensor(h, A.cols)
        _hash_tensor(h, A.vals)
    elif isinstance(A, CSRMatrix):
        h.update(repr((int(A.n), A.nnz(), _dtype_name(A.dtype))).encode())
        for t in (A.rows, A.cols, A.vals):
            _hash_tensor(h, t)
    else:
        return f"id:{id(A):x}"
    return h.hexdigest()[:16]


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
                  replace_every=None, spmv_engine=None, tile=None, core=None):
    # ``tile`` is the JAX package's row tile of its TPU kernels; the CUDA
    # kernels have none, so it is recorded (describe(), config(), the plan
    # cache key) and changes no computation
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


class _Runner:
    """One entry point's solve: the single-rhs solve (``k=None``) or the
    lane-batched solve of k right-hand sides. It owns that entry point's
    pinned workspace, the zero warm start of its shape, reused by every
    call (no solver writes x0)."""

    def __init__(self, plan: "SolverPlan", k: Optional[int]):
        self.plan = plan
        self.k = k
        shape = (plan.n,) if k is None else (k, plan.n)
        self.zeros = torch.zeros(shape, dtype=plan.A.dtype, device=plan.A.device)

    def __call__(self, b, x0, atol: float, rtol: float) -> SolveResult:
        p = self.plan
        if tuple(b.shape) != tuple(self.zeros.shape):
            raise ValueError(f"rhs of shape {tuple(b.shape)}, expected {tuple(self.zeros.shape)}")
        if x0 is not None and tuple(x0.shape) != tuple(b.shape):
            raise ValueError(f"x0 of shape {tuple(x0.shape)}, expected {tuple(b.shape)}")
        return p._fn(p.A, b, M=p.M, x0=self.zeros if x0 is None else x0, atol=atol, rtol=rtol,
                     maxiter=p.maxiter, engine=p.engine, **p._call_kwargs)


class SolverPlan:
    """A pinned, reusable solver: setup done, only iteration remains.

    Build via :func:`repro_torch.plan`. ``solve(b)`` takes one rhs,
    ``solve_batched(B)`` k of them; ``trace_count`` is the number of
    runners built (one per entry point and batch size).
    """

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
        self._fn = fn
        self._call_kwargs = dict(kwargs)
        self._pipecg = None
        self._runners: Dict[Optional[int], _Runner] = {}
        self._runners_lock = threading.Lock()
        with _span("plan.build", method=method, engine=engine, n=self.n):
            self.M = _resolve_pc(M, A)
            spmv_engine = "auto"
            if method == "pipecg" and kwargs.get("core") is None:
                # resolve once: raises here for a bad engine or operator, not
                # per solve; then pin the operator-bound fused_iter core
                # (padded diagonals and all), built once and reused by every
                # solve, single and batched
                self._pipecg = _resolve_config(A, self.M, engine, kwargs.get("spmv_engine"),
                                               kwargs.get("replace_every"), None)
                spmv_engine = self._pipecg[1]
                self._call_kwargs["core"] = pin_pipecg_core(
                    A, self.M, engine, kwargs.get("spmv_engine"), kwargs.get("replace_every"))
            self._spmv = resolve_engine(A, spmv_engine)
        _metrics.counter("plan.builds").inc()

    # -- execution --------------------------------------------------------

    @property
    def trace_count(self) -> int:
        """Runners built: 1 for ``solve`` plus 1 per ``solve_batched`` batch size."""
        return len(self._runners)

    def _runner(self, k: Optional[int]) -> _Runner:
        runner = self._runners.get(k)
        if runner is None:
            with self._runners_lock:  # server workers may ask concurrently
                runner = self._runners.get(k)
                if runner is None:
                    runner = self._runners[k] = _Runner(self, k)
                    _metrics.counter("plan.traces").inc()
        return runner

    def _tols(self, atol, rtol) -> Tuple[float, float]:
        return (self.atol if atol is None else float(atol),
                self.rtol if rtol is None else float(rtol))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None,
              atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve ``A x = b`` (b of shape (n,)) on the operator's device."""
        if b.dim() != 1:
            raise ValueError(f"solve takes one rhs of shape ({self.n},), got "
                             f"{tuple(b.shape)}; use solve_batched for (k, n)")
        return self._runner(None)(b, x0, *self._tols(atol, rtol))

    def solve_batched(self, B: torch.Tensor, x0: torch.Tensor | None = None,
                      atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve k right-hand sides, ``B`` of shape (k, n), in one lane-batched
        loop -> SolveResult with a leading lane axis (history (k, maxiter+1)).

        Each lane freezes when it converges, so per-lane iteration counts, x
        and histories are those of k single solves (wall-clock is set by
        the slowest lane). On the card every kernel of the path runs its
        batched entry; nothing loops over lanes. A zero rhs converges at
        once (0 iterations, x = x0).
        """
        if B.dim() != 2:
            raise ValueError(f"solve_batched takes (k, {self.n}) right-hand sides, got "
                             f"{tuple(B.shape)}")
        return self._runner(int(B.shape[0]))(B, x0, *self._tols(atol, rtol))

    def describe(self) -> dict:
        """What this plan pinned at setup: the JAX package's keys, plus
        ``device`` and ``spmv``, the SPMV engine its solves run (for the
        fused_iter core, the one of init and residual replacement)."""
        d = {
            "method": self.method,
            "engine": self.engine,
            "n": self.n,
            "dtype": _dtype_name(self.A.dtype),
            "operator": type(self.A).__name__,
            "preconditioner": type(self.M).__name__,
            "atol": self.atol,
            "rtol": self.rtol,
            "maxiter": self.maxiter,
            "distributed": self.distributed,
            "trace_count": self.trace_count,
            "device": str(self.A.device),
        }
        d.update({k: v for k, v in self.kwargs.items() if v is not None})
        if self._pipecg is not None:
            d.update(zip(("core", "spmv_engine", "replace_every"), self._pipecg))
        d["spmv"] = self._spmv
        return d

    def config(self) -> dict:
        """JSON-able rebuild recipe: ``plan(A, **cfg)`` on an operator with
        the same contents reproduces this plan (same ``describe()``, same
        pool key); the serving tier's warm-start manifests store it.
        Raises for a plan whose configuration holds live Python objects (a
        custom preconditioner, a pinned core)."""
        if isinstance(self.M, JacobiPC):
            M = "jacobi"
        elif isinstance(self.M, IdentityPC):
            M = "identity"
        else:
            raise ValueError(
                f"plan with a custom preconditioner object ({type(self.M).__name__}) is not "
                "manifest-serializable; use M='jacobi'/'identity'"
            )
        cfg = {"method": self.method, "engine": self.engine, "M": M, "atol": self.atol,
               "rtol": self.rtol, "maxiter": self.maxiter}
        for k, v in self.kwargs.items():
            if v is None:
                continue
            if not isinstance(v, (bool, int, float, str)):
                raise ValueError(
                    f"plan kwarg {k}={type(v).__name__} is not manifest-serializable "
                    "(pass plain scalars/strings)"
                )
            cfg[k] = v
        return cfg

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.describe().items())
        return f"SolverPlan({cfg})"


def plan(A, method: str = "pipecg", engine: str = "auto", M="jacobi",
         *, atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
         **kwargs) -> SolverPlan:
    """Build a reusable :class:`SolverPlan` for ``A`` (see module docstring).

    ``replace_every``/``spmv_engine``/``tile`` are pipecg's keyword
    arguments; a method given an argument it does not take raises
    TypeError. ``tile`` is the JAX package's row tile of its TPU kernels:
    the CUDA kernels have no tile, so the value changes no computation; a
    plan records it in ``describe()``, ``config()`` and its cache key.
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
            _metrics.counter("plan_cache.hits").inc()
            return cached
        _CACHE_STATS["misses"] += 1
        _metrics.counter("plan_cache.misses").inc()
    else:
        _CACHE_STATS["uncachable"] += 1
        _metrics.counter("plan_cache.uncachable").inc()
    p = plan(A, method=method, engine=engine, M=M, maxiter=maxiter, **kwargs)
    if key is not None:
        _PLAN_CACHE[key] = p
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
        _metrics.gauge("plan_cache.size").set(len(_PLAN_CACHE))
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
