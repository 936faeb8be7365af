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

Distributed methods (``core.distributed``: "h1"–"h4", "pl2", "pl3", or
"pipecg_distributed" with ``dist_method=``) split a DIA operator's rows
over a mesh of devices, one host thread per shard:

    p = repro_torch.plan(A, method="h3", shards=2, partition="nnz",
                         weights=[0.98, 0.02])     # the card + the host
    p.describe()          # shards, bounds, reducer, SPMV strategy, depth

A plan pins the row decomposition (``decompose`` with the performance
model's ``weights``, or equal rows), the mesh (by default shard 0 on the
card and the rest on the host; ``devices=``/``mesh=`` choose others),
the ``ShardedDIA`` blocks and the sharded Jacobi diagonal, and one runner
per entry point; ``solve_batched`` carries the k lanes inside every
shard's loop, so each reduction carries all k partials.

With observability on (``repro_torch.obs.enable()``) a solve is
synchronised and timed, the plan's metrics are recorded and a
:class:`~repro_torch.obs.SolveReport` lands on ``plan.last_report``; with
``obs.enable(reports=False)`` a solve only records its spans
(``plan.solve`` or ``plan.solve_batched``, and the loop's) and counters,
and waits for nothing; off, the solve runs as it would without the
bookkeeping.
"""
from __future__ import annotations

import hashlib
import inspect
import sys as _sys
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .core import chronopoulos_cg, identity, jacobi, pcg, pipecg
from .core.distributed import build_distributed_solver, make_solver_mesh, method_names
from .core.perfmodel import decompose
from .core.pipecg import _resolve_config, pin_pipecg_core
from .core.preconditioners import IdentityPC, JacobiPC
from .core.types import SolveResult
from .obs import metrics as _metrics
from .obs.trace import reports as _obs_reports, span as _span
from .sparse.formats import BellMatrix, CSRMatrix, DIAMatrix
from .sparse.partition import balanced_rows, shard_dia, shard_vector, unshard_vector
from .sparse.spmv import resolve_engine, spmv

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
    """All method names, each exactly once, sorted: the single-device
    registry and the distributed methods."""
    return tuple(sorted(set(_SOLVERS) | set(method_names()) | {"pipecg_distributed"}))


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

    def _check(self, b, x0) -> None:
        if tuple(b.shape) != tuple(self.zeros.shape):
            raise ValueError(f"rhs of shape {tuple(b.shape)}, expected {tuple(self.zeros.shape)}")
        if x0 is not None and tuple(x0.shape) != tuple(b.shape):
            raise ValueError(f"x0 of shape {tuple(x0.shape)}, expected {tuple(b.shape)}")

    def __call__(self, b, x0, atol: float, rtol: float,
                 maxiter: Optional[int] = None) -> SolveResult:
        p = self.plan
        self._check(b, x0)
        return p._fn(p.A, b, M=p.M, x0=self.zeros if x0 is None else x0, atol=atol, rtol=rtol,
                     maxiter=p.maxiter if maxiter is None else maxiter, engine=p.engine,
                     **p._call_kwargs)


class _DistRunner(_Runner):
    """A distributed plan's entry point: the mesh solver built for this
    batch size (``core.distributed.build_distributed_solver``). A nonzero
    warm start solves the shifted system A d = b - A x0 and returns x0 + d,
    as the JAX package does."""

    def __init__(self, plan: "SolverPlan", k: Optional[int]):
        super().__init__(plan, k)
        self.solver = plan._build_solver(k)

    def __call__(self, b, x0, atol: float, rtol: float,
                 maxiter: Optional[int] = None) -> SolveResult:
        p = self.plan
        self._check(b, x0)
        rhs = b if x0 is None else b - spmv(p.A, x0)
        res = self.solver(shard_vector(rhs, p.bounds, p.mesh.devices), p._inv_sh, atol, rtol,
                          maxiter)
        p.last_stats = self.solver.last_stats
        x = unshard_vector(res.x, p.bounds, p.A.device)
        return SolveResult(x=x if x0 is None else x0 + x, iterations=res.iterations.to(p.A.device),
                           residual_norm=res.residual_norm.to(p.A.device),
                           converged=res.converged.to(p.A.device),
                           history=res.history.to(p.A.device), steps=res.steps)


class SolverPlan:
    """A pinned, reusable solver: setup done, only iteration remains.

    Build via :func:`repro_torch.plan`. ``solve(b)`` takes one rhs,
    ``solve_batched(B)`` k of them; ``trace_count`` is the number of
    runners built (one per entry point and batch size). With
    observability enabled, ``last_report`` holds the latest solve's
    :class:`~repro_torch.obs.SolveReport`.
    """

    def __init__(self, A, *, method="pipecg", engine="auto", M="jacobi",
                 atol=1e-5, rtol=0.0, maxiter=10000, **kwargs):
        if method in method_names():  # "h1"-"h4", "pl2", "pl3"
            kwargs.setdefault("dist_method", method)
            method = "pipecg_distributed"
        distributed = method == "pipecg_distributed"
        if not distributed and method not in _SOLVERS:
            raise ValueError(f"unknown method {method!r}; have {solver_names()}")
        self.A = A
        self.method = method
        self.engine = engine
        self.atol = float(atol)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        self.n = int(A.shape[0])
        self.distributed = distributed
        self._pipecg = None
        self._runners: Dict[Optional[int], _Runner] = {}
        self._runners_lock = threading.Lock()
        self.last_report = None       # SolveReport of the latest solve (obs on)
        # a distributed plan's latest solve: wall seconds, per-shard loop
        # seconds and wait seconds by collective kind, the communicator's
        # counts, the steps taken (core.distributed.build_distributed_solver)
        self.last_stats = None
        self._census_launches = None  # launches per step, counted once (obs on)
        with _span("plan.build", method=method, engine=engine, n=self.n,
                   distributed=distributed):
            self.M = _resolve_pc(M, A)
            if distributed:
                self._setup_distributed(kwargs)
            else:
                self._setup_single(kwargs)
        _metrics.counter("plan.builds").inc()

    # -- setup ------------------------------------------------------------

    def _setup_single(self, kwargs) -> None:
        method, A, engine = self.method, self.A, self.engine
        fn = _SOLVERS[method]
        params = inspect.signature(fn).parameters
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
            unknown = set(kwargs) - set(params)
            if unknown:
                raise TypeError(
                    f"method {method!r} does not accept {sorted(unknown)}; "
                    f"it takes {sorted(k for k in params if k not in ('A', 'b'))}"
                )
        self.kwargs = dict(kwargs)
        self._fn = fn
        self._call_kwargs = dict(kwargs)
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

    def _setup_distributed(self, kwargs) -> None:
        dist_method = kwargs.pop("dist_method", "h3")
        shards = int(kwargs.pop("shards", 1))
        weights = kwargs.pop("weights", None)
        partition = kwargs.pop("partition", "rows")
        mesh = kwargs.pop("mesh", None)
        devices = kwargs.pop("devices", None)
        reducer = kwargs.pop("reducer", None)
        spmv_strategy = kwargs.pop("spmv", None)
        sub = kwargs.pop("sub", None)
        replace_every = int(kwargs.pop("replace_every", 0) or 0)
        if kwargs:
            raise TypeError(
                f"distributed plan does not accept {sorted(kwargs)}; it takes "
                "['devices', 'dist_method', 'mesh', 'partition', 'reducer', "
                "'replace_every', 'shards', 'spmv', 'sub', 'weights']"
            )
        A = self.A
        if not isinstance(A, DIAMatrix):
            raise TypeError(f"distributed solve needs a DIAMatrix, got {type(A).__name__}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if partition not in ("rows", "nnz"):
            raise ValueError(f"unknown partition {partition!r} (use 'rows' or 'nnz')")
        if isinstance(self.M, JacobiPC):
            inv_diag = self.M.inv_diag
        elif isinstance(self.M, IdentityPC):
            inv_diag = torch.ones(A.n, dtype=A.dtype, device=A.device)
        else:
            raise TypeError(
                f"distributed solve supports Jacobi/identity PCs, got {type(self.M).__name__}"
            )
        # the paid-once set-up: decomposition, mesh, operator blocks
        with _span("plan.decompose", shards=shards, partition=partition):
            if weights is not None or partition == "nnz":
                bounds = decompose(A, shards,
                                   weights=None if weights is None else np.asarray(weights))
            else:
                bounds = balanced_rows(A.n, shards)
        self.dist_method = dist_method
        self.shards = shards
        self.bounds = tuple(int(x) for x in np.asarray(bounds))
        with _span("plan.shard"):
            self.mesh = mesh if mesh is not None else make_solver_mesh(shards, sub=sub,
                                                                       devices=devices)
            if self.mesh.n_shards != shards:
                raise ValueError(f"mesh has {self.mesh.n_shards} devices, shards={shards}")
            self.sharded = shard_dia(A, self.bounds, self.mesh.devices)
            self._inv_sh = shard_vector(inv_diag, self.bounds, self.mesh.devices)
        # every knob that changes the solver goes in here: describe()
        # reports it and the plan cache key freezes the same user kwargs
        self.kwargs = {"dist_method": dist_method, "shards": shards, "partition": partition,
                       "reducer": reducer, "spmv": spmv_strategy, "sub": sub,
                       "replace_every": replace_every}
        self._dist_options = dict(method=dist_method, engine=self.engine, maxiter=self.maxiter,
                                  reducer=reducer, spmv=spmv_strategy,
                                  replace_every=replace_every)
        solver = self._runner(None).solver  # validates the configuration now
        self.pipeline_depth = solver.pipeline_depth
        self.reducer = solver.reduce_name
        self.spmv_strategy = solver.spmv_name
        self.shard_cores = solver.cores

    def _build_solver(self, k: Optional[int]):
        with _span("plan.build_solver", dist_method=self.dist_method, nrhs=k or 0):
            return build_distributed_solver(self.sharded, mesh=self.mesh, nrhs=k,
                                            **self._dist_options)

    # -- execution --------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.A.device

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
                    cls = _DistRunner if self.distributed else _Runner
                    runner = self._runners[k] = cls(self, k)
                    _metrics.counter("plan.traces").inc()
        return runner

    def _run_fixed(self, b: torch.Tensor, maxiter: int) -> SolveResult:
        """One solve of ``b`` at atol = rtol = 0 for ``maxiter`` steps (the
        launch census of ``obs.report``)."""
        k = None if b.dim() == 1 else int(b.shape[0])
        return self._runner(k)(b, None, 0.0, 0.0, maxiter=maxiter)

    def _tols(self, atol, rtol) -> Tuple[float, float]:
        return (self.atol if atol is None else float(atol),
                self.rtol if rtol is None else float(rtol))

    def _timed(self, k: Optional[int], b, x0, atol, rtol, name: str):
        """Run one entry point under a span; with reports on
        (``obs.enable()``), synchronised and timed. Returns (result,
        seconds or None, cold)."""
        with _span(name, k=k or 1):
            if not _obs_reports():
                return self._runner(k)(b, x0, *self._tols(atol, rtol)), None, False
            traces_before = self.trace_count
            t0 = time.perf_counter()
            res = self._runner(k)(b, x0, *self._tols(atol, rtol))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
        return res, elapsed, self.trace_count > traces_before

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None,
              atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve ``A x = b`` (b of shape (n,)) on the operator's device.

        With observability enabled (``repro_torch.obs.enable()``) the solve
        is synchronised and timed, the plan's metrics are recorded and a
        :class:`~repro_torch.obs.SolveReport` lands on ``last_report``.
        """
        if b.dim() != 1:
            raise ValueError(f"solve takes one rhs of shape ({self.n},), got "
                             f"{tuple(b.shape)}; use solve_batched for (k, n)")
        res, elapsed, cold = self._timed(None, b, x0, atol, rtol, "plan.solve")
        _metrics.counter("plan.solves").inc()
        if elapsed is not None:
            self._record_solve(res, elapsed, b, cold=cold)
        return res

    def solve_batched(self, B: torch.Tensor, x0: torch.Tensor | None = None,
                      atol: float | None = None, rtol: float | None = None) -> SolveResult:
        """Solve k right-hand sides, ``B`` of shape (k, n), in one lane-batched
        loop -> SolveResult with a leading lane axis (history (k, maxiter+1)).

        Each lane freezes when it converges, so per-lane iteration counts, x
        and histories are those of k single solves (wall-clock is set by
        the slowest lane). On the card every kernel of the path runs its
        batched entry; nothing loops over lanes. A zero rhs converges at
        once (0 iterations, x = x0). A distributed plan carries the lanes
        inside every shard's loop: one reduction carries all k partials.
        With observability on, batch metrics and ``last_report`` (its worst
        lane) are recorded.
        """
        if B.dim() != 2:
            raise ValueError(f"solve_batched takes (k, {self.n}) right-hand sides, got "
                             f"{tuple(B.shape)}")
        k = int(B.shape[0])
        res, elapsed, cold = self._timed(k, B, x0, atol, rtol, "plan.solve_batched")
        _metrics.counter("plan.batched_solves").inc()
        _metrics.counter("plan.batched_rhs").inc(k)
        if elapsed is not None:
            from .obs.report import iterations_from_history

            self._record_solve(res, elapsed, B[0] if k else None, cold=cold, batched=True)
            for it in np.asarray(iterations_from_history(res.history)).ravel():
                _metrics.histogram("plan.solve_iterations").record(int(it))
        return res

    def _record_solve(self, res: SolveResult, elapsed: float, b, *, cold: bool,
                      batched: bool = False) -> None:
        """Obs-enabled bookkeeping: the solve's metrics and its SolveReport."""
        from .obs.report import plan_launches_per_iteration, solve_report

        if self._census_launches is None and b is not None:
            # counted once per plan: hand-written kernel launches per step
            self._census_launches = plan_launches_per_iteration(self, b)
        report = solve_report(self, res, elapsed_s=elapsed, launches=self._census_launches,
                              cold_start=cold)
        self.last_report = report
        if cold:
            # this solve built a runner: keep its time out of the
            # steady-state histogram
            _metrics.counter("plan.cold_solves").inc()
            _metrics.histogram("plan.cold_solve_time_s").record(elapsed)
        else:
            _metrics.histogram("plan.solve_time_s").record(elapsed)
        if batched:
            return
        _metrics.histogram("plan.solve_iterations").record(report.iterations)
        if not report.converged:
            _metrics.counter("plan.solves_unconverged").inc()
        if report.rr_events:
            _metrics.counter("plan.rr_events").inc(report.rr_events)

    def describe(self) -> dict:
        """What this plan pinned at setup: the JAX package's keys, plus
        ``device`` and, for a single-device plan, ``spmv``, the SPMV engine
        its solves run (for the fused_iter core, the one of init and
        residual replacement); a distributed plan adds its shards, bounds,
        reducer, SPMV strategy, mesh and each shard's core."""
        d = {
            "method": self.dist_method if self.distributed else self.method,
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
        if self.distributed:
            d.update(
                shards=self.shards,
                shard_bounds=self.bounds,
                rows_per_shard=tuple(int(x) for x in np.diff(self.bounds)),
                partition=self.kwargs["partition"],
                reducer=self.reducer,              # override-resolved, not the
                spmv_strategy=self.spmv_strategy,  # method's registered default
                mesh_axes=self.mesh.axis_names,
                mesh_devices=tuple(str(dv) for dv in self.mesh.devices),
                shard_cores=self.shard_cores,
                pipeline_depth=self.pipeline_depth,
                sub=self.kwargs.get("sub"),
                replace_every=self.kwargs.get("replace_every", 0),
            )
            return d
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
    arguments; ``shards``/``weights``/``partition``/``mesh``/``devices``/
    ``reducer``/``spmv``/``sub``/``replace_every`` the distributed
    methods' (``sub`` builds the 2-D mesh the "h4" reducer needs;
    ``devices`` defaults to the card for shard 0 and the host for the
    rest). A method given an argument it does not take raises
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


def _freeze(v):
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (np.ndarray, torch.Tensor)):  # e.g. the performance model's weights
        return ("arr",) + tuple(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                                .ravel().tolist())
    return ("id", id(v))  # identity-keyed; the plan keeps the object alive


def _plan_key(A, method, engine, M, maxiter, kwargs):
    Mk = M if (M is None or isinstance(M, str)) else ("id", id(M))
    items = tuple((k, _freeze(kwargs[k])) for k in sorted(kwargs))
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
