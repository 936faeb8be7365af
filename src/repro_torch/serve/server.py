"""``SolverServer`` — the async serving tier's front door.

Composes the subsystem: an admission queue + batching policy per plan
(``serve.queue``), a plan-pool router with async builds and LRU eviction
(``serve.router``), and the pinned-plan bucket economics of
``serve.engine``. The paper's thesis applied at the request
level: the solver hot loop stays saturated while admission, batching and
cold plan builds all overlap with in-flight solves.

    srv = SolverServer(max_batch=8, max_wait_ms=2.0)
    fut = srv.submit(A, b, atol=1e-6)        # non-blocking admission
    res = fut.result()                       # ServeResult: x, iterations…
    srv.shutdown(drain=True)                 # zero dropped requests

Steady-state traffic builds exactly TWO runners per plan — the
single-rhs solve (buckets of one) and the ``max_batch`` lane-batched
solve (everything else, zero-padded to size) — no matter the arrival
pattern; ``plan.trace_count`` shows it. Per-request iteration counts are
honest even though a bucket runs to its slowest member: they come from
each history row's NaN tail. On the card each plan's worker runs its
buckets on a CUDA stream of its own and waits for that stream alone, so
a bucket's latency does not include other plans' buckets. Right-hand
sides are read after the work the device's default stream had queued
when the bucket formed (where ``submit``'s callers make them), and a
result's memory is kept from reuse until the default stream's work on it
has run.
``SolverServer.from_manifest`` warm-starts a fresh replica from a saved
manifest so its first request builds no runner.

With ``repro_torch.obs`` on, the tier records a ``serve.admit`` span per
``submit``, a ``serve.queue`` span per request (admission to its
bucket's close), the worker's ``serve.wait`` inside the queue and one
``serve.bucket`` span per bucket (its id, k, size, steps, its slowest
lane's iterations and the request ids) around ``serve.assemble`` (stack and pad), the plan's spans,
``serve.sync``, ``serve.readback`` and ``serve.deliver`` (``set_result``,
which runs the callers' callbacks); none of them waits for the device.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs.report import iterations_from_history
from ..obs.trace import enabled as _obs_enabled, record_span as _record_span, span as _span
from .engine import bucket_waste, record_bucket
from .queue import RequestQueue, ServerClosed, SolveRequest, reject
from .router import PlanEntry, PlanPool

__all__ = ["ServeResult", "SolverServer"]

_BUCKET_IDS = itertools.count()


@dataclass(frozen=True)
class ServeResult:
    """Per-request outcome, sliced out of its bucket's batched solve.

    ``iterations`` is this request's own count (its history row's NaN
    tail); ``steps`` is the bucket's ``SolveResult.steps``, the loop
    steps its lanes shared, no-op steps after the slowest lane's
    convergence included. ``request_id`` is ``SolveRequest.id``.
    """

    x: object
    iterations: int
    converged: bool
    residual_norm: float
    queue_wait_s: float      # admission -> bucket close
    solve_s: float           # bucket wall-clock (shared by its bucket)
    bucket_size: int         # live requests in the bucket (1 = the single runner)
    bucket_occupancy: float  # live / compiled lanes
    request_id: int
    steps: int


def _worker_stream(plan) -> Optional[torch.cuda.Stream]:
    """The CUDA stream a plan's worker runs its buckets on; None on the CPU."""
    dev = getattr(plan.A, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    return torch.cuda.Stream(device=dev)


class _PlanWorker:
    """One plan's serving loop: queue -> buckets -> pinned runners."""

    def __init__(self, server: "SolverServer", entry: PlanEntry):
        self.server = server
        self.entry = entry
        self.queue = RequestQueue(max_depth=server.max_depth)
        self.idle = threading.Event()
        self.idle.set()
        self.thread = threading.Thread(
            target=self._run, name=f"plan-serve-{entry.key[0][:8]}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        self.entry.ready.wait()
        if self.entry.error is not None:
            # the plan never built: fail whatever queued (and keeps queuing
            # until the router's miss path stops routing here)
            while True:
                self.queue.fail_all(self.entry.error)
                if self.queue.closed and len(self.queue) == 0:
                    return
                time.sleep(0.01)
        self.stream = _worker_stream(self.entry.plan)
        while True:
            with _span("serve.wait"):
                batch = self.queue.next_batch(self.server.max_batch,
                                              self.server.max_wait_ms / 1e3)
            if batch is None:
                return  # closed + drained
            if _obs_enabled():
                closed = time.monotonic_ns()  # same clock as enqueued_at, in ns
                for r in batch:
                    _record_span("serve.queue", round(r.enqueued_at * 1e9), closed,
                                 request=r.id)
            if not batch:
                continue  # every popped request had an expired deadline
            self.idle.clear()
            try:
                with self.entry.pinned(), (nullcontext() if self.stream is None
                                           else torch.cuda.stream(self.stream)):
                    self._serve(batch)
            finally:
                self.idle.set()

    def _serve(self, batch: List[SolveRequest]) -> None:
        plan = self.entry.plan
        k = len(batch)
        atol = min(r.atol for r in batch)  # tightest in the tolerance bucket
        rtol = min(r.rtol for r in batch)
        t0 = time.monotonic()  # same clock as SolveRequest.enqueued_at
        stream = self.stream
        with _span("serve.bucket", k=k) as bucket:
            try:
                if stream is not None:  # the rhs were made on the default stream
                    stream.wait_stream(torch.cuda.default_stream(stream.device))
                if k == 1:
                    res = plan.solve(batch[0].b, atol=atol, rtol=rtol)
                    size = 1
                else:
                    with _span("serve.assemble"):
                        B = torch.stack([r.b for r in batch])
                        pad = self.server.max_batch - k
                        if pad > 0:  # pad into the one bucket runner
                            B = torch.cat([B, B.new_zeros(pad, B.shape[1])])
                    size = B.shape[0]
                    record_bucket(k, size)
                    res = plan.solve_batched(B, atol=atol, rtol=rtol)
                if stream is not None:
                    with _span("serve.sync"):
                        stream.synchronize()
                    # callers use x on the default stream: keep its memory
                    # from this stream's reuse until that work has run
                    res.x.record_stream(torch.cuda.default_stream(stream.device))
            except BaseException as e:
                for r in batch:
                    r.future.set_exception(e)
                _metrics.counter("serve.solve_errors").inc(k)
                return
            solve_s = time.monotonic() - t0
            steps = int(res.steps)
            if bucket is not None:
                bucket.attrs.update(bucket=next(_BUCKET_IDS), size=size, steps=steps,
                                    requests=[r.id for r in batch])

            with _span("serve.readback"):
                if k == 1:
                    iters = np.asarray([iterations_from_history(res.history)])
                    xs = [res.x]
                    conv = [bool(res.converged)]
                    rnorm = [float(res.residual_norm)]
                else:
                    iters = iterations_from_history(res.history)[:k]
                    _metrics.counter("serve.wasted_lane_iterations").inc(
                        bucket_waste(iters, size))
                    xs = [res.x[i] for i in range(k)]
                    conv = res.converged[:k].tolist()
                    rnorm = res.residual_norm[:k].tolist()
            if bucket is not None:
                bucket.attrs["iterations"] = int(max(iters))
            with _span("serve.deliver"):
                for i, r in enumerate(batch):
                    it = int(iters[i])
                    _metrics.histogram("serve.rhs_iterations").record(it)
                    r.future.set_result(ServeResult(
                        x=xs[i], iterations=it, converged=bool(conv[i]),
                        residual_norm=float(rnorm[i]),
                        queue_wait_s=max(t0 - r.enqueued_at, 0.0),
                        solve_s=solve_s, bucket_size=k,
                        bucket_occupancy=k / size,
                        request_id=r.id, steps=steps,
                    ))


class SolverServer:
    """Async multi-plan solver serving (module docstring).

    ``max_batch``/``max_wait_ms`` set the bucket-closing policy,
    ``max_depth`` the per-plan admission bound (beyond it ``submit``
    raises ``QueueFull`` — explicit backpressure), ``max_plans`` the
    warm-plan pool size. The remaining kwargs are per-request defaults;
    ``submit(..., method=..., engine=...)`` overrides route to their own
    pooled plan.
    """

    def __init__(self, *, max_batch: int = 8, max_wait_ms: float = 2.0,
                 max_depth: int = 256, max_plans: int = 8,
                 method: str = "pipecg", engine: str = "auto", M="jacobi",
                 atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
                 **plan_kwargs):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_depth = int(max_depth)
        self.defaults = dict(method=method, engine=engine, M=M, atol=atol,
                             rtol=rtol, maxiter=maxiter, **plan_kwargs)
        self.pool = PlanPool(max_plans=max_plans, on_evict=self._on_evict)
        self._workers: Dict[tuple, _PlanWorker] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- admission --------------------------------------------------------

    def submit(self, A, b, *, atol: Optional[float] = None,
               rtol: Optional[float] = None,
               deadline_ms: Optional[float] = None, **overrides) -> Future:
        """Admit one rhs; returns a Future resolving to a ServeResult.

        Non-blocking once the operator's fingerprint is known (the first
        request of an operator hashes it): a warm plan's bucket forms
        around the request; a cold (method/engine/tolerance-bucket) miss
        starts an async build that never stalls traffic on warm plans.
        ``b`` lies on the operator's device. Raises ``QueueFull`` /
        ``ServerClosed`` for explicit backpressure.
        """
        if self._closed:
            reject("shutdown")
            raise ServerClosed("SolverServer is shut down")
        cfg = dict(self.defaults)
        cfg.update(overrides)
        if atol is not None:
            cfg["atol"] = float(atol)
        if rtol is not None:
            cfg["rtol"] = float(rtol)
        with _span("serve.admit") as sp:
            entry, _ = self.pool.get_or_create(A, cfg)
            worker = self._worker_for(entry)
            req = SolveRequest(
                b=b, atol=float(cfg["atol"]), rtol=float(cfg["rtol"]),
                deadline=None if deadline_ms is None
                else time.monotonic() + deadline_ms / 1e3,
            )
            if sp is not None:
                sp.attrs["request"] = req.id
            _metrics.counter("serve.requests").inc()
            worker.queue.put(req)
        return req.future

    def submit_many(self, A, B: Sequence, **kwargs) -> List[Future]:
        """Admit a batch of rhs (one Future each, same routing)."""
        return [self.submit(A, b, **kwargs) for b in B]

    # -- workers / lifecycle ----------------------------------------------

    def _worker_for(self, entry: PlanEntry) -> _PlanWorker:
        with self._lock:
            worker = self._workers.get(entry.key)
            if worker is None or worker.entry is not entry:
                worker = self._workers[entry.key] = _PlanWorker(self, entry)
            return worker

    def _on_evict(self, entry: PlanEntry) -> None:
        # evicted plans drain gracefully: queue stops admitting, the
        # worker serves what is queued (it holds the plan ref), then exits
        with self._lock:
            worker = self._workers.pop(entry.key, None)
        if worker is not None:
            worker.queue.close()

    def plans(self) -> List:
        """The pool's built plans (building/failed entries excluded)."""
        return [e.plan for e in self.pool.entries() if e.plan is not None]

    def entries(self):
        return self.pool.entries()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queue is empty and every worker idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                workers = list(self._workers.values())
            busy = [w for w in workers
                    if len(w.queue) or not w.idle.is_set()
                    or (not w.entry.ready.is_set())]
            if not busy:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop admitting; with ``drain`` serve everything queued first.

        Graceful shutdown drops zero requests: queues close (late
        ``submit`` raises and is counted under ``serve.rejects.shutdown``)
        while workers finish every admitted bucket, then threads join.
        """
        self._closed = True
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if not drain:
                w.queue.fail_all(ServerClosed("server shut down without drain"))
            w.queue.close()
        for w in workers:
            w.thread.join(timeout)

    def __enter__(self) -> "SolverServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- warm start --------------------------------------------------------

    def save_manifest(self, path: str, *, operator_specs=None) -> dict:
        """Snapshot this server's built plans for cross-process warm start."""
        from .warmstart import save_manifest

        return save_manifest(
            path, self.plans(), operator_specs=operator_specs,
            serve={"max_batch": self.max_batch,
                   "max_wait_ms": self.max_wait_ms,
                   "max_depth": self.max_depth},
        )

    @classmethod
    def from_manifest(cls, path: str, *, warm: bool = True, strict: bool = True,
                      device=None, **overrides) -> "SolverServer":
        """Build a server with every manifest plan rebuilt on ``device``
        (None: CUDA) and, with ``warm``, its two runners built.

        After this returns (``warm=True``), the first request against any
        manifest plan builds no runner — the replica is hot before it sees
        traffic.
        """
        from .warmstart import load_manifest

        loaded, serve_cfg = load_manifest(path, warm=False, strict=strict, device=device)
        kwargs = {"max_batch": serve_cfg.get("max_batch", 8),
                  "max_wait_ms": serve_cfg.get("max_wait_ms", 2.0),
                  "max_depth": serve_cfg.get("max_depth", 256)}
        kwargs.update(overrides)
        srv = cls(**kwargs)
        for p, entry in loaded:
            # the manifest's fingerprint, checked against the rebuilt operator
            # under ``strict``: the operator is not hashed again
            srv.pool.adopt(p.A, p, fingerprint=entry["fingerprint"] if strict else None)
            if warm:
                from .warmstart import warm_plan

                warm_plan(p, srv.max_batch)
        return srv

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Pool/queue/worker state (metrics live in ``repro.obs``)."""
        with self._lock:
            queues = {str(k): len(w.queue) for k, w in self._workers.items()}
        return {
            "plans": len(self.pool),
            "workers": len(queues),
            "queue_depths": queues,
            "trace_counts": {p.method: p.trace_count for p in self.plans()},
            "closed": self._closed,
        }
