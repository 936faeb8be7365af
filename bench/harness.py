"""One run of one cell: set-up, the measured window, the per-layer trace,
and the check of the answers against the float64 reference.

The program is driven only through its public entries: ``repro_torch.plan``
with ``.solve(b)``, and ``repro_torch.serve.SolverServer`` with
``.submit(A, b)``. Set-up (timed as ``setup_s``) makes the operator from
the seed, hands it to the program in the configuration's form, builds the
plan or the server and warms the runners the traffic uses. Then the
window runs the traffic mix for ``seconds``; nothing is built inside it.
Afterwards the program's state is freed and the reference regenerates the
operator and each sampled right side from the seed and judges the
program's answers.
"""
from __future__ import annotations

import gc
import math
import threading
import time
from dataclasses import dataclass, field

import torch

from bench import catalog, loadgen
from bench.reference import ReferenceOperator
from bench.trace import Tracer

__all__ = ["Request", "Run", "run_cell", "SAMPLE", "LATE_S"]

SAMPLE = 48     # answers the reference checks, a uniform sample drawn from the seed
LATE_S = 60.0   # how long past the window's close an answer is waited for
TRACE_FROM, TRACE_TO = 0.25, 0.5   # the traced part, as shares of the window
TRACE_RETRIES = 2   # windows run again where the profiler recorded nothing
LEAD_IN_S = 1.0     # seconds of the cell's traffic before the window, in set-up


@dataclass
class Request:
    i: int
    due: float                    # due (open loop) or sent (closed loop), host clock
    done: float | None = None     # answered, host clock
    iterations: int = 0
    steps: int = 0                # loop steps of a plan solve (no-op steps included)
    converged: bool = False
    residual_norm: float = math.nan
    queue_wait_s: float = 0.0
    solve_s: float = 0.0
    bucket: object = None         # requests of one server bucket share it
    traced: bool = False
    error: str | None = None


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    cfg: dict
    mix: dict
    seconds: float                # the window's measured length
    window_start: float           # host clock
    setup_s: float
    requests: list                # every request due in the window
    trace: object = None          # trace.TraceSummary of a --trace 1 run
    trace_span: tuple | None = None  # host clock at the traced part's two markers
    extra: dict = field(default_factory=dict)

    @property
    def answered(self) -> list:
        return [r for r in self.requests if r.done is not None and r.error is None]


class _Kept:
    """A uniform sample of the window's answers (``loadgen.Reservoir``, from
    the seed), copied into a buffer allocated before the window, so keeping
    an answer allocates nothing while the window runs. A slot is claimed
    when a request is sent and filled when its answer comes, unless a later
    request took the slot meanwhile."""

    def __init__(self, k: int, seed: int, n: int, dev):
        self.reservoir = loadgen.Reservoir(k, seed)
        self.buf = torch.empty((k, n), dtype=torch.float32, device=dev) if k else None
        self.meta = [None] * k  # (request index, reported residual norm) a slot
        self.lock = threading.Lock()

    def claim(self, i: int):
        with self.lock:
            slot = self.reservoir.slot()
            if slot is not None:
                self.meta[slot] = (i, None)
            return slot

    def store(self, slot, i: int, x, reported) -> None:
        if slot is None:
            return
        with self.lock:
            if self.meta[slot] is not None and self.meta[slot][0] == i:
                self.buf[slot].copy_(x)
                self.meta[slot] = (i, reported)

    def answers(self) -> list:
        """(request index, x, reported norm) of every filled slot."""
        return [(m[0], self.buf[slot], float(m[1])) for slot, m in enumerate(self.meta)
                if m is not None and m[1] is not None]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- the window's loops ------------------------------------------------------

def _closed_plan(solver, rhs, seconds, dev, kept, tracer, first):
    """One client: the next solve as soon as the last one returns."""
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    reqs, raw = [], []
    w0 = time.monotonic()
    i = first
    while True:
        t = time.monotonic()
        if t - w0 >= seconds and reqs:
            break
        if tracer is not None:
            tracer.boundary(w0)
        if side is not None:  # the client's b on a stream of its own
            with torch.cuda.stream(side):
                b = rhs.make(i)
            torch.cuda.current_stream(dev).wait_stream(side)
            b.record_stream(torch.cuda.current_stream(dev))
        else:
            b = rhs.make(i)
        t0 = time.monotonic()
        res = solver.solve(b)
        t1 = time.monotonic()
        req = Request(i=i, due=t0, done=t1, steps=int(res.steps))
        reqs.append(req)
        raw.append((res.iterations, res.residual_norm, res.converged))
        kept.store(kept.claim(i), i, res.x, res.residual_norm)
        i += 1
    if raw:
        vals = torch.stack([torch.stack([it.double(), rn.double(), cv.double()])
                            for it, rn, cv in raw]).cpu().tolist()
        for req, (it, rn, cv) in zip(reqs, vals):
            req.iterations, req.residual_norm, req.converged = int(it), rn, bool(cv)
    return reqs, w0, reqs[-1].done, {}


class _ServerClient:
    """Submits requests to a SolverServer and books their answers; the
    answer callback runs in the server's worker, right after the bucket."""

    def __init__(self, srv, A):
        self.srv, self.A = srv, A
        self.rhs = self.kept = self.tracer = None  # each window's own
        self.w0 = None
        from repro_torch.serve.queue import QueueFull, ServerClosed

        self.refused = (QueueFull, ServerClosed)

    def submit(self, i: int, due: float):
        req = Request(i=i, due=due)
        b = self.rhs.make(i)
        slot = self.kept.claim(i)
        try:
            fut = self.srv.submit(self.A, b)
        except self.refused as e:  # refused: a failed request
            req.error, req.done = f"{type(e).__name__}: {e}", time.monotonic()
            return req, None
        fut.add_done_callback(lambda f, req=req, slot=slot: self._answer(f, req, slot))
        return req, fut

    def _answer(self, fut, req: Request, slot) -> None:
        t = time.monotonic()
        try:
            res = fut.result()
        except Exception as e:  # a failed request is counted, not raised
            req.error = f"{type(e).__name__}: {e}"
            req.done = t
            return
        req.iterations, req.converged = res.iterations, res.converged
        req.residual_norm, req.queue_wait_s = res.residual_norm, res.queue_wait_s
        req.solve_s = res.solve_s
        req.bucket = (res.solve_s, res.bucket_size)
        self.kept.store(slot, req.i, res.x, res.residual_norm)
        req.done = t
        if self.tracer is not None and self.w0 is not None:
            self.tracer.boundary(self.w0)


def _mark_traced_buckets(reqs, tracer) -> None:
    groups = {}
    for r in reqs:
        if r.done is not None and r.error is None:
            groups.setdefault(r.bucket, []).append(r)
    for members in groups.values():
        end = min(r.done for r in members)
        traced = tracer.traced(end - members[0].solve_s, end)
        for r in members:
            r.traced = traced


def _await(reqs, deadline: float) -> None:
    while any(r.done is None for r in reqs) and time.monotonic() < deadline:
        time.sleep(0.002)


def _open_server(client, rate, seconds, seed, first):
    offsets = loadgen.arrival_offsets(rate, seconds, seed)
    reqs, lags = [], []
    w0 = time.monotonic()
    client.w0 = w0
    for i, off in enumerate(offsets):
        due = w0 + float(off)
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        lags.append(time.monotonic() - due)
        reqs.append(client.submit(first + i, due)[0])
    w1 = w0 + seconds
    _await(reqs, w1 + LATE_S)
    return reqs, w0, w1, {"generator_lag_max_s": max(lags, default=0.0)}


def _window(solver, client, rhs, mix, seconds, dev, seed, tracer, kept, first):
    """Run the mix for ``seconds``: through the plan ``solver`` with one
    closed-loop client where ``client`` is None, else through the server
    ``client`` submits to."""
    if client is None:
        return _closed_plan(solver, rhs, seconds, dev, kept, tracer, first)
    client.rhs, client.kept, client.tracer = rhs, kept, tracer
    return _open_server(client, mix["rate_per_s"], seconds, seed, first)


# -- one run -------------------------------------------------------------------

def run_cell(cfg: dict, mix: dict, metric_entries: list, *, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda", control: bool = False) -> dict:
    """Run one cell once; returns the result line's fields and the checks.

    ``t_start`` is when the process began (set-up counts from it).
    ``control`` runs the configuration's control in the program's place:
    the program with the lower-precision path ``cfg["control"]["plan"]``
    names switched on."""
    if (mix["entry"], mix["loop"], mix.get("clients", 1)) not in (("plan", "closed", 1),
                                                                  ("server", "open", 1)):
        raise ValueError("a mix is one closed-loop plan client or an open loop to the server")
    import repro_torch
    from repro_torch.serve import SolverServer

    dev = torch.device(device)
    op = catalog.module("operators", cfg["operator"])
    form = catalog.module("forms", cfg["form"])
    solver_kw = dict(cfg["solver"])
    offs, data = op.band(cfg, seed, dev)
    n = int(data.shape[1])
    if control:
        solver_kw.update(cfg["control"]["plan"])
    A = form.build(offs, data)
    entry = mix["entry"]
    del data
    rhs = loadgen.RhsSource(n, seed, mix["rhs"], dev)
    warm = loadgen.RhsSource(n, seed, mix["rhs"], dev, key="warmup")
    solver = srv = None
    if entry == "plan":
        solver = repro_torch.plan(A, **solver_kw)
        for j in range(2):  # builds the runner, then one steady solve
            solver.solve(warm.make(j))
    else:
        scfg = mix["server"]
        srv = SolverServer(max_batch=scfg["max_batch"], max_wait_ms=scfg["max_wait_ms"],
                           **solver_kw)
        srv.submit(A, warm.make(0)).result()  # a bucket of one: the single runner
        futs = srv.submit_many(A, [warm.make(j) for j in range(1, 1 + scfg["max_batch"])])
        for f in futs:  # a full bucket: the lane-batched runner
            f.result()
    client = None if entry == "plan" else _ServerClient(srv, A)
    # a lead-in of the cell's own traffic, with right sides of their own:
    # the allocator's cache and the server's queue reach their steady state
    # before the window (windows that began cold stalled ~0.3 s at the start)
    _window(solver, client, warm, mix, LEAD_IN_S, dev, seed, None, _Kept(0, seed, n, dev),
            1 << 20)
    _sync(dev)
    setup_s = time.monotonic() - t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kept = _Kept(SAMPLE, seed, n, dev)
    earlier = []  # requests of windows whose trace came back unsound
    attempts = []  # each traced window's (kernels, markers, device s, host s)
    for attempt in range(1 + TRACE_RETRIES * trace):
        tracer = None
        if trace:
            tracer = Tracer(TRACE_FROM * seconds, TRACE_TO * seconds)
            tracer.begin()
        first = len(earlier)
        # set-up's objects leave the collector's generations: a full collection
        # inside the window then scans only what the window made
        gc.collect()
        gc.freeze()
        pauses = _GcPauses()
        gc.callbacks.append(pauses)
        reqs, w0, w1, extra = _window(solver, client, rhs, mix, seconds, dev, seed, tracer,
                                      kept, first)
        _sync(dev)
        gc.callbacks.remove(pauses)
        gc.unfreeze()
        extra["gc_max_ms"] = 1e3 * pauses.longest
        summary = tracer.finish() if tracer is not None else None
        if not trace:
            break
        attempts.append([summary and summary.kernels, summary and summary.marked,
                         summary and summary.window_s,
                         tracer.t_stop - tracer.t_start if tracer.t_stop else None])
        if tracer.sound(summary):
            break
        # the session did not record the traced part (seen in a few of some
        # thirty traced runs): the window runs again, with fresh right
        # sides, under a fresh session
        earlier += reqs
    if attempts:
        extra["trace_attempts"] = attempts
    span = None
    if tracer is not None and tracer.t_stop is not None:
        span = (tracer.t_start, tracer.t_stop)
        if entry == "plan":
            for req in reqs:
                req.traced = tracer.traced(req.due, req.done)
        else:
            _mark_traced_buckets(reqs, tracer)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if srv is not None:
        srv.shutdown(drain=True)

    extra.update(_diagnostics(reqs))
    run = Run(cfg=cfg, mix=mix, seconds=w1 - w0, window_start=w0, setup_s=setup_s,
              requests=reqs, trace=summary, trace_span=span,
              extra=extra)
    metrics = {}
    for m in metric_entries:
        value = catalog.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    answers = kept.answers()
    del solver, srv, A
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    every = earlier + reqs
    checks = judge(cfg, seed, dev, rhs, answers, every)
    failed = sum(1 for r in every if r.error is not None or r.done is None)
    return {"run": run, "metrics": metrics, "checks": checks, "attempted": len(every),
            "failed": failed, "memory_peak_bytes": int(peak), "extra": extra}


class _GcPauses:
    """The longest pause of the cyclic collector in the window."""

    def __init__(self):
        self.longest, self.t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self.t = time.perf_counter()
        elif self.t is not None:
            self.longest = max(self.longest, time.perf_counter() - self.t)


def _diagnostics(reqs) -> dict:
    """What the standard error's info line adds: service times and
    latency quantiles of the window, for reading a run's spread."""
    from bench.stats import percentile

    done = [r for r in reqs if r.done is not None and r.error is None]
    if not done:
        return {}
    lat = [r.done - r.due for r in done]
    worst = max(done, key=lambda r: r.done - r.due)
    out = {"p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
           "max_ms": 1e3 * max(lat), "max_due_s": worst.due - reqs[0].due,
           "iterations": [min(r.iterations for r in done), max(r.iterations for r in done)]}
    buckets = {r.bucket: r for r in done if r.bucket is not None}
    if buckets:
        svc = [r.solve_s for r in buckets.values()]
        out.update(buckets=len(buckets), mean_bucket=len(done) / len(buckets),
                   bucket_p50_ms=1e3 * percentile(svc, 50), bucket_p95_ms=1e3 * percentile(svc, 95))
    return out


def judge(cfg: dict, seed: int, dev, rhs, kept, reqs) -> dict:
    """Each number compared beside its limit (``cfg["limits"]``; the exact
    counts have the limit 0)."""
    op = catalog.module("operators", cfg["operator"])
    ref = ReferenceOperator(*op.band(cfg, seed, dev, dtype=torch.float64))
    worst = dict.fromkeys(cfg["limits"], 0.0)
    for i, x, reported in kept:
        got = ref.judge(rhs.make(i), x, reported)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    if not kept:
        worst = {k: math.inf for k in worst}
    answered = [r for r in reqs if r.done is not None and r.error is None]
    counts = {"unconverged": sum(1 for r in answered if not r.converged),
              "unanswered": len(reqs) - len(answered)}
    checks = {k: {"value": worst[k], "limit": float(lim)} for k, lim in cfg["limits"].items()}
    checks.update({k: {"value": v, "limit": 0} for k, v in counts.items()})
    return checks


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
