"""The window's arithmetic: end-to-end metrics from the requests of a run,
and the per-layer metrics from its counters and trace summary."""
import math

import pytest

from bench import catalog
from bench.harness import Request, Run
from bench.stats import percentile
from bench.trace import TraceSummary

PLAN = {"entry": "plan", "loop": "closed", "clients": 1}
OPEN = {"entry": "server", "loop": "open", "server": {"max_batch": 8}}


def _read(name, run):
    return catalog.module("metrics", name).read(run)


def _run(mix, reqs, seconds=2.0, **kw):
    return Run(cfg={}, mix=mix, seconds=seconds, window_start=100.0, setup_s=7.5,
               requests=reqs, **kw)


def test_percentile_is_nearest_rank_over_every_value():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile(xs, 50) == 50
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, math.inf], 95) == math.inf
    assert math.isnan(percentile([], 95))


def test_solve_ms_is_the_window_over_the_solves_completed():
    reqs = [Request(i=i, due=100 + 0.5 * i, done=100.5 + 0.5 * i, converged=True) for i in range(4)]
    assert _read("solve_ms", _run(PLAN, reqs, seconds=2.0)) == pytest.approx(500.0)
    assert _read("solve_ms", _run(OPEN, reqs)) is None
    assert _read("setup_s", _run(PLAN, reqs)) == 7.5


def test_latency_p95_counts_every_request_from_its_due_time():
    # 19 answered 10 ms after due, one 1 s after: p95 (rank 19 of 20) is 10 ms
    reqs = [Request(i=i, due=100 + 0.01 * i, done=100.01 + 0.01 * i) for i in range(19)]
    reqs.append(Request(i=19, due=100.5, done=101.5))
    assert _read("latency_p95_ms", _run(OPEN, reqs)) == pytest.approx(10.0)
    # a second late one moves rank 19 to the late tail
    reqs[0] = Request(i=0, due=100.0, done=102.0)
    assert _read("latency_p95_ms", _run(OPEN, reqs)) == pytest.approx(1000.0)
    # a request that never came back is late without end, and counts
    reqs[1] = Request(i=1, due=100.01, done=None)
    assert _read("latency_p95_ms", _run(OPEN, reqs)) == pytest.approx(2000.0)
    reqs[2] = Request(i=2, due=100.02, done=None)
    assert _read("latency_p95_ms", _run(OPEN, reqs)) is None
    assert _read("latency_p95_ms", _run(PLAN, reqs)) is None


def test_queue_wait_p95_reads_the_traced_part_only():
    reqs = [Request(i=i, due=100 + 0.1 * i, done=101 + 0.1 * i, queue_wait_s=0.001 * i)
            for i in range(20)]
    run = _run(OPEN, reqs, trace_span=(100.45, 101.55))
    # due in [100.45, 101.55] with the bucket closed by 101.55: i = 5..15
    assert _read("queue_wait_p95_ms", run) == pytest.approx(15.0)
    assert _read("queue_wait_p95_ms", _run(OPEN, reqs)) is None


def test_solver_loop_counters_and_trace_shares():
    reqs = [Request(i=i, due=100 + i, done=100.5 + i, iterations=24, steps=32, traced=i < 2)
            for i in range(4)]
    tr = TraceSummary(window_s=2.0, busy_s=1.5, solver_kernel_s=1.2, solver_kernels=640)
    run = _run(PLAN, reqs, trace=tr)
    assert _read("noop_step_share", run) == pytest.approx(25.0)
    assert _read("launches_per_step", run) == pytest.approx(640 / 64)
    assert _read("device_idle.solve", run) == pytest.approx(25.0)
    assert _read("launches_per_step", _run(PLAN, reqs)) is None

