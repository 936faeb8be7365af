"""The span reduction (``bench.spans``) on hand-made Chrome traces and span
trees: clocks tied by the markers' launches or the trace's base time,
idle gaps split by overlap, parts that sum to the device's idle share,
markers that disagree, and a run without spans."""
import time

import pytest
import torch

from bench import catalog, spans
from bench.harness import Request, Run
from bench.trace import reduce_events

OFF_US = 1000.0  # trace time = monotonic time + 1000 us in every hand-made trace


def _ev(name, ts, dur, cat="kernel", corr=None):
    args = {"stream": 7}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _trace(launch_shift_us=0.0, runtime=True):
    """Markers at 1020 (ends 1021) and 1200 (trace us), launched at 1010
    and 1190; kernels busy over [1021, 1040] and [1080, 1140]."""
    events = [
        _ev("void at::cuda::spin_kernel(long)", 1020, 1, corr=1),
        _ev("void fused_iter_kernel<1>(float*)", 1021, 19, corr=3),
        _ev("void fused_iter_kernel<1>(float*)", 1080, 40, corr=4),
        _ev("Memcpy DtoD", 1110, 30, cat="gpu_memcpy", corr=5),  # overlaps: busy to 1140
        _ev("void at::cuda::spin_kernel(long)", 1200, 1, corr=2),
    ]
    if runtime:
        events += [_ev("cudaLaunchKernel", 1010, 2, cat="cuda_runtime", corr=1),
                   _ev("cudaLaunchKernel", 1190 + launch_shift_us, 2, cat="cuda_runtime", corr=2)]
    return events


STAMPS = [(10_000, 5_000_010_000), (190_000, 5_000_190_000)]  # (monotonic, wall) ns
BASE_NS = 5_000_000_000 - int(OFF_US * 1e3)


def _sp(name, a_us, b_us, thread=1, children=(), **attrs):
    """A span dict at trace times a..b (us), stored on the program's clock."""
    return {"name": name, "thread": thread, "start_ns": int((a_us - OFF_US) * 1e3),
            "end_ns": int((b_us - OFF_US) * 1e3), "attrs": attrs, "children": list(children)}


def _solve_spans():
    poll = _sp("pipecg.poll", 1060, 1070)
    loop = _sp("pipecg.loop", 1060, 1150, children=[poll], steps=16, polls=1)
    return [_sp("plan.solve", 1030, 1150, k=1,
                children=[_sp("pipecg.init", 1030, 1060), loop])]


def test_clocks_tie_by_the_markers_launches_or_the_base_time():
    (a, ra), (b, rb) = spans.clock_offsets(_trace(), STAMPS)
    assert (ra, rb) == ("runtime", "runtime") and a == b == pytest.approx(OFF_US)
    (a, ra), (b, _) = spans.clock_offsets(_trace(runtime=False), STAMPS, BASE_NS)
    assert ra == "base" and a == b == pytest.approx(OFF_US)
    assert spans.clock_offsets(_trace(runtime=False), STAMPS) is None
    assert spans.clock_offsets(_trace(), STAMPS[:1]) is None


def test_a_gap_straddling_two_spans_is_split_by_overlap():
    out = spans.reduce_spans(_trace(), _solve_spans(), STAMPS, "plan")
    window = 1200 - 1021
    by = dict(out["idle_by_host"])
    # gap [1040, 1080]: 20 us in pipecg.init, 10 in pipecg.poll, 10 in pipecg.loop;
    # gap [1140, 1200]: 10 us in pipecg.loop, then 50 outside any span
    assert by == pytest.approx({"pipecg.init": 20e-6, "pipecg.poll": 10e-6,
                                "pipecg.loop": 20e-6, "outside": 50e-6})
    m = out["metrics"]
    assert m["idle_entry.solve"] == pytest.approx(100 * 20 / window)
    assert m["idle_loop.solve"] == pytest.approx(100 * 30 / window)
    assert out["info"]["idle_outside"] == pytest.approx(100 * 50 / window)
    # 90 us of loop less 10 of poll over 16 steps
    assert m["host_ms_per_step"] == pytest.approx(80e-3 / 16)
    assert out["info"]["clock_route"] == "runtime" and out["info"]["traced_solves"] == 1


@pytest.mark.parametrize("runtime", [True, False], ids=["runtime", "base"])
def test_the_parts_sum_to_the_device_idle(runtime):
    events = _trace(runtime=runtime)
    summary = reduce_events(events)
    idle = 100.0 * (1.0 - summary.busy_s / summary.window_s)
    out = spans.reduce_spans(events, _solve_spans(), STAMPS, "plan", BASE_NS, idle)
    info = out["info"]
    parts = out["metrics"]["idle_entry.solve"] + out["metrics"]["idle_loop.solve"]
    assert parts + info["idle_outside"] == pytest.approx(idle)
    assert info["idle_sum_diff_pts"] == pytest.approx(0.0, abs=1e-9)
    assert info["device_idle"] == pytest.approx(idle) and info["idle_other"] == 0.0


def test_markers_that_disagree_leave_every_span_reading_none():
    out = spans.reduce_spans(_trace(launch_shift_us=60.0), _solve_spans(), STAMPS, "plan")
    assert out["info"]["offset_diff_us"] == pytest.approx(60.0)
    assert all(v is None for v in out["metrics"].values()) and out["idle_by_host"] is None
    near = spans.reduce_spans(_trace(launch_shift_us=40.0), _solve_spans(), STAMPS, "plan")
    assert near["metrics"]["idle_entry.solve"] is not None


def test_a_run_without_spans_leaves_every_existing_reading_unchanged():
    events = _trace()
    before = reduce_events(events)
    out = spans.reduce_spans(events, [], STAMPS, "plan")
    assert all(v is None for v in out["metrics"].values())
    after = reduce_events(events)
    assert after == before
    reqs = [Request(i=i, due=100 + i, done=100.5 + i, iterations=24, steps=32, traced=True)
            for i in range(2)]
    mix = {"entry": "plan", "loop": "closed", "clients": 1}
    run = lambda tr: Run(cfg={}, mix=mix, seconds=2.0, window_start=100.0, setup_s=1.0,
                         requests=reqs, trace=tr)
    for name in ("device_idle.solve", "launches_per_step", "noop_step_share"):
        read = catalog.module("metrics", name).read
        assert read(run(after)) == read(run(before))


def test_serving_parts_and_host_readings():
    worker = 2
    bucket = _sp("serve.bucket", 1050, 1150, thread=worker, k=3, size=4, steps=32,
                 iterations=27, requests=[0, 1, 2], bucket=0, children=[
                     _sp("serve.assemble", 1050, 1055, thread=worker),
                     _sp("plan.solve_batched", 1055, 1130, thread=worker, k=4, children=[
                         _sp("pipecg.init", 1055, 1070, thread=worker),
                         _sp("pipecg.loop", 1070, 1130, thread=worker, steps=32, polls=3)]),
                     _sp("serve.sync", 1130, 1135, thread=worker),
                     _sp("serve.readback", 1135, 1145, thread=worker),
                     _sp("serve.deliver", 1145, 1150, thread=worker)])
    roots = [
        _sp("serve.wait", 1000, 1050, thread=worker),
        bucket,
        _sp("serve.wait", 1150, 1300, thread=worker),
        _sp("serve.admit", 1030, 1031, thread=1, request=2),
        {"name": "serve.queue", "thread": None, "start_ns": 0, "end_ns": 50_000,
         "attrs": {"request": 2}, "children": []},
        # a bucket after the traced part: counted by the no-op share only
        _sp("serve.bucket", 1300, 1400, thread=worker, k=1, size=1, steps=16, iterations=12),
    ]
    out = spans.reduce_spans(_trace(), roots, STAMPS, "server")
    window = 1200 - 1021
    m = out["metrics"]
    # gap [1040, 1080]: serve.wait 10, serve.assemble 5, pipecg.init 15, pipecg.loop 10;
    # gap [1140, 1200]: serve.readback 5, serve.deliver 5, serve.wait 50
    assert m["idle_queue.serve"] == pytest.approx(100 * 60 / window)
    assert m["idle_bucket_host.serve"] == pytest.approx(100 * 30 / window)
    assert m["idle_loop.serve"] == pytest.approx(100 * 10 / window)
    assert out["info"]["idle_outside"] == 0.0
    assert dict(out["idle_by_host"])["serve.wait"] == pytest.approx(60e-6)
    assert m["host_ms_per_bucket"] == pytest.approx((100 - 60 - 5) * 1e-3)
    assert m["noop_step_share.serve"] == pytest.approx(100 * (1 - (27 + 12) / (32 + 16)))
    assert out["info"]["traced_buckets"] == 1


def test_span_tracer_records_spans_for_its_session_only(monkeypatch):
    """The tracer's recorder on a CPU session: the program's spans record
    from ``begin`` to ``finish``, a stamp a marker, the trace kept whole."""
    from bench import trace
    from repro_torch import obs

    cpu_profile = torch.profiler.profile
    monkeypatch.setattr(trace.torch.profiler, "profile", lambda activities: cpu_profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(trace.torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda *a: None)
    obs.clear_spans()
    tr = spans.SpanTracer(0.0, 0.0)
    try:
        tr.begin()
        assert spans.SpanTracer.last is tr and obs.enabled() and not obs.reports()
        w0 = time.monotonic() - 1.0
        tr.boundary(w0)
        with obs.span("plan.solve"):
            torch.ones(4).sum()
        tr.boundary(w0)
        summary = tr.finish()
    finally:
        obs.disable()
    assert not obs.enabled() and [s.name for s in obs.span_tree()] == ["plan.solve"]
    assert len(tr.stamps) == 2 and tr.stamps[0][0] <= tr.stamps[1][0]
    assert tr.events and isinstance(tr.base_ns, int)
    assert summary == reduce_events(tr.events, tr.t_stop - tr.t_start)
    obs.clear_spans()
