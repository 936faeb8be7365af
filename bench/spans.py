"""The program's spans on the device trace's clock: each idle gap of a
traced run charged to what the host was doing.

``repro_torch.obs`` records spans on ``time.monotonic_ns()`` without
waiting for the device (``obs.enable(reports=False)``); the profiler's
Chrome trace times its events on a host clock of its own. The two
``spin_kernel`` markers that bound the traced part tie them: the host
stamps ``time.monotonic_ns()`` right before each marker's launch, the
trace holds that launch's ``cudaLaunchKernel`` (linked to the marker by
its correlation id), and the offset between the clocks is the launch's
trace time less the stamp. Where the trace holds no runtime events, the
offset comes from the trace's ``baseTimeNanoseconds`` and a
``time.time_ns()`` / ``time.monotonic_ns()`` pair taken beside each
marker. The two markers' offsets must agree within ``AGREE_US``; else no
span reading is made.

Each idle gap of the device between the markers (no kernel, copy or fill
running, as ``bench.trace`` counts busy time) is charged to the
innermost span open on the launching thread, the thread whose
``pipecg.loop`` spans last longest, in proportion to overlap; where that
thread is in no span, to ``outside``. The readings (percent of the traced
window; ``host_ms_*`` in host milliseconds):

* ``idle_entry.solve``: in ``plan.solve`` outside ``pipecg.loop``;
* ``idle_loop.solve`` / ``idle_loop.serve``: inside ``pipecg.loop``, polls
  included;
* ``idle_queue.serve``: the worker in ``serve.wait``;
* ``idle_bucket_host.serve``: in ``serve.bucket`` outside ``pipecg.loop``;
* ``host_ms_per_step``: host time in ``pipecg.loop`` outside
  ``pipecg.poll``, over the steps of the traced solves;
* ``host_ms_per_bucket``: host time of a traced ``serve.bucket`` outside
  ``pipecg.loop`` and ``serve.sync``;
* ``noop_step_share.serve``: 1 - the buckets' slowest-lane iterations
  over their steps, over the window's buckets.

The parts and ``outside`` sum to the device's idle share
(``idle_sum_diff_pts`` says by how much they miss it).

``BENCHMARK.json`` does not read these yet: ``bench.run`` and
``bench.harness`` would have to switch the recorder on in the traced run
and hand the spans, the stamps and the trace to this module. Until then
one traced run with the recorder on is:

    python3 -m bench.spans --workload poisson125.solve --seed N --seconds 20

It runs ``bench.run --trace 1`` (its result line first) with the
program's recorder on for the window, then prints one more JSON line:
the readings, ``idle_by_host`` (seconds per innermost span name, top 10)
and how the clocks were tied.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

from bench import run as _run  # first: its clock of the process's start
from bench import trace as _trace

__all__ = ["AGREE_US", "clock_offsets", "reduce_spans", "SpanTracer", "main"]

AGREE_US = 50.0
_TOP = 10
# per entry: (part, span name whose presence in the open stack charges the part), in order
PARTS = {
    "plan": (("loop", "pipecg.loop"), ("entry", "plan.solve")),
    "server": (("loop", "pipecg.loop"), ("bucket_host", "serve.bucket"), ("queue", "serve.wait")),
}
METRICS = {
    "plan": {"idle_entry.solve": "entry", "idle_loop.solve": "loop"},
    "server": {"idle_queue.serve": "queue", "idle_bucket_host.serve": "bucket_host",
               "idle_loop.serve": "loop"},
}


def _device(events):
    """(markers, other device events) by start, as ``bench.trace`` reads them."""
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _trace._DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    return ([e for e in dev if _trace._MARK in e["name"]],
            [e for e in dev if _trace._MARK not in e["name"]])


def clock_offsets(events, stamps, base_ns=None):
    """Per marker, the trace's host time less the program's clock, in
    microseconds, and the route: ``"runtime"`` (the marker's launch in the
    trace) or ``"base"`` (``baseTimeNanoseconds`` and the stamp's
    wall-clock pair). ``stamps`` are ``(monotonic_ns, time_ns)`` taken
    right before each marker's launch, in order. None where the markers
    and stamps do not pair up or no route is open."""
    marks, _ = _device(events)
    if not marks or len(marks) != len(stamps):
        return None
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = []
    for m, (mono, wall) in zip(marks, stamps):
        ts = launches.get(m.get("args", {}).get("correlation"))
        if ts is not None:
            out.append((ts - mono * 1e-3, "runtime"))
        elif base_ns is not None:
            out.append(((wall - mono - base_ns) * 1e-3, "base"))
        else:
            return None
    return out


def _flat(spans):
    """Every span dict of a tree (``obs.spans_to_dicts()``), depth first."""
    for s in spans:
        yield s
        yield from _flat(s.get("children", ()))


def _segments(spans, stack, lo, hi, off):
    """(start, end, open names) covering [lo, hi] (trace microseconds)
    along one thread's nested spans."""
    t = lo
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        a, b = max(s["start_ns"] * 1e-3 + off, lo), min(s["end_ns"] * 1e-3 + off, hi)
        if b <= a:
            continue
        if a > t:
            yield t, a, stack
        yield from _segments(s.get("children", ()), stack + (s["name"],), a, b, off)
        t = max(t, b)
    if t < hi:
        yield t, hi, stack


def _gaps(dev, lo, hi):
    """Idle intervals of the device inside [lo, hi] and the window's busy time."""
    gaps, busy, cur = [], 0.0, lo
    for e in dev:
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        busy += max(b - max(a, cur), 0.0)
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps, busy


def _part(stack, rules):
    for part, name in rules:
        if name in stack:
            return part
    return "other" if stack else "outside"


def _host_readings(kind, roots, thread, t0_ns, t1_ns):
    """``host_ms_per_step`` / ``host_ms_per_bucket`` over the units of the
    traced part (host clock), ``noop_step_share.serve`` over every bucket."""
    mine = [s for s in _flat(roots) if s.get("thread") == thread]
    inside = [s for s in mine if t0_ns <= s["start_ns"] and s["end_ns"] <= t1_ns]
    out = {}
    if kind == "plan":
        loops = [s for s in inside if s["name"] == "pipecg.loop"]
        steps = sum(s["attrs"].get("steps", 0) for s in loops)
        host = sum(s["end_ns"] - s["start_ns"] - sum(c["end_ns"] - c["start_ns"]
                                                     for c in s.get("children", ())
                                                     if c["name"] == "pipecg.poll")
                   for s in loops)
        out["host_ms_per_step"] = host * 1e-6 / steps if steps else None
        out["traced_solves"] = sum(1 for s in inside if s["name"] == "plan.solve")
        return out
    buckets = [s for s in inside if s["name"] == "serve.bucket"]
    hosts = []
    for s in buckets:
        away = sum(c["end_ns"] - c["start_ns"] for c in _flat(s.get("children", ()))
                   if c["name"] in ("pipecg.loop", "serve.sync"))
        hosts.append(s["end_ns"] - s["start_ns"] - away)
    out["host_ms_per_bucket"] = sum(hosts) * 1e-6 / len(hosts) if hosts else None
    every = [s for s in mine if s["name"] == "serve.bucket" and "steps" in s["attrs"]]
    steps = sum(s["attrs"]["steps"] for s in every)
    its = sum(s["attrs"].get("iterations", 0) for s in every)
    out["noop_step_share.serve"] = 100.0 * (1.0 - its / steps) if steps else None
    out["traced_buckets"] = len(buckets)
    return out


def reduce_spans(events, spans, stamps, kind, base_ns=None, device_idle=None):
    """The span readings of one traced run: ``events`` the Chrome trace's
    events, ``spans`` the program's span trees as dicts, ``stamps`` the
    markers' ``(monotonic_ns, time_ns)``, ``kind`` the mix's entry
    (``"plan"`` or ``"server"``), ``device_idle`` the percent the trace's
    own reduction read (checked against the parts' sum). Returns
    ``{"metrics": {...}, "idle_by_host": [[name, s], ...], "info": {...}}``;
    every reading None where the clocks cannot be tied."""
    names = list(METRICS[kind]) + (["host_ms_per_step"] if kind == "plan" else
                                   ["host_ms_per_bucket", "noop_step_share.serve"])
    out = {"metrics": dict.fromkeys(names), "idle_by_host": None, "info": {}}
    offs = clock_offsets(events, stamps, base_ns)
    marks, dev = _device(events)
    if offs is None or len(marks) != 2 or not spans:
        out["info"]["clock"] = "untied"
        return out
    diff = abs(offs[1][0] - offs[0][0])
    out["info"].update(clock_route=offs[0][1], offset_diff_us=diff)
    if offs[0][1] == "runtime" and base_ns is not None:  # how far the other route lies
        out["info"]["base_route_minus_us"] = sum(
            (wall - mono - base_ns) * 1e-3 - o for (o, _), (mono, wall) in zip(offs, stamps)) / 2
    if diff > AGREE_US or offs[0][1] != offs[1][1]:
        return out
    off = 0.5 * (offs[0][0] + offs[1][0])
    lo = float(marks[0]["ts"]) + float(marks[0]["dur"])
    hi = float(marks[1]["ts"])
    window = hi - lo
    loop_us = defaultdict(int)
    for s in _flat(spans):
        if s["name"] == "pipecg.loop" and s.get("thread") is not None:
            loop_us[s["thread"]] += s["end_ns"] - s["start_ns"]
    if not loop_us or window <= 0:
        out["info"]["clock"] = "no solver loop"
        return out
    thread = max(loop_us, key=loop_us.get)
    roots = [s for s in spans if s.get("thread") == thread]

    gaps, busy = _gaps(dev, lo, hi)
    by_name, by_part = defaultdict(float), defaultdict(float)
    segs = list(_segments(roots, (), lo, hi, off))
    first = 0  # gaps and segments both run in time order
    for a, b in gaps:
        while first < len(segs) and segs[first][1] <= a:
            first += 1
        for s0, s1, stack in segs[first:]:
            if s0 >= b:
                break
            part = min(s1, b) - max(s0, a)
            if part > 0:
                by_name[stack[-1] if stack else "outside"] += part
                by_part[_part(stack, PARTS[kind])] += part
    pct = lambda us: 100.0 * us / window
    for metric, part in METRICS[kind].items():
        out["metrics"][metric] = pct(by_part.get(part, 0.0))
    total = sum(by_part.values())
    idle = pct(window - busy)
    out["idle_by_host"] = [[k, v * 1e-6] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]]
    out["info"].update(idle_outside=pct(by_part.get("outside", 0.0)),
                       idle_other=pct(by_part.get("other", 0.0)), device_idle=idle,
                       idle_sum_diff_pts=pct(total) - (idle if device_idle is None
                                                       else device_idle))
    for k, v in _host_readings(kind, spans, thread, stamps[0][0], stamps[1][0]).items():
        (out["metrics"] if k in out["metrics"] else out["info"])[k] = v
    return out


class SpanTracer(_trace.Tracer):
    """``bench.trace.Tracer`` with the program's span recorder on from the
    session's start to :meth:`finish`, a clock stamp right before each
    marker's launch, and the trace kept (``events``, ``base_ns``)."""

    last = None  # the newest instance: the harness makes one a window

    def begin(self) -> None:
        from repro_torch import obs

        SpanTracer.last = self
        self.stamps, self.events, self.base_ns, self.summary = [], [], None, None
        obs.clear_spans()
        obs.enable(reports=False)
        super().begin()

    def _mark(self) -> float:
        self.stamps.append((time.monotonic_ns(), time.time_ns()))
        return super()._mark()

    def finish(self):
        """As ``Tracer.finish``, keeping the whole trace; the recorder stops."""
        from repro_torch import obs

        with self._lock:
            if self.state == "on":
                self.t_stop = self._mark()
                self.state = "marked"
        self._stop_profiler()
        obs.disable()
        if self.state != "marked":
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        self._prof = None
        self.events = doc.get("traceEvents", [])
        base = doc.get("baseTimeNanoseconds")
        self.base_ns = None if base is None else int(base)
        self.summary = _trace.reduce_events(self.events, self.t_stop - self.t_start)
        return self.summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from bench import catalog, harness

    kept = harness.Tracer
    harness.Tracer = SpanTracer
    try:
        rc = _run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        harness.Tracer = kept
    tr = SpanTracer.last
    if rc or tr is None or tr.summary is None:
        return rc or 6
    from repro_torch import obs

    mix = catalog.traffic(catalog.workload(catalog.load_benchmark(), args.workload)["traffic"])
    s = tr.summary
    idle = 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
    out = reduce_spans(tr.events, obs.spans_to_dicts(), tr.stamps, mix["entry"], tr.base_ns,
                       idle)
    out["info"].update(workload=args.workload, seed=args.seed, spans=len(obs.span_tree()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
