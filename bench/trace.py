"""The traced part of a ``--trace 1`` run: ``torch.profiler`` with device
activity only (no host op recording, so the host runs as it does
untraced), one session a window, started before it; two marker kernels
on the solver's stream at two boundaries between units of work (solves,
or a server's buckets) bound the traced part, and the trace is reduced to
the numbers the per-layer metrics read.

The profiler's Chrome trace is written to ``TMPDIR``, read and deleted.
The traced window is the device time between the markers. The solver's
stream is the one whose kernels take the most device time in it: the
right sides are made on another stream, so its kernels are the solves'
or the buckets' own. Busy time is the union of every kernel, copy and
fill interval on the device inside the window.
"""
from __future__ import annotations

import json
import math
import os
import re
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["Tracer", "TraceSummary", "reduce_events"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_CHARS = 80
_MARK = "spin_kernel"   # torch.cuda._sleep's kernel: the traced part's two ends
_MARK_CYCLES = 1000


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    solver_kernel_s: float = 0.0
    solver_kernels: int = 0
    kernels: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    marked: int = 0


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and arguments' tail."""
    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::|std::", "", name)
    return name if len(name) <= _NAME_CHARS else name[: _NAME_CHARS - 3] + "..."


def reduce_events(events: list, host_window_s: float = 0.0) -> TraceSummary:
    """Reduce Chrome-trace events (``ph == "X"``, times in microseconds)
    between the two marker kernels (``spin_kernel``) the tracer put on the
    solver's stream at the traced part's start and end; without markers,
    over the whole trace and the host's window."""
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    marks = [e for e in dev if _MARK in e["name"]]
    dev = [e for e in dev if _MARK not in e["name"]]
    if marks:
        lo = float(marks[0]["ts"]) + float(marks[0]["dur"])
        hi = float(marks[-1]["ts"]) if len(marks) > 1 else max(
            (float(e["ts"]) + float(e["dur"]) for e in dev), default=lo)
        window_s = max(hi - lo, 0.0) * 1e-6
    else:
        lo, hi, window_s = -math.inf, math.inf, host_window_s
    clipped = []
    for e in dev:
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            clipped.append((a, b, e))
    kernels = [(a, b, e) for a, b, e in clipped if e["cat"] == "kernel"]
    by_stream = defaultdict(float)
    for a, b, e in kernels:
        by_stream[e.get("args", {}).get("stream")] += b - a
    solver = max(by_stream, key=by_stream.get) if by_stream else None
    solver_ev = [(a, b) for a, b, e in kernels if e.get("args", {}).get("stream") == solver]

    by_name = defaultdict(float)
    for a, b, e in clipped:
        by_name[_short(e["name"])] += (b - a) * 1e-6

    busy = 0.0
    gaps = defaultdict(float)
    cur_lo = cur_hi = None
    last_name = None
    for a, b, e in clipped:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                gaps[f"{last_name} -> {_short(e['name'])}"] += (a - cur_hi) * 1e-6
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
        if b >= cur_hi:
            last_name = _short(e["name"])
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return TraceSummary(
        window_s=window_s, busy_s=busy * 1e-6,
        solver_kernel_s=sum(b - a for a, b in solver_ev) * 1e-6,
        solver_kernels=len(solver_ev), kernels=len(kernels),
        device_ops=top(by_name), idle_gaps=top(gaps), marked=len(marks))


class Tracer:
    """Profiles the units of work between the first unit boundary after
    ``start_at`` seconds of the window and the first after ``stop_at``.

    One profiler session a window: :meth:`begin` starts it on the run's
    main thread before the window opens (its set-up then stays out of the
    window, and no unit ever waits for a start). :meth:`boundary`, called
    between units from any thread, puts a marker kernel on that thread's
    stream at the traced part's start and end; at the end the main thread's own boundary
    stops the session at once, and :meth:`finish` stops any other after
    the window, so no other thread's load is held back.
    """

    def __init__(self, start_at: float, stop_at: float):
        self.start_at, self.stop_at = float(start_at), float(stop_at)
        self.state = "idle"
        self.t_start = self.t_stop = None
        self._prof = None
        self._running = False
        self._owner = threading.get_ident()
        self._lock = threading.Lock()

    def begin(self) -> None:
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self._running = True

    def _mark(self) -> float:
        torch.cuda._sleep(_MARK_CYCLES)
        return time.monotonic()

    def boundary(self, w0: float) -> None:
        with self._lock:
            now = time.monotonic()
            if self.state == "idle" and now - w0 >= self.start_at:
                self.t_start = self._mark()
                self.state = "on"
            elif self.state == "on" and now - w0 >= self.stop_at:
                self.t_stop = self._mark()
                self.state = "marked"
                if threading.get_ident() == self._owner:
                    self._stop_profiler()  # the main thread's own units wait for it

    def _stop_profiler(self) -> None:
        if self._running:
            torch.cuda.synchronize()  # every marked kernel has run and is recorded
            self._prof.stop()
            self._running = False

    def traced(self, t_begin: float, t_end: float) -> bool:
        """Whether a unit that ran from ``t_begin`` to ``t_end`` lies in the traced part."""
        return (self.t_start is not None and self.t_stop is not None
                and t_begin >= self.t_start and t_end <= self.t_stop)

    def finish(self) -> TraceSummary | None:
        """After the window (main thread): mark the end if no boundary did,
        stop the session and reduce its trace (None if nothing was marked)."""
        with self._lock:
            if self.state == "on":
                self.t_stop = self._mark()
                self.state = "marked"
        self._stop_profiler()
        if self.state != "marked":
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        return reduce_events(events, self.t_stop - self.t_start)

    def sound(self, summary) -> bool:
        """Whether the session recorded the traced part: both markers, some
        kernels, and the markers as far apart on the device as on the host."""
        if summary is None or summary.marked != 2 or summary.kernels == 0:
            return False
        host = self.t_stop - self.t_start
        return abs(summary.window_s - host) <= 0.1 * host + 0.05
