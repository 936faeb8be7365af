"""Process-local metrics: counters, gauges, histograms.

A deliberately tiny registry — no labels cardinality, no exporters, no
background threads — because the quantity that matters here is *solver*
telemetry: plan-cache hits, traces, solves, iterations, batch occupancy,
padding waste. Everything is a strict no-op while observability is
disabled (``obs.disable()``, the default): ``inc``/``set``/``record``
check the shared enable flag and return, so the hot serving path pays one
predicate per event and the metric values stay exactly zero — the
overhead guard tests assert this.

Sinks: :func:`snapshot` (plain dict), :func:`format_metrics` (human
readable), :func:`dump_jsonl` (one JSON line per metric, grep/jq-able).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Union

from . import trace as _trace

__all__ = [
    "counter",
    "gauge",
    "histogram",
    "metric_names",
    "snapshot",
    "reset_metrics",
    "format_metrics",
    "dump_jsonl",
    "Counter",
    "Gauge",
    "Histogram",
]

_LOCK = threading.Lock()

# histograms keep raw samples for percentiles, capped so a long-lived
# serving process cannot grow without bound (count/sum/min/max stay exact)
_HIST_SAMPLES_MAX = 4096


class Counter:
    """Monotonic event count. ``inc`` is a no-op while obs is disabled."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _trace.enabled():
            return
        with _LOCK:
            self.value += n

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache size)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        if not _trace.enabled():
            return
        with _LOCK:
            self.value = float(v)

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "value": self.value}


class Histogram:
    """Distribution summary: count/sum/min/max + capped raw samples."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []

    def record(self, v: float) -> None:
        if not _trace.enabled():
            return
        v = float(v)
        with _LOCK:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self.samples) < _HIST_SAMPLES_MAX:
                self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], from the retained samples (0.0 when empty)."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        idx = min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return xs[idx]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


Metric = Union[Counter, Gauge, Histogram]

_REGISTRY: Dict[str, Metric] = {}


def _get(name: str, cls) -> Metric:
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"not {cls.__name__}"
            )
        return m


def counter(name: str) -> Counter:
    """Get-or-create the counter ``name`` (dotted names by convention)."""
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def metric_names() -> tuple:
    with _LOCK:
        return tuple(sorted(_REGISTRY))


def snapshot() -> Dict[str, dict]:
    """{name: metric dict} for every registered metric."""
    with _LOCK:
        items = list(_REGISTRY.items())
    return {name: m.to_dict() for name, m in sorted(items)}


def reset_metrics() -> None:
    """Drop all metrics (values AND registrations) — test/bench hygiene."""
    with _LOCK:
        _REGISTRY.clear()


def format_metrics() -> str:
    """Human-readable dump, one metric per line."""
    lines = []
    for name, d in snapshot().items():
        if d["kind"] == "histogram":
            lines.append(
                f"{name:<40s} hist  count={d['count']:<8g} mean={d['mean']:.4g} "
                f"p50={d['p50']:.4g} p99={d['p99']:.4g} max={d['max']:.4g}"
            )
        else:
            lines.append(f"{name:<40s} {d['kind']:<5s} {d['value']:g}")
    return "\n".join(lines)


def dump_jsonl(path: str) -> None:
    """One JSON object per metric per line (append-friendly, jq-able)."""
    with open(path, "w") as f:
        for d in snapshot().values():
            f.write(json.dumps(d, sort_keys=True) + "\n")
