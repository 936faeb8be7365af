"""repro_torch.obs — solver telemetry: spans, metrics, solve reports.

Off by default and free while off:

    import repro_torch.obs as obs

    obs.enable()                      # spans record, metrics count
    p = repro_torch.plan(A, method="pipecg")
    res = p.solve(b)                  # synchronised + timed under a span
    print(p.last_report.summary())    # curve, launches/step, GB/s, ...
    srv.submit(A, b).result()         # serving counters, histograms, spans
    print(obs.format_metrics())       # plan cache, buckets, queue waits, ...
    obs.dump_spans("spans.json"); obs.dump_jsonl("metrics.jsonl")

    obs.enable(reports=False)         # spans and counters; nothing syncs

* ``trace``   — host-side span trees on ``time.monotonic_ns()``: name,
  id, parent, thread, start, end and counts, recorded without waiting for
  the device (the benchmark maps them onto its device trace). Spans sit
  at the layer boundaries: ``plan.solve``/``plan.solve_batched`` >
  ``pipecg.init``, ``pipecg.loop`` > ``pipecg.poll``; ``serve.admit``,
  ``serve.queue`` (per request), ``serve.wait``, ``serve.bucket`` >
  ``serve.assemble``, the plan's spans, ``serve.sync``,
  ``serve.readback``, ``serve.deliver``.
* ``metrics`` — process-local counters/gauges/histograms with JSON-lines
  and human-readable sinks; strict no-ops while disabled.
* ``report``  — :class:`SolveReport` built from a ``SolveResult`` and the
  plan, :func:`convergence_curve` (the one NaN-trim implementation),
  ``iterations_from_history`` (per-rhs counts from the NaN tails), the
  environment fingerprint (torch, CUDA, the card, its power limit) and
  the kernel launch census.
"""
from __future__ import annotations

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    counter,
    dump_jsonl,
    format_metrics,
    gauge,
    histogram,
    metric_names,
    reset_metrics,
    snapshot,
)
from .report import (  # noqa: F401
    SolveReport,
    comparable_env,
    convergence_curve,
    env_fingerprint,
    iterations_from_history,
    plan_launches_per_iteration,
    solve_report,
    structural_bytes_per_elem,
)
from .trace import (  # noqa: F401
    Span,
    clear_spans,
    disable,
    dump_spans,
    enable,
    enabled,
    record_span,
    reports,
    span,
    span_tree,
    spans_to_dicts,
)

__all__ = [
    # switch
    "enable", "disable", "enabled", "reports",
    # spans
    "span", "record_span", "Span", "span_tree", "clear_spans",
    "spans_to_dicts", "dump_spans",
    # metrics
    "counter", "gauge", "histogram", "metric_names", "snapshot",
    "reset_metrics", "format_metrics", "dump_jsonl",
    "Counter", "Gauge", "Histogram",
    # report
    "SolveReport", "solve_report", "convergence_curve",
    "iterations_from_history", "env_fingerprint", "comparable_env",
    "structural_bytes_per_elem", "plan_launches_per_iteration",
]
