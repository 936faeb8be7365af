"""Host-side spans and profiler annotations for the solver stack.

Two instruments, both strict no-ops until ``enable()``:

* :func:`span` — a host-side timed span. Spans nest into a tree (plan
  build; serving bucket > solve) and each span also opens a
  ``torch.profiler.record_function`` range, so the same region shows up
  under the same name in a ``torch.profiler`` trace.
* :func:`trace_scope` — ``torch.profiler.record_function(name)`` alone,
  for code whose wall time is not wanted as a span (a phase of the
  solver loop): it labels the launches inside it in a profile and adds
  no device work.

Host spans measure wall time with ``time.perf_counter`` around host
work; CUDA launches are asynchronous, so a span around a solve measures
end to end only if the code inside it synchronises (the serving worker
does, once per bucket).

State is process-local and thread-safe: each thread keeps its own open
span stack; finished root spans accumulate in one shared list read by
``span_tree()`` / ``dump_spans()``.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enable",
    "disable",
    "enabled",
    "span",
    "trace_scope",
    "Span",
    "span_tree",
    "clear_spans",
    "spans_to_dicts",
    "dump_spans",
]

_ENABLED = False
_LOCK = threading.Lock()
_ROOTS: List["Span"] = []
_TLS = threading.local()


def enable() -> None:
    """Turn observability on process-wide (spans record, metrics count)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn observability off; instruments revert to no-ops."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


@dataclass
class Span:
    """One timed region; children are spans opened while it was open."""

    name: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    t_start: float = 0.0
    t_end: float = 0.0
    children: List["Span"] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def find(self, name: str) -> Optional["Span"]:
        """First descendant (or self) with this name, depth-first."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


def _stack() -> List[Span]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _record_function(name: str):
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a named host span (and a profiler range) around a block.

    Yields the :class:`Span` (or None when disabled) so callers can attach
    attributes discovered mid-block: ``sp and sp.attrs.update(...)``.
    """
    if not _ENABLED:
        yield None
        return
    sp = Span(name=name, attrs=dict(attrs))
    st = _stack()
    st.append(sp)
    sp.t_start = time.perf_counter()
    try:
        with _record_function(name):
            yield sp
    finally:
        sp.t_end = time.perf_counter()
        st.pop()
        if st:
            st[-1].children.append(sp)
        else:
            with _LOCK:
                _ROOTS.append(sp)


def trace_scope(name: str):
    """``torch.profiler.record_function(name)`` when enabled, a
    nullcontext otherwise."""
    if not _ENABLED:
        return contextlib.nullcontext()
    return _record_function(name)


def span_tree() -> Tuple[Span, ...]:
    """All finished root spans, oldest first."""
    with _LOCK:
        return tuple(_ROOTS)


def clear_spans() -> None:
    with _LOCK:
        _ROOTS.clear()


def spans_to_dicts() -> List[dict]:
    return [s.to_dict() for s in span_tree()]


def dump_spans(path: str) -> None:
    """Write the span tree as JSON (one object, ``{"spans": [...]}``)."""
    with open(path, "w") as f:
        json.dump({"spans": spans_to_dicts()}, f, indent=2)
