"""Host-side spans for the solver stack, on the host's monotonic clock.

Off by default, and off a span site costs one predicate check:
:func:`span` returns a shared no-op context. On (``enable()``), each span
records its name, an id, its parent's id, the thread that opened it, its
start and end from ``time.monotonic_ns()`` (the clock of
``SolveRequest.enqueued_at``) and its attributes, the counts of the
region. Recording never waits for the device: a span around CUDA
launches times their enqueue, so on the card a span's end is when the
host moved on, which is what a device trace on the same clock needs to
charge the device's idle gaps to what the host was doing.

:func:`record_span` records a span with explicit start and end (a
request's queue wait, which begins on the thread that admitted it and
ends on the worker's); it belongs to no thread.

``enable(reports=False)`` records spans and counters only; ``enable()``
also lets the plan synchronise and time each solve and build its
``SolveReport`` (:func:`reports`).

State is process-local and thread-safe: each thread keeps its own open
span stack; finished root spans accumulate in one shared list, read by
``span_tree()`` / ``dump_spans()`` until ``clear_spans()``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enable",
    "disable",
    "enabled",
    "reports",
    "span",
    "record_span",
    "Span",
    "span_tree",
    "clear_spans",
    "spans_to_dicts",
    "dump_spans",
]

_ENABLED = False
_REPORTS = True
_LOCK = threading.Lock()
_ROOTS: List["Span"] = []
_TLS = threading.local()
_IDS = itertools.count(1)


def enable(reports: bool = True) -> None:
    """Turn observability on process-wide: spans record, metrics count.
    With ``reports`` a plan also synchronises and times each solve and
    keeps its ``SolveReport``; without, nothing waits for the device."""
    global _ENABLED, _REPORTS
    _REPORTS = bool(reports)
    _ENABLED = True


def disable() -> None:
    """Turn observability off; instruments revert to no-ops."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reports() -> bool:
    """Whether solves are synchronised, timed and reported."""
    return _ENABLED and _REPORTS


def _stack() -> List["Span"]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@dataclass(eq=False)
class Span:
    """One timed region; children are spans opened in it on its thread.
    Used as a context manager (:func:`span`), it takes its parent and
    thread from the thread that enters it."""

    name: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    span_id: int = field(default_factory=lambda: next(_IDS))
    parent_id: Optional[int] = None
    thread: Optional[int] = None
    start_ns: int = 0
    end_ns: int = 0
    children: List["Span"] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return max(self.end_ns - self.start_ns, 0) * 1e-9

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        self.thread = threading.get_ident()
        st.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.monotonic_ns()
        st = _stack()
        st.pop()
        if st:
            st[-1].children.append(self)
        else:
            with _LOCK:
                _ROOTS.append(self)
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "thread": self.thread,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
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


class _Off:
    """The context of every span site while observability is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A named host span around a block (``with span(...) as sp``).

    ``sp`` is the :class:`Span`, or None when disabled, so callers can
    attach attributes found mid-block: ``if sp is not None:
    sp.attrs.update(...)``.
    """
    if not _ENABLED:
        return _OFF
    return Span(name, attrs)


def record_span(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a finished root span with explicit ``time.monotonic_ns()``
    bounds, on no thread (a no-op when disabled)."""
    if not _ENABLED:
        return
    sp = Span(name, attrs, start_ns=int(start_ns), end_ns=int(end_ns))
    with _LOCK:
        _ROOTS.append(sp)


def span_tree() -> Tuple[Span, ...]:
    """All finished root spans, in the order they finished."""
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
