"""Admission queue + batching policy for the async serving tier.

The front half of ``serve.server.SolverServer``:
requests are admitted into a bounded :class:`RequestQueue` and a worker
pops them in *buckets* — a bucket closes when it reaches ``max_batch``
(full) or when ``max_wait`` has elapsed since its first request arrived
(timeout). That is the request-level version of the paper's overlap
argument: admission and batching proceed while the previous bucket's
solve is still in flight on device, so queue management hides behind
useful compute instead of serializing with it.

Deliberately thread+condvar based, with ``concurrent.futures.Future``
results — no hard asyncio dependency in the core. An asyncio front end
wraps a submitted future with ``asyncio.wrap_future``.

Backpressure is explicit and observable: a full queue raises
:class:`QueueFull` at ``put`` (never silent dropping, never unbounded
growth), a closed queue raises :class:`ServerClosed`, and a request whose
deadline expired before its bucket was served fails with
:class:`DeadlineExceeded`. Every rejection increments a per-reason
``serve.rejects.<reason>`` counter; queue depth, per-request wait time
and bucket close reasons land in ``repro_torch.obs.metrics`` gauges/
histograms/counters (no-ops while observability is disabled).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

from ..obs import metrics as _metrics

__all__ = [
    "DeadlineExceeded",
    "QueueFull",
    "RequestQueue",
    "ServerClosed",
    "SolveRequest",
]


class QueueFull(RuntimeError):
    """Admission rejected: the bounded queue is at ``max_depth``."""


class ServerClosed(RuntimeError):
    """Admission rejected: the queue/server no longer accepts requests."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its bucket was served."""


def reject(reason: str, n: int = 1) -> None:
    """Count a rejection under ``serve.rejects.<reason>``."""
    _metrics.counter(f"serve.rejects.{reason}").inc(n)


@dataclass
class SolveRequest:
    """One queued right-hand side: payload + tolerance + deadline + future.

    ``deadline`` is an absolute ``time.monotonic()`` instant (None = no
    deadline). ``future`` resolves to the per-request result the server
    builds from its bucket's solve; callers block on it (or wrap it for
    asyncio).
    """

    b: object
    atol: float
    rtol: float = 0.0
    deadline: Optional[float] = None
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)


class RequestQueue:
    """Bounded FIFO admission queue with a bucket-closing pop policy.

    * ``put`` — O(1) admit; raises :class:`QueueFull` past ``max_depth``
      and :class:`ServerClosed` after :meth:`close` (both counted).
    * ``next_batch(max_batch, max_wait)`` — block for the next bucket:
      the bucket closes on ``max_batch`` requests (``closed_full``) or
      ``max_wait`` seconds after its FIRST request arrived
      (``closed_timeout``), whichever comes first. Requests whose
      deadline already passed are failed + counted, not returned.
    * ``close`` — stop admitting; queued requests still drain (graceful
      shutdown leaves zero dropped requests). ``next_batch`` returns
      ``None`` once closed *and* drained.
    """

    def __init__(self, max_depth: int = 256, name: str = "serve.queue"):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self.name = name
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def put(self, req: SolveRequest) -> None:
        with self._cond:
            if self._closed:
                reject("shutdown")
                raise ServerClosed(f"{self.name} is closed to new requests")
            if len(self._items) >= self.max_depth:
                reject("queue_full")
                raise QueueFull(
                    f"{self.name} at max_depth={self.max_depth}; retry later "
                    "(backpressure, not silent queue growth)"
                )
            self._items.append(req)
            _metrics.gauge(f"{self.name}.depth").set(len(self._items))
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def next_batch(self, max_batch: int, max_wait: float) -> Optional[List[SolveRequest]]:
        """Pop the next bucket (see class docstring). ``None`` = drained+closed.

        May return an empty list when every popped request had an expired
        deadline — callers just loop.
        """
        with self._cond:
            while not self._items and not self._closed:
                self._cond.wait(0.05)
            if not self._items:
                return None  # closed and fully drained
            batch = [self._items.popleft()]
            t_close = batch[0].enqueued_at + max_wait
            while len(batch) < max_batch:
                if self._items:
                    batch.append(self._items.popleft())
                    continue
                now = time.monotonic()
                if self._closed or now >= t_close:
                    break
                self._cond.wait(min(t_close - now, 0.05))
            _metrics.gauge(f"{self.name}.depth").set(len(self._items))
            _metrics.counter(
                f"{self.name}.closed_full" if len(batch) >= max_batch
                else f"{self.name}.closed_timeout"
            ).inc()
        now = time.monotonic()
        live: List[SolveRequest] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                reject("deadline")
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed {now - r.deadline:.3f}s before the "
                    "bucket was served"
                ))
                continue
            _metrics.histogram(f"{self.name}.wait_ms").record(
                (now - r.enqueued_at) * 1e3
            )
            live.append(r)
        return live

    def fail_all(self, exc: BaseException) -> int:
        """Fail every queued request (plan build error); returns the count."""
        with self._cond:
            items, self._items = list(self._items), deque()
            _metrics.gauge(f"{self.name}.depth").set(0)
        for r in items:
            r.future.set_exception(exc)
        reject("plan_error", len(items))
        return len(items)
