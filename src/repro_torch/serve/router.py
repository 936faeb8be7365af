"""Plan-pool router: warm ``SolverPlan``s keyed by (operator, config, tol).

The middle of the async serving tier. A :class:`PlanPool` holds entries
keyed by

    (operator fingerprint, method, engine, M, tolerance bucket,
     maxiter, extra plan kwargs)

— :func:`repro_torch.plan.operator_fingerprint` is *content*-based, so
the same matrix built in two processes routes to the same key (what
warm-start manifests rely on). The fingerprint hashes the operator's
data through the host, so the pool memoises it per live object: a
multi-GB operator is hashed once, not per request. Tolerances are bucketed by decade
(:func:`tolerance_bucket`): requests in the same decade share one plan
and are batched together; a bucket's batch is solved at the tightest
tolerance in it, so no request is ever solved looser than it asked.

A pool miss builds the plan **asynchronously** on a builder thread —
traffic routed to already-warm plans never blocks behind a cold build
(the request-level form of the paper's communication hiding; the miss's
own requests queue behind the entry's ``ready`` event). A build on the
card loads the kernel library at its first launch, behind the library's
lock. Eviction is LRU
with in-flight pinning: an entry being served (``entry.pinned()``) or
still building is never evicted; victims go through the pool's
``on_evict`` hook so the serving layer can drain their queues gracefully.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Optional, Tuple

from ..obs import metrics as _metrics

__all__ = ["PlanEntry", "PlanPool", "pool_key", "tolerance_bucket"]


def tolerance_bucket(atol: float) -> float:
    """Decade bucket for a tolerance: 3e-6 -> 1e-6, 5e-5 -> 1e-5.

    The bucket's nominal value is the decade's lower edge, so a batch
    solved at it is at least as tight as every request it carries.
    Non-positive tolerances (pure rtol / run-to-maxiter) map to 0.0.
    """
    if atol is None or atol <= 0.0:
        return 0.0
    return 10.0 ** math.floor(math.log10(atol))


def pool_key(fingerprint: str, config: dict) -> tuple:
    """The pool's routing key for an operator fingerprint + plan config.

    ``config`` is the :meth:`SolverPlan.config` shape (method/engine/M/
    atol/rtol/maxiter + extra kwargs). Stable across processes for
    content-fingerprinted operators — the warm-start round-trip test
    asserts a manifest-rebuilt plan lands on the identical key.
    """
    cfg = dict(config)
    method = cfg.pop("method", "pipecg")
    engine = cfg.pop("engine", "auto")
    M = cfg.pop("M", "jacobi")
    atol = cfg.pop("atol", 1e-5)
    rtol = cfg.pop("rtol", 0.0)
    maxiter = cfg.pop("maxiter", 10000)
    extras = tuple(sorted((k, v) for k, v in cfg.items() if v is not None))
    if rtol:
        extras += (("rtol", float(rtol)),)
    return (fingerprint, method, engine, M, tolerance_bucket(atol),
            int(maxiter), extras)


class PlanEntry:
    """One pooled plan: key, build state, pin count.

    ``plan`` is None until the builder thread finishes; waiters block on
    ``ready`` and then check ``error``. ``pinned()`` guards an in-flight
    solve against eviction.
    """

    def __init__(self, key: tuple, config: dict):
        self.key = key
        self.config = dict(config)
        self.plan = None
        self.error: Optional[BaseException] = None
        self.ready = threading.Event()
        self.build_s: Optional[float] = None
        self._pins = 0
        self._lock = threading.Lock()

    @property
    def tol(self) -> float:
        """The tolerance this entry's buckets are solved at (decade edge)."""
        return self.key[4]

    @property
    def pins(self) -> int:
        with self._lock:
            return self._pins

    @contextmanager
    def pinned(self):
        with self._lock:
            self._pins += 1
        try:
            yield self
        finally:
            with self._lock:
                self._pins -= 1

    def wait(self, timeout: Optional[float] = None):
        """Block until built; returns the plan or raises the build error."""
        if not self.ready.wait(timeout):
            raise TimeoutError(f"plan build for {self.key!r} still running")
        if self.error is not None:
            raise self.error
        return self.plan


class PlanPool:
    """LRU pool of warm plans with async builds and pinned eviction.

    ``get_or_create(A, config)`` routes to the existing entry (hit) or
    inserts a building entry and kicks a daemon builder thread (miss) —
    the call never blocks on a plan build, so warm-plan traffic keeps
    flowing while a cold plan is set up. ``adopt`` inserts an already-built
    plan under the same key a ``get_or_create`` would compute (the
    warm-start path). ``on_evict(entry)`` fires outside the pool lock.
    """

    def __init__(self, max_plans: int = 8,
                 on_evict: Optional[Callable[[PlanEntry], None]] = None):
        if max_plans < 1:
            raise ValueError(f"max_plans must be >= 1, got {max_plans}")
        self.max_plans = int(max_plans)
        self.on_evict = on_evict
        self._entries: "OrderedDict[tuple, PlanEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self._fp_lock = threading.Lock()  # one hash per operator, whoever asks first
        self._fp_cache: dict = {}  # id(A) -> (A, fingerprint)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> Tuple[PlanEntry, ...]:
        with self._lock:
            return tuple(self._entries.values())

    def fingerprint(self, A) -> str:
        """Content fingerprint of ``A``, memoized per live object (the
        memo holds ``A``, so its id cannot be reused while it lives)."""
        from ..plan import operator_fingerprint

        with self._fp_lock:
            hit = self._fp_cache.get(id(A))
            if hit is not None and hit[0] is A:
                return hit[1]
            fp = operator_fingerprint(A)
            if len(self._fp_cache) > 4 * self.max_plans:  # stale-id hygiene
                self._fp_cache.clear()
            self._fp_cache[id(A)] = (A, fp)
            _metrics.counter("serve.router.fingerprints").inc()
            return fp

    def lookup(self, key: tuple) -> Optional[PlanEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def get_or_create(self, A, config: dict) -> Tuple[PlanEntry, bool]:
        """Route to the entry for (A, config); returns (entry, created).

        On a miss the entry is inserted immediately (so concurrent
        requests pile onto ONE build) and a daemon thread builds the
        plan; ``entry.ready``/``entry.error`` publish the outcome.
        """
        key = pool_key(self.fingerprint(A), config)
        evicted = []
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                _metrics.counter("serve.router.hits").inc()
                return entry, False
            _metrics.counter("serve.router.misses").inc()
            entry = PlanEntry(key, config)
            self._entries[key] = entry
            evicted = self._evict_locked()
            _metrics.gauge("serve.router.plans").set(len(self._entries))
        for victim in evicted:
            self._notify_evict(victim)
        threading.Thread(
            target=self._build, args=(entry, A),
            name=f"plan-build-{key[0][:8]}", daemon=True,
        ).start()
        return entry, True

    def adopt(self, A, plan, fingerprint: Optional[str] = None) -> PlanEntry:
        """Insert an already-built plan (warm start) under its routing key.
        ``fingerprint``, when the caller has verified it (a manifest
        entry's), seeds the memo instead of hashing ``A`` again."""
        config = plan.config()
        if fingerprint is not None:
            with self._fp_lock:
                self._fp_cache[id(A)] = (A, fingerprint)
        key = pool_key(self.fingerprint(A), config)
        entry = PlanEntry(key, config)
        entry.plan = plan
        entry.ready.set()
        evicted = []
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._entries.move_to_end(key)
                return existing
            self._entries[key] = entry
            evicted = self._evict_locked()
            _metrics.gauge("serve.router.plans").set(len(self._entries))
        for victim in evicted:
            self._notify_evict(victim)
        return entry

    def _build(self, entry: PlanEntry, A) -> None:
        import time as _time

        from ..plan import plan as _plan

        t0 = _time.perf_counter()
        try:
            entry.plan = _plan(A, **entry.config)
        except BaseException as e:  # publish, don't kill the thread silently
            entry.error = e
            _metrics.counter("serve.router.build_errors").inc()
        finally:
            entry.build_s = _time.perf_counter() - t0
            _metrics.histogram("serve.router.build_s").record(entry.build_s)
            entry.ready.set()

    def _evict_locked(self) -> list:
        """LRU eviction skipping pinned/building entries; returns victims."""
        victims = []
        while len(self._entries) > self.max_plans:
            victim_key = None
            for key, entry in self._entries.items():  # LRU order
                if entry.pins == 0 and entry.ready.is_set():
                    victim_key = key
                    break
            if victim_key is None:
                # everything pinned or building: soft cap, try again later
                _metrics.counter("serve.router.evict_blocked").inc()
                break
            victims.append(self._entries.pop(victim_key))
            _metrics.counter("serve.router.evictions").inc()
        return victims

    def _notify_evict(self, entry: PlanEntry) -> None:
        if self.on_evict is not None:
            try:
                self.on_evict(entry)
            except Exception:
                pass
