"""The one traffic generator: right-hand sides and arrival times from the seed.

A traffic mix (``traffic/<name>.json``) is data:

* ``entry``: ``"plan"`` (``plan.solve`` called directly) or ``"server"``
  (``SolverServer.submit``), with ``server``: its ``max_batch`` and
  ``max_wait_ms``;
* ``loop``: ``"closed"`` with one client (``plan``: the next right side
  when the last answer returns) or ``"open"`` with ``rate_per_s``
  (``server``: Poisson arrivals on a schedule, whatever the system does);
* ``rhs``: ``b = s * r / sqrt(N)``, r standard normal, s log-uniform over
  [``scale_lo``, ``scale_hi``] (a time-stepper's or an ensemble's right
  sides).

Request ``i`` of a run draws its ``r`` from a device generator seeded by
``(seed, i)``, so the reference can draw the same b again after the
window without taking it from the program. An open loop's gaps between
arrivals are independent exponential draws at the mix's rate, from the
seed: a Poisson process, bursts included.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

__all__ = ["derive_seed", "RhsSource", "arrival_offsets", "Reservoir"]

_KEYS = {"operator": 1, "rhs": 2, "scale": 3, "arrivals": 4, "sample": 5, "warmup": 6}
_M64 = 2**64 - 1


def _mix(z: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit words that scatters bits."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def derive_seed(seed: int, key: str, *index: int) -> int:
    """A 63-bit seed for one purpose (and index) of a run's ``--seed``
    (cheap enough to draw per request on the client's path)."""
    z = _mix((int(seed) & _M64) ^ (_KEYS[key] << 58))
    for i in index:
        z = _mix(z ^ (int(i) & _M64))
    return z >> 1


class RhsSource:
    """Request i's right side: ``b = s_i * r_i / sqrt(N)`` on ``device``."""

    def __init__(self, n: int, seed: int, spec: dict, device, *, key: str = "rhs"):
        self.n = int(n)
        self.seed = int(seed)
        self.key = key
        self.lo = math.log(spec["scale_lo"])
        self.hi = math.log(spec["scale_hi"])
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def scale(self, i: int) -> float:
        u = (derive_seed(self.seed, "scale", i) >> 10) / 2.0**53  # uniform on [0, 1)
        return math.exp(self.lo + (self.hi - self.lo) * u) / math.sqrt(self.n)

    def make(self, i: int) -> torch.Tensor:
        self.gen.manual_seed(derive_seed(self.seed, self.key, i))
        r = torch.randn(self.n, generator=self.gen, device=self.device)
        return r.mul_(self.scale(i))


def arrival_offsets(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds after the window opens) of an open loop: the
    cumulative sum of independent exponential gaps at ``rate_per_s``,
    drawn from the seed, cut at ``seconds``."""
    rng = np.random.default_rng(derive_seed(seed, "arrivals"))
    due = np.empty(0)
    while not due.size or due[-1] < seconds:
        gaps = rng.exponential(1.0 / rate_per_s, int(rate_per_s * seconds) + 64)
        due = np.concatenate([due, (due[-1] if due.size else 0.0) + np.cumsum(gaps)])
    return due[due < seconds]


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from the
    seed (Algorithm R), so the answers checked after the window are a sample
    of every answer due in it and memory stays bounded."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.items: list = []
        self.seen = 0
        self.rng = random.Random(derive_seed(seed, "sample"))

    def slot(self) -> int | None:
        """The slot the next item takes, or None where it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None
