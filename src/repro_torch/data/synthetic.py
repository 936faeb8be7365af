"""Deterministic synthetic token pipeline with host-side prefetch.

A copy of the JAX package's ``repro/data/synthetic.py``: numpy only, so
the port's batches are bit-identical to the reference's.

Determinism contract: the batch for (seed, step) is a pure function — a
restarted or re-elastically-sharded job consumes byte-identical data, which
is what makes checkpoint/restart exact (runtime/fault_tolerance.py).

Prefetch: a background thread keeps ``depth`` batches ready (generation
overlaps device compute — the paper's hide-the-transfer discipline applied
to the input pipeline).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["SyntheticConfig", "batch_for_step", "prefetch_batches"]


@dataclass(frozen=True)
class SyntheticConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def batch_for_step(dc: SyntheticConfig, step: int, cfg: Optional[ArchConfig] = None) -> dict:
    """Markov-ish token stream (not uniform noise, so loss can decrease)."""
    rng = _rng_for(dc.seed, step)
    B, T, V = dc.batch, dc.seq_len, dc.vocab_size
    # piecewise-linear token process: next ~ prev + small step (mod V)
    start = rng.integers(0, V, size=(B, 1))
    steps = rng.integers(-3, 4, size=(B, T))
    tokens = (start + np.cumsum(steps, axis=1)) % V
    out = {"tokens": tokens.astype(np.int32)}
    if cfg is not None and cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.02
    if cfg is not None and cfg.family == "vlm":
        out["img_feats"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return out


def prefetch_batches(
    dc: SyntheticConfig,
    start_step: int,
    n_steps: int,
    cfg: Optional[ArchConfig] = None,
    depth: int = 2,
    place=None,
) -> Iterator[dict]:
    """Host-prefetched iterator; ``place`` optionally maps a host batch to
    device tensors (e.g. ``lambda b: {k: torch.from_numpy(v).to(dev) ...}``)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def producer():
        for s in range(start_step, start_step + n_steps):
            b = batch_for_step(dc, s, cfg)
            if place is not None:
                b = place(b)
            q.put(b)
        q.put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
