"""Performance model — paper §IV-C1, for N devices.

The paper times 5 SPMV executions on the CPU and on the GPU, converts
them to throughputs s_dev = nnz / t_dev and splits nnz in proportion.
Here the same model drives (a) the row partition of a mesh that mixes
the card and the host's cores (``decompose(A, n, weights=...)``) and (b)
continuous re-balancing: :class:`StragglerTracker` keeps an EWMA of each
device's step time and proposes new weights when the imbalance passes a
threshold (a slow device gets fewer rows).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..sparse.formats import DIAMatrix
from ..sparse.partition import balanced_nnz
from .distributed import _window_spmv

__all__ = ["measure_spmv_time", "relative_weights", "decompose", "StragglerTracker"]


def measure_spmv_time(A: DIAMatrix, runs: int = 5, rows: Optional[int] = None) -> float:
    """Median seconds of ``runs`` SPMVs of ``A`` on its own device (the
    paper: 5 runs, so later iterations' cache effects are represented).

    Each device runs the SPMV its shard runs: on a card the ``spmv_dia``
    kernel, each run timed with CUDA events; on the host the windowed
    multiply-adds over the zero-padded vector (``core.distributed``'s host
    path), timed with ``time.perf_counter``. ``rows`` times the block of
    the first ``rows`` rows instead of the whole operator (the size a
    shard would get). One untimed call first (the card's: the kernel build
    and load).
    """
    n = A.n if rows is None else int(rows)
    data = A.data if n == A.n else A.data[:, :n].contiguous()
    hw = A.bandwidth
    if A.device.type == "cuda":
        from ..kernels.spmv_dia import spmv_dia_cuda

        block = DIAMatrix(data, A.offsets, n)
        x = torch.ones(n, dtype=A.dtype, device=A.device)

        def call():
            spmv_dia_cuda(block, x)
    else:
        v = torch.nn.functional.pad(torch.ones(n, dtype=A.dtype), (hw, hw))

        def call():
            _window_spmv(data, A.offsets, v, hw, n)

    call()
    times = []
    if A.device.type == "cuda":
        torch.cuda.synchronize(A.device)
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(runs):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def relative_weights(times_or_speeds: np.ndarray, *, are_times: bool = True) -> np.ndarray:
    """r_dev = s_dev / sum(s): the paper's relative-performance formula."""
    v = np.asarray(times_or_speeds, dtype=np.float64)
    speeds = 1.0 / v if are_times else v
    return speeds / speeds.sum()


def decompose(A: DIAMatrix, n_parts: int, weights: np.ndarray | None = None) -> np.ndarray:
    """Row boundaries so nnz per part ~ weight (the paper's N_cpu derivation)."""
    row_nnz = (A.data != 0).sum(dim=0).cpu().numpy()
    return balanced_nnz(row_nnz, n_parts, weights)


@dataclass
class StragglerTracker:
    """EWMA per-device step-time tracker -> re-partition trigger.

    The paper's performance model run continuously: feed the observed
    per-device times each step; when max/min EWMA exceeds
    ``imbalance_threshold`` the tracker recommends new weights (inverse
    EWMA times).
    """

    n_devices: int
    alpha: float = 0.2
    imbalance_threshold: float = 1.25
    ewma: np.ndarray | None = field(default=None)

    def update(self, step_times: np.ndarray) -> None:
        t = np.asarray(step_times, dtype=np.float64)
        if self.ewma is None:
            self.ewma = t.copy()
        else:
            self.ewma = self.alpha * t + (1 - self.alpha) * self.ewma

    @property
    def imbalance(self) -> float:
        if self.ewma is None:
            return 1.0
        return float(self.ewma.max() / max(self.ewma.min(), 1e-12))

    def needs_rebalance(self) -> bool:
        return self.imbalance > self.imbalance_threshold

    def proposed_weights(self) -> np.ndarray:
        if self.ewma is None:
            return np.ones(self.n_devices) / self.n_devices
        return relative_weights(self.ewma, are_times=True)
