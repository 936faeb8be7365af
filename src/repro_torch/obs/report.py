"""Per-solve figures derived from a ``SolveResult``.

Of the JAX package's ``obs/report.py`` only the NaN-tail iteration count
is ported (the serving tier needs it); ``SolveReport`` and the plan's
obs-enabled solve bookkeeping wait for the telemetry slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["iterations_from_history"]


def iterations_from_history(history):
    """Per-solve iteration counts derived from the NaN tail of history.

    1-D -> int; 2-D (k, maxiter+1) -> int64 array of shape (k,). Takes a
    tensor on any device or a numpy array; a batched solve's lanes each
    carry their own NaN tail, so the counts are honest per rhs even
    though the bucket's wall clock is shared.
    """
    if hasattr(history, "detach"):
        history = history.detach().cpu().numpy()
    h = np.asarray(history, dtype=np.float64)
    valid = (~np.isnan(h)).sum(axis=-1)
    iters = np.maximum(valid - 1, 0)
    if h.ndim == 1:
        return int(iters)
    return iters.astype(np.int64)
