"""Carry an operator across from numpy arrays (e.g. the JAX package's).

The tests build an operator with the JAX package, take its numpy
arrays, and hand them to the port through these functions; nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.preconditioners import JacobiPC
from .kernels.common import resolve_device
from .sparse.formats import DIAMatrix

__all__ = ["dia_from_arrays", "jacobi_from_arrays"]


def dia_from_arrays(data: np.ndarray, offsets, n: int, *, device,
                    dtype: torch.dtype | None = None) -> DIAMatrix:
    """A ``DIAMatrix`` from a (k, n) numpy array and its offsets."""
    data = np.asarray(data)
    offsets = tuple(int(o) for o in offsets)
    if data.shape != (len(offsets), int(n)):
        raise ValueError(f"data shape {data.shape} != ({len(offsets)}, {n})")
    t = torch.from_numpy(np.array(data, copy=True))  # JAX's arrays are read-only
    if dtype is not None:
        t = t.to(dtype)
    return DIAMatrix(t.to(resolve_device(device)), offsets, int(n))


def jacobi_from_arrays(inv_diag: np.ndarray, *, device) -> JacobiPC:
    """A ``JacobiPC`` from a numpy inverse diagonal."""
    t = torch.from_numpy(np.array(inv_diag, copy=True))
    return JacobiPC(inv_diag=t.to(resolve_device(device)))
