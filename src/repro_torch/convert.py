"""Carry an operator across from numpy arrays (e.g. the JAX package's).

The tests build an operator or preconditioner with the JAX package, take
its numpy arrays, and hand them to the port through these functions;
nothing here imports JAX. ``device`` is required (``None`` means CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.preconditioners import BlockJacobiPC, JacobiPC
from .kernels.common import resolve_device
from .sparse.formats import BellMatrix, CSRMatrix, DIAMatrix

__all__ = [
    "dia_from_arrays",
    "bell_from_arrays",
    "csr_from_arrays",
    "jacobi_from_arrays",
    "block_jacobi_from_arrays",
]


def _tensor(a: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))  # JAX's arrays are read-only
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def dia_from_arrays(data: np.ndarray, offsets, n: int, *, device,
                    dtype: torch.dtype | None = None) -> DIAMatrix:
    """A ``DIAMatrix`` from a (k, n) numpy array and its offsets."""
    data = np.asarray(data)
    offsets = tuple(int(o) for o in offsets)
    if data.shape != (len(offsets), int(n)):
        raise ValueError(f"data shape {data.shape} != ({len(offsets)}, {n})")
    return DIAMatrix(_tensor(data, device, dtype), offsets, int(n))


def bell_from_arrays(cols: np.ndarray, vals: np.ndarray, n: int, *, device,
                     dtype: torch.dtype | None = None) -> BellMatrix:
    """A ``BellMatrix`` from (n, R) numpy column ids and values."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[0] != int(n):
        raise ValueError(f"cols {cols.shape} and vals {vals.shape} must both be ({n}, R)")
    return BellMatrix(_tensor(cols, device, torch.int32), _tensor(vals, device, dtype), int(n))


def csr_from_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, *, device,
                    dtype: torch.dtype | None = None) -> CSRMatrix:
    """A ``CSRMatrix`` from parallel (nnz,) numpy row ids (sorted), column
    ids and values."""
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    if not (rows.ndim == 1 and rows.shape == cols.shape == vals.shape):
        raise ValueError(f"rows {rows.shape}, cols {cols.shape}, vals {vals.shape} must be (nnz,)")
    return CSRMatrix(_tensor(rows, device, torch.int32), _tensor(cols, device, torch.int32),
                     _tensor(vals, device, dtype), int(n))


def jacobi_from_arrays(inv_diag: np.ndarray, *, device) -> JacobiPC:
    """A ``JacobiPC`` from a numpy inverse diagonal."""
    return JacobiPC(inv_diag=_tensor(inv_diag, device))


def block_jacobi_from_arrays(inv_blocks: np.ndarray, block: int, *, device) -> BlockJacobiPC:
    """A ``BlockJacobiPC`` from (n // block, block, block) numpy inverse blocks."""
    inv_blocks = np.asarray(inv_blocks)
    if inv_blocks.ndim != 3 or inv_blocks.shape[1:] != (block, block):
        raise ValueError(f"inv_blocks shape {inv_blocks.shape} != (nb, {block}, {block})")
    return BlockJacobiPC(inv_blocks=_tensor(inv_blocks, device), block=int(block))
