"""Stencil matrix generators (the paper's Poisson problems).

A d-dimensional grid of side ``n`` with a ``(2*radius+1)**d``-point
stencil gives one diagonal per stencil tap at offset
``sum_k tap_k * n**k``. The data is built in numpy float64 exactly as
the JAX package builds it, then cast and moved to the device, so both
packages hold the same bits.

SPD: off-diagonal taps are ``-1`` and the centre tap is the count of
neighbours inside the grid plus ``sigma > 0``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..kernels.common import resolve_device
from .formats import DIAMatrix

__all__ = ["poisson_dia", "poisson125", "poisson27", "poisson7", "stencil_offsets"]


def stencil_offsets(dim: int, n: int, radius: int) -> list[int]:
    """Linearized offsets of a dense (2r+1)^dim stencil on an n^dim grid."""
    offs = []
    for tap in itertools.product(range(-radius, radius + 1), repeat=dim):
        offs.append(sum(t * n**k for k, t in enumerate(tap)))
    return sorted(set(offs))


def _to_dia(data: np.ndarray, offsets, N: int, device, dtype) -> DIAMatrix:
    t = torch.from_numpy(data).to(dtype)
    return DIAMatrix(t.to(device), tuple(offsets), N)


def poisson_dia(dim: int, n: int, radius: int, sigma: float = 1.0, *, device=None,
                dtype: torch.dtype = torch.float32) -> DIAMatrix:
    """SPD stencil operator on an ``n**dim`` grid in DIA storage.

    Dirichlet truncation in grid coordinates: a tap is dropped when any
    coordinate leaves the grid. ``device=None`` means CUDA.
    """
    device = resolve_device(device)
    N = n**dim
    taps = [t for t in itertools.product(range(-radius, radius + 1), repeat=dim) if any(t)]
    offsets = stencil_offsets(dim, n, radius)
    pos = {o: j for j, o in enumerate(offsets)}
    data = np.zeros((len(offsets), N), dtype=np.float64)
    idx = np.arange(N)
    coords = [(idx // n**k) % n for k in range(dim)]
    for tap in taps:
        off = sum(t * n**k for k, t in enumerate(tap))
        valid = np.ones(N, dtype=bool)
        for k, t in enumerate(tap):
            c = coords[k] + t
            valid &= (c >= 0) & (c < n)
        data[pos[off], valid] = -1.0
    data[pos[0]] = -data.sum(axis=0) + sigma
    return _to_dia(data, offsets, N, device, dtype)


def poisson7(n: int, sigma: float = 1.0, *, device=None,
             dtype: torch.dtype = torch.float32) -> DIAMatrix:
    """3-D 7-point star stencil (the classic Laplacian plus sigma)."""
    device = resolve_device(device)
    N = n**3
    offsets = sorted({0, 1, -1, n, -n, n * n, -(n * n)})
    pos = {o: j for j, o in enumerate(offsets)}
    data = np.zeros((len(offsets), N), dtype=np.float64)
    idx = np.arange(N)
    coords = [(idx // n**k) % n for k in range(3)]
    for k in range(3):
        for t in (-1, 1):
            c = coords[k] + t
            data[pos[t * n**k], (c >= 0) & (c < n)] = -1.0
    data[pos[0]] = -data.sum(axis=0) + sigma
    return _to_dia(data, offsets, N, device, dtype)


def poisson27(n: int, sigma: float = 1.0, *, device=None,
              dtype: torch.dtype = torch.float32) -> DIAMatrix:
    return poisson_dia(3, n, radius=1, sigma=sigma, device=device, dtype=dtype)


def poisson125(n: int, sigma: float = 1.0, *, device=None,
               dtype: torch.dtype = torch.float32) -> DIAMatrix:
    """The paper's 125-point (5x5x5) Poisson-class operator, nnz/N ~ 122."""
    return poisson_dia(3, n, radius=2, sigma=sigma, device=device, dtype=dtype)
