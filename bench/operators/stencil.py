"""The paper's 3-D Poisson stencil operators, made on the device.

A frozen copy of ``repro_torch.sparse.stencil.poisson_dia``: an
``n**dim`` grid, a dense ``(2*radius+1)**dim`` stencil, one diagonal per
tap at offset ``sum_k tap_k * n**k``, off-diagonal taps -1 where every
coordinate stays inside the grid (Dirichlet truncation), and a centre of
the in-grid neighbour count plus ``sigma``. The entries are small
integers, so every dtype holds them exactly. The seed draws nothing.
"""
from __future__ import annotations

import itertools

import torch


def offsets(cfg: dict) -> tuple:
    dim, n, r = cfg["dim"], cfg["grid"], cfg["radius"]
    return tuple(sorted({sum(t * n**k for k, t in enumerate(tap))
                         for tap in itertools.product(range(-r, r + 1), repeat=dim)}))


def rows(cfg: dict) -> int:
    return cfg["grid"] ** cfg["dim"]


def band(cfg: dict, seed: int, device, dtype=torch.float32):
    """(offsets ascending, data (n_diags, N)) with ``data[j, i] = A[i, i + offsets[j]]``."""
    del seed
    dim, n, r, sigma = cfg["dim"], cfg["grid"], cfg["radius"], cfg["sigma"]
    N = n**dim
    offs = offsets(cfg)
    pos = {o: j for j, o in enumerate(offs)}
    data = torch.zeros((len(offs), N), dtype=dtype, device=device)
    idx = torch.arange(N, device=device)
    inside = {}
    for k in range(dim):
        c = (idx // n**k) % n
        for t in range(-r, r + 1):
            inside[k, t] = (c + t >= 0) & (c + t < n)
    minus_one = torch.tensor(-1.0, dtype=dtype, device=device)
    for tap in itertools.product(range(-r, r + 1), repeat=dim):
        if not any(tap):
            continue
        valid = inside[0, tap[0]]
        for k in range(1, dim):
            valid = valid & inside[k, tap[k]]
        row = data[pos[sum(t * n**k for k, t in enumerate(tap))]]
        row.copy_(torch.where(valid, minus_one, row))
    data[pos[0]] = -data.sum(dim=0) + sigma
    return offs, data
