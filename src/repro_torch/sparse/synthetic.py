"""Synthetic SPD matrices standing in for the paper's SuiteSparse set.

The seven Table-I matrices are replaced by synthetic banded SPD matrices
matched in N and nnz/N (and shown under the same names). The generator
draws random banded symmetric off-diagonals and makes the matrix
strictly diagonally dominant, hence SPD. The data is drawn in numpy
float64 with ``np.random.default_rng(seed)`` exactly as the JAX package
draws it, then cast and moved to the device, so both packages hold the
same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.common import resolve_device
from .formats import DIAMatrix

__all__ = ["synthetic_spd_dia", "table1_matrix", "TABLE1"]

# name -> (N, nnz per row) from Table I of the paper.
TABLE1: dict[str, tuple[int, float]] = {
    "bcsstk15": (3948, 29.84),
    "gyro": (17361, 58.81),
    "boneS01": (127224, 52.78),
    "hood": (220542, 48.82),
    "offshore": (259789, 16.33),
    "Serena": (1391349, 46.38),
    "Queen_4147": (4147110, 79.45),
}


def synthetic_spd_dia(
    n: int,
    nnz_per_row: float,
    seed: int = 0,
    bandwidth: int | None = None,
    sigma: float = 1.0,
    dtype: torch.dtype = torch.float32,
    *,
    device=None,
) -> DIAMatrix:
    """Random banded SPD matrix in DIA form with ~``nnz_per_row`` band width.

    The band is split between near diagonals (cache-local, stencil-like)
    and a few far diagonals, mirroring the profile of FEM matrices in the
    paper's table. ``device=None`` means CUDA.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_pairs = max(1, int(round((nnz_per_row - 1) / 2)))
    bw = bandwidth if bandwidth is not None else max(n_pairs * 2, min(n // 8 + 1, 4 * n_pairs))
    bw = min(bw, n - 1)
    near = [o for o in range(1, n_pairs // 2 + 2)][: max(1, n_pairs // 2)]
    remaining = n_pairs - len(near)
    far_pool = np.arange(max(near) + 1, bw + 1)
    if remaining > 0 and far_pool.size > 0:
        far = sorted(rng.choice(far_pool, size=min(remaining, far_pool.size), replace=False).tolist())
    else:
        far = []
    pos_offsets = sorted(set(near + far))

    offsets = sorted({0, *pos_offsets, *(-o for o in pos_offsets)})
    pos = {o: j for j, o in enumerate(offsets)}
    data = np.zeros((len(offsets), n), dtype=np.float64)

    for o in pos_offsets:
        vals = rng.uniform(0.1, 1.0, size=n - o) * rng.choice([-1.0, 1.0], size=n - o)
        # A[i, i+o] = vals[i] for i in [0, n-o)
        data[pos[o], : n - o] = vals
        # symmetry: A[i, i-o] = A[i-o, i] -> data[-o][i] = data[o][i-o]
        data[pos[-o], o:n] = vals

    # strict diagonal dominance -> SPD
    data[pos[0]] = np.abs(data).sum(axis=0) + sigma
    t = torch.from_numpy(data).to(dtype)
    return DIAMatrix(t.to(device), tuple(offsets), n)


def table1_matrix(name: str, scale: float = 1.0, seed: int = 0,
                  dtype: torch.dtype = torch.float32, *, device=None) -> DIAMatrix:
    """Synthetic analogue of a Table-I matrix, optionally scaled down in N.

    ``scale`` < 1 shrinks N (for CPU-sized tests) while keeping nnz/N.
    ``device=None`` means CUDA.
    """
    if name not in TABLE1:
        raise KeyError(f"unknown Table-I matrix {name!r}; have {sorted(TABLE1)}")
    n_full, nnz_per_row = TABLE1[name]
    n = max(64, int(n_full * scale))
    return synthetic_spd_dia(n, nnz_per_row, seed=seed, dtype=dtype, device=device)
