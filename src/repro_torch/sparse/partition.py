"""Row partitioning and the 2-D (local/halo) decomposition — paper §IV-C.

The paper's Hybrid-PIPECG-3 cuts rows so that nnz is proportional to the
measured device throughput (1-D), then splits each part's nnz into
``nnz1`` (columns the device holds) and ``nnz2`` (columns that arrive in
the halo exchange), overlapping SPMV part 1 with the exchange (2-D).

* ``balanced_nnz`` cuts rows so each shard's nnz matches its weight
  (uniform on equal devices; measured weights for the card plus the host).
* ``ShardedDIA`` holds one banded block per shard, each on its shard's
  device. Blocks on different devices cannot be one tensor, so unlike the
  JAX package's (stacked and padded to a common row count for
  ``shard_map``) every block keeps exactly its own rows: a host shard with
  2% of the rows does 2% of the work. The local/halo column split is
  implicit in the band: columns inside the shard's rows are ``nnz1``, the
  boundary strips ``nnz2``.

Shards exchange boundary slabs of ``bandwidth`` rows with their ring
neighbours, and the local SPMV runs while the slabs are in flight
(``core.distributed.spmv_halo``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .formats import DIAMatrix

__all__ = [
    "balanced_rows",
    "balanced_nnz",
    "ShardedDIA",
    "shard_dia",
    "shard_vector",
    "unshard_vector",
    "shard_vectors",
    "unshard_vectors",
    "partition_stats",
]


def balanced_rows(n: int, parts: int) -> np.ndarray:
    """Equal-row boundaries: (parts+1,) with boundaries[0]=0, [-1]=n."""
    base = n // parts
    rem = n % parts
    sizes = np.full(parts, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def balanced_nnz(row_nnz: np.ndarray, parts: int, weights: np.ndarray | None = None) -> np.ndarray:
    """Cut rows so each part's nnz is proportional to its weight.

    The paper's performance-model decomposition: ``weights`` are relative
    device speeds (s_dev / sum(s)); uniform if None. Returns row
    boundaries (parts+1,).
    """
    n = len(row_nnz)
    if weights is None:
        weights = np.ones(parts)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    cum = np.concatenate([[0], np.cumsum(row_nnz, dtype=np.float64)])
    total = cum[-1]
    targets = np.cumsum(weights) * total
    bounds = np.searchsorted(cum, targets[:-1], side="left")
    bounds = np.clip(bounds, 1, n - 1)
    # strictly increasing (each part >= 1 row when possible)
    for i in range(1, len(bounds)):
        if bounds[i] <= bounds[i - 1]:
            bounds[i] = min(bounds[i - 1] + 1, n - 1)
    return np.concatenate([[0], bounds, [n]]).astype(np.int64)


def _devices(devices, P: int, default: torch.device) -> Tuple[torch.device, ...]:
    if devices is None:
        return (default,) * P
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) != P:
        raise ValueError(f"{len(devs)} devices for {P} shards")
    return devs


@dataclass(frozen=True)
class ShardedDIA:
    """A DIA matrix split into row blocks, one per shard.

    ``blocks[p][j, i] = A[boundaries[p]+i, boundaries[p]+i+offsets[j]]``
    for ``i < rows[p]``, on ``devices[p]``; each block is a
    ``(n_diags, rows[p])`` tensor (no padding rows).
    """

    blocks: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    n: int
    boundaries: Tuple[int, ...]

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(b.device for b in self.blocks)

    @property
    def rows(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.diff(self.boundaries))

    @property
    def rows_max(self) -> int:
        return max(self.rows)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets)

    def diagonal_sharded(self) -> Tuple[torch.Tensor, ...]:
        j = self.offsets.index(0)
        return tuple(b[j] for b in self.blocks)


def shard_dia(dia: DIAMatrix, boundaries, devices: Optional[Sequence] = None) -> ShardedDIA:
    """Split a DIA matrix into row blocks along ``boundaries``, block p on
    ``devices[p]`` (default: the operator's device)."""
    boundaries = np.asarray(boundaries)
    P = len(boundaries) - 1
    sizes = np.diff(boundaries)
    hw = dia.bandwidth
    if int(sizes.min()) < hw and not (sizes == sizes.max()).all():
        # equal shards are fine at any bandwidth: the halo SPMV walks
        # ceil(hw/rows) ring hops; only the unequal (performance-model)
        # partition is restricted to single-hop neighbour exchange
        raise ValueError(
            f"smallest shard ({int(sizes.min())}) < bandwidth ({hw}): "
            f"unequal shards support single-hop halo only (use balanced_rows "
            f"for the multi-hop path)"
        )
    devs = _devices(devices, P, dia.device)
    blocks = tuple(
        dia.data[:, int(boundaries[p]):int(boundaries[p + 1])].to(devs[p]).contiguous()
        for p in range(P)
    )
    return ShardedDIA(blocks=blocks, offsets=tuple(dia.offsets), n=dia.n,
                      boundaries=tuple(int(b) for b in boundaries))


def shard_vector(x: torch.Tensor, boundaries, devices: Optional[Sequence] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """(n,) -> one (rows[p],) block per shard, block p on ``devices[p]``
    (default: x's device). (k, n) lanes give (k, rows[p]) blocks."""
    boundaries = np.asarray(boundaries)
    P = len(boundaries) - 1
    devs = _devices(devices, P, x.device)
    return tuple(
        x[..., int(boundaries[p]):int(boundaries[p + 1])].to(devs[p]).contiguous()
        for p in range(P)
    )


def shard_vectors(xs: torch.Tensor, boundaries, devices: Optional[Sequence] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """(k, n) right-hand sides -> one (k, rows[p]) block per shard, the
    batched solver's layout: each shard holds its k row blocks contiguously."""
    if xs.dim() != 2:
        raise ValueError(f"shard_vectors takes (k, n), got {tuple(xs.shape)}")
    return shard_vector(xs, boundaries, devices)


def unshard_vector(parts: Sequence[torch.Tensor], boundaries=None, device=None) -> torch.Tensor:
    """Per-shard blocks -> the (n,) vector (or (k, n) lanes) on ``device``
    (default: block 0's). ``boundaries``, if given, checks the block sizes."""
    if boundaries is not None:
        sizes = np.diff(np.asarray(boundaries))
        got = [p.shape[-1] for p in parts]
        if list(sizes) != got:
            raise ValueError(f"block sizes {got} do not match the boundaries' {list(sizes)}")
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def unshard_vectors(parts: Sequence[torch.Tensor], boundaries=None, device=None) -> torch.Tensor:
    """(k, rows[p]) blocks -> (k, n): the inverse of :func:`shard_vectors`."""
    return unshard_vector(parts, boundaries, device)


def partition_stats(dia: DIAMatrix, boundaries: np.ndarray) -> dict:
    """nnz1/nnz2 accounting per shard — the paper's 2-D decomposition view."""
    data = dia.data.detach().cpu().numpy()
    stats = {"shards": []}
    for p in range(len(boundaries) - 1):
        lo, hi = int(boundaries[p]), int(boundaries[p + 1])
        nnz1 = nnz2 = 0
        rows = np.arange(lo, hi)
        for j, o in enumerate(dia.offsets):
            cols = rows + o
            local = (cols >= lo) & (cols < hi)
            valid = (cols >= 0) & (cols < dia.n) & (data[j, lo:hi] != 0)
            nnz1 += int(np.count_nonzero(local & valid))
            nnz2 += int(np.count_nonzero(~local & valid))
        stats["shards"].append({"rows": hi - lo, "nnz_local": nnz1, "nnz_halo": nnz2})
    return stats
