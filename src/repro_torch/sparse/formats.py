"""Sparse matrix containers of the port, and the conversions between them.

* ``DIAMatrix`` — diagonal (banded) storage, the natural format for the
  paper's Poisson stencil matrices (7/27/125-point): every diagonal is a
  dense vector and SPMV is a sum of shifted elementwise products.
  ``offsets`` is a static tuple, so the shifts are known before any
  kernel runs.
* ``BellMatrix`` — Block-ELLPACK: every row padded to a fixed number of
  slots ``R`` (column index + value), row-major ``(n, R)``. General
  sparsity with a regular layout.
* ``CSRMatrix`` — device CSR in expanded (COO-row) form: per-entry row
  ids sorted ascending, so SPMV is a gather + sorted segment sum.
* ``CSRHost`` — host-side (numpy) CSR, for construction and conversion.

The layouts, dtypes (int32 indices on the device) and the padding
convention (a padding slot is column 0 with value 0) are the JAX
package's. Every device container has a ``.device``. The conversions
are vectorised: none loops over rows in Python or sorts all entries,
so they run at Queen_4147's 327,617,742 entries. Those that build a
device container take ``device`` (``None`` means CUDA) and do their
work there.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from ..kernels.common import resolve_device

__all__ = [
    "DIAMatrix",
    "BellMatrix",
    "CSRMatrix",
    "CSRHost",
    "csr_from_dense",
    "dia_from_csr",
    "bell_from_csr",
    "csr_from_dia",
    "csr_device_from_host",
]

_SPAN_CHUNK = 1 << 20  # rows a column_span pass reads at once


@dataclass(frozen=True)
class DIAMatrix:
    """Banded matrix in diagonal storage.

    ``data[j, i] = A[i, i + offsets[j]]`` (row-major banded convention).
    Entries whose column falls outside ``[0, n)`` are stored as 0 and
    never read.
    """

    data: torch.Tensor  # (n_diags, n)
    offsets: Tuple[int, ...]
    n: int

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def shape(self):
        return (self.n, self.n)

    def diagonal(self) -> torch.Tensor:
        return self.data[self.offsets.index(0)]

    def nnz(self) -> int:
        """Structural nnz (band entries inside the matrix)."""
        return sum(self.n - abs(o) for o in self.offsets)

    def with_dtype(self, dtype: torch.dtype) -> "DIAMatrix":
        return DIAMatrix(self.data.to(dtype), self.offsets, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from .spmv import spmv  # lazy: spmv imports formats

        return spmv(self, x)


@dataclass(frozen=True)
class BellMatrix:
    """Block-ELLPACK: fixed ``R`` slots per row.

    Padding slots point at column 0 with value 0 (a safe gather target).
    """

    cols: torch.Tensor  # (n, R) int32
    vals: torch.Tensor  # (n, R)
    n: int

    @property
    def slots_per_row(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def shape(self):
        return (self.n, self.n)

    def diagonal(self) -> torch.Tensor:
        row = torch.arange(self.n, dtype=self.cols.dtype, device=self.device)[:, None]
        return (self.vals * (self.cols == row)).sum(dim=1)

    def nnz(self) -> int:
        return int(self.cols.shape[0] * self.cols.shape[1])

    @cached_property
    def columns_in_range(self) -> bool:
        """Whether every column index lies in [0, n): the CUDA kernel
        gathers x by them (checked once per operator)."""
        return bool(((self.cols >= 0) & (self.cols < self.n)).all())

    @cached_property
    def column_span(self) -> int:
        """max |col - row| over the nonzero slots (0 for none): the lane
        kernel sizes its window of x by it (computed once per operator, a
        chunk of rows at a time; not part of the operator's identity)."""
        span = 0
        for lo in range(0, self.n, _SPAN_CHUNK):
            cols = self.cols[lo:lo + _SPAN_CHUNK]
            rows = torch.arange(lo, lo + cols.shape[0], dtype=cols.dtype, device=cols.device)
            dist = (cols - rows[:, None]).abs() * (self.vals[lo:lo + _SPAN_CHUNK] != 0)
            if dist.numel():
                span = max(span, int(dist.max()))
        return span

    def with_dtype(self, dtype: torch.dtype) -> "BellMatrix":
        return BellMatrix(self.cols, self.vals.to(dtype), self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from .spmv import spmv

        return spmv(self, x)


@dataclass(frozen=True)
class CSRMatrix:
    """Device CSR in expanded (COO-row) form.

    ``rows``/``cols``/``vals`` are parallel (nnz,) tensors sorted by row,
    the layout a sorted segment sum wants. Build via
    :func:`csr_device_from_host`.
    """

    rows: torch.Tensor  # (nnz,) int32, sorted ascending
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    n: int

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def shape(self):
        return (self.n, self.n)

    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @cached_property
    def row_lengths(self) -> torch.Tensor:
        """Entries per row, (n,) int64: the segments of the sorted segment
        sum (counted once per operator)."""
        return torch.bincount(self.rows, minlength=self.n)

    def diagonal(self) -> torch.Tensor:
        on_diag = torch.where(self.rows == self.cols, self.vals, 0)
        return torch.zeros(self.n, dtype=self.vals.dtype, device=self.device).index_add_(
            0, self.rows, on_diag)

    def with_dtype(self, dtype: torch.dtype) -> "CSRMatrix":
        return CSRMatrix(self.rows, self.cols, self.vals.to(dtype), self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from .spmv import spmv

        return spmv(self, x)


@dataclass(frozen=True)
class CSRHost:
    """Host-side CSR (numpy). Construction and conversion only."""

    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int64
    data: np.ndarray  # (nnz,)
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row_ids(self) -> np.ndarray:
        """The row of every entry, (nnz,) int64."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.row_nnz())

    def diagonal(self) -> np.ndarray:
        """A[i, i], from the first entry of row i in column i (0 if none)."""
        d = np.zeros(self.n, dtype=self.data.dtype)
        rows = self.row_ids()
        hit = np.flatnonzero(self.indices == rows)
        # rows[hit] ascends: keep the first hit of each row
        first = hit[np.r_[True, rows[hit][1:] != rows[hit][:-1]]] if hit.size else hit
        d[rows[first]] = self.data[first]
        return d

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.n, self.n), dtype=self.data.dtype)
        A[self.row_ids(), self.indices] = self.data
        return A


def csr_from_dense(A: np.ndarray) -> CSRHost:
    """Host CSR of a dense numpy matrix: its nonzeros in row-major order."""
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSRHost(indptr, cols.astype(np.int64), A[rows, cols].astype(A.dtype), n)


def _host_arrays(csr: CSRHost, device: torch.device):
    """(row ids int64, column ids int64, values) of ``csr`` on ``device``."""
    row_nnz = torch.from_numpy(np.diff(csr.indptr)).to(device)
    rows = torch.repeat_interleave(torch.arange(csr.n, device=device), row_nnz,
                                   output_size=csr.nnz)
    cols = torch.from_numpy(np.ascontiguousarray(csr.indices, dtype=np.int64)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(csr.data)).to(device)
    return rows, cols, vals


def csr_device_from_host(csr: CSRHost, *, device=None) -> CSRMatrix:
    """Expand host CSR (indptr) into the device COO-row layout."""
    rows, cols, vals = _host_arrays(csr, resolve_device(device))
    return CSRMatrix(rows=rows.to(torch.int32), cols=cols.to(torch.int32), vals=vals, n=csr.n)


def dia_from_csr(csr: CSRHost, *, device=None) -> DIAMatrix:
    """Host CSR to DIA. Offsets = every distinct (col - row), ascending.

    The distinct offsets come from a presence table over the 2n - 1
    possible offsets, not from a sort of the entries. An entry that
    repeats a (row, col) pair overwrites the earlier one.
    """
    device = resolve_device(device)
    n = csr.n
    rows, cols, vals = _host_arrays(csr, device)
    offs = cols - rows
    present = torch.zeros(2 * n - 1, dtype=torch.bool, device=device)
    present[offs + (n - 1)] = True
    uniq = torch.nonzero(present).flatten() - (n - 1)
    pos = torch.empty(2 * n - 1, dtype=torch.int64, device=device)
    pos[uniq + (n - 1)] = torch.arange(uniq.numel(), device=device)
    data = torch.zeros(uniq.numel(), n, dtype=vals.dtype, device=device)
    data[pos[offs + (n - 1)], rows] = vals
    return DIAMatrix(data, tuple(uniq.tolist()), n)


def csr_from_dia(dia: DIAMatrix) -> CSRHost:
    """Host CSR of a DIA matrix: its nonzero band entries, rows ascending
    and columns ascending within a row (the order of a (row, col) sort).

    Runs on the operator's device. With the offsets in ascending order,
    the entries of one row already lie in column order, so the rows of
    the (n, k) band table give the CSR order without a sort.
    """
    n, dev = dia.n, dia.device
    order = sorted(range(dia.n_diags), key=lambda j: dia.offsets[j])
    offs = torch.tensor([dia.offsets[j] for j in order], dtype=torch.int64, device=dev)
    vals = dia.data[order].t()  # (n, k), offsets ascending along each row
    cols = torch.arange(n, device=dev)[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(dim=1).cpu().numpy(), out=indptr[1:])
    return CSRHost(indptr, cols[keep].cpu().numpy(), vals[keep].cpu().numpy(), n)


def bell_from_csr(csr: CSRHost, slots_per_row: int | None = None, *, device=None) -> BellMatrix:
    """Host CSR to Block-ELLPACK with ``R`` slots per row (default: the
    longest row). Row i's entries fill slots 0..nnz_i-1 in CSR order; the
    rest are padding (column 0, value 0)."""
    device = resolve_device(device)
    n = csr.n
    row_nnz = csr.row_nnz()
    longest = int(row_nnz.max()) if n else 0
    R = int(slots_per_row or longest or 1)
    if longest > R:
        raise ValueError(f"slots_per_row={R} < max row nnz {longest}")
    rows, cols, vals = _host_arrays(csr, device)
    starts = torch.from_numpy(np.ascontiguousarray(csr.indptr[:-1])).to(device)
    slot = torch.arange(csr.nnz, device=device) - starts[rows]
    flat = rows * R + slot
    bcols = torch.zeros(n * R, dtype=torch.int32, device=device)
    bvals = torch.zeros(n * R, dtype=vals.dtype, device=device)
    bcols[flat] = cols.to(torch.int32)
    bvals[flat] = vals
    return BellMatrix(bcols.view(n, R), bvals.view(n, R), n)
