"""Sparse matrix containers of the port.

``DIAMatrix`` — diagonal (banded) storage, the natural format for the
paper's Poisson stencil matrices (7/27/125-point): every diagonal is a
dense vector and SPMV is a sum of shifted elementwise products.
``offsets`` is a static tuple, so the shifts are known before any
kernel runs. Bell and CSR storage are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["DIAMatrix"]


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
