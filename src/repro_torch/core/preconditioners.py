"""Preconditioners.

The paper (§V-A) uses the Jacobi (diagonal) preconditioner: cheap
setup, and an elementwise apply that fuses into the vector-update
kernels. Block-Jacobi (dense-inverted diagonal blocks) is the JAX
package's beyond-paper baseline strengthener; its apply is a batched
block product that the loop runs after the VMA kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["JacobiPC", "IdentityPC", "BlockJacobiPC", "jacobi", "identity", "block_jacobi",
           "apply_pc"]


@dataclass(frozen=True)
class JacobiPC:
    inv_diag: torch.Tensor  # (n,)


@dataclass(frozen=True)
class IdentityPC:
    pass


@dataclass(frozen=True)
class BlockJacobiPC:
    """Dense-inverted diagonal blocks."""

    inv_blocks: torch.Tensor  # (n // block, block, block)
    block: int


def jacobi(A) -> JacobiPC:
    d = A.diagonal()
    return JacobiPC(inv_diag=torch.where(d != 0, 1.0 / d, 1.0).to(d.dtype))


def identity(A=None) -> IdentityPC:
    return IdentityPC()


def block_jacobi(A, block: int = 4) -> BlockJacobiPC:
    """Extract (and invert, in float32) the diagonal blocks of a DIA or
    Bell matrix."""
    from ..sparse.formats import BellMatrix, DIAMatrix  # lazy: sparse imports kernels

    n = A.n
    if n % block:
        raise ValueError(f"n={n} not divisible by block={block}")
    dev = A.device
    blocks = torch.zeros(n // block, block, block, dtype=A.dtype, device=dev)
    if isinstance(A, DIAMatrix):
        i = torch.arange(n, device=dev)
        li = i % block
        for j, o in enumerate(A.offsets):
            if abs(o) >= block:
                continue
            # entry (i, i+o) lands in block i//block iff (i % block) + o in [0, block)
            ok = (li + o >= 0) & (li + o < block) & (i + o >= 0) & (i + o < n)
            blocks.index_put_((i // block, li, torch.clamp(li + o, 0, block - 1)),
                              torch.where(ok, A.data[j], 0), accumulate=True)
    elif isinstance(A, BellMatrix):
        cols = A.cols.to(torch.int64)
        i = torch.arange(n, device=dev)[:, None].expand_as(cols)
        same = (cols // block) == (i // block)
        blocks.index_put_((i // block, i % block, cols % block),
                          torch.where(same, A.vals, 0), accumulate=True)
    else:
        raise TypeError(f"block_jacobi takes a DIAMatrix or BellMatrix, got {type(A).__name__}")
    inv = torch.linalg.inv(blocks.to(torch.float32)).to(A.dtype)
    return BlockJacobiPC(inv_blocks=inv, block=block)


def apply_pc(M, r: torch.Tensor) -> torch.Tensor:
    if isinstance(M, JacobiPC):
        return M.inv_diag * r
    if isinstance(M, IdentityPC):
        return r
    if isinstance(M, BlockJacobiPC):
        nb = M.inv_blocks.shape[0]
        if r.dim() == 1:
            return torch.einsum("bij,bj->bi", M.inv_blocks, r.reshape(nb, M.block)).reshape(-1)
        lanes = r.reshape(r.shape[0], nb, M.block)  # (k, n): one product for every lane
        return torch.einsum("bij,lbj->lbi", M.inv_blocks, lanes).reshape(r.shape)
    raise TypeError(f"unsupported preconditioner {type(M).__name__}")
