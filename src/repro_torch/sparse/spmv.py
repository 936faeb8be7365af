"""SPMV engine dispatch — one entry point, per-engine backends for DIA.

``spmv(A, x, engine=...)`` routes on (matrix type, engine) through a
registry. Engines for ``DIAMatrix`` (the JAX package's names in
brackets):

    "torch"  [jnp]     spmv_dia: plain shift-sum, the reference
    "cuda"   [pallas]  kernels.spmv_dia: the hand-written CUDA kernel
    "bf16"   [bf16]    spmv_dia_bf16: bf16 storage, f32 accumulation
    "auto"             "cuda" for an operator on a CUDA device, else
                       "torch" (only because the caller put it on the CPU)

The kernel wrapper itself runs its plain version for CPU tensors, so
"cuda" on a CPU operator computes the same thing as "torch". An engine
name that is not registered raises ValueError.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.spmv_dia.ref import shifted, spmv_dia_ref
from .formats import DIAMatrix

__all__ = [
    "spmv",
    "spmv_dia",
    "spmv_dia_bf16",
    "shifted",
    "register_spmv",
    "resolve_engine",
    "spmv_engines",
]


def spmv_dia(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j data[j, i] * x[i + offsets[j]] (zero outside [0, n))."""
    y = torch.zeros_like(x)
    for j, o in enumerate(A.offsets):
        y = y + A.data[j] * shifted(x, o)
    return y


def spmv_dia_bf16(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Mixed-precision DIA SPMV: bf16 storage, f32 accumulation.

    Band data and x are cast to bf16 (half the bytes of the
    memory-bound SPMV); every product accumulates in at least f32 and
    the result comes back in x's dtype. On a CUDA operator this is the
    CUDA kernel on the bf16 operands. Expect O(1e-2) relative error per
    apply: plans turn residual replacement on for this engine.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    A16 = A if A.dtype == torch.bfloat16 else A.with_dtype(torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    if x.device.type == "cuda":
        from ..kernels.spmv_dia import spmv_dia_cuda

        return spmv_dia_cuda(A16, x16, out_dtype=acc).to(x.dtype)
    return spmv_dia_ref(A16.data, A.offsets, x16, out_dtype=acc).to(x.dtype)


def _spmv_dia_cuda(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    from ..kernels.spmv_dia import spmv_dia_cuda

    return spmv_dia_cuda(A, x)


# (matrix type) -> (engine name) -> fn(A, x) -> y
_REGISTRY: Dict[type, Dict[str, Callable]] = {}


def register_spmv(mat_type: type, engine: str, fn: Callable, *, overwrite: bool = False) -> None:
    """Register an SPMV backend for ``mat_type`` under ``engine``.

    Raises ValueError if that (format, engine) pair is already
    registered, unless ``overwrite=True``.
    """
    table = _REGISTRY.setdefault(mat_type, {})
    if engine in table and not overwrite:
        raise ValueError(
            f"SPMV engine {engine!r} already registered for "
            f"{mat_type.__name__}; pass overwrite=True to replace it"
        )
    table[engine] = fn


register_spmv(DIAMatrix, "torch", spmv_dia)
register_spmv(DIAMatrix, "cuda", _spmv_dia_cuda)
register_spmv(DIAMatrix, "bf16", spmv_dia_bf16)


def _engines_for(A) -> Dict[str, Callable]:
    table: Dict[str, Callable] = {}
    for klass in reversed(type(A).__mro__):
        table.update(_REGISTRY.get(klass, {}))
    if not table:
        raise TypeError(f"unsupported matrix type {type(A).__name__}")
    return table


def spmv_engines(A) -> Tuple[str, ...]:
    """Engine names registered for this matrix."""
    return tuple(sorted(_engines_for(A)))


def resolve_engine(A, engine: str = "auto") -> str:
    """The engine name ``spmv(A, x, engine=...)`` will run.

    "auto" is "cuda" for an operator on a CUDA device when registered,
    else "torch". A concrete name resolves to itself when registered and
    raises ValueError otherwise.
    """
    table = _engines_for(A)
    if engine == "auto":
        return "cuda" if A.device.type == "cuda" and "cuda" in table else "torch"
    if engine not in table:
        raise ValueError(f"no SPMV engine {engine!r} for {type(A).__name__}; have {sorted(table)}")
    return engine


def spmv(A, x: torch.Tensor, engine: str = "auto") -> torch.Tensor:
    """y = A @ x through the engine registry (see :func:`resolve_engine`)."""
    return _engines_for(A)[resolve_engine(A, engine)](A, x)
