"""SPMV engine dispatch — one entry point, per-format/per-engine backends.

``spmv(A, x, engine=...)`` routes on (matrix type, engine) through a
registry. The selection matrix (the JAX package's names in brackets):

    engine          DIAMatrix            BellMatrix           CSRMatrix
    -------------   ------------------   ------------------   -------------------
    "torch" [jnp]   spmv_dia (shifts)    spmv_bell (gather)   spmv_csr (scatter)
    "cuda" [pallas] kernels.spmv_dia     kernels.spmv_bell    — (runs "segsum")
    "segsum"        —                    —                    spmv_csr_segsum
    "bf16"          spmv_dia_bf16        —                    —

    dense tensor         -> A @ x ("torch")
    object with .matvec  -> protocol fallback ("torch"; matrix-free FunctionOperator)

``engine="auto"``: "cuda" for an operator on a CUDA device when the
format has a CUDA kernel; else "segsum" where registered (CSR: the
sorted segmented sum); else "torch" (the plain version, which "auto"
picks on the card only for a format with no kernel). "cuda" asked of a
format with no CUDA kernel runs what "auto" picks for it (CSR:
"segsum"), and :func:`resolve_engine` names that engine. Any other name
that is not registered raises ValueError.

The kernel wrappers run their plain version for CPU tensors, so "cuda"
on a CPU operator computes the same thing as "torch".

``spmv(A, x, active=flag)`` hands a solver loop's 0-d bool device flag
to the engine that reads it (the Bell CUDA kernel), which then skips its
work once the solve has converged; every other engine ignores the flag.

``x`` may be ``(k, n)``, k right-hand sides (the JAX package's
``jax.vmap`` of the SPMV): the plain engines broadcast over the lane
axis, the CUDA engines run their kernels' lane-batched entries (which
read the operator once for up to 8 lanes and take a ``(k,)`` flag; the
bf16 engine runs the bf16 lane entry), and a matrix-free operator's
``matvec`` receives the ``(k, n)`` tensor.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.spmv_bell.ref import spmv_bell_ref
from ..kernels.spmv_dia.ref import shifted, spmv_dia_ref
from .formats import BellMatrix, CSRMatrix, DIAMatrix

__all__ = [
    "spmv",
    "spmv_dia",
    "spmv_dia_bf16",
    "spmv_bell",
    "spmv_csr",
    "spmv_csr_segsum",
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
        from ..kernels.spmv_dia import spmv_dia_batched_bf16, spmv_dia_cuda

        if x.dim() == 2:  # k lanes: each lane bit for bit the 1-D kernel's
            return spmv_dia_batched_bf16(A16, x16).to(x.dtype)
        return spmv_dia_cuda(A16, x16, out_dtype=acc).to(x.dtype)
    return spmv_dia_ref(A16.data, A.offsets, x16, out_dtype=acc).to(x.dtype)


def spmv_bell(A: BellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_r vals[i, r] * x[cols[i, r]] (padding slots add 0)."""
    return spmv_bell_ref(A.cols, A.vals, x)


def spmv_csr(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Reference CSR SPMV: gather columns, scatter-add into rows."""
    return torch.zeros(*x.shape[:-1], A.n, dtype=x.dtype, device=x.device).index_add_(
        -1, A.rows, A.vals * x[..., A.cols])


def spmv_csr_segsum(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """CSR SPMV as a sorted segment sum over the per-entry products.

    ``rows`` is sorted by construction, so each row is one contiguous
    segment; an empty row sums to 0. Lanes of a (k, n) x are reduced in
    one call, along the entry axis.
    """
    if x.dim() == 1:
        return torch.segment_reduce(A.vals * x[A.cols], "sum", lengths=A.row_lengths)
    prod = (A.vals * x[..., A.cols]).movedim(-1, 0)
    return torch.segment_reduce(prod, "sum", lengths=A.row_lengths).movedim(0, -1).contiguous()


def _spmv_dense(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return A @ x if x.dim() == 1 else x @ A.mT


def _spmv_matvec(A, x: torch.Tensor) -> torch.Tensor:
    return A.matvec(x)


def _spmv_dia_cuda(A: DIAMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    from ..kernels.spmv_dia import spmv_dia_batched, spmv_dia_cuda

    # the single-lane kernel has no flag; the batched one skips idle lanes
    return spmv_dia_batched(A, x, active) if x.dim() == 2 else spmv_dia_cuda(A, x)


def _spmv_bell_cuda(A: BellMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    from ..kernels.spmv_bell import spmv_bell_batched, spmv_bell_cuda

    if x.dim() == 2:
        return spmv_bell_batched(A, x, active)
    return spmv_bell_cuda(A, x, active)


# (matrix type) -> (engine name) -> fn(A, x) -> y
_REGISTRY: Dict[type, Dict[str, Callable]] = {}
# the backends that also take a solver loop's flag: fn(A, x, active)
_TAKES_ACTIVE = (_spmv_dia_cuda, _spmv_bell_cuda)


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
register_spmv(BellMatrix, "torch", spmv_bell)
register_spmv(BellMatrix, "cuda", _spmv_bell_cuda)
register_spmv(CSRMatrix, "torch", spmv_csr)
register_spmv(CSRMatrix, "segsum", spmv_csr_segsum)


def _engines_for(A) -> Dict[str, Callable]:
    # merge along the MRO: a subclass inherits its base format's engines
    table: Dict[str, Callable] = {}
    for klass in reversed(type(A).__mro__):
        table.update(_REGISTRY.get(klass, {}))
    if table:
        return table
    if isinstance(A, torch.Tensor):
        return {"torch": _spmv_dense}
    if hasattr(A, "matvec"):  # LinearOperator protocol (matrix-free etc.)
        return {"torch": _spmv_matvec}
    raise TypeError(f"unsupported matrix type {type(A).__name__}")


def spmv_engines(A) -> Tuple[str, ...]:
    """Engine names registered for this matrix."""
    return tuple(sorted(_engines_for(A)))


def resolve_engine(A, engine: str = "auto") -> str:
    """The engine name ``spmv(A, x, engine=...)`` will run.

    "auto": "cuda" for an operator on a CUDA device when registered, else
    "segsum" when registered, else "torch". A concrete name resolves to
    itself when registered; "cuda" for a format without a CUDA kernel
    resolves as "auto" does; any other name raises ValueError.
    """
    table = _engines_for(A)
    if engine == "auto":
        device = getattr(A, "device", None)
        if "cuda" in table and device is not None and device.type == "cuda":
            return "cuda"
        return "segsum" if "segsum" in table else "torch"
    if engine in table:
        return engine
    if engine == "cuda":
        return resolve_engine(A, "auto")
    raise ValueError(f"no SPMV engine {engine!r} for {type(A).__name__}; have {sorted(table)}")


def spmv(A, x: torch.Tensor, engine: str = "auto", active=None) -> torch.Tensor:
    """y = A @ x through the engine registry (see :func:`resolve_engine`).

    ``active``: a solver loop's 0-d bool device flag, passed to the Bell
    CUDA kernel and ignored by every other engine.
    """
    fn = _engines_for(A)[resolve_engine(A, engine)]
    if active is not None and fn in _TAKES_ACTIVE:
        return fn(A, x, active)
    return fn(A, x)
