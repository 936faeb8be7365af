r"""Pipelined PCG — Algorithm 2 of the paper (Ghysels & Vanroose).

Thin single-device front end over the shared solver loop in
``core.iteration``: the iteration core, the SPMV engine and the (here:
local) reduction are injected, so this file holds no iteration math.

What it does own is the choice of execution path for the kernel cores
("cuda", "fused_iter"):

* a DIA operator with an elementwise (Jacobi/identity) preconditioner
  runs the **padded path**: operator diagonals, b, x0 and inv_diag are
  zero-padded once to a multiple of the kernels' block, and x is sliced
  back to n at the end. The DIA zero convention keeps the padded tail
  exactly 0 through every recurrence. ``SolverPlan`` builds the
  ``fused_iter`` core once at plan time, pinning the padded diagonals;
* any other operator (Bell, CSR, dense, matrix-free) or preconditioner
  runs unpadded: ``fused_vma`` takes any length, and the SPMV is the
  operator's own engine (``spmv_bell`` on the card for a Bell operator).

``b`` (and ``x0``) may be ``(k, n)``: the same paths run over lanes (the
JAX package's ``jax.vmap`` of the solve), through the kernels'
lane-batched entries on the card; padding is along the last axis.
"""
from __future__ import annotations

import torch

from ..kernels.common import BLOCK, ceil_to, pad1d
from ..sparse.formats import DIAMatrix
from ..sparse.spmv import resolve_engine, spmv, spmv_dia, spmv_dia_bf16
from .iteration import (
    get_core,
    make_fused_iter_core,
    resolve_core_name,
    run_pipecg,
    solve_inputs,
)
from .preconditioners import IdentityPC, JacobiPC, apply_pc
from .types import SolveResult

__all__ = ["pipecg", "pin_pipecg_core"]

# default residual-replacement period when the reduced-precision SPMV
# engine is selected and the caller did not choose one
_BF16_REPLACE_EVERY = 50

_KERNEL_CORES = ("cuda", "fused_iter")


def _elementwise_pc(M) -> bool:
    return isinstance(M, (JacobiPC, IdentityPC))


def _padded_spmv_fns(Ap: DIAMatrix, spmv_engine: str):
    """(iteration spmv, replacement spmv) on pre-padded vectors.

    Both keep the padded tail at exactly zero. The replacement SPMV is
    always full precision: under the "bf16" engine it is the f32 safety
    net that residual replacement re-derives vectors through.
    """
    from ..kernels.spmv_dia import spmv_dia_batched, spmv_dia_cuda

    eng = resolve_engine(Ap, spmv_engine)

    def _cuda(v, active=None):
        return spmv_dia_batched(Ap, v, active) if v.dim() == 2 else spmv_dia_cuda(Ap, v)

    def _plain(v, active=None):
        return spmv_dia(Ap, v)

    full = _cuda if Ap.device.type == "cuda" else _plain
    if eng == "cuda":
        return _cuda, _cuda
    if eng == "bf16":
        A16 = Ap.with_dtype(torch.bfloat16)  # cast once per solve, not per apply
        return (lambda v, active=None: spmv_dia_bf16(A16, v)), full
    return _plain, _plain


def _with_unit_diag(core, ones: torch.Tensor):
    """The "cuda" core under a preconditioner the loop applies itself:
    fused_vma gets a unit diagonal built once per solve, and the loop
    then replaces m by ``pc_fn(w)``."""

    def unit_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
        return core(z, q, s, p, x, r, u, w, n, m, ones, alpha, beta, active)

    return unit_core


def _pipecg_impl(A, b, M, x0, atol, rtol, maxiter, core_name, spmv_engine, replace_every,
                 core_obj) -> SolveResult:
    # Jacobi fuses into the iteration core; any other PC is applied per
    # iteration by the loop (inv_diag=None -> m = pc_fn(w))
    inv_diag = M.inv_diag if isinstance(M, JacobiPC) else None
    n_cols = b.shape[-1]
    replace_spmv_fn = (lambda v: spmv(A, v, engine="auto")) if spmv_engine == "bf16" else None
    kernel_core = core_name in _KERNEL_CORES

    if not kernel_core or not (isinstance(A, DIAMatrix) and _elementwise_pc(M)):
        core = get_core(core_name, A)
        if kernel_core and isinstance(M, IdentityPC):
            # the kernel fuses identity as a unit diagonal, so every vector
            # the loop builds is a buffer of its own
            M = JacobiPC(inv_diag=torch.ones(n_cols, dtype=b.dtype, device=b.device))
            inv_diag = M.inv_diag
        elif kernel_core and inv_diag is None:
            core = _with_unit_diag(core, torch.ones(n_cols, dtype=b.dtype, device=b.device))
        i, x, norm, converged, hist, steps = run_pipecg(
            b,
            x0,
            spmv_fn=lambda v, active=None: spmv(A, v, engine=spmv_engine, active=active),
            pc_fn=lambda r: apply_pc(M, r),
            core=core,
            inv_diag=inv_diag,
            atol=atol,
            rtol=rtol,
            maxiter=maxiter,
            replace_every=replace_every,
            replace_spmv_fn=replace_spmv_fn,
        )
        return SolveResult(x=x, iterations=i, residual_norm=norm, converged=converged,
                           history=hist, steps=steps)

    # ---- padded execution: pad once, run the loop on aligned views ----
    n = A.n
    if core_name == "fused_iter":
        core = core_obj if core_obj is not None else make_fused_iter_core(A)
        n_pad = core.n_pad
    else:
        core = get_core(core_name)
        n_pad = ceil_to(n, BLOCK)
    # init and replacement run the operator's own precision: the fused
    # core's pinned band serves them unless it was pinned in another dtype
    if core_name == "fused_iter" and core.padded_data.dtype == A.data.dtype:
        Ap = DIAMatrix(core.padded_data, A.offsets, n_pad)
    else:
        Ap = DIAMatrix(torch.nn.functional.pad(A.data, (0, n_pad - n)).contiguous(),
                       A.offsets, n_pad)
    bp = pad1d(b, n_pad)
    x0p = pad1d(x0, n_pad)
    # the kernels fuse an elementwise PC: identity is a unit diagonal, so
    # every vector the loop builds is a buffer of its own
    inv_p = (pad1d(inv_diag, n_pad) if inv_diag is not None
             else torch.ones(n_pad, dtype=b.dtype, device=b.device))
    spmv_fn, replace_fn = _padded_spmv_fns(Ap, spmv_engine)

    i, x, norm, converged, hist, steps = run_pipecg(
        bp,
        x0p,
        spmv_fn=spmv_fn,
        pc_fn=lambda r: inv_p * r,
        core=core,
        inv_diag=inv_p,
        atol=atol,
        rtol=rtol,
        maxiter=maxiter,
        replace_every=replace_every,
        replace_spmv_fn=replace_fn,
    )
    return SolveResult(x=x[..., :n], iterations=i, residual_norm=norm, converged=converged,
                       history=hist, steps=steps)


def _resolve_config(A, M, engine: str, spmv_engine, replace_every, core):
    """Shared engine/core/spmv/replace resolution for pipecg and plans.

    "auto" degrades from fused_iter to the "cuda" core when the operator
    is not a DIA matrix or the preconditioner is not elementwise; an
    explicit "fused_iter" raises there, as the JAX package does.
    """
    core_name = "fused_iter" if core is not None else resolve_core_name(engine, A)
    if core_name == "fused_iter":
        if not isinstance(A, DIAMatrix):
            if engine != "auto":
                raise TypeError(
                    f"engine 'fused_iter' needs a DIAMatrix operator, got {type(A).__name__}"
                )
            core_name = "cuda"
        elif M is not None and not _elementwise_pc(M):
            if engine != "auto":
                raise ValueError(
                    "engine 'fused_iter' fuses an elementwise preconditioner; "
                    f"use M='jacobi'/'identity', got {type(M).__name__}"
                )
            core_name = "cuda"
    if spmv_engine is None:
        # fused_iter uses SPMV only at init/replacement -> device default;
        # engine="cuda"/"auto" runs the whole iteration on kernels
        spmv_engine = "auto" if core_name == "fused_iter" or engine in ("cuda", "auto") else "torch"
    resolve_engine(A, spmv_engine)  # raises here for an engine the format lacks
    if replace_every is None:
        replace_every = _BF16_REPLACE_EVERY if spmv_engine == "bf16" else 0
    return core_name, spmv_engine, int(replace_every)


def pin_pipecg_core(A, M, engine: str, spmv_engine=None, replace_every=None):
    """Plan-time setup: build (once) the operator-pinned fused core.

    Returns the ``core`` to thread into :func:`pipecg`, or None when the
    resolved configuration does not use one.
    """
    core_name, _, _ = _resolve_config(A, M, engine, spmv_engine, replace_every, None)
    if core_name != "fused_iter":
        return None
    return make_fused_iter_core(A)


def pipecg(
    A,
    b,
    M=None,
    x0=None,
    atol: float = 1e-5,
    rtol: float = 0.0,
    maxiter: int = 10000,
    engine: str = "torch",
    spmv_engine: str | None = None,
    replace_every: int | None = None,
    core=None,
) -> SolveResult:
    """Solve SPD ``A x = b`` with Pipelined PCG (Algorithm 2).

    engine="torch"      — plain PyTorch iteration core (the reference).
    engine="cuda"       — the fused_vma kernel for the 8 VMAs + Jacobi PC +
                          dots; the SPMV is a second kernel.
    engine="fused_iter" — the whole iteration (banded SPMV + VMAs + PC +
                          dots) as one CUDA kernel; needs a DIAMatrix
                          and a Jacobi/identity PC.
    engine="auto"       — fused_iter where it applies on a CUDA device,
                          else "cuda" there; "torch" for an operator on
                          the CPU.
    spmv_engine         — "torch"/"cuda"/"bf16"/"auto"; defaults to
                          "auto" for fused_iter (init + residual
                          replacement only) and to following ``engine``
                          otherwise.
    replace_every       — if > 0, re-derive all auxiliary vectors from
                          their definitions (at full precision) every k
                          iterations. Default: 0, except 50 when
                          spmv_engine="bf16".
    core                — a prebuilt core from :func:`pin_pipecg_core`.

    ``b`` (and ``x0``) must be on the operator's device; ``(k, n)`` solves
    k right-hand sides at once, every result field gaining the lane axis.
    """
    M, x0 = solve_inputs(A, b, M, x0)
    core_name, spmv_engine, replace_every = _resolve_config(A, M, engine, spmv_engine,
                                                            replace_every, core)
    return _pipecg_impl(A, b, M, x0, float(atol), float(rtol), int(maxiter), core_name,
                        spmv_engine, replace_every, core)
