r"""Pipelined PCG — Algorithm 2 of the paper (Ghysels & Vanroose).

Thin single-device front end over the shared solver loop in
``core.iteration``: the iteration core, the SPMV engine and the (here:
local) reduction are injected, so this file holds no iteration math.

What it does own is the **padded execution path**. For the kernel cores
("cuda", "fused_iter") the solve runs on views zero-padded once to a
multiple of the kernels' block — operator diagonals, b, x0, inv_diag —
and slices x back to n at the end. The DIA zero convention keeps the
padded tail exactly 0 through every recurrence. ``SolverPlan`` builds
the ``fused_iter`` core once at plan time, pinning the padded diagonals.
"""
from __future__ import annotations

import torch

from ..kernels.common import BLOCK, ceil_to, pad1d
from ..sparse.formats import DIAMatrix
from ..sparse.spmv import resolve_engine, spmv, spmv_dia, spmv_dia_bf16
from .iteration import get_core, make_fused_iter_core, resolve_core_name, run_pipecg
from .preconditioners import JacobiPC, apply_pc, identity
from .types import SolveResult

__all__ = ["pipecg", "pin_pipecg_core"]

# default residual-replacement period when the reduced-precision SPMV
# engine is selected and the caller did not choose one
_BF16_REPLACE_EVERY = 50

_KERNEL_CORES = ("cuda", "fused_iter")


def _padded_spmv_fns(Ap: DIAMatrix, spmv_engine: str):
    """(iteration spmv, replacement spmv) on pre-padded vectors.

    Both keep the padded tail at exactly zero. The replacement SPMV is
    always full precision: under the "bf16" engine it is the f32 safety
    net that residual replacement re-derives vectors through.
    """
    from ..kernels.spmv_dia import spmv_dia_cuda

    eng = resolve_engine(Ap, spmv_engine)

    def _cuda(v):
        return spmv_dia_cuda(Ap, v)

    def _plain(v):
        return spmv_dia(Ap, v)

    full = _cuda if Ap.device.type == "cuda" else _plain
    if eng == "cuda":
        return _cuda, _cuda
    if eng == "bf16":
        A16 = Ap.with_dtype(torch.bfloat16)  # cast once per solve, not per apply
        return (lambda v: spmv_dia_bf16(A16, v)), full
    return _plain, _plain


def _pipecg_impl(A, b, M, x0, atol, rtol, maxiter, core_name, spmv_engine, replace_every,
                 core_obj) -> SolveResult:
    # Jacobi fuses into the iteration core; identity is the unit diagonal
    inv_diag = M.inv_diag if isinstance(M, JacobiPC) else None

    if core_name not in _KERNEL_CORES:
        i, x, norm, converged, hist, steps = run_pipecg(
            b,
            x0,
            spmv_fn=lambda v: spmv(A, v, engine=spmv_engine),
            pc_fn=lambda r: apply_pc(M, r),
            core=get_core(core_name, A),
            inv_diag=inv_diag,
            atol=atol,
            rtol=rtol,
            maxiter=maxiter,
            replace_every=replace_every,
            replace_spmv_fn=(
                (lambda v: spmv(A, v, engine="auto")) if spmv_engine == "bf16" else None
            ),
        )
        return SolveResult(x=x, iterations=i, residual_norm=norm, converged=converged,
                           history=hist, steps=steps)

    # ---- padded execution: pad once, run the loop on aligned views ----
    n = A.n
    if core_name == "fused_iter":
        core = core_obj if core_obj is not None else make_fused_iter_core(A)
        n_pad = core.n_pad
        Ap = DIAMatrix(core.padded_data, A.offsets, n_pad)
    else:
        core = get_core(core_name)
        n_pad = ceil_to(n, BLOCK)
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
    return SolveResult(x=x[:n], iterations=i, residual_norm=norm, converged=converged,
                       history=hist, steps=steps)


def _resolve_config(A, engine: str, spmv_engine, replace_every, core):
    """Shared engine/core/spmv/replace resolution for pipecg and plans."""
    if not isinstance(A, DIAMatrix):
        raise TypeError(f"the port's pipecg takes a DIAMatrix operator, got {type(A).__name__}")
    core_name = "fused_iter" if core is not None else resolve_core_name(engine, A)
    if spmv_engine is None:
        # fused_iter uses SPMV only at init/replacement -> device default;
        # engine="cuda"/"auto" runs the whole iteration on kernels
        spmv_engine = "auto" if core_name == "fused_iter" or engine in ("cuda", "auto") else "torch"
    if replace_every is None:
        replace_every = _BF16_REPLACE_EVERY if spmv_engine == "bf16" else 0
    return core_name, spmv_engine, int(replace_every)


def pin_pipecg_core(A, engine: str, spmv_engine=None, replace_every=None):
    """Plan-time setup: build (once) the operator-pinned fused core.

    Returns the ``core`` to thread into :func:`pipecg`, or None when the
    resolved configuration does not use one.
    """
    core_name, _, _ = _resolve_config(A, engine, spmv_engine, replace_every, None)
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
                          dots) as one CUDA kernel.
    engine="auto"       — fused_iter for an operator on a CUDA device,
                          "torch" for one on the CPU.
    spmv_engine         — "torch"/"cuda"/"bf16"/"auto"; defaults to
                          "auto" for fused_iter (init + residual
                          replacement only) and to following ``engine``
                          otherwise.
    replace_every       — if > 0, re-derive all auxiliary vectors from
                          their definitions (at full precision) every k
                          iterations. Default: 0, except 50 when
                          spmv_engine="bf16".
    core                — a prebuilt core from :func:`pin_pipecg_core`.

    ``b`` (and ``x0``) must be on the operator's device.
    """
    if b.device != A.device:
        raise ValueError(f"b is on {b.device}, the operator on {A.device}")
    if M is None:
        M = identity()
    if x0 is None:
        x0 = torch.zeros_like(b)
    elif x0.device != A.device:
        raise ValueError(f"x0 is on {x0.device}, the operator on {A.device}")
    core_name, spmv_engine, replace_every = _resolve_config(A, engine, spmv_engine,
                                                            replace_every, core)
    return _pipecg_impl(A, b, M, x0, float(atol), float(rtol), int(maxiter), core_name,
                        spmv_engine, replace_every, core)
