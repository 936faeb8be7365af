"""Preconditioned Conjugate Gradient — Algorithm 1 of the paper.

The baseline every speedup in the paper is measured against
(Paralution/PETSc PCG are this algorithm). Three reductions per
iteration, each a hard synchronization point: nothing overlaps.

Written as ``run_pipecg`` is: every scalar is a 0-d device tensor, the
:class:`~repro_torch.core.iteration.Convergence` bookkeeping keeps the
``active`` flag on the device, and the host polls it once per
``POLL_EVERY`` steps. The SPMV goes through ``spmv(A, ·)`` ("auto"), so
on the card it is the format's CUDA kernel (``spmv_bell``, ``spmv_dia``);
the loop hands it the ``active`` flag, so ``spmv_bell`` skips its work
in the steps between convergence and the poll.

A ``(k, n)`` rhs runs the same loop over lanes (the JAX package's
``jax.vmap``): (k,) scalars, the kernels' lane-batched SPMV, and an
inactive lane keeps p, r and x (vmap's per-lane select).
"""
from __future__ import annotations

import torch

from ..sparse.spmv import spmv
from .iteration import Convergence, dot_f32, hold, lane, solve_inputs
from .preconditioners import apply_pc
from .types import SolveResult

__all__ = ["pcg", "dot_f32"]


def _pcg_impl(A, b, M, x0, atol: float, rtol: float, maxiter: int) -> SolveResult:
    dtype = b.dtype
    r = b - spmv(A, x0)
    u = apply_pc(M, r)
    gamma = dot_f32(u, r)
    conv = Convergence(torch.sqrt(dot_f32(u, u)), atol, rtol, maxiter)
    gamma_prev = torch.ones_like(gamma)
    p = torch.zeros_like(b)
    x = x0.clone()  # the result never aliases the caller's x0

    for k in range(maxiter):
        if conv.poll(k):
            break
        act = conv.active
        beta = lane((gamma / gamma_prev if k > 0 else torch.zeros_like(gamma)).to(dtype), b)
        p = hold(act, u + beta * p, p)
        s = spmv(A, p, active=act)
        delta = dot_f32(s, p)  # reduction 1
        alpha = lane((gamma / delta).to(dtype), b)
        x = torch.where(lane(act, b), x + alpha * p, x)
        r = hold(act, r - alpha * s, r)
        u = apply_pc(M, r)
        gamma_new = dot_f32(u, r)  # reduction 2
        conv.record(k, torch.sqrt(dot_f32(u, u)))  # reduction 3
        gamma, gamma_prev = gamma_new, gamma
    return SolveResult(x=x, iterations=conv.iterations, residual_norm=conv.norm,
                       converged=conv.converged, history=conv.history, steps=conv.steps)


def pcg(A, b, M=None, x0=None, atol: float = 1e-5, rtol: float = 0.0,
        maxiter: int = 10000) -> SolveResult:
    """Solve SPD ``A x = b`` with PCG (Algorithm 1).

    Convergence criterion is the paper's: sqrt((u, u)) <= max(atol,
    rtol*norm0) where u is the preconditioned residual. ``b`` (and
    ``x0``) must be on the operator's device.
    """
    M, x0 = solve_inputs(A, b, M, x0)
    return _pcg_impl(A, b, M, x0, float(atol), float(rtol), int(maxiter))
