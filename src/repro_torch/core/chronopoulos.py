"""Chronopoulos–Gear CG: one synchronization per iteration.

The stepping stone between PCG (3 reductions) and PIPECG (1 overlapped
reduction): the two recurrence dot products and the convergence norm
are computed back to back so they reduce in a single fused
synchronization, but the result is still consumed in the same
iteration — no overlap slack.

Written as ``run_pipecg`` is (device scalars, one host poll per
``POLL_EVERY`` steps); the SPMV goes through ``spmv(A, ·)`` ("auto").
A ``(k, n)`` rhs runs the same loop over lanes, as ``pcg`` does.
"""
from __future__ import annotations

import torch

from ..sparse.spmv import spmv
from .iteration import Convergence, dot_f32, hold, lane, solve_inputs
from .preconditioners import apply_pc
from .types import SolveResult

__all__ = ["chronopoulos_cg"]


def _cg_cg_impl(A, b, M, x0, atol: float, rtol: float, maxiter: int) -> SolveResult:
    dtype = b.dtype
    r = b - spmv(A, x0)
    u = apply_pc(M, r)
    w = spmv(A, u)
    gamma = dot_f32(r, u)
    delta = dot_f32(w, u)
    conv = Convergence(torch.sqrt(dot_f32(u, u)), atol, rtol, maxiter)
    alpha = (gamma / delta).to(dtype)
    beta = torch.zeros_like(alpha)
    p = torch.zeros_like(b)
    s = torch.zeros_like(b)
    x = x0.clone()  # the result never aliases the caller's x0

    for k in range(maxiter):
        if conv.poll(k):
            break
        act = conv.active
        a, bt = lane(alpha, b), lane(beta, b)
        p = hold(act, u + bt * p, p)
        s = hold(act, w + bt * s, s)
        x = torch.where(lane(act, b), x + a * p, x)
        r = hold(act, r - a * s, r)
        u = apply_pc(M, r)
        w = spmv(A, u, active=act)
        # single synchronization: the three dots reduce together
        gamma_new = dot_f32(r, u)
        delta = dot_f32(w, u)
        conv.record(k, torch.sqrt(dot_f32(u, u)))
        beta = (gamma_new / gamma).to(dtype)
        alpha = (gamma_new / (delta - beta * gamma_new / alpha)).to(dtype)
        gamma = gamma_new
    return SolveResult(x=x, iterations=conv.iterations, residual_norm=conv.norm,
                       converged=conv.converged, history=conv.history, steps=conv.steps)


def chronopoulos_cg(A, b, M=None, x0=None, atol: float = 1e-5, rtol: float = 0.0,
                    maxiter: int = 10000) -> SolveResult:
    """Solve SPD ``A x = b`` with Chronopoulos–Gear CG (one reduction per
    iteration). ``b`` (and ``x0``) must be on the operator's device."""
    M, x0 = solve_inputs(A, b, M, x0)
    return _cg_cg_impl(A, b, M, x0, float(atol), float(rtol), int(maxiter))
