r"""The PIPECG iteration — one recurrence, several execution strategies.

Every PIPECG execution in the port runs the same recurrence (Ghysels &
Vanroose Alg. 2, lines 10-21):

    scalars   beta_i, alpha_i           <- gamma/delta/alpha of it. i-1/i
    VMAs      z,q,s,p (10-13)           <- beta
    VMAs      x,r,u,w (14-17)           <- alpha
    dots      gamma', delta', ||u||^2   (18-20)
    PC        m = M^-1 w                (21)
    SPMV      n = A m                   (22)

The iteration core is the strategy (JAX package names in brackets):

    core          needs                    SPMV per iteration    CUDA kernels/iter
    -----------   ----------------------   -------------------   -----------------
    "torch"       [jnp]        any         via spmv_fn           0 (plain PyTorch)
    "cuda"        [pallas]     any         via spmv_fn           fused_vma + spmv_dia
    "fused_iter"  DIAMatrix, Jacobi or     inside the kernel     fused_iter
                  identity PC
    "auto"        fused_iter for a DIA operator on a CUDA device, "torch"
                  for an operator the caller put on the CPU.

The loop is a Python loop that never waits for the device inside an
iteration: gamma, delta, alpha, the norm, the iteration counter and an
``active`` flag are 0-d device tensors, and the kernels read alpha, beta
and ``active`` through pointers. The host polls ``active`` once every
``POLL_EVERY`` steps; the steps between convergence and the poll are
no-ops on the device (the kernels return early, the plain core keeps x),
so iteration counts, x, the residual norm and the NaN-tailed history are
exactly those of a loop that stops at convergence.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .reduce import Reducer, make_reducer

__all__ = [
    "POLL_EVERY",
    "dot_f32",
    "pipecg_vma_core",
    "torch_core",
    "vma_core_cuda",
    "make_fused_iter_core",
    "resolve_core_name",
    "get_core",
    "core_names",
    "register_core",
    "run_pipecg",
]

POLL_EVERY = 16  # host polls for convergence once per this many steps


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product accumulated in at-least-float32 (float64 stays float64)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.sum(a.to(acc) * b.to(acc))


def pipecg_vma_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta):
    """THE PIPECG recurrence: 8 VMAs + (Jacobi) PC + 3 dot partials.

    ``inv_diag`` is the fused Jacobi inverse diagonal, or None when the
    preconditioner is applied by the caller (m is then returned as w).
    Returns new tensors plus the dots ``(gamma, delta, ||u||^2)``.
    """
    z = n + beta * z
    q = m + beta * q
    s = w + beta * s
    p = u + beta * p
    x = x + alpha * p
    r = r - alpha * s
    u = u - alpha * q
    w = w - alpha * z
    m = inv_diag * w if inv_diag is not None else w
    return z, q, s, p, x, r, u, w, m, (dot_f32(r, u), dot_f32(w, u), dot_f32(u, u))


def torch_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    """The plain core for the loop: the recurrence, with x kept where the
    0-d bool tensor ``active`` is False."""
    z, q, s, p, x_new, r, u, w, m, dots = pipecg_vma_core(
        z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta
    )
    if active is not None:
        x_new = torch.where(active, x_new, x)
    return z, q, s, p, x_new, r, u, w, m, dots


def vma_core_cuda(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    """The core through the fused_vma kernel (vectors updated in place).

    ``inv_diag`` is required: the identity PC is a unit diagonal.
    """
    from ..kernels.fused_vma import fused_vma_dots

    *vecs, dots = fused_vma_dots(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active)
    return (*vecs, (dots[0], dots[1], dots[2]))


def make_fused_iter_core(A) -> Callable:
    """Build a whole-iteration core for one DIA operator (one kernel/iter).

    The core folds the banded SPMV n = A m into the VMA + PC + dots pass
    (``kernels.fused_iter``). It works on vectors padded to ``core.n_pad``
    (a multiple of the kernels' block); the padded diagonals are pinned
    on the core here — build once per plan, not per solve. The core is
    called with the current m and a second buffer that receives the new
    m, and returns the updated vectors. ``inv_diag`` is required (the
    identity PC is a unit diagonal).

    Attributes: ``fuses_spmv=True``, ``n_pad``, ``padded_data``, ``offsets``.
    """
    from ..kernels.common import BLOCK, ceil_to
    from ..kernels.fused_iter import fused_iter_step
    from ..sparse.formats import DIAMatrix

    if not isinstance(A, DIAMatrix):
        raise TypeError(
            f"core 'fused_iter' needs a DIAMatrix operator (its SPMV is a "
            f"fused banded kernel), got {type(A).__name__}"
        )
    n_pad = ceil_to(A.n, BLOCK)
    dp = torch.nn.functional.pad(A.data, (0, n_pad - A.n)).contiguous()
    offsets = A.offsets

    def core(z, q, s, p, x, r, u, w, m, m_out, inv_diag, alpha, beta, active=None):
        *vecs, dots = fused_iter_step(
            dp, offsets, z, q, s, p, x, r, u, w, m, m_out, inv_diag, alpha, beta, active
        )
        return (*vecs, (dots[0], dots[1], dots[2]))

    core.fuses_spmv = True
    core.n_pad = n_pad
    core.padded_data = dp
    core.offsets = offsets
    return core


make_fused_iter_core.needs_operator = True

_CORES = {
    "torch": torch_core,
    "cuda": vma_core_cuda,
    "fused_iter": make_fused_iter_core,
}


def register_core(name: str, core: Callable, *, overwrite: bool = False) -> None:
    """Register an iteration core: a plain core callable (the
    ``torch_core`` contract) or, flagged ``core.needs_operator = True``, a
    factory ``core(A) -> core_fn`` built per operator. Raises ValueError
    if ``name`` is taken, unless ``overwrite=True``."""
    if name in _CORES and not overwrite:
        raise ValueError(
            f"iteration core {name!r} already registered; pass overwrite=True to replace it"
        )
    _CORES[name] = core


def core_names() -> Tuple[str, ...]:
    return tuple(sorted(_CORES))


def resolve_core_name(engine: str, A=None) -> str:
    """The core name ``get_core`` builds for this engine and operator.

    "auto": "fused_iter" for a DIA operator on a CUDA device (the caller
    checks the Jacobi/identity PC), "cuda" for another operator on a CUDA
    device, "torch" for an operator on the CPU.
    """
    if engine != "auto":
        return engine
    from ..sparse.formats import DIAMatrix

    if A is None or A.device.type != "cuda":
        return "torch"
    return "fused_iter" if isinstance(A, DIAMatrix) else "cuda"


def get_core(engine: str, A=None) -> Callable:
    """Resolve an iteration core; operator-built cores take ``A``."""
    engine = resolve_core_name(engine, A)
    if engine not in _CORES:
        raise ValueError(f"unknown iteration engine {engine!r}; have {core_names()}")
    core = _CORES[engine]
    if getattr(core, "needs_operator", False):
        return core(A)
    return core


def run_pipecg(
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    spmv_fn: Callable[[torch.Tensor], torch.Tensor],
    pc_fn: Callable[[torch.Tensor], torch.Tensor],
    core: Callable = torch_core,
    reducer: Optional[Reducer] = None,
    inv_diag: Optional[torch.Tensor] = None,
    atol: float,
    rtol: float,
    maxiter: int,
    replace_every: int = 0,
    replace_spmv_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """One PIPECG solve, generic over SPMV / PC / core / reduction strategy.

    When ``inv_diag`` is given the core fuses the Jacobi PC; otherwise
    ``pc_fn`` is applied to w each iteration. Cores flagged
    ``fuses_spmv`` compute n = A m inside the kernel: the loop then
    carries no n and calls ``spmv_fn`` only for init and residual
    replacement. ``replace_spmv_fn`` overrides the SPMV of residual
    replacement only (the full-precision safety net under the "bf16"
    engine). Kernel cores update their vectors in place, so every vector
    the loop hands them is its own buffer. Returns ``(iterations, x,
    residual_norm, converged, history, steps)``.
    """
    if reducer is None:
        reducer = make_reducer("local")
    if replace_spmv_fn is None:
        replace_spmv_fn = spmv_fn
    fused_spmv = bool(getattr(core, "fuses_spmv", False))
    dtype, dev = b.dtype, b.device

    # init (Alg. 2 lines 1-3)
    r = b - spmv_fn(x0)
    u = pc_fn(r)
    w = spmv_fn(u)
    gamma, delta, nn = reducer(dot_f32(r, u), dot_f32(w, u), dot_f32(u, u))
    norm = torch.sqrt(nn)
    m = pc_fn(w)
    n = None if fused_spmv else spmv_fn(m)
    thresh = torch.maximum(
        torch.tensor(atol, dtype=norm.dtype, device=dev),
        torch.tensor(rtol, dtype=norm.dtype, device=dev) * norm,
    )
    hist = torch.full((maxiter + 1,), math.nan, dtype=torch.float32, device=dev)
    hist[0] = norm.to(torch.float32)
    nan = torch.tensor(math.nan, dtype=torch.float32, device=dev)
    z, q, s, p = (torch.zeros_like(b) for _ in range(4))
    x = x0.clone()  # kernel cores update x in place; the caller's x0 stays
    m_spare = torch.empty_like(m) if fused_spmv else None
    i = torch.zeros((), dtype=torch.int32, device=dev)
    active = norm > thresh
    gamma_prev = alpha_prev = None
    steps = 0

    for k in range(maxiter):
        if k % POLL_EVERY == 0 and not bool(active):  # the one host sync
            break
        # scalars (lines 5-9) — consume the previous iteration's dots. While
        # active, the device counter i equals k, so the branch is k's.
        if k > 0:
            beta = gamma / gamma_prev
            alpha = gamma / (delta - beta * gamma / alpha_prev)
        else:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        a, bt = alpha.to(dtype), beta.to(dtype)
        if fused_spmv:
            z, q, s, p, x, r, u, w, m_new, (g_p, d_p, n_p) = core(
                z, q, s, p, x, r, u, w, m, m_spare, inv_diag, a, bt, active
            )
            m, m_spare = m_new, m
        else:
            z, q, s, p, x, r, u, w, m, (g_p, d_p, n_p) = core(
                z, q, s, p, x, r, u, w, n, m, inv_diag, a, bt, active
            )
            if inv_diag is None:
                m = pc_fn(w)  # general (non-fused) preconditioner
        gamma_new, delta_new, uu = reducer(g_p, d_p, n_p)
        if not fused_spmv:
            n = spmv_fn(m)  # line 22
        norm_new = torch.sqrt(uu)

        if replace_every > 0 and k > 0 and (k + 1) % replace_every == 0:
            # Residual replacement (Cools & Vanroose): re-derive every
            # auxiliary vector from its definition to arrest the roundoff
            # drift of the recurrences. x and p are unchanged by it.
            r = b - replace_spmv_fn(x)
            u = pc_fn(r)
            w = replace_spmv_fn(u)
            s = replace_spmv_fn(p)
            q = pc_fn(s)
            z = replace_spmv_fn(q)
            m = pc_fn(w)
            if not fused_spmv:
                n = replace_spmv_fn(m)
            gamma_new, delta_new, nn = reducer(dot_f32(r, u), dot_f32(w, u), dot_f32(u, u))
            norm_new = torch.sqrt(nn)

        hist[k + 1] = torch.where(active, norm_new.to(torch.float32), nan)
        norm = torch.where(active, norm_new, norm)
        i = i + active
        active = active & (norm_new > thresh)
        gamma, gamma_prev, delta, alpha_prev = gamma_new, gamma, delta_new, alpha
        steps = k + 1
    return i, x, norm, norm <= thresh, hist, steps
