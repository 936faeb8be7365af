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
    "cuda"        [pallas]     any         via spmv_fn           fused_vma + the SPMV
                                                                 (spmv_dia / spmv_bell;
                                                                 CSR: segsum, torch ops)
    "fused_iter"  DIAMatrix, Jacobi or     inside the kernel     fused_iter
                  identity PC
    "auto"        fused_iter for a DIA operator with a Jacobi/identity PC
                  on a CUDA device, "cuda" for any other operator or PC
                  there, "torch" for an operator the caller put on the CPU.

The loop is a Python loop that never waits for the device inside an
iteration: gamma, delta, alpha, the norm, the iteration counter and an
``active`` flag are 0-d device tensors, and the kernels read alpha, beta
and ``active`` through pointers. The host polls ``active`` once every
``POLL_EVERY`` steps; the steps between convergence and the poll are
no-ops on the device (the kernels, ``spmv_bell`` among them, return
early; the plain core keeps x),
so iteration counts, x, the residual norm and the NaN-tailed history are
exactly those of a loop that stops at convergence.
``make_deep_pipecg_core(l)`` builds the communication-reduced sibling
loop (one global reduction per l iterations: the distributed methods
``pl2``/``pl3``).

Lane-batched solves (``SolverPlan.solve_batched``, the JAX package's
``jax.vmap`` of the loop) run the same loop over ``(k, n)`` vectors:
every scalar, the counter and ``active`` become ``(k,)`` device tensors,
the history ``(k, maxiter+1)``, and the host polls ``active.any()``. A
lane freezes when it converges, as vmap's per-lane select does: the
kernels leave an inactive lane's vectors untouched and the plain core
keeps every vector of it, so a lane that starts inactive (a zero rhs,
the server's padding) never lets its 0/0 scalars reach a vector.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .preconditioners import identity
from .reduce import Reducer, make_reducer

__all__ = [
    "POLL_EVERY",
    "Convergence",
    "solve_inputs",
    "dot_f32",
    "lane",
    "hold",
    "pipecg_vma_core",
    "torch_core",
    "vma_core_cuda",
    "make_fused_iter_core",
    "make_deep_pipecg_core",
    "resolve_core_name",
    "get_core",
    "core_names",
    "register_core",
    "run_pipecg",
]

POLL_EVERY = 16  # host polls for convergence once per this many steps


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product accumulated in at-least-float32 (float64 stays float64):
    a 0-d tensor for vectors, (k,) for (k, n) lanes. Each lane is reduced
    as one vector is, so a batched solve's scalars equal each lane's single
    solve bit for bit: on the card a (k, n) row sum adds its terms in
    another order than a 1-D sum."""
    acc = torch.promote_types(a.dtype, torch.float32)
    if a.dim() == 2:
        return torch.stack([torch.sum(a_.to(acc) * b_.to(acc)) for a_, b_ in zip(a, b)])
    return torch.sum(a.to(acc) * b.to(acc))


def lane(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-lane scalars shaped to scale ``v``: (k,) -> (k, 1) when v is
    (k, n); a 0-d scalar of a single solve is returned as it is."""
    return s[:, None] if v.dim() == 2 else s


def hold(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """A batched loop's vector update: every inactive lane keeps ``old``
    (vmap's per-lane select). A single solve takes ``new`` as it is."""
    return torch.where(active[:, None], new, old) if new.dim() == 2 else new


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
    0-d bool tensor ``active`` is False.

    Batched, on (k, n) vectors with (k,) alpha, beta and ``active``: an
    inactive lane keeps every vector (vmap's per-lane select)."""
    old = (z, q, s, p, x, r, u, w, m)
    *new, dots = pipecg_vma_core(z, q, s, p, x, r, u, w, n, m, inv_diag, lane(alpha, z),
                                 lane(beta, z))
    if active is not None:
        if z.dim() == 2:
            new = [hold(active, v, o) for v, o in zip(new, old)]
        else:
            new[4] = torch.where(active, new[4], x)
    return (*new, dots)


def vma_core_cuda(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    """The core through the fused_vma kernel (vectors updated in place).

    ``inv_diag=None`` (a preconditioner the loop applies itself) runs the
    kernel with a unit diagonal, as the JAX package's Pallas core does;
    the loop then replaces m by ``pc_fn(w)``. (k, n) vectors go through
    the kernel's lane-batched entry.
    """
    from ..kernels.fused_vma import fused_vma_dots, fused_vma_dots_batched

    inv = inv_diag if inv_diag is not None else torch.ones(w.shape[-1], dtype=w.dtype,
                                                           device=w.device)
    fused = fused_vma_dots_batched if w.dim() == 2 else fused_vma_dots
    *vecs, dots = fused(z, q, s, p, x, r, u, w, n, m, inv, alpha, beta, active)
    return (*vecs, dots.unbind(-1))


def make_fused_iter_core(A, data_dtype: Optional[torch.dtype] = None) -> Callable:
    """Build a whole-iteration core for one DIA operator (one kernel/iter).

    The core folds the banded SPMV n = A m into the VMA + PC + dots pass
    (``kernels.fused_iter``). It works on vectors padded to ``core.n_pad``
    (a multiple of the kernels' block); the padded diagonals are pinned
    on the core here — build once per plan, not per solve.
    ``data_dtype=torch.bfloat16`` pins them in bf16 (half the band's
    bytes); each entry is upcast to f32 before its product and the
    vectors stay f32, as the JAX package's ``data_dtype``. The core is
    called with the current m and a second buffer that receives the new
    m, and returns the updated vectors. ``inv_diag`` is required (the
    identity PC is a unit diagonal). (k, n_pad) vectors go through the
    kernel's lane-batched entry, which reads the band once for 8 lanes.

    Attributes: ``fuses_spmv=True``, ``n_pad``, ``padded_data``, ``offsets``.
    """
    from ..kernels.common import BLOCK, ceil_to
    from ..kernels.fused_iter import fused_iter_batched, fused_iter_step
    from ..sparse.formats import DIAMatrix

    if not isinstance(A, DIAMatrix):
        raise TypeError(
            f"core 'fused_iter' needs a DIAMatrix operator (its SPMV is a "
            f"fused banded kernel), got {type(A).__name__}"
        )
    n_pad = ceil_to(A.n, BLOCK)
    dp = torch.nn.functional.pad(A.data, (0, n_pad - A.n)).contiguous()
    if data_dtype is not None:
        dp = dp.to(data_dtype)
    offsets = A.offsets

    def core(z, q, s, p, x, r, u, w, m, m_out, inv_diag, alpha, beta, active=None):
        step = fused_iter_batched if z.dim() == 2 else fused_iter_step
        *vecs, dots = step(
            dp, offsets, z, q, s, p, x, r, u, w, m, m_out, inv_diag, alpha, beta, active
        )
        return (*vecs, dots.unbind(-1))

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

    device = getattr(A, "device", None)
    if device is None or device.type != "cuda":
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


def solve_inputs(A, b, M, x0):
    """``(M, x0)`` of a solve: identity and zeros by default; b and x0
    must lie on the operator's device."""
    if b.device != A.device:
        raise ValueError(f"b is on {b.device}, the operator on {A.device}")
    if x0 is None:
        x0 = torch.zeros_like(b)
    elif x0.device != A.device:
        raise ValueError(f"x0 is on {x0.device}, the operator on {A.device}")
    return identity() if M is None else M, x0


class Convergence:
    """Device-side convergence bookkeeping of every solver loop.

    Holds the threshold ``max(atol, rtol * norm0)``, the NaN-tailed
    history, the last norm while active, the iteration counter and the
    ``active`` flag, all on the device. :meth:`poll` is the one host sync,
    once per ``POLL_EVERY`` steps; :meth:`record` books step k without a
    sync, so a step after convergence changes nothing that is returned.
    For a batch ``norm0`` is (k,): every field gains the lane axis (the
    history is (k, maxiter+1)) and the loop runs while any lane is active.
    """

    def __init__(self, norm0: torch.Tensor, atol: float, rtol: float, maxiter: int):
        dev = norm0.device
        self.thresh = torch.maximum(
            torch.tensor(atol, dtype=norm0.dtype, device=dev),
            torch.tensor(rtol, dtype=norm0.dtype, device=dev) * norm0,
        )
        self.history = torch.full((*norm0.shape, maxiter + 1), math.nan, dtype=torch.float32,
                                  device=dev)
        self.history[..., 0] = norm0.to(torch.float32)
        self._nan = torch.tensor(math.nan, dtype=torch.float32, device=dev)
        self.norm = norm0
        self.iterations = torch.zeros(norm0.shape, dtype=torch.int32, device=dev)
        self.active = norm0 > self.thresh
        self.steps = 0

    def poll(self, k: int) -> bool:
        """True when the loop may stop before step k (syncs every POLL_EVERY steps)."""
        return k % POLL_EVERY == 0 and not bool(self.active.any())

    def record(self, k: int, norm_new: torch.Tensor) -> None:
        """Book step k's norm if the solve was still active, then update the flag."""
        self.history[..., k + 1] = torch.where(self.active, norm_new.to(torch.float32),
                                               self._nan)
        self.norm = torch.where(self.active, norm_new, self.norm)
        self.iterations = self.iterations + self.active
        self.active = self.active & (norm_new > self.thresh)
        self.steps = k + 1

    @property
    def converged(self) -> torch.Tensor:
        return self.norm <= self.thresh


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
    ``pc_fn`` is applied to w each iteration. Inside the loop ``spmv_fn``
    is called as ``spmv_fn(v, active=flag)`` with the device ``active``
    flag, which an SPMV kernel may read to skip its work once the solve
    has converged; init calls it as ``spmv_fn(v)``. Cores flagged
    ``fuses_spmv`` compute n = A m inside the kernel: the loop then
    carries no n and calls ``spmv_fn`` only for init and residual
    replacement. ``replace_spmv_fn`` overrides the SPMV of residual
    replacement only (the full-precision safety net under the "bf16"
    engine). Kernel cores update their vectors in place, so every vector
    the loop hands them is its own buffer. A reducer with a ``post``
    method (a mesh reducer, ``core.reduce``) is split in two: the loop
    posts the dot partials before the SPMV of line 22 and waits for their
    sums after it, so the reduction overlaps the SPMV. Returns
    ``(iterations, x, residual_norm, converged, history, steps)``.
    """
    if reducer is None:
        reducer = make_reducer("local")
    post = getattr(reducer, "post", None)
    if replace_spmv_fn is None:
        replace_spmv_fn = spmv_fn
    fused_spmv = bool(getattr(core, "fuses_spmv", False))
    dtype = b.dtype

    # init (Alg. 2 lines 1-3)
    r = b - spmv_fn(x0)
    u = pc_fn(r)
    w = spmv_fn(u)
    gamma, delta, nn = reducer(dot_f32(r, u), dot_f32(w, u), dot_f32(u, u))
    conv = Convergence(torch.sqrt(nn), atol, rtol, maxiter)
    m = pc_fn(w)
    n = None if fused_spmv else spmv_fn(m)
    z, q, s, p = (torch.zeros_like(b) for _ in range(4))
    x = x0.clone()  # kernel cores update x in place; the caller's x0 stays
    m_spare = torch.empty_like(m) if fused_spmv else None
    gamma_prev = alpha_prev = None

    for k in range(maxiter):
        if conv.poll(k):
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
                z, q, s, p, x, r, u, w, m, m_spare, inv_diag, a, bt, conv.active
            )
            m, m_spare = m_new, m
        else:
            z, q, s, p, x, r, u, w, m, (g_p, d_p, n_p) = core(
                z, q, s, p, x, r, u, w, n, m, inv_diag, a, bt, conv.active
            )
            if inv_diag is None:
                m = pc_fn(w)  # general (non-fused) preconditioner
        if post is None:
            gamma_new, delta_new, uu = reducer(g_p, d_p, n_p)
        else:
            wait = post(g_p, d_p, n_p)  # the sums are needed after the SPMV only
        if not fused_spmv:
            n = spmv_fn(m, active=conv.active)  # line 22
        if post is not None:
            gamma_new, delta_new, uu = wait()
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

        conv.record(k, norm_new)
        gamma, gamma_prev, delta, alpha_prev = gamma_new, gamma, delta_new, alpha
    return conv.iterations, x, conv.norm, conv.converged, conv.history, conv.steps


# ---------------------------------------------------------------------------
# depth-l pipelined (communication-reduced) CG — one reduction per l steps
# ---------------------------------------------------------------------------

def _per_lane(fn, *xs):
    """``fn`` on each lane of (k, ...) tensors, stacked: a lane's result is
    then bit for bit that of the same solve alone (a batched product may
    add in another order)."""
    return torch.stack([fn(*x) for x in zip(*xs)])


def _quad(a: torch.Tensor, M: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-lane a^T M c for (k, m) coordinates and (k, m, m) Gram matrices."""
    return (a * torch.bmm(M, c.unsqueeze(-1)).squeeze(-1)).sum(-1)


def make_deep_pipecg_core(l: int):
    r"""Build the depth-``l`` pipelined CG loop (one global reduction per l
    iterations), the JAX package's ``make_deep_pipecg_core``.

    Per outer step, on the split-preconditioned operator
    ``At = D^{-1/2} A D^{-1/2}`` (Jacobi/identity only: CG on ``At`` gives
    the iterates of Jacobi-PCG on ``A`` in exact arithmetic):

    * the monomial bases ``P_j = At^j p`` (j = 0..l) and ``R_j = At^j r``
      (j = 0..l-1): ``2l - 1`` SPMVs, no communication beyond the SPMV's;
    * one reduction: the Gram matrices ``V V^T`` and ``V D^{-1} V^T`` of
      ``V = [P | R]``, stacked, through the reducer's ``.array``;
    * l CG iterations in coordinates (length 2l + 1), every dot a small
      ``c^T G c`` form; a lane stops at its own iteration (a solve that
      converges at iteration 7 under ``pl3`` reports 7, not 9);
    * the vectors recovered from their coordinates, and residual
      replacement (``replace_every``) rounded to outer steps.

    The Gram matrices come back to the host once per outer step: the
    coordinate steps run there, in float32 on the CPU, on every rank of a
    mesh alike, so every rank reads the same bits and stops at the same
    iteration (a card's and the host's matrix products need not agree
    bit for bit). The loop therefore needs no convergence poll.

    ``b`` may be (k, n): k lanes, each with its own coordinates, norm and
    iteration count, and one reduction carrying all of them. Returns a
    loop with :func:`run_pipecg`'s signature and result tuple (``steps``
    counts the iterations the outer steps advanced), tagged
    ``pipeline_depth = l``; ``pc_fn`` and ``core`` are accepted for that
    signature and unused (the preconditioner is ``inv_diag``).
    """
    if l < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {l}")
    m = 2 * l + 1  # basis size: P_0..P_l, R_0..R_{l-1}

    # shift matrix: coordinates of (At v) from those of v. Columns l (P_l)
    # and 2l (R_{l-1}) are zero: the inner steps never apply At to a vector
    # reaching those basis tails
    S = torch.zeros(m, m, dtype=torch.float32)
    for j in range(l):
        S[j + 1, j] = 1.0
    for j in range(l - 1):
        S[l + 2 + j, l + 1 + j] = 1.0

    def run_deep_pipecg(
        b: torch.Tensor,
        x0: torch.Tensor,
        *,
        spmv_fn: Callable[[torch.Tensor], torch.Tensor],
        pc_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        core: Optional[Callable] = None,
        reducer: Optional[Reducer] = None,
        inv_diag: Optional[torch.Tensor] = None,
        atol: float,
        rtol: float,
        maxiter: int,
        replace_every: int = 0,
        replace_spmv_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ):
        del pc_fn, core  # elementwise PC only, through inv_diag
        if reducer is None:
            reducer = make_reducer("local")
        reduce_array = getattr(reducer, "array", None)
        if reduce_array is None:
            raise ValueError(
                "deep-pipeline methods need a reducer with an '.array' reduction (all "
                "core.reduce strategies have one; attach reducer.array on custom reducers)"
            )
        if replace_spmv_fn is None:
            replace_spmv_fn = spmv_fn
        lanes = b.dim() == 2
        k = b.shape[0] if lanes else 1
        dtype = b.dtype
        acc = torch.promote_types(dtype, torch.float32)
        S_acc = S.to(acc)

        # split preconditioning: solve At xt = bt with At = D^-1/2 A D^-1/2
        if inv_diag is not None:
            isd = torch.sqrt(inv_diag)
            dsq = torch.where(isd > 0, 1.0 / torch.where(isd > 0, isd, torch.ones_like(isd)),
                              torch.zeros_like(isd))
        else:
            isd = dsq = None

        def _split(v):
            return isd * v if isd is not None else v

        def _At(v, raw=spmv_fn):
            return _split(raw(_split(v)))

        def _rows(v):  # (k, ...) view of a single solve's tensors
            return v if lanes else v.unsqueeze(0)

        bt = _split(b)
        xt = dsq * x0 if dsq is not None else x0
        rt = bt - _At(xt)
        # the convergence metric of run_pipecg: ||u|| with u = D^-1 r, i.e.
        # rt^T D^-1 rt; one set-up reduction
        nn_part = dot_f32(rt, inv_diag * rt if inv_diag is not None else rt)
        norm = _rows(torch.sqrt(reducer(nn_part, nn_part, nn_part)[2])).cpu()
        thresh = torch.maximum(torch.tensor(atol, dtype=norm.dtype),
                               torch.tensor(rtol, dtype=norm.dtype) * norm)
        # +1 slack slot: writes of masked (stopped) inner steps land at
        # maxiter + 1 and are cut off at the end
        hist = torch.full((k, maxiter + 2), math.nan, dtype=torch.float32)
        hist[:, 0] = norm.to(torch.float32)
        it = torch.zeros(k, dtype=torch.int32)
        lane_ix = torch.arange(k)
        rr_outer = max(1, -(-replace_every // l)) if replace_every > 0 else 0
        p = rt
        outer = 0

        while bool(((norm > thresh) & (it < maxiter)).any()):
            # Z-basis recurrences: 2l-1 SPMVs, no extra reduction
            basis = [p]
            for _ in range(l):
                basis.append(_At(basis[-1]))
            basis.append(rt)
            for _ in range(l - 1):
                basis.append(_At(basis[-1]))
            V = torch.stack(basis, dim=-2)  # (m, R) or (k, m, R)
            Va = _rows(V.to(acc))

            # the one global reduction per l iterations
            G_loc = _per_lane(lambda v: v @ v.T, Va)
            if inv_diag is not None:
                H_loc = _per_lane(lambda v: (v * inv_diag.to(acc)) @ v.T, Va)
                GH = reduce_array(torch.stack([G_loc, H_loc], dim=1)).cpu()
                G, H = GH[:, 0], GH[:, 1]
            else:
                G = H = reduce_array(G_loc).cpu()

            # l CG iterations in coordinates, on the host (no communication)
            pc = torch.zeros(k, m, dtype=acc)
            pc[:, 0] = 1.0
            rc = torch.zeros(k, m, dtype=acc)
            rc[:, l + 1] = 1.0
            xc = torch.zeros(k, m, dtype=acc)
            for _ in range(l):
                active = (norm > thresh) & (it < maxiter)
                sc = pc @ S_acc.T  # coordinates of At p
                rr = _quad(rc, G, rc)
                alpha = rr / _quad(pc, G, sc)
                xc_n = xc + alpha[:, None] * pc
                rc_n = rc - alpha[:, None] * sc
                beta = _quad(rc_n, G, rc_n) / rr
                pc_n = rc_n + beta[:, None] * pc
                norm_n = torch.sqrt(torch.clamp(_quad(rc_n, H, rc_n), min=0.0))
                xc = torch.where(active[:, None], xc_n, xc)
                rc = torch.where(active[:, None], rc_n, rc)
                pc = torch.where(active[:, None], pc_n, pc)
                norm = torch.where(active, norm_n.to(norm.dtype), norm)
                slot = torch.where(active, it.long() + 1, maxiter + 1)
                hist[lane_ix, slot] = norm_n.to(torch.float32)
                it = it + active.to(torch.int32)

            # recover the vectors from their coordinates
            def combine(c):
                c = c.to(device=V.device, dtype=dtype)
                out = _per_lane(lambda c_, v_: c_ @ v_, c, _rows(V))
                return out if lanes else out[0]

            xt = xt + combine(xc)
            rt = combine(rc)
            p = combine(pc)
            outer += 1
            if rr_outer and outer % rr_outer == 0:
                # residual replacement at outer-step cadence: re-derive the
                # true split residual at full precision
                rt = bt - _At(xt, raw=replace_spmv_fn)

        dev = b.device
        x = _split(xt)  # back-transform: x = D^-1/2 xt
        out = (it.to(dev), x, norm.to(dev), (norm <= thresh).to(dev),
               hist[:, : maxiter + 1].to(dev))
        if not lanes:
            out = (out[0][0], x, out[2][0], out[3][0], out[4][0])
        return (*out, outer * l)

    run_deep_pipecg.pipeline_depth = l
    run_deep_pipecg.spmvs_per_iteration = (2 * l - 1) / l
    return run_deep_pipecg
