"""SolveReport: one solve, every number needed to check a "faster" claim.

A solve result here carries its evidence: the trimmed convergence curve,
iterations to tolerance, time to solution, hand-written kernel launches
per solver step (counted from the kernel wrappers' launch counters, the
counterpart of the JAX package's ``pallas_call`` census), the structural
bytes-moved model and the achieved GB/s against the card's HBM peak
(``launch.roofline.HW``), residual-replacement events, plan-cache traffic
and an environment fingerprint (torch, CUDA, the card and its power
limit) that makes two records comparable, or not.

``SolverPlan.solve`` builds one when observability is enabled
(``plan.last_report``); :func:`solve_report` is the manual form.
:func:`convergence_curve` is the one NaN-trimming implementation:
``SolveResult.history`` is NaN-padded past convergence and has no NaN
tail at an exactly-maxiter solve.
"""
from __future__ import annotations

import functools
import json
import platform
import subprocess
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "convergence_curve",
    "iterations_from_history",
    "env_fingerprint",
    "comparable_env",
    "structural_bytes_per_elem",
    "kernel_launches",
    "plan_launches_per_iteration",
    "SolveReport",
    "solve_report",
]


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


# ---------------------------------------------------------------------------
# convergence-curve trimming (the one implementation)
# ---------------------------------------------------------------------------

def _trim_row(h: np.ndarray) -> np.ndarray:
    nan = np.isnan(h)
    if not nan.any():
        # an exactly-maxiter solve: all maxiter+1 entries are real, the
        # whole row is the curve
        return h
    return h[: int(np.argmax(nan))]


def convergence_curve(result_or_history):
    """Trim the NaN padding from a solve history.

    Accepts a ``SolveResult`` (anything with ``.history``), a tensor or
    a numpy array. A 1-D history gives one ``np.ndarray`` of length
    ``iterations + 1`` (entry 0 is the initial preconditioned residual
    norm); a 2-D (batched) history a list of per-row arrays, ragged
    since lanes converge at different iterations.
    """
    h = _numpy(getattr(result_or_history, "history", result_or_history))
    if h.ndim == 1:
        return _trim_row(h)
    if h.ndim == 2:
        return [_trim_row(row) for row in h]
    raise ValueError(f"history must be 1-D or 2-D, got shape {h.shape}")


def iterations_from_history(history):
    """Per-solve iteration counts derived from the NaN tail of history.

    1-D -> int; 2-D (k, maxiter+1) -> int64 array of shape (k,). Takes a
    tensor on any device or a numpy array; a batched solve's lanes each
    carry their own NaN tail, so the counts are honest per rhs even
    though the bucket's wall clock is shared.
    """
    h = _numpy(history)
    valid = (~np.isnan(h)).sum(axis=-1)
    iters = np.maximum(valid - 1, 0)
    if h.ndim == 1:
        return int(iters)
    return iters.astype(np.int64)


# ---------------------------------------------------------------------------
# environment fingerprint (what makes two records comparable)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _power_limit() -> Optional[str]:
    """The first card's power limit as nvidia-smi prints it ("700.00 W")."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def env_fingerprint() -> Dict[str, Any]:
    """Torch, CUDA, the card's name and its power limit, for records.

    ``backend`` is "cuda" where torch sees a card, else "cpu"; a card set
    below its maximum power runs slower under load, so the limit is part
    of what makes two timings comparable.
    """
    import torch

    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else (platform.machine() or "cpu"),
        "device_count": torch.cuda.device_count() if cuda else 1,
        "power_limit": _power_limit() if cuda else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": platform.python_version(),
    }


_COMPARABLE_KEYS = ("backend", "device_kind", "power_limit", "torch_version", "cuda_version")


def comparable_env(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Whether wall-clock numbers from two fingerprints may be compared:
    the same backend, card, power limit, torch and CUDA."""
    return all(a.get(k) == b.get(k) for k in _COMPARABLE_KEYS)


# ---------------------------------------------------------------------------
# structural traffic model + launch census
# ---------------------------------------------------------------------------

# the port's core names and the JAX package's for the same structure
_CORE_STRUCTURE = {"torch": "plain", "jnp": "plain", "cuda": "vma", "pallas": "vma",
                   "fused_iter": "fused_iter"}


def structural_bytes_per_elem(core: str, n_diags: int, elem_bytes: int = 4) -> Optional[float]:
    """Per-iteration bytes per row each core moves by construction.

    torch [jnp]         separate passes: SPMV (band + x + y) + 8 triads
                        (2 reads, 1 write each) + PC (3) + 3 dots (2 reads).
    cuda [pallas]       SPMV kernel (band + x + y) + one fused VMA kernel
                        (11 reads + 9 writes).
    fused_iter          one kernel: band + m + 8 state vectors + inv_diag
                        read, 9 vectors written (dot partials are noise).

    Returns None for a core the model does not cover (a plug-in).
    """
    vec = {
        "plain": (n_diags + 2) + 8 * 3 + 3 + 3 * 2,
        "vma": (n_diags + 2) + (11 + 9),
        "fused_iter": n_diags + 10 + 9,
    }.get(_CORE_STRUCTURE.get(core))
    return None if vec is None else vec * float(elem_bytes)


def _kernel_wrappers():
    from ..kernels import (
        fused_dots,
        fused_iter_batched,
        fused_iter_step,
        fused_vma_dots,
        fused_vma_dots_batched,
        spmv_bell_batched,
        spmv_bell_cuda,
        spmv_dia_batched,
        spmv_dia_batched_bf16,
        spmv_dia_cuda,
    )

    return (fused_dots, fused_iter_batched, fused_iter_step, fused_vma_dots,
            fused_vma_dots_batched, spmv_bell_batched, spmv_bell_cuda, spmv_dia_batched,
            spmv_dia_batched_bf16, spmv_dia_cuda)


def kernel_launches() -> int:
    """Launches of the solver's hand-written kernels so far in this process
    (the sum of their wrappers' ``launches`` counters)."""
    return sum(w.launches for w in _kernel_wrappers())


def plan_launches_per_iteration(plan, b, steps: int = 16):
    """Hand-written kernel launches per step of a plan's solver loop, counted.

    Runs the plan's loop twice on ``b`` with atol = rtol = 0, for ``steps``
    and ``2 * steps`` steps, and divides the difference of the kernel
    launch counters by the difference of the steps taken, so set-up
    launches (init SPMVs) cancel. ``fused_iter`` gives 1, the ``cuda`` core
    with a CUDA SPMV 2, the plain path 0. A plan on the CPU launches no
    kernel (the wrappers run their plain versions on CPU tensors), so it
    gives 0 without running. The count is an int when whole (a deep
    pipeline's may be a fraction). Other threads launching kernels at the
    same time would be counted too. Returns None when the loop stopped
    before its steps (a breakdown).
    """
    import torch

    if plan.device.type != "cuda":
        return 0
    counted = []
    for m in (steps, 2 * steps):
        before = kernel_launches()
        res = plan._run_fixed(b, m)
        torch.cuda.synchronize(plan.device)
        counted.append((kernel_launches() - before, res.steps))
    (l1, s1), (l2, s2) = counted
    if s2 <= s1:
        return None
    per = (l2 - l1) / (s2 - s1)
    return int(per) if float(per).is_integer() else per


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclass
class SolveReport:
    """Everything one solve claims, in checkable form."""

    # identity
    method: str
    engine: str
    core: Optional[str]
    operator: str
    n: Optional[int]
    dtype: str
    distributed: bool
    # convergence
    iterations: int
    converged: bool
    residual_norm: float
    curve: np.ndarray  # trimmed, length iterations+1
    # cost
    time_s: Optional[float]
    cold_start: bool  # this solve built a runner: wall time is not steady-state
    time_per_iter_s: Optional[float]
    launches_per_iter: Optional[float]
    est_bytes_per_iter: Optional[float]
    achieved_gbs: Optional[float]
    frac_of_hbm_peak: Optional[float]
    # numerics safety net
    replace_every: int
    rr_events: int
    # plan economics
    trace_count: int
    plan_cache: Dict[str, int] = field(default_factory=dict)
    # provenance
    env: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "curve"}
        d["curve"] = [float(x) for x in np.asarray(self.curve).ravel()]
        return d

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kwargs)

    def summary(self) -> str:
        """Multi-line human-readable report."""
        lines = [
            f"SolveReport: {self.method}/{self.engine}"
            + (f" core={self.core}" if self.core else "")
            + f"  {self.operator}(n={self.n}, {self.dtype})"
            + ("  [distributed]" if self.distributed else ""),
            f"  convergence : {self.iterations} iters, converged={self.converged}, "
            f"|u|={self.residual_norm:.3e}",
        ]
        if len(self.curve):
            lines.append(
                f"  curve       : {self.curve[0]:.3e} -> {self.curve[-1]:.3e} "
                f"({len(self.curve)} points)"
            )
        if self.time_s is not None:
            per = f", {self.time_per_iter_s*1e6:.1f} us/iter" if self.time_per_iter_s else ""
            cold = "  [cold start: includes building a runner]" if self.cold_start else ""
            lines.append(f"  time        : {self.time_s*1e3:.3f} ms{per}{cold}")
        if self.launches_per_iter is not None:
            lines.append(f"  launches    : {self.launches_per_iter} kernel(s)/step "
                         "(kernel launch counters)")
        if self.achieved_gbs is not None:
            lines.append(
                f"  bandwidth   : {self.achieved_gbs:.2f} GB/s achieved "
                f"({self.frac_of_hbm_peak:.1%} of the HBM peak, structural model)"
            )
        if self.replace_every:
            lines.append(
                f"  resid-repl  : every {self.replace_every} iters -> {self.rr_events} event(s)"
            )
        lines.append(f"  plan        : trace_count={self.trace_count}, cache={self.plan_cache}")
        env = self.env
        if env:
            lines.append(f"  env         : {env.get('device_kind')} "
                         f"({env.get('power_limit') or 'no power limit read'}), "
                         f"torch {env.get('torch_version')}, CUDA {env.get('cuda_version')}")
        return "\n".join(lines)


def solve_report(plan, result, *, elapsed_s: Optional[float] = None, b=None,
                 launches: Optional[float] = None, cold_start: bool = False) -> SolveReport:
    """Build a :class:`SolveReport` from a plan and its ``SolveResult``.

    ``elapsed_s`` is the synchronised wall time of the solve if the caller
    measured one (``SolverPlan.solve`` does, when observability is on);
    ``b`` enables the launch census (:func:`plan_launches_per_iteration`,
    which runs the plan's loop); ``launches`` passes a count already taken
    (plans cache theirs). ``cold_start`` marks a solve whose wall time
    includes building a runner: the report keeps that time but derives no
    per-iteration time or bandwidth from it. Achieved GB/s and the share of
    the HBM peak are derived only for a plan on a CUDA device.
    """
    from ..launch.roofline import HW
    from ..plan import plan_cache_stats

    desc = plan.describe()
    iterations = int(_numpy(result.iterations).max())
    curve = convergence_curve(result)
    if isinstance(curve, list):  # batched result: report the worst lane
        curve = max(curve, key=len)

    core = desc.get("core")
    if launches is None and b is not None:
        launches = plan_launches_per_iteration(plan, b)

    n = desc.get("n")
    est_bpe = None
    data = getattr(plan.A, "data", None)
    if core is not None and data is not None:
        est_bpe = structural_bytes_per_elem(core, int(data.shape[0]), int(data.element_size()))
    est_bytes = None if (est_bpe is None or n is None) else est_bpe * n

    time_per_iter = achieved = frac = None
    if elapsed_s is not None and iterations > 0 and not cold_start:
        time_per_iter = elapsed_s / iterations
        if est_bytes is not None and plan.device.type == "cuda":
            achieved = est_bytes / time_per_iter / 1e9
            frac = achieved / (HW["hbm_bw"] / 1e9)

    replace_every = int(desc.get("replace_every") or 0)
    rr_events = iterations // replace_every if replace_every > 0 else 0

    return SolveReport(
        method=desc.get("method", plan.method),
        engine=desc.get("engine", "?"),
        core=core,
        operator=desc.get("operator", type(plan.A).__name__),
        n=n,
        dtype=desc.get("dtype", "?"),
        distributed=bool(desc.get("distributed", False)),
        iterations=iterations,
        converged=bool(_numpy(result.converged).all()),
        residual_norm=float(_numpy(result.residual_norm).max()),
        curve=curve,
        time_s=elapsed_s,
        cold_start=cold_start,
        time_per_iter_s=time_per_iter,
        launches_per_iter=launches,
        est_bytes_per_iter=est_bytes,
        achieved_gbs=achieved,
        frac_of_hbm_peak=frac,
        replace_every=replace_every,
        rr_events=rr_events,
        trace_count=plan.trace_count,
        plan_cache=plan_cache_stats(),
        env=env_fingerprint(),
    )
