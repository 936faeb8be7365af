"""Top-level solver API of the port — one-shot ``solve`` over the plan cache.

``repro_torch.plan(A, ...)`` is the primary entry point (see
``repro_torch.plan``). ``repro_torch.solve(A, b, ...)`` fetches the
matching plan from a keyed LRU cache and runs ``plan.solve(b)``, so
repeated solves against one operator reuse its pinned core.

``engine``: "torch" (plain PyTorch, the JAX package's "jnp"), "cuda"
(fused_vma kernel + spmv_dia kernel, the JAX "pallas"), "fused_iter" (the
whole iteration as one CUDA kernel) or "auto" (fused_iter on a CUDA
operator, torch on a CPU one). ``spmv_engine``: "torch"/"cuda"/"bf16"/"auto".
"""
from __future__ import annotations

from .core.types import SolveResult
from .plan import SolverPlan, clear_plan_cache, get_plan, plan, plan_cache_stats, solver_names

__all__ = [
    "solve",
    "plan",
    "SolverPlan",
    "get_plan",
    "solver_names",
    "plan_cache_stats",
    "clear_plan_cache",
]


def solve(A, b, method: str = "pipecg", engine: str = "auto", M="jacobi", x0=None,
          atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
          **kwargs) -> SolveResult:
    """Solve SPD ``A x = b`` once, through a cached plan."""
    p = get_plan(A, method=method, engine=engine, M=M, maxiter=maxiter, **kwargs)
    return p.solve(b, x0=x0, atol=atol, rtol=rtol)
