"""Top-level solver API of the port — one-shot ``solve`` over the plan cache.

``repro_torch.plan(A, ...)`` is the primary entry point (see
``repro_torch.plan``). ``repro_torch.solve(A, b, method=..., ...)``
fetches the matching plan from a keyed LRU cache and runs
``plan.solve(b)``, so repeated solves against one operator reuse its
pinned core.

``method``: "pipecg" (default), "pcg" or "chronopoulos" (the registry of
``repro_torch.plan.register_solver``), or a distributed method over a
mesh of the card and the host's cores (``core.distributed``): "h1"/"h2"
(all-gather SPMV; three or one reductions), "h3" (halo SPMV, one packed
reduction: the paper's Hybrid-PIPECG-3), "h4" (hierarchical reduction,
pass ``sub=``), "pl2"/"pl3" (one reduction per 2 or 3 iterations), with
``shards=``, ``partition="rows"|"nnz"``, ``weights=`` (the performance
model's relative speeds), ``devices=`` (default: the card, then the
host), ``mesh=``, ``reducer=``, ``spmv=``, ``replace_every=``. ``engine``: "torch" (plain
PyTorch, the JAX package's "jnp"), "cuda" (fused_vma kernel + the
format's SPMV, the JAX "pallas"), "fused_iter" (the whole iteration as
one CUDA kernel, DIA only) or "auto" (the kernels on a CUDA operator,
torch on a CPU one); the baselines take "auto"/"torch".
``spmv_engine``: "torch"/"cuda"/"segsum"/"bf16"/"auto".
"""
from __future__ import annotations

from .core.types import SolveResult
from .plan import (
    SolverPlan,
    clear_plan_cache,
    get_plan,
    plan,
    plan_cache_stats,
    register_solver,
    solver_names,
)

__all__ = [
    "solve",
    "plan",
    "SolverPlan",
    "get_plan",
    "register_solver",
    "solver_names",
    "plan_cache_stats",
    "clear_plan_cache",
]


def solve(A, b, method: str = "pipecg", engine: str = "auto", M="jacobi", x0=None,
          atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
          **kwargs) -> SolveResult:
    """Solve SPD ``A x = b`` once, through a cached plan. Extra keyword
    arguments go to the method (a keyword it does not take raises
    TypeError); a distributed method's nonzero ``x0`` solves the shifted
    system ``A d = b - A x0`` and returns ``x0 + d``."""
    p = get_plan(A, method=method, engine=engine, M=M, maxiter=maxiter, **kwargs)
    return p.solve(b, x0=x0, atol=atol, rtol=rtol)
