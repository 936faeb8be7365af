"""repro_torch — the PyTorch + CUDA port of ``repro`` (Pipelined CG).

Runs the single-device Jacobi-preconditioned pipelined CG (Ghysels &
Vanroose Alg. 2) of a DIA stencil operator on an NVIDIA H100, with the
JAX package's three Pallas TPU kernels on that path (``spmv_dia``,
``fused_vma``, ``fused_iter``) rewritten as hand-written CUDA kernels.
The JAX package ``repro`` stays the reference; this package imports
nothing of it, nor JAX.

Entry points: ``repro_torch.plan(A, ...)`` -> reusable ``SolverPlan``,
and the one-shot ``repro_torch.solve(A, b, ...)`` over a keyed plan
cache. Operators: ``repro_torch.sparse.poisson7/27/125(n, device=...)``.
Everything runs on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

_API = (
    "solve",
    "SolverPlan",
    "get_plan",
    "solver_names",
    "plan_cache_stats",
    "clear_plan_cache",
)


def __getattr__(name):
    # lazy: `import repro_torch` stays cheap
    import importlib

    if name == "plan":
        # the submodule doubles as the entry point (it is callable)
        return importlib.import_module(".plan", __name__)
    if name in _API:
        return getattr(importlib.import_module(".api", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API) | {"plan"})
