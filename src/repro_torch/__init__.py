"""repro_torch — the PyTorch + CUDA port of ``repro`` (Pipelined CG).

Runs single-device pipelined CG (Ghysels & Vanroose Alg. 2) and the PCG
and Chronopoulos–Gear baselines on an NVIDIA H100, for DIA (banded),
Block-ELLPACK and CSR operators, with the JAX package's Pallas TPU
kernels on those paths (``spmv_dia``, ``fused_vma``, ``fused_iter``,
``spmv_bell``, and ``fused_dot`` beside them) rewritten as hand-written
CUDA kernels. Its LM substrate trains the dense decoder family
(``configs``, ``models``, ``train``, ``ckpt``, ``runtime``,
``launch.train``) with AdamW through the ``fused_adam`` CUDA kernel;
``flash_attn`` is ported beside it.
The JAX package ``repro`` stays the reference; this package imports
nothing of it, nor JAX.

Entry points: ``repro_torch.plan(A, ...)`` -> reusable ``SolverPlan``
(``solve(b)``, and ``solve_batched(B)`` for k right-hand sides through
the kernels' lane-batched entries), the one-shot ``repro_torch.solve(A,
b, ...)`` over a keyed plan cache, and the serving tier
``repro_torch.serve`` (``SolverServer``: queue, plan-pool router,
warm-start manifests), with its telemetry in ``repro_torch.obs``. Operators: ``repro_torch.sparse.poisson7/27/125(n, device=...)``,
``table1_matrix(name, device=...)`` and the converters
``csr_from_dia``/``bell_from_csr``/``csr_device_from_host``.
Everything runs on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

_API = (
    "solve",
    "SolverPlan",
    "get_plan",
    "register_solver",
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
