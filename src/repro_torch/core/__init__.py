"""Core solver library of the port — one iteration core, several strategies.

``iteration``     the PIPECG recurrence (``pipecg_vma_core``), the core
                  registry ("torch" / "cuda" / "fused_iter"), the shared
                  convergence bookkeeping and the solver loop ``run_pipecg``.
``reduce``        reduction strategy for the dot partials (``local``).
``pipecg``        Algorithm 2 on one device, with the padded kernel path.
``pcg``           Algorithm 1, the paper's baseline (three reductions).
``chronopoulos``  Chronopoulos–Gear CG (one reduction, no overlap).
"""
from .chronopoulos import chronopoulos_cg
from .iteration import dot_f32, get_core, pipecg_vma_core, register_core, run_pipecg
from .pcg import pcg
from .pipecg import pipecg
from .preconditioners import (
    BlockJacobiPC,
    IdentityPC,
    JacobiPC,
    apply_pc,
    block_jacobi,
    identity,
    jacobi,
)
from .reduce import make_reducer
from .types import SolveResult

__all__ = [
    "BlockJacobiPC",
    "IdentityPC",
    "JacobiPC",
    "SolveResult",
    "apply_pc",
    "block_jacobi",
    "chronopoulos_cg",
    "dot_f32",
    "get_core",
    "identity",
    "jacobi",
    "make_reducer",
    "pcg",
    "pipecg",
    "pipecg_vma_core",
    "register_core",
    "run_pipecg",
]
