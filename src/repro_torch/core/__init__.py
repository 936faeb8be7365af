"""Core solver library of the port — one iteration core, several strategies.

``iteration``   the PIPECG recurrence (``pipecg_vma_core``), the core
                registry ("torch" / "cuda" / "fused_iter") and the shared
                solver loop ``run_pipecg``.
``reduce``      reduction strategy for the dot partials (``local``).
``pipecg``      Algorithm 2 on one device, with the padded kernel path.
"""
from .iteration import dot_f32, get_core, pipecg_vma_core, register_core, run_pipecg
from .pipecg import pipecg
from .preconditioners import IdentityPC, JacobiPC, apply_pc, identity, jacobi
from .reduce import make_reducer
from .types import SolveResult

__all__ = [
    "IdentityPC",
    "JacobiPC",
    "SolveResult",
    "apply_pc",
    "dot_f32",
    "get_core",
    "identity",
    "jacobi",
    "make_reducer",
    "pipecg",
    "pipecg_vma_core",
    "register_core",
    "run_pipecg",
]
