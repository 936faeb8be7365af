"""Core solver library of the port — one iteration core, several strategies.

``iteration``     the PIPECG recurrence (``pipecg_vma_core``), the core
                  registry ("torch" / "cuda" / "fused_iter"), the shared
                  convergence bookkeeping and the solver loop ``run_pipecg``.
``reduce``        reduction strategies for the dot partials (local /
                  separate / packed / hierarchical h4), split into post
                  and wait on a mesh.
``comm``          the solver mesh (one device per shard, one host thread
                  per shard) and its in-process collectives.
``distributed``   the paper's hybrid methods h1–h3, h4, pl2, pl3 over a
                  mesh of the card and the host's cores.
``perfmodel``     the paper's performance model: SPMV timing, relative
                  weights, the nnz decomposition, straggler tracking.
``pipecg``        Algorithm 2 on one device, with the padded kernel path.
``pcg``           Algorithm 1, the paper's baseline (three reductions).
``chronopoulos``  Chronopoulos–Gear CG (one reduction, no overlap).
"""
from .chronopoulos import chronopoulos_cg
from .comm import MeshAborted, SolverMesh
from .distributed import (
    DistMethod,
    build_distributed_solver,
    get_method,
    make_solver_mesh,
    method_names,
    pipecg_distributed,
    register_dist_spmv,
    register_method,
)
from .iteration import (
    dot_f32,
    get_core,
    make_deep_pipecg_core,
    pipecg_vma_core,
    register_core,
    run_pipecg,
)
from .perfmodel import StragglerTracker, decompose, measure_spmv_time, relative_weights
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
from .reduce import make_reducer, reducer_names, reducer_needs_subaxis, register_reducer
from .types import SolveResult

__all__ = [
    "BlockJacobiPC",
    "DistMethod",
    "IdentityPC",
    "JacobiPC",
    "MeshAborted",
    "SolveResult",
    "SolverMesh",
    "StragglerTracker",
    "apply_pc",
    "block_jacobi",
    "build_distributed_solver",
    "chronopoulos_cg",
    "decompose",
    "dot_f32",
    "get_core",
    "get_method",
    "identity",
    "jacobi",
    "make_deep_pipecg_core",
    "make_reducer",
    "make_solver_mesh",
    "measure_spmv_time",
    "method_names",
    "pcg",
    "pipecg",
    "pipecg_distributed",
    "pipecg_vma_core",
    "reducer_names",
    "reducer_needs_subaxis",
    "register_core",
    "register_dist_spmv",
    "register_method",
    "register_reducer",
    "relative_weights",
    "run_pipecg",
]
