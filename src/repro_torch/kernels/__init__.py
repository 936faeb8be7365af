"""Hand-written CUDA kernels for the PIPECG hot spots (Hopper, sm_90a).

fused_iter — the whole PIPECG iteration: banded DIA SPMV + 8 VMAs +
             Jacobi PC + dot partials in one launch.
fused_vma  — the iteration core: 8 VMAs + Jacobi PC + dot partials in
             one pass (paper §V-B kernel fusion, extended).
spmv_dia   — banded/stencil SPMV, f32 or bf16 storage, f32 accumulate.

Each kernel ships kernel.py (ctypes binding of ``csrc/*.cu``), ops.py
(the public wrapper: checks, allocation, launch counter; the plain
version for CPU tensors) and ref.py (the plain PyTorch version).
"""
from .fused_iter import fused_iter_ref, fused_iter_step
from .fused_vma import fused_vma_dots, fused_vma_dots_ref
from .spmv_dia import spmv_dia_cuda, spmv_dia_ref

__all__ = [
    "fused_iter_ref",
    "fused_iter_step",
    "fused_vma_dots",
    "fused_vma_dots_ref",
    "spmv_dia_cuda",
    "spmv_dia_ref",
]
