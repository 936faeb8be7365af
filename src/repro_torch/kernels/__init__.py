"""Hand-written CUDA kernels of the port (Hopper, sm_90a): the PIPECG hot
spots and the LM substrate's two.

fused_iter — the whole PIPECG iteration: banded DIA SPMV + 8 VMAs +
             Jacobi PC + dot partials in one launch; the band f32 or
             bf16 (f32 vectors and sums).
fused_vma  — the iteration core: 8 VMAs + Jacobi PC + dot partials in
             one pass (paper §V-B kernel fusion, extended).
spmv_dia   — banded/stencil SPMV, f32 or bf16 storage, f32 accumulate
             (the lane-batched entry in both, ``spmv_dia_batched_bf16``).
spmv_bell  — Block-ELLPACK SPMV (general sparsity), f32 or bf16 storage,
             f32 accumulate, any row count.
fused_dot  — the three PIPECG dots (r,u), (w,u), (u,u) in one pass.
fused_adam — one-pass AdamW over a parameter tensor, in place.
flash_attn — softmax attention with an online softmax (no caller on
             any path, in the JAX package either).

The four kernels of the solver loop also have a lane-batched entry
(``*_batched``: k right-hand sides in one launch, the TPU kernel under
``jax.vmap``), which the serving tier's ``solve_batched`` runs.

Each kernel ships kernel.py (ctypes binding of ``csrc/*.cu``), ops.py
(the public wrapper: checks, allocation, launch counter; the plain
version for CPU tensors) and ref.py (the plain PyTorch version).
"""
from .flash_attn import flash_attention, flash_attention_ref
from .fused_adam import adamw_hyper, fused_adamw, fused_adamw_ref
from .fused_dot import fused_dots, fused_dots_ref
from .fused_iter import fused_iter_batched, fused_iter_batched_ref, fused_iter_ref, fused_iter_step
from .fused_vma import (
    fused_vma_dots,
    fused_vma_dots_batched,
    fused_vma_dots_batched_ref,
    fused_vma_dots_ref,
)
from .spmv_bell import spmv_bell_batched, spmv_bell_batched_ref, spmv_bell_cuda, spmv_bell_ref
from .spmv_dia import (
    spmv_dia_batched,
    spmv_dia_batched_bf16,
    spmv_dia_batched_bf16_ref,
    spmv_dia_batched_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
)

__all__ = [
    "adamw_hyper",
    "flash_attention",
    "flash_attention_ref",
    "fused_adamw",
    "fused_adamw_ref",
    "fused_dots",
    "fused_dots_ref",
    "fused_iter_batched",
    "fused_iter_batched_ref",
    "fused_iter_ref",
    "fused_iter_step",
    "fused_vma_dots",
    "fused_vma_dots_batched",
    "fused_vma_dots_batched_ref",
    "fused_vma_dots_ref",
    "spmv_bell_batched",
    "spmv_bell_batched_ref",
    "spmv_bell_cuda",
    "spmv_bell_ref",
    "spmv_dia_batched",
    "spmv_dia_batched_bf16",
    "spmv_dia_batched_bf16_ref",
    "spmv_dia_batched_ref",
    "spmv_dia_cuda",
    "spmv_dia_ref",
]
