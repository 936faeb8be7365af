from .ops import fused_vma_dots, fused_vma_dots_batched
from .ref import fused_vma_dots_batched_ref, fused_vma_dots_ref

__all__ = ['fused_vma_dots', 'fused_vma_dots_batched', 'fused_vma_dots_batched_ref', 'fused_vma_dots_ref']
