from .ops import fused_vma_dots
from .ref import fused_vma_dots_ref

__all__ = ["fused_vma_dots", "fused_vma_dots_ref"]
