from .ops import fused_iter_step
from .ref import fused_iter_ref

__all__ = ["fused_iter_ref", "fused_iter_step"]
