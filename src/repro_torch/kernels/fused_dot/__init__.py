from .ops import fused_dots
from .ref import fused_dots_ref

__all__ = ["fused_dots", "fused_dots_ref"]
