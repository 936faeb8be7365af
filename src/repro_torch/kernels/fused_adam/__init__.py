from .ops import adamw_hyper, fused_adamw
from .ref import fused_adamw_ref

__all__ = ["adamw_hyper", "fused_adamw", "fused_adamw_ref"]
