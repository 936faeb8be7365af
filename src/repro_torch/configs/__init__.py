"""Architecture configs: one module per ported architecture (+ shapes).

Use ``get_config("<arch-id>")`` / ``list_configs()`` / ``SHAPES``. The
four dense configs, the two MoE configs, the SSM config (xlstm-1.3b)
and the hybrid config (zamba2-2.7b) are registered; the
encoder-decoder and VLM configs wait with their families (ROADMAP).
"""
from .base import SHAPES, ArchConfig, ShapeConfig, get_config, list_configs, reduced

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        granite_moe_1b_a400m,
        internlm2_1_8b,
        olmoe_1b_7b,
        qwen2_5_14b,
        qwen3_8b,
        stablelm_1_6b,
        xlstm_1_3b,
        zamba2_2_7b,
    )

    _LOADED = True


__all__ = [
    "ArchConfig",
    "SHAPES",
    "ShapeConfig",
    "get_config",
    "list_configs",
    "reduced",
]
