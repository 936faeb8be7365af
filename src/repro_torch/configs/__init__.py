"""Architecture configs: one module per ported architecture (+ shapes).

Use ``get_config("<arch-id>")`` / ``list_configs()`` / ``SHAPES``. All
ten of the JAX package's configs are registered: four dense, two MoE,
the SSM config (xlstm-1.3b), the hybrid config (zamba2-2.7b), the
encoder-decoder config (whisper-tiny) and the VLM config
(llama-3.2-vision-11b).
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
        llama_3_2_vision_11b,
        olmoe_1b_7b,
        qwen2_5_14b,
        qwen3_8b,
        stablelm_1_6b,
        whisper_tiny,
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
