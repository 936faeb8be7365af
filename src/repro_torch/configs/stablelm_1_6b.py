"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified].
24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352. LayerNorm.
"""
from .base import ArchConfig, register


@register("stablelm-1.6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        norm="layernorm",
        source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    )
