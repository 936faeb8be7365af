"""qwen3-8b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""
from .base import ArchConfig, register


@register("qwen3-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        head_dim=128,
        rope_theta=1000000.0,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )
