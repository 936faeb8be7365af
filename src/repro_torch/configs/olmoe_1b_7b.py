"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].
16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from .base import ArchConfig, register


@register("olmoe-1b-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        n_experts=64,
        top_k=8,
        qk_norm=True,  # OLMoE uses QK-norm
        source="[arXiv:2409.02060; hf]",
    )
