"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. 24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""
from .base import ArchConfig, register


@register("granite-moe-1b-a400m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=32,
        top_k=8,
        tie_embeddings=True,
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    )
