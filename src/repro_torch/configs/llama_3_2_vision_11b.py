"""llama-3.2-vision-11b — cross-attn image layers, ViT frontend stubbed
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. 40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256; a gated cross-attention layer after
every 4 self layers (8 cross layers total: 32 self + 8 cross = 40L).
"""
from .base import ArchConfig, register


@register("llama-3.2-vision-11b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        cross_attn_every=5,  # groups of 4 self + 1 cross
        n_img_tokens=1601,
        source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    )
