"""zamba2-2.7b — Mamba2 blocks + shared attention block
[arXiv:2411.15242; hf]. 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Shared transformer block applied after every 6
Mamba2 blocks (weight sharing; the per-application LoRA deltas are
omitted, as in the JAX package).
"""
from .base import ArchConfig, register


@register("zamba2-2.7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_heads=32,
        proj_factor=2.0,
        attn_every=6,
        chunk=256,
        subquadratic=True,
        source="[arXiv:2411.15242; hf]",
    )
