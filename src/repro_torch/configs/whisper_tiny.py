"""whisper-tiny — enc-dec audio backbone, conv frontend stubbed
[arXiv:2212.04356; unverified]. 4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865. LayerNorm + GELU + biased MHA; encoder sees 1500 stub frames.
"""
from .base import ArchConfig, register


@register("whisper-tiny")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,        # decoder layers
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        qkv_bias=True,
        norm="layernorm",
        enc_seq=1500,
        source="[arXiv:2212.04356; unverified]",
    )
