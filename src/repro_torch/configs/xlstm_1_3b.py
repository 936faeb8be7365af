"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304. d_ff=0 means no separate
FFN: the mLSTM/sLSTM blocks carry their own up/down projections
(proj_factor 2). Block cadence 7 mLSTM : 1 sLSTM (the paper's xLSTM[7:1]).
"""
from .base import ArchConfig, register


@register("xlstm-1.3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=512,
        ssm_heads=4,
        proj_factor=2.0,
        slstm_every=8,
        chunk=256,
        subquadratic=True,
        source="[arXiv:2405.04517; unverified]",
    )
