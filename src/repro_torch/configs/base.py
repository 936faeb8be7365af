"""Architecture + shape configuration system, as the JAX package's.

One ``ArchConfig`` dataclass covers the six model families, field for
field with ``repro.configs.base``; each architecture file instantiates it
with the published numbers and registers it under its public id
(``--arch <id>`` in the launchers). The port registers every config of
the six families.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "register", "get_config", "list_configs", "reduced"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    # 0 = materialize full (Tq, Tk) scores; >0 = online-softmax over KV
    # chunks of this size (flash-attention-style, beyond-paper §Perf knob)
    attn_chunk: int = 0

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0        # mamba2 state dim per head
    ssm_heads: int = 0        # 0 -> n_heads
    proj_factor: float = 2.0  # inner dim = proj_factor * d_model
    chunk: int = 128          # chunked-scan block length
    slstm_every: int = 0      # xlstm: every k-th block is sLSTM
    attn_every: int = 0       # zamba2: shared attn block every k mamba blocks

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500  # precomputed audio frame positions (stub frontend)

    # vlm (llama-3.2-vision)
    cross_attn_every: int = 0  # a cross-attn layer after every k self layers
    n_img_tokens: int = 0      # stubbed patch embeddings per image

    dtype: str = "bfloat16"
    # long_500k applicability: quadratic-attention archs skip it
    subquadratic: bool = False

    source: str = ""  # provenance note [source; verified-tier]

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def ssm_heads_(self) -> int:
        return self.ssm_heads or self.n_heads

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The assigned LM shape set (applies to every architecture).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    # import the per-arch modules lazily so the registry is populated
    from . import _load_all  # noqa: F401

    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test scale: same family/topology, tiny dims.

    Keeps every structural feature (GQA ratio, MoE experts>top_k, slstm/attn
    cadence, cross-attn cadence) while shrinking width/depth/vocab.
    """
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv * max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)), kv)
    heads = min(heads, 4)
    kv = min(kv, heads)
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else (cfg.attn_every + 1)),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads_, 4) if cfg.family in ("ssm", "hybrid") else 0,
        chunk=16,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=32 if cfg.n_enc_layers else cfg.enc_seq,
        n_img_tokens=16 if cfg.n_img_tokens else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        dtype="float32",
    )
    if cfg.slstm_every:
        small["n_layers"] = 2 * small["slstm_every"]
    if cfg.attn_every:
        small["n_layers"] = 2 * small["attn_every"]
    if cfg.cross_attn_every:
        small["cross_attn_every"] = 2
        small["n_layers"] = 6
    small.update(overrides)
    return replace(cfg, **small)
