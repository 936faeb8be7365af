"""Analytic FLOP / byte models per architecture family, as the JAX
package's ``launch/analytic.py``: the same arithmetic in the same order.

The dry-run's roofline rows (``launch/dryrun.py``) and the denominators of
whole-step roofline shares: ``analytic_flops`` counts every matmul of a
step trip-count exactly (no compiler is asked), ``analytic_hbm_bytes`` a
first-order traffic model. All counts are GLOBAL (the whole step across
all devices); matmul flops = 2mnk, and train multiplies the forward's by 3
(forward + 2x backward).
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig
from ..models.moe import moe_capacity

__all__ = ["model_flops_simple", "analytic_flops", "analytic_hbm_bytes", "param_count", "active_param_count"]


def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the layout tree."""
    from ..models.zoo import build_model

    api = build_model(cfg)
    return api.n_params()


def active_param_count(cfg: ArchConfig) -> int:
    """Params touched per token (MoE: top_k of n_experts expert params)."""
    n = param_count(cfg)
    if cfg.n_experts and cfg.top_k:
        expert_params = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
        active = cfg.n_layers * cfg.top_k * 3 * cfg.d_model * cfg.d_ff
        return n - expert_params + active
    return n


def model_flops_simple(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """The required MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference),
    N = active params, D = tokens processed this step."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# detailed per-family counting (adds the non-weight attention/GLA terms that
# 6*N*D misses — quadratic attention dominates prefill_32k for dense archs)
# ---------------------------------------------------------------------------

def _attn_layer_flops(cfg, n_tok, kv_len) -> float:
    hd = cfg.head_dim_
    d = cfg.d_model
    proj = 2 * n_tok * d * (cfg.n_heads * hd) * 2  # wq + wo
    proj += 2 * n_tok * d * (cfg.n_kv_heads * hd) * 2  # wk + wv
    sdpa = 2 * n_tok * kv_len * cfg.n_heads * hd * 2  # QK^T + AV
    return proj + sdpa


def _mlp_flops(cfg, n_tok, f=None) -> float:
    f = cfg.d_ff if f is None else f
    return 3 * 2 * n_tok * cfg.d_model * f


def _moe_flops(cfg, n_tok) -> float:
    router = 2 * n_tok * cfg.d_model * cfg.n_experts
    comp = cfg.n_experts * moe_capacity(int(n_tok), cfg.top_k, cfg.n_experts, cfg.moe_capacity_factor)
    return router + 3 * 2 * comp * cfg.d_model * cfg.d_ff


def _gla_flops(cfg, n_tok, dk, dv, nh, chunk) -> float:
    intra = 2 * n_tok * chunk * nh * (dk + dv)
    inter = 2 * n_tok * nh * dk * dv * 2  # q@S + state update
    return intra + inter


def _mlstm_flops(cfg, n_tok, step=False) -> float:
    d, din = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_heads_
    dk = din // nh
    proj = 2 * n_tok * d * 2 * din + 3 * 2 * n_tok * din * din + 2 * n_tok * din * d
    chunk = 1 if step else cfg.chunk
    return proj + _gla_flops(cfg, n_tok, dk, dk, nh, chunk)


def _slstm_flops(cfg, n_tok) -> float:
    d = cfg.d_model
    nh = cfg.ssm_heads_
    dh = d // nh
    return 2 * n_tok * d * 4 * d + 2 * n_tok * nh * dh * 4 * dh + 2 * n_tok * d * d


def _mamba_flops(cfg, n_tok, step=False) -> float:
    d, din = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_heads_
    st = cfg.ssm_state
    dh = din // nh
    in_p = 2 * n_tok * d * (2 * din + 2 * st + nh)
    conv = 2 * n_tok * (din + 2 * st) * 4
    out_p = 2 * n_tok * din * d
    chunk = 1 if step else cfg.chunk
    return in_p + conv + out_p + _gla_flops(cfg, n_tok, st, dh, nh, chunk)


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Detailed forward flops x (3 if train). Decode counts one step."""
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        n_tok, kv_len = B, T
    else:
        n_tok, kv_len = B * T, T

    fam = cfg.family
    total = 0.0
    if fam == "dense":
        total = cfg.n_layers * (_attn_layer_flops(cfg, n_tok, kv_len) + _mlp_flops(cfg, n_tok))
    elif fam == "moe":
        total = cfg.n_layers * (_attn_layer_flops(cfg, n_tok, kv_len) + _moe_flops(cfg, n_tok))
    elif fam == "ssm":
        n_s = cfg.n_layers // cfg.slstm_every
        n_m = cfg.n_layers - n_s
        total = n_m * _mlstm_flops(cfg, n_tok, step=shape.kind == "decode") + n_s * _slstm_flops(cfg, n_tok)
    elif fam == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        total = cfg.n_layers * _mamba_flops(cfg, n_tok, step=shape.kind == "decode")
        total += n_groups * (_attn_layer_flops(cfg, n_tok, kv_len) + _mlp_flops(cfg, n_tok))
    elif fam == "encdec":
        enc_tok = B * cfg.enc_seq
        enc = cfg.n_enc_layers * (_attn_layer_flops(cfg, enc_tok, cfg.enc_seq) + _mlp_flops(cfg, enc_tok))
        dec = cfg.n_layers * (
            _attn_layer_flops(cfg, n_tok, kv_len)
            + _attn_layer_flops(cfg, n_tok, cfg.enc_seq)  # cross
            + _mlp_flops(cfg, n_tok)
        )
        # decode recomputes no encoder; prefill/train include it
        total = dec + (enc if shape.kind != "decode" else 0.0)
    elif fam == "vlm":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        n_self = n_groups * (cfg.cross_attn_every - 1)
        total = n_self * (_attn_layer_flops(cfg, n_tok, kv_len) + _mlp_flops(cfg, n_tok))
        total += n_groups * (
            _attn_layer_flops(cfg, n_tok, cfg.n_img_tokens) + _mlp_flops(cfg, n_tok)
        )
    else:
        raise ValueError(fam)

    total += 2.0 * n_tok * cfg.d_model * cfg.vocab_size  # unembed
    if shape.kind == "train":
        total *= 3.0
    return total


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, dtype_bytes: int = 2) -> float:
    """First-order HBM traffic per step (global): weights + optimizer state
    (train) or weights + KV/state cache (decode) + major activations."""
    n = param_count(cfg)
    B, T = shape.global_batch, shape.seq_len
    d = cfg.d_model
    act_unit = B * T * d * dtype_bytes

    if shape.kind == "train":
        weights = n * dtype_bytes * 3          # read fwd + read bwd + write grad
        opt = n * 4 * 4                        # m,v read+write f32
        acts = cfg.n_layers * 8 * act_unit     # rough per-layer activation traffic
        logits = B * T * cfg.vocab_size * dtype_bytes * 2
        return weights + opt + acts + logits
    if shape.kind == "prefill":
        return n * dtype_bytes + cfg.n_layers * 6 * act_unit + B * T * cfg.vocab_size * dtype_bytes
    # decode: every weight + the whole KV cache (or SSM state) is read once
    hd = cfg.head_dim_
    if cfg.family == "ssm":
        din = cfg.d_inner
        nh = cfg.ssm_heads_
        cache = cfg.n_layers * B * nh * (din // nh) ** 2 * 4 * 2
    elif cfg.family == "hybrid":
        nh = cfg.ssm_heads_
        dh = cfg.d_inner // nh
        cache = cfg.n_layers * B * nh * cfg.ssm_state * dh * 4 * 2
        cache += (cfg.n_layers // cfg.attn_every) * B * T * cfg.n_kv_heads * hd * 2 * dtype_bytes
    else:
        L_kv = cfg.n_layers
        cache = L_kv * B * T * cfg.n_kv_heads * hd * 2 * dtype_bytes
    return n * dtype_bytes + cache + B * cfg.vocab_size * dtype_bytes
