"""Llama-3.2-Vision-style VLM backbone (llama-3.2-vision-11b), as the JAX
package's ``models/vlm.py``: a dense decoder with a gated cross-attention
layer after every ``cross_attn_every - 1`` self layers.

The ViT frontend is a stub: the batch carries pre-projected patch
embeddings (B, n_img_tokens, d_model) in the model's dtype. Cross layers
have the released model's zero-init tanh gate, so at init the model is its
text-only backbone. ``remat`` wraps the self layers only, as in JAX.

Decode reads the self layers' caches and writes every layer's current k/v
after the layer loop (``transformer.write_cache``); the cross K/V are
recomputed from ``img_feats`` at every step, as JAX does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from .attention import KVCache, cross_attention, cross_attn_params, init_kv_cache
from .common import apply_norm, make_norm_params, require_dtype
from .mlp import swiglu, swiglu_params
from .transformer import (
    _stack_kv,
    check_remat,
    dense_layer_apply,
    dense_layer_params,
    embed_params,
    embed_tokens,
    remat_call,
    unembed,
    write_cache,
)

__all__ = ["VLMCache", "vlm_layout", "vlm_forward", "vlm_init_cache", "vlm_decode"]


class VLMCache(NamedTuple):
    self_kv: KVCache         # (L_self, B, S, KV, hd)
    img_feats: torch.Tensor  # (B, n_img, d)


def _cross_layer_params(cfg: ArchConfig) -> dict:
    return {
        "norm": make_norm_params(cfg.d_model, cfg.norm),
        "cross": cross_attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "mlp": swiglu_params(cfg.d_model, cfg.d_ff),
    }


def _groups(cfg: ArchConfig) -> tuple[int, int]:
    """(n_groups, self layers per group): each group is k - 1 self layers
    and one cross layer, k = ``cross_attn_every``."""
    k = cfg.cross_attn_every
    return cfg.n_layers // k, k - 1


def vlm_layout(cfg: ArchConfig) -> dict:
    n_groups, self_per = _groups(cfg)
    return {
        **embed_params(cfg),
        "self_layers": [dense_layer_params(cfg) for _ in range(n_groups * self_per)],
        "cross_layers": [_cross_layer_params(cfg) for _ in range(n_groups)],
    }


def _cross_apply(lp, x: torch.Tensor, img: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = apply_norm(x, lp["norm"], cfg.norm)
    x = x + cross_attention(lp["cross"], h, img, cfg, gated=True)
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    return x + swiglu(lp["mlp"], h)


def vlm_forward(params, tokens: torch.Tensor, img_feats: torch.Tensor, cfg: ArchConfig, *,
                remat=False, return_cache: bool = False):
    """Causal forward over full sequences (train / prefill): logits (B, T,
    V); ``return_cache=True`` also returns the self layers' (k, v) stacked
    to (L_self, B, T, KV, hd)."""
    check_remat(remat, return_cache)
    require_dtype("img_feats", img_feats, params["embedding"].dtype)
    x = embed_tokens(params, tokens, cfg)
    n_groups, self_per = _groups(cfg)
    kvs = []
    for g in range(n_groups):
        for j in range(self_per):
            lp = params["self_layers"][g * self_per + j]
            if remat:
                x = remat_call(lambda h, lp=lp: dense_layer_apply(lp, h, cfg)[0], remat, x)
            else:
                x, kv = dense_layer_apply(lp, x, cfg)
                if return_cache:
                    kvs.append(kv)
        x = _cross_apply(params["cross_layers"][g], x, img_feats, cfg)
    logits = unembed(params, x, cfg)
    if return_cache:
        return logits, _stack_kv(kvs)
    return logits


def vlm_init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, device=None) -> VLMCache:
    """Zero self caches of max_seq positions and zero ``img_feats`` on
    ``device`` (``None``: CUDA)."""
    n_groups, self_per = _groups(cfg)
    dev = resolve_device(device)
    return VLMCache(
        self_kv=init_kv_cache(cfg, batch, max_seq, n_groups * self_per, dtype, dev),
        img_feats=torch.zeros((batch, cfg.n_img_tokens, cfg.d_model), dtype=dtype, device=dev),
    )


def vlm_decode(params, token: torch.Tensor, cache: VLMCache, pos: int, cfg: ArchConfig):
    """One token (B, 1) at position ``pos``: (logits (B, 1, V), the cache
    with this token's k/v written at ``pos`` in place)."""
    require_dtype("img_feats", cache.img_feats, params["embedding"].dtype)
    x = embed_tokens(params, token, cfg)
    n_groups, self_per = _groups(cfg)
    kvs = []
    for g in range(n_groups):
        for j in range(self_per):
            li = g * self_per + j
            x, kv = dense_layer_apply(params["self_layers"][li], x, cfg,
                                      cache=KVCache(cache.self_kv.k[li], cache.self_kv.v[li]),
                                      cache_pos=pos)
            kvs.append(kv)
        x = _cross_apply(params["cross_layers"][g], x, cache.img_feats, cfg)
    logits = unembed(params, x, cfg)
    write_cache(cache.self_kv, *_stack_kv(kvs), pos)
    return logits, cache
