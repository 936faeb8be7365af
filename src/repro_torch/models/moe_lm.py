"""MoE decoder LM (granite-moe-1b-a400m: 32 experts top-8; olmoe-1b-7b:
64 experts top-8), as the JAX package's ``models/moe_lm.py``.

The attention stack is the dense family's; every layer's FFN is the
capacity-bounded top-k MoE of ``moe.py``. The load-balance loss is summed
over the layers and returned beside the logits. Under
``use_sharding_rules(resolver, mesh)`` with a mesh that passes JAX's test
(``sharded_moe_applies``) the layer takes ``moe_ffn_sharded``, as JAX's
does. Decode reads and writes the cache as ``transformer.dense_lm_decode``
does (in place, after the layer loop).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import KVCache, attention, attn_params
from .common import apply_norm, current_mesh, make_norm_params
from .moe import moe_ffn, moe_ffn_sharded, moe_params
from .transformer import (
    _stack_kv,
    check_remat,
    embed_params,
    embed_tokens,
    remat_call,
    unembed,
    write_cache,
)

__all__ = ["moe_lm_layout", "moe_lm_forward", "moe_lm_decode", "sharded_moe_applies"]


def _moe_layer_params(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": make_norm_params(cfg.d_model, cfg.norm),
        "attn": attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "moe": moe_params(cfg.d_model, cfg.d_ff, cfg.n_experts),
    }


def moe_lm_layout(cfg: ArchConfig) -> dict:
    return {
        **embed_params(cfg),
        "layers": [_moe_layer_params(cfg) for _ in range(cfg.n_layers)],
    }


def sharded_moe_applies(mesh, cfg: ArchConfig, batch: int) -> bool:
    """JAX's rule for the sharded dispatch: a mesh with a "model" axis that
    divides the expert count, and a batch that every present data axis
    divides."""
    return (
        mesh is not None
        and "model" in mesh.shape
        and cfg.n_experts % mesh.shape["model"] == 0
        and all(batch % mesh.shape[a] == 0 for a in ("pod", "data") if a in mesh.shape)
    )


def _moe_layer_apply(lp, x: torch.Tensor, cfg: ArchConfig, *, cache: KVCache | None = None,
                     cache_pos=None):
    h = apply_norm(x, lp["attn_norm"], cfg.norm)
    a, new_kv = attention(lp["attn"], h, cfg, cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    B, T, d = h.shape
    if sharded_moe_applies(current_mesh(), cfg, B):
        y3, aux = moe_ffn_sharded(lp["moe"], h, cfg.top_k, cfg.moe_capacity_factor)
        return x + y3, new_kv, aux
    y, aux = moe_ffn(lp["moe"], h.reshape(B * T, d), cfg.top_k, cfg.moe_capacity_factor)
    return x + y.reshape(B, T, d), new_kv, aux


def moe_lm_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, remat=False,
                   return_cache: bool = False):
    """Returns (logits, aux_loss) or, with ``return_cache``, (logits,
    aux_loss, (k, v)) with k, v stacked to (L, B, T, KV, hd). The MoE layer
    tags nothing, so ``remat="save_collectives"`` recomputes it whole, as
    in JAX."""
    check_remat(remat, return_cache)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for lp in params["layers"]:
        if remat:
            x, a = remat_call(lambda h, lp=lp: _moe_layer_apply(lp, h, cfg)[::2], remat, x)
        else:
            x, kv, a = _moe_layer_apply(lp, x, cfg)
            if return_cache:
                kvs.append(kv)
        aux = aux + a
    logits = unembed(params, x, cfg)
    if return_cache:
        return logits, aux, _stack_kv(kvs)
    return logits, aux


def moe_lm_decode(params, token: torch.Tensor, cache: KVCache, pos: int, cfg: ArchConfig):
    """One decode step: (logits (B, 1, V), cache updated in place at pos)."""
    x = embed_tokens(params, token, cfg)
    kvs = []
    for i, lp in enumerate(params["layers"]):
        x, kv, _aux = _moe_layer_apply(lp, x, cfg, cache=KVCache(cache.k[i], cache.v[i]),
                                       cache_pos=pos)
        kvs.append(kv)
    return unembed(params, x, cfg), write_cache(cache, *_stack_kv(kvs), pos)
