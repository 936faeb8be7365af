"""Dense decoder-only LM (qwen2.5 / qwen3 / stablelm / internlm2), as the
JAX package's ``models/transformer.py``.

The JAX package scans one stacked layer body; here the layers are a
``ModuleList`` walked in a Python loop, and ``remat_call`` wraps each layer
in ``torch.utils.checkpoint`` where JAX's ``remat_wrap`` uses
``jax.checkpoint``. ``remat="save_collectives"`` is JAX's
``save_only_these_names("attn_out", "mlp_out")``: a torch policy sees ops,
not names, so ``checkpoint_name`` is a registered identity op
(``repro_torch::checkpoint_name``) inside such a region, and the
selective-checkpoint policy saves its outputs and recomputes the rest.

Cached decode: every layer reads its slice of the (L, B, S, KV, hd)
cache, never writes it, and returns its current-token k/v; after the
layer loop ``write_cache`` writes all of them at ``pos``. Where JAX
returns a new cache array, ``write_cache`` updates the preallocated
cache in place (PyTorch's idiom) and returns it.
"""
from __future__ import annotations

import contextvars
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from .attention import KVCache, attention, attn_params
from .common import ParamSpec, apply_norm, make_norm_params, shard_hint
from .mlp import swiglu, swiglu_params

__all__ = [
    "embed_params",
    "dense_layer_params",
    "dense_layer_apply",
    "dense_lm_layout",
    "dense_lm_forward",
    "dense_lm_decode",
    "write_cache",
    "embed_tokens",
    "unembed",
    "checkpoint_name",
    "remat_call",
    "check_remat",
]

SAVED_NAMES = ("attn_out", "mlp_out")  # what JAX's "save_collectives" policy keeps
_TAGGING = contextvars.ContextVar("repro_torch_tagging", default=False)


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _tagged(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()  # a custom op may not return its input


_tagged.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """JAX's ``checkpoint_name``: the identity, except inside a
    ``remat="save_collectives"`` region, where it is the op whose output
    the policy saves."""
    return _tagged(x, name) if _TAGGING.get() else x


def _save_tagged(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.checkpoint_name.default and args[1] in SAVED_NAMES:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _tagging(fn):
    """fn run with ``checkpoint_name`` live: in the forward and again in
    the backward's recompute, so both see the same ops."""

    @functools.wraps(fn)
    def run(*args):
        token = _TAGGING.set(True)
        try:
            return fn(*args)
        finally:
            _TAGGING.reset(token)

    return run


def check_remat(remat, returns_cache: bool = False) -> None:
    """remat is False, True (full) or "save_collectives", as JAX's
    ``remat_wrap`` takes; a cache or state cannot come out of a remat
    region."""
    if remat not in (False, True, "save_collectives"):
        raise ValueError(f"remat must be False, True or 'save_collectives', got {remat!r}")
    if remat and returns_cache:
        raise ValueError("returning a cache or state needs remat=False")


def remat_call(fn, remat, *args):
    """fn(*args), under ``torch.utils.checkpoint`` when ``remat``: True
    recomputes everything in the backward; "save_collectives" keeps the
    values tagged ``attn_out`` and ``mlp_out`` and recomputes the rest (a
    region that tags none is recomputed whole, as in JAX). The recompute
    runs in the forward's context: on a card's tensors the backward runs
    on the autograd engine's own thread, where the sharding rules and mesh
    (context variables) that chose the forward's path would be unset."""
    if not remat:
        return fn(*args)
    if remat == "save_collectives":
        run = functools.partial(contextvars.copy_context().run, _tagging(fn))
        return checkpoint(run, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_tagged))
    return checkpoint(functools.partial(contextvars.copy_context().run, fn), *args,
                      use_reentrant=False)


def embed_params(cfg: ArchConfig) -> dict:
    p = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    p["final_norm"] = make_norm_params(cfg.d_model, cfg.norm)
    return p


def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return shard_hint(F.embedding(tokens.long(), params["embedding"]), ("batch", None, None))


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm)
    head = params["embedding"].t() if cfg.tie_embeddings else params["lm_head"]
    return shard_hint(x @ head, ("batch", None, "vocab"))


def dense_layer_params(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": make_norm_params(cfg.d_model, cfg.norm),
        "attn": attn_params(cfg),
        "mlp_norm": make_norm_params(cfg.d_model, cfg.norm),
        "mlp": swiglu_params(cfg.d_model, cfg.d_ff),
    }


def dense_layer_apply(lp, x: torch.Tensor, cfg: ArchConfig, *, cache: KVCache | None = None,
                      cache_pos=None):
    h = apply_norm(x, lp["attn_norm"], cfg.norm)
    a, new_kv = attention(lp["attn"], h, cfg, cache=cache, cache_pos=cache_pos)
    x = x + checkpoint_name(a, "attn_out")
    h = apply_norm(x, lp["mlp_norm"], cfg.norm)
    x = x + checkpoint_name(swiglu(lp["mlp"], h), "mlp_out")
    return shard_hint(x, ("batch", None, None)), new_kv


def dense_lm_layout(cfg: ArchConfig) -> dict:
    return {
        **embed_params(cfg),
        "layers": [dense_layer_params(cfg) for _ in range(cfg.n_layers)],
    }


def _stack_kv(kvs: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer (k, v) pairs stacked to (L, B, T, KV, hd) each."""
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def dense_lm_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, remat=False,
                     return_cache: bool = False):
    """Causal forward over full sequences (train / prefill); logits (B, T, V)
    in the parameters' dtype. ``return_cache=True`` also returns the
    per-layer (k, v) stacked to (L, B, T, KV, hd) for the prefill -> decode
    hand-off."""
    check_remat(remat, return_cache)
    x = embed_tokens(params, tokens, cfg)
    kvs = []
    for lp in params["layers"]:
        if remat:
            x = remat_call(lambda h, lp=lp: dense_layer_apply(lp, h, cfg)[0], remat, x)
        else:
            x, kv = dense_layer_apply(lp, x, cfg)
            if return_cache:
                kvs.append(kv)
    logits = unembed(params, x, cfg)
    if return_cache:
        return logits, _stack_kv(kvs)
    return logits


@torch.no_grad()
def write_cache(cache: KVCache, k_toks: torch.Tensor, v_toks: torch.Tensor, pos: int) -> KVCache:
    """Write every layer's current-token k/v (L, B, 1, KV, hd) at position
    ``pos`` of the cache, in place (one copy per tensor); returns the cache."""
    cache.k[:, :, pos:pos + 1] = k_toks
    cache.v[:, :, pos:pos + 1] = v_toks
    return cache


def dense_lm_decode(params, token: torch.Tensor, cache: KVCache, pos: int, cfg: ArchConfig):
    """One decode step. token (B, 1) int; cache (L, B, S, KV, hd) pair; pos
    the write index. Returns (logits (B, 1, V), cache), the cache updated in
    place at ``pos`` after the layer loop."""
    x = embed_tokens(params, token, cfg)
    kvs = []
    for i, lp in enumerate(params["layers"]):
        x, kv = dense_layer_apply(lp, x, cfg, cache=KVCache(cache.k[i], cache.v[i]),
                                  cache_pos=pos)
        kvs.append(kv)
    logits = unembed(params, x, cfg)
    return logits, write_cache(cache, *_stack_kv(kvs), pos)
