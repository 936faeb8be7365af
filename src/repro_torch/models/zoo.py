"""Model API, as the JAX package's ``models/zoo.py``, for the dense and
MoE families.

    api = build_model(cfg)
    params = api.init_params(generator)     # a ParamTree on generator.device
    logits = api.forward(params, batch)     # batch = {"tokens": (B, T) int}
    logits, cache = api.prefill(params, batch)
    cache = api.init_cache(batch_size, max_seq)   # device=None: CUDA
    logits, cache = api.decode(params, token, cache, pos)

The MoE family's ``forward`` returns (logits, aux), as JAX's does. The
four other families (ssm, hybrid, encdec, vlm) wait for their slices
(ROADMAP) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from . import moe_lm as _moe
from . import transformer as _dense
from .attention import KVCache, init_kv_cache
from .common import DTYPES, ParamTree, count_params

__all__ = ["ModelApi", "build_model", "make_generator"]

def make_generator(seed: int = 0, device=None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (``None`` means CUDA)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    layout: Dict[str, Any] = field(repr=False)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    def init_params(self, generator: torch.Generator) -> ParamTree:
        """Parameters drawn from ``generator`` on its device, by the JAX
        package's init rule (``common.init_tensor``)."""
        return ParamTree(self.layout, dtype=self.dtype, device=generator.device,
                         generator=generator)

    def empty_params(self, device=None) -> ParamTree:
        """Uninitialised parameters of this layout (for the converter)."""
        return ParamTree(self.layout, dtype=self.dtype, device=resolve_device(device))

    def forward(self, params: ParamTree, batch: dict, remat: bool = False):
        """Logits (B, T, V); the MoE family returns (logits, aux)."""
        if self.cfg.family == "moe":
            return _moe.moe_lm_forward(params, batch["tokens"], self.cfg, remat=remat)
        return _dense.dense_lm_forward(params, batch["tokens"], self.cfg, remat=remat)

    def prefill(self, params: ParamTree, batch: dict) -> tuple[torch.Tensor, KVCache]:
        """The full forward over the prompt: (logits (B, T, V), its cache of
        (L, B, T, KV, hd) tensors)."""
        if self.cfg.family == "moe":
            logits, _aux, kvs = _moe.moe_lm_forward(params, batch["tokens"], self.cfg,
                                                    return_cache=True)
        else:
            logits, kvs = _dense.dense_lm_forward(params, batch["tokens"], self.cfg,
                                                  return_cache=True)
        return logits, KVCache(*kvs)

    def init_cache(self, batch_size: int, max_seq: int, device=None) -> KVCache:
        """A zero cache of max_seq positions on ``device`` (``None``: CUDA)."""
        return init_kv_cache(self.cfg, batch_size, max_seq, self.cfg.n_layers, self.dtype,
                             device)

    def decode(self, params: ParamTree, token: torch.Tensor, cache: KVCache,
               pos: int) -> tuple[torch.Tensor, KVCache]:
        """One token (B, 1) at position ``pos``: (logits (B, 1, V), the cache
        with this token's k/v written at ``pos``, in place)."""
        if self.cfg.family == "moe":
            return _moe.moe_lm_decode(params, token, cache, pos, self.cfg)
        return _dense.dense_lm_decode(params, token, cache, pos, self.cfg)

    def n_params(self) -> int:
        return count_params(self.layout)


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family == "dense":
        layout = _dense.dense_lm_layout(cfg)
    elif cfg.family == "moe":
        layout = _moe.moe_lm_layout(cfg)
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: only dense and moe are (see ROADMAP)")
    return ModelApi(cfg=cfg, layout=layout)
