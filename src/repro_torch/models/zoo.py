"""Model API, as the JAX package's ``models/zoo.py``, for the dense, MoE,
SSM (xLSTM) and hybrid (Zamba2) families.

    api = build_model(cfg)
    params = api.init_params(generator)     # a ParamTree on generator.device
    logits = api.forward(params, batch)     # batch = {"tokens": (B, T) int}
    logits, cache = api.prefill(params, batch)
    cache = api.init_cache(batch_size, max_seq)   # device=None: CUDA
    logits, cache = api.decode(params, token, cache, pos)

The MoE family's ``forward`` returns (logits, aux), as JAX's does. The
cache is a ``KVCache`` (dense, MoE), an ``XLSTMState`` (ssm: a recurrent
state, O(1) in the context) or a ``ZambaState`` (hybrid: recurrent
states and the shared attention block's KV caches); ``decode`` updates
it in place. The encdec and vlm families wait for their slices (ROADMAP)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from . import mamba as _mamba
from . import moe_lm as _moe
from . import transformer as _dense
from . import xlstm as _xlstm
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
        fam, tokens = self.cfg.family, batch["tokens"]
        if fam == "moe":
            return _moe.moe_lm_forward(params, tokens, self.cfg, remat=remat)
        if fam == "ssm":
            return _xlstm.xlstm_forward(params, tokens, self.cfg, remat=remat)
        if fam == "hybrid":
            return _mamba.zamba_forward(params, tokens, self.cfg, remat=remat)
        return _dense.dense_lm_forward(params, tokens, self.cfg, remat=remat)

    def prefill(self, params: ParamTree, batch: dict):
        """The full forward over the prompt: (logits (B, T, V), its cache: k/v
        of (L, B, T, KV, hd), or the recurrent state after the T tokens)."""
        fam, tokens = self.cfg.family, batch["tokens"]
        if fam == "ssm":
            return _xlstm.xlstm_forward(params, tokens, self.cfg, return_state=True)
        if fam == "hybrid":
            return _mamba.zamba_forward(params, tokens, self.cfg, return_state=True)
        if fam == "moe":
            logits, _aux, kvs = _moe.moe_lm_forward(params, tokens, self.cfg, return_cache=True)
        else:
            logits, kvs = _dense.dense_lm_forward(params, tokens, self.cfg, return_cache=True)
        return logits, KVCache(*kvs)

    def init_cache(self, batch_size: int, max_seq: int, device=None):
        """A zero cache of max_seq positions on ``device`` (``None``: CUDA);
        the SSM family's state has no positions and ignores max_seq."""
        fam = self.cfg.family
        if fam == "ssm":
            return _xlstm.xlstm_init_state(self.cfg, batch_size, device)
        if fam == "hybrid":
            return _mamba.zamba_init_state(self.cfg, batch_size, max_seq, self.dtype, device)
        return init_kv_cache(self.cfg, batch_size, max_seq, self.cfg.n_layers, self.dtype,
                             device)

    def decode(self, params: ParamTree, token: torch.Tensor, cache, pos: int):
        """One token (B, 1) at position ``pos``: (logits (B, 1, V), the cache
        updated in place: this token's k/v written at ``pos``, the recurrent
        states stepped)."""
        fam = self.cfg.family
        if fam == "moe":
            return _moe.moe_lm_decode(params, token, cache, pos, self.cfg)
        if fam == "ssm":
            return _xlstm.xlstm_decode(params, token, cache, pos, self.cfg)
        if fam == "hybrid":
            return _mamba.zamba_decode(params, token, cache, pos, self.cfg)
        return _dense.dense_lm_decode(params, token, cache, pos, self.cfg)

    def n_params(self) -> int:
        return count_params(self.layout)


_LAYOUTS = {"dense": _dense.dense_lm_layout, "moe": _moe.moe_lm_layout,
            "ssm": _xlstm.xlstm_layout, "hybrid": _mamba.zamba_layout}


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _LAYOUTS:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: only "
                                  f"{', '.join(_LAYOUTS)} are (see ROADMAP)")
    layout = _LAYOUTS[cfg.family](cfg)
    return ModelApi(cfg=cfg, layout=layout)
