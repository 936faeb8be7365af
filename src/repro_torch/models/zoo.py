"""Model API over the six families, as the JAX package's ``models/zoo.py``.

    api = build_model(cfg)
    params = api.init_params(generator)     # a ParamTree on generator.device
    logits = api.forward(params, batch)     # batch = {"tokens": (B, T) int, ...}
    logits, cache = api.prefill(params, batch)
    cache = api.init_cache(batch_size, max_seq)   # device=None: CUDA
    logits, cache = api.decode(params, token, cache, pos)
    abstract = api.abstract_params()        # a ParamTree on "meta": no storage
    specs = api.input_specs(shape)          # meta stand-ins of every input

``batch`` holds "tokens" plus the family's extras, in the model's dtype:
encdec "frames" (B, enc_seq, d), the stub audio frontend's output; vlm
"img_feats" (B, n_img_tokens, d), the stub ViT's. The MoE family's
``forward`` returns (logits, aux), as JAX's does. The cache is a
``KVCache`` (dense, MoE), an ``XLSTMState`` (ssm: a recurrent state, O(1)
in the context), a ``ZambaState`` (hybrid: recurrent states and the
shared attention block's KV caches), an ``EncDecCache`` (the decoder's KV
caches and the encoder's output) or a ``VLMCache`` (the self layers' KV
caches and the image features); ``decode`` updates it in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..kernels.common import resolve_device
from . import encdec as _encdec
from . import mamba as _mamba
from . import moe_lm as _moe
from . import transformer as _dense
from . import vlm as _vlm
from . import xlstm as _xlstm
from .attention import KVCache, init_kv_cache
from .common import DTYPES, ParamTree, abstract, count_params, logical_axes_tree

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

    def abstract_params(self):
        """The parameters as a ``ParamTree`` on the ``meta`` device, in the
        model's dtype: ``init_params``'s tree without storage."""
        return abstract(self.layout, self.dtype)

    def param_logical_axes(self):
        """The logical axis names of every leaf, in the layout's tree."""
        return logical_axes_tree(self.layout)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` stand-ins for every model input of this shape, as JAX's
        ShapeDtypeStructs: train and prefill take "tokens" (B, T) (train
        also "labels"), plus the family's "frames" or "img_feats" in the
        model's dtype; decode takes "token" (B, 1), the cache of a
        T-position context (``init_cache(B, T, device="meta")``) and "pos".
        Token ids are int32, as in JAX; "pos" is a 0-d int32 here, where
        ``decode`` takes a Python int."""
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta(B, T)}
            if shape.kind == "train":
                specs["labels"] = meta(B, T)
            if cfg.family == "encdec":
                specs["frames"] = meta(B, cfg.enc_seq, cfg.d_model, dtype=self.dtype)
            if cfg.family == "vlm":
                specs["img_feats"] = meta(B, cfg.n_img_tokens, cfg.d_model, dtype=self.dtype)
            return specs
        return {"token": meta(B, 1), "cache": self.init_cache(B, T, device="meta"), "pos": meta()}

    def _extras(self, batch: dict) -> tuple:
        """The family's inputs beside the tokens (JAX's ``_batch_extras``)."""
        if self.cfg.family == "encdec":
            return (batch["frames"],)
        if self.cfg.family == "vlm":
            return (batch["img_feats"],)
        return ()

    def forward(self, params: ParamTree, batch: dict, remat=False):
        """Logits (B, T, V); the MoE family returns (logits, aux). ``remat``
        is False, True or "save_collectives"."""
        fam, tokens = self.cfg.family, batch["tokens"]
        fwd = {"moe": _moe.moe_lm_forward, "ssm": _xlstm.xlstm_forward,
               "hybrid": _mamba.zamba_forward, "encdec": _encdec.encdec_forward,
               "vlm": _vlm.vlm_forward}.get(fam, _dense.dense_lm_forward)
        return fwd(params, tokens, *self._extras(batch), self.cfg, remat=remat)

    def prefill(self, params: ParamTree, batch: dict):
        """The full forward over the prompt: (logits (B, T, V), its cache: k/v
        of (L, B, T, KV, hd) (with ``enc_out`` or ``img_feats`` beside them),
        or the recurrent state after the T tokens)."""
        fam, tokens = self.cfg.family, batch["tokens"]
        if fam == "ssm":
            return _xlstm.xlstm_forward(params, tokens, self.cfg, return_state=True)
        if fam == "hybrid":
            return _mamba.zamba_forward(params, tokens, self.cfg, return_state=True)
        if fam == "encdec":
            logits, (kvs, enc_out) = _encdec.encdec_forward(
                params, tokens, batch["frames"], self.cfg, return_cache=True)
            return logits, _encdec.EncDecCache(self_kv=KVCache(*kvs), enc_out=enc_out)
        if fam == "vlm":
            logits, kvs = _vlm.vlm_forward(params, tokens, batch["img_feats"], self.cfg,
                                           return_cache=True)
            return logits, _vlm.VLMCache(self_kv=KVCache(*kvs), img_feats=batch["img_feats"])
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
        if fam == "encdec":
            return _encdec.encdec_init_cache(self.cfg, batch_size, max_seq, self.dtype, device)
        if fam == "vlm":
            return _vlm.vlm_init_cache(self.cfg, batch_size, max_seq, self.dtype, device)
        return init_kv_cache(self.cfg, batch_size, max_seq, self.cfg.n_layers, self.dtype,
                             device)

    def decode(self, params: ParamTree, token: torch.Tensor, cache, pos: int):
        """One token (B, 1) at position ``pos``: (logits (B, 1, V), the cache
        updated in place: this token's k/v written at ``pos``, the recurrent
        states stepped)."""
        dec = {"moe": _moe.moe_lm_decode, "ssm": _xlstm.xlstm_decode,
               "hybrid": _mamba.zamba_decode, "encdec": _encdec.encdec_decode,
               "vlm": _vlm.vlm_decode}.get(self.cfg.family, _dense.dense_lm_decode)
        return dec(params, token, cache, pos, self.cfg)

    def decode_reads(self, name: str) -> bool:
        """Whether ``decode`` reads its input ``name``: "token", "pos",
        "params.<parameter>" or "cache.<field>". Each family's decode reads
        them all but these, which JAX's ``jit`` prunes from the compiled
        serve step: the SSM's position (its state holds no positions), the
        hybrid cache's ``pos`` field (the step takes the position argument
        and writes pos + 1 there) and the encoder-decoder's encoder
        parameters (the cache holds the encoder's output)."""
        return not any(name.startswith(u) for u in _DECODE_UNREAD.get(self.cfg.family, ()))

    def n_params(self) -> int:
        return count_params(self.layout)


# the inputs (``ModelApi.decode_reads``'s names, or their prefixes) a family's
# decode never reads
_DECODE_UNREAD = {"ssm": ("pos",), "hybrid": ("cache.pos",), "encdec": ("params.enc_",)}

_LAYOUTS = {"dense": _dense.dense_lm_layout, "moe": _moe.moe_lm_layout,
            "ssm": _xlstm.xlstm_layout, "hybrid": _mamba.zamba_layout,
            "encdec": _encdec.encdec_layout, "vlm": _vlm.vlm_layout}


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _LAYOUTS:
        raise ValueError(f"unknown family {cfg.family!r}")
    return ModelApi(cfg=cfg, layout=_LAYOUTS[cfg.family](cfg))
