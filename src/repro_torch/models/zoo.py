"""Model API, as the JAX package's ``models/zoo.py``, for the dense family.

    api = build_model(cfg)
    params = api.init_params(generator)   # a ParamTree on generator.device
    logits = api.forward(params, batch)   # batch = {"tokens": (B, T) int}

The other five families (moe, ssm, hybrid, encdec, vlm) wait for their
slices (ROADMAP) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from . import transformer as _dense
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

    def forward(self, params: ParamTree, batch: dict, remat: bool = False) -> torch.Tensor:
        return _dense.dense_lm_forward(params, batch["tokens"], self.cfg, remat=remat)

    def n_params(self) -> int:
        return count_params(self.layout)


def build_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: only the dense family is (see ROADMAP)")
    return ModelApi(cfg=cfg, layout=_dense.dense_lm_layout(cfg))
