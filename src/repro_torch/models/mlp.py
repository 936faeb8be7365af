"""Dense MLP block (SwiGLU), as the JAX package's ``models/mlp.py``.

``gelu_mlp`` (the encoder-decoder family's) waits for that family.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec

__all__ = ["swiglu_params", "swiglu"]


def swiglu_params(d: int, f: int) -> dict:
    return {
        "w_gate": ParamSpec((d, f)),
        "w_up": ParamSpec((d, f)),
        "w_down": ParamSpec((f, d)),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
