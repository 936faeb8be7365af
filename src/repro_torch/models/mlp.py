"""Dense MLP blocks (SwiGLU; the encoder-decoder family's biased GELU),
as the JAX package's ``models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec, shard_hint

__all__ = ["swiglu_params", "swiglu", "gelu_mlp_params", "gelu_mlp"]


def swiglu_params(d: int, f: int) -> dict:
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard_hint(h, ("batch", None, "mlp"))
    return h @ p["w_down"]


def gelu_mlp_params(d: int, f: int) -> dict:
    return {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "b_up": ParamSpec((f,), ("mlp",), init="zeros"),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
        "b_down": ParamSpec((d,), ("embed",), init="zeros"),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    h = shard_hint(h, ("batch", None, "mlp"))
    return h @ p["w_down"] + p["b_down"]
