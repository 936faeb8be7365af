"""Shared model-building blocks: the parameter layout, norms and RoPE.

Parameters are declared as a nested dict of ``ParamSpec(shape,
logical_axes, init)``, as in the JAX package; lists stand for per-layer
stacks. From that one layout the port derives the parameter count, an
abstract tree of ``meta`` tensors (no allocation; the dry-run), the
logical axes that ``launch/sharding.py`` maps to mesh axes, and a
``ParamTree`` module that holds one ``nn.Parameter`` per spec. The JAX
package stacks each layer weight under a leading ``layers`` axis; here
every layer is its own module (a ``ModuleList``), so a per-layer weight
gets a gradient of its own size, its axes have no ``layers`` entry, and
``convert.lm_params_from_arrays`` only unstacks. ``x @ W`` keeps W as
(d_in, d_out), as in JAX.

Sharding hints: models call ``shard_hint(x, axes)`` on activations at the
JAX package's call sites. Outside ``use_sharding_rules`` it does nothing.
Under it, it calls the resolver, so the rules log the hints they cannot
honour, as JAX's do; but it returns ``x`` unchanged: the port has no SPMD
partitioner for a constraint to steer (a sharded run places each shard's
slice itself, ``launch/mesh.shard_map``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = [
    "DTYPES",
    "ParamSpec",
    "ParamTree",
    "init_tensor",
    "count_params",
    "abstract",
    "logical_axes_tree",
    "use_sharding_rules",
    "current_mesh",
    "shard_hint",
    "make_norm_params",
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "rope_angles",
    "apply_rope",
    "causal_mask_bias",
    "require_dtype",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec shape {self.shape} has axes {self.axes}")


def init_tensor(spec: ParamSpec, dtype: torch.dtype, generator: torch.Generator | None,
                device) -> torch.Tensor:
    """The JAX package's init rule (``common.py:_init_array``): zeros, ones
    times ``scale``, or normal with std ``scale / sqrt(fan_in)``, where
    fan_in is ``shape[-2]`` for 2-D leaves (so the (V, d) embedding draws
    with std 1/sqrt(V)). Normals are drawn in f32 from ``generator`` and
    cast. ``generator=None`` leaves the tensor uninitialised (the
    converter fills it)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
    if generator is None:
        return torch.empty(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return (draw * std).to(dtype)


def count_params(layout) -> int:
    if isinstance(layout, ParamSpec):
        return math.prod(layout.shape)
    if isinstance(layout, list):
        return sum(count_params(x) for x in layout)
    return sum(count_params(x) for x in layout.values())


def logical_axes_tree(layout):
    """The layout's logical axis names, leaf for leaf."""
    if isinstance(layout, ParamSpec):
        return layout.axes
    if isinstance(layout, list):
        return [logical_axes_tree(x) for x in layout]
    return {k: logical_axes_tree(v) for k, v in layout.items()}


class ParamTree(nn.Module):
    """A module holding one parameter per ``ParamSpec`` of a layout; nested
    dicts become submodules and lists ``ModuleList``s. ``p["wq"]`` reads a
    parameter or submodule, as the JAX functions index their dicts."""

    def __init__(self, layout: dict, *, dtype: torch.dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        for name, spec in layout.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(
                    name, nn.Parameter(init_tensor(spec, dtype, generator, device)))
            elif isinstance(spec, list):
                setattr(self, name, nn.ModuleList(
                    ParamTree(s, dtype=dtype, device=device, generator=generator) for s in spec))
            else:
                setattr(self, name, ParamTree(spec, dtype=dtype, device=device,
                                              generator=generator))

    def __getitem__(self, name: str):
        return getattr(self, name)


# --------------------------------------------------------------------------
# sharding-hint context (installed by launch/sharding.py)
# --------------------------------------------------------------------------

_ACTIVE_RULES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_rules",
                                                               default=None)
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_active_mesh",
                                                              default=None)


@contextlib.contextmanager
def use_sharding_rules(resolver: Callable, mesh=None):
    """resolver(shape, logical_axes) -> NamedSharding | None, called by
    every ``shard_hint`` inside the block. ``mesh`` (optional) also
    exposes the mesh to the modules that run per-shard regions (the
    sharded MoE dispatch) through ``current_mesh()``."""
    token = _ACTIVE_RULES.set(resolver)
    token_m = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_RULES.reset(token)
        _ACTIVE_MESH.reset(token_m)


def current_mesh():
    return _ACTIVE_MESH.get()


def shard_hint(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """``x`` unchanged. Under ``use_sharding_rules`` the resolver sees the
    hint first (and logs a rule it drops); JAX then constrains x's layout
    (``with_sharding_constraint``). Here the resolver's sharding goes to
    the dry run's census, if one is counting (``launch/roofline``), which
    reshards its placement of ``x``."""
    resolver = _ACTIVE_RULES.get()
    if resolver is not None:
        sharding = resolver(tuple(x.shape), axes)
        if sharding is not None:
            for mode in _get_current_dispatch_mode_stack():
                hint = getattr(mode, "placement_hint", None)
                if hint is not None:
                    hint(x, sharding)
    return x


def abstract(layout, dtype: torch.dtype) -> ParamTree:
    """The layout's ``ParamTree`` on the ``meta`` device: every parameter's
    shape and dtype, no storage (JAX's ShapeDtypeStruct tree for the
    dry-run)."""
    return ParamTree(layout, dtype=dtype, device="meta")


def require_dtype(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """An input beside the tokens (encoder frames, image features) must
    come in the model's dtype, as JAX's ``input_specs`` declares: JAX's bf16
    models fed f32 raise or quietly promote, and torch's matmul raises."""
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}; the model takes {dtype}: cast it first")


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def make_norm_params(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # the JAX order: normalise in f32, cast to x's dtype, then scale
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split (not interleaved) rotation. x (..., seq, heads, head_dim);
    cos/sin (seq, head_dim//2) or broadcastable; computed in f32."""
    half = x.shape[-1] // 2
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def causal_mask_bias(q_len: int, kv_len: int, q_offset: int = 0, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(q_len, kv_len) additive bias: 0 where kv <= q_offset + q, -1e30 after."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(kv_pos <= q_pos, zero, torch.full((), -1e30, dtype=dtype, device=device))
