"""Logical-axis sharding rules with divisibility-aware degradation, as the
JAX package's ``launch/sharding.py``.

Rules map logical axis names (from ``models/common.ParamSpec`` and the
``shard_hint`` call sites) to mesh axes. Every sharded dim must divide the
product of its mesh axes, so ``resolve_spec`` drops a rule whose dim does
not divide (after trying a prefix of its axes): the tensor is then
replicated along the dropped axes, and the drop is logged in
``Rules.dropped`` for the dry-run to report (whisper-tiny's vocabulary of
51,865 cannot split 16 ways).

:class:`P` and :class:`NamedSharding` stand for ``jax.sharding``'s: a spec
is one entry per dim (None, a mesh axis name, or a tuple of names), and a
sharding gives the block a device holds (``shard_shape``) and cuts it
(``local``). ``param_shardings`` follows the port's per-layer tree: each
per-layer list is resolved once, as the stacked (n_layers, ...) leaf of
the JAX layout with its leading "layers" axis (which maps to no mesh
axis), so a drop is logged once a group, with the group's shape, as JAX
logs it; every layer of the group then shares the per-layer spec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .mesh import Mesh, block_index, entry_axes

__all__ = ["P", "NamedSharding", "Rules", "DEFAULT_RULES", "resolve_spec", "make_resolver",
           "param_shardings", "named_shardings", "batch_shardings", "cache_shardings",
           "scalar_sharding", "sharded_bytes", "tree_leaves"]

MeshAxes = Union[str, Tuple[str, ...], None]


class P(tuple):
    """A PartitionSpec: one entry per leading dim of a tensor (missing
    trailing entries are None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The block each device holds of a tensor of ``global_shape``."""
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            parts = math.prod(self.mesh.shape[a] for a in entry_axes(entry))
            if dim % parts:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does not split {parts} "
                                 f"ways under {self.spec}")
            out.append(dim // parts)
        return tuple(out)

    def local(self, t: torch.Tensor, coords: Dict[str, int]) -> torch.Tensor:
        """The block of ``t`` the device at ``coords`` ({axis: index}) holds
        (a view)."""
        return t[block_index(self.mesh, self.spec, coords, t.shape)]


@dataclass
class Rules:
    table: Dict[str, MeshAxes]
    dropped: list = field(default_factory=list)  # (shape, axis, reason) log

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.table.get(name)


def DEFAULT_RULES() -> Rules:
    return Rules(
        table={
            "batch": ("pod", "data"),
            "vocab": "model",
            "heads_flat": "model",
            "kv_flat": "model",
            "heads": "model",
            "mlp": "model",
            "experts": "model",
            "expert_mlp": None,
            "embed": None,
            "layers": None,
            "seq": None,
        }
    )


def _present_axes(mesh, axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in mesh.shape)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
                 rules: Rules) -> P:
    """A spec for a tensor of ``shape`` with these logical axes, dropping
    mesh axes that do not divide (a prefix first) or that an earlier dim
    already took. Only ``mesh.shape`` is read."""
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        axes = _present_axes(mesh, rules.get(name))
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if dim % size != 0:
            # try a prefix of the axes before giving up
            ok = ()
            for k in range(len(axes) - 1, 0, -1):
                size_k = math.prod(mesh.shape[a] for a in axes[:k])
                if dim % size_k == 0:
                    ok = axes[:k]
                    break
            if not ok:
                rules.dropped.append((tuple(shape), name, f"{dim} % {size} != 0"))
                parts.append(None)
                continue
            axes = ok
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return P(*parts)


def make_resolver(mesh: Mesh, rules: Rules):
    """Resolver for ``models.common.use_sharding_rules`` (activation hints)."""

    def resolver(shape, logical):
        return NamedSharding(mesh, resolve_spec(shape, logical, mesh, rules))

    return resolver


def param_shardings(api, mesh: Mesh, rules: Rules):
    """A ``NamedSharding`` per parameter, in the layout's tree (dicts and
    per-layer lists). Keys are resolved in sorted order, the order of
    JAX's tree walk, so ``rules.dropped`` lists the drops as JAX does."""

    def walk(node, axes, lead=()):
        if isinstance(node, list):
            n = len(node)
            if any(layer != node[0] for layer in node):
                raise ValueError("the layers of a per-layer list differ in layout")
            one = walk(node[0], axes[0], lead=(n,))
            return [one] * n
        if isinstance(node, dict):
            return {k: walk(node[k], axes[k], lead) for k in sorted(node)}
        if lead:  # one layer of a stacked group: resolve the group's leaf
            spec = resolve_spec((*lead, *node.shape), ("layers", *axes), mesh, rules)
            return NamedSharding(mesh, P(*spec[1:]))
        return NamedSharding(mesh, resolve_spec(node.shape, axes, mesh, rules))

    return walk(api.layout, api.param_logical_axes())


def named_shardings(tree, prefix: str = "") -> dict:
    """{dotted name: sharding} of a ``param_shardings`` tree; the names are
    those of ``ParamTree.named_parameters()``."""
    if isinstance(tree, NamedSharding):
        return {prefix[:-1]: tree}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        out.update(named_shardings(v, f"{prefix}{k}."))
    return out


def batch_shardings(specs: dict, mesh: Mesh, rules: Rules):
    """Shard every batch input on its leading (batch) dim."""
    def one(t):
        logical = ["batch"] + [None] * (len(t.shape) - 1)
        return NamedSharding(mesh, resolve_spec(t.shape, logical, mesh, rules))

    return {k: one(v) if hasattr(v, "shape") else v for k, v in specs.items()}


def _tree_map(fn, tree):
    """fn on every tensor leaf of NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_shardings(cache_tree, shape_cfg, mesh: Mesh, rules: Rules, layout: str = "default"):
    """Heuristic decode-cache layouts, leaf for leaf of the cache.

    layout="default":
      * any dim equal to global_batch shards over the data axes (if divisible);
      * else a dim equal to seq_len shards over 'data' (context parallelism:
        the long_500k batch=1 case);
      * the trailing (feature/head_dim) axis shards over 'model' if divisible.
    layout="seq_model" (flash-decode): additionally shard the cache
      SEQUENCE axis over 'model', so attention would reduce small per-shard
      softmax statistics instead of resharding the cache every step.
    Scalars (pos) replicate.
    """
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    data_axes = _present_axes(mesh, ("pod", "data"))
    data_size = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1
    model_size = mesh.shape.get("model", 1)

    def one(t):
        if not hasattr(t, "shape") or len(t.shape) == 0:
            return NamedSharding(mesh, P())
        parts = [None] * len(t.shape)
        batch_done = False
        for i, d in enumerate(t.shape):
            if d == B and not batch_done and B % data_size == 0 and B >= data_size:
                parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                batch_done = True
                break
        if not batch_done and "data" in mesh.shape:
            for i, d in enumerate(t.shape):
                if d == S and S % mesh.shape["data"] == 0:
                    parts[i] = "data"
                    batch_done = True
                    break
        if layout == "seq_model":
            for i, d in enumerate(t.shape):
                if parts[i] is None and d == S and S % model_size == 0:
                    parts[i] = "model"
                    return NamedSharding(mesh, P(*parts))
        last = len(t.shape) - 1
        if parts[last] is None and t.shape[last] % model_size == 0 and t.shape[last] >= model_size:
            parts[last] = "model"
        return NamedSharding(mesh, P(*parts))

    return _tree_map(one, cache_tree)


def scalar_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree (NamedTuples, tuples, lists, dicts), in
    order."""
    leaves: list = []
    _tree_map(leaves.append, tree)
    return leaves


def sharded_bytes(pairs) -> int:
    """The bytes one device holds of (tensor, sharding) pairs: the sum of
    each block's size."""
    return sum(math.prod(s.shard_shape(t.shape)) * t.element_size() for t, s in pairs)
