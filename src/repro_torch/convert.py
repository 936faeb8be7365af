"""Carry an operator, or an LM's parameters and optimizer state, across
from numpy arrays (e.g. the JAX package's).

The tests build an operator, a preconditioner or a model with the JAX
package, take its numpy arrays, and hand them to the port through these
functions; nothing here imports JAX. ``device`` is required (``None``
means CUDA). The JAX package stacks each LM layer weight under a leading
axis per stacked group (``layers``; ``mamba``; ``mlstm`` and ``slstm``;
``enc_layers`` and ``dec_layers``; ``self_layers`` and ``cross_layers``);
the port keeps one module per layer, so the LM converters only unstack
(and ``lm_arrays_from_params`` stacks back). The recurrent states of the
SSM and hybrid families and the encdec and vlm caches come across whole
(``state_from_arrays``).
"""
from __future__ import annotations

import typing
from collections.abc import Mapping

import numpy as np
import torch

from .core.preconditioners import BlockJacobiPC, JacobiPC
from .configs.base import ArchConfig
from .kernels.common import resolve_device
from .sparse.formats import BellMatrix, CSRMatrix, DIAMatrix

__all__ = [
    "dia_from_arrays",
    "bell_from_arrays",
    "csr_from_arrays",
    "jacobi_from_arrays",
    "block_jacobi_from_arrays",
    "lm_params_from_arrays",
    "lm_arrays_from_params",
    "train_state_from_arrays",
    "kv_cache_from_arrays",
    "state_from_arrays",
]


def _tensor(a: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))  # JAX's arrays are read-only
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def dia_from_arrays(data: np.ndarray, offsets, n: int, *, device,
                    dtype: torch.dtype | None = None) -> DIAMatrix:
    """A ``DIAMatrix`` from a (k, n) numpy array and its offsets."""
    data = np.asarray(data)
    offsets = tuple(int(o) for o in offsets)
    if data.shape != (len(offsets), int(n)):
        raise ValueError(f"data shape {data.shape} != ({len(offsets)}, {n})")
    return DIAMatrix(_tensor(data, device, dtype), offsets, int(n))


def bell_from_arrays(cols: np.ndarray, vals: np.ndarray, n: int, *, device,
                     dtype: torch.dtype | None = None) -> BellMatrix:
    """A ``BellMatrix`` from (n, R) numpy column ids and values."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[0] != int(n):
        raise ValueError(f"cols {cols.shape} and vals {vals.shape} must both be ({n}, R)")
    return BellMatrix(_tensor(cols, device, torch.int32), _tensor(vals, device, dtype), int(n))


def csr_from_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, *, device,
                    dtype: torch.dtype | None = None) -> CSRMatrix:
    """A ``CSRMatrix`` from parallel (nnz,) numpy row ids (sorted), column
    ids and values."""
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    if not (rows.ndim == 1 and rows.shape == cols.shape == vals.shape):
        raise ValueError(f"rows {rows.shape}, cols {cols.shape}, vals {vals.shape} must be (nnz,)")
    return CSRMatrix(_tensor(rows, device, torch.int32), _tensor(cols, device, torch.int32),
                     _tensor(vals, device, dtype), int(n))


def jacobi_from_arrays(inv_diag: np.ndarray, *, device) -> JacobiPC:
    """A ``JacobiPC`` from a numpy inverse diagonal."""
    return JacobiPC(inv_diag=_tensor(inv_diag, device))


def block_jacobi_from_arrays(inv_blocks: np.ndarray, block: int, *, device) -> BlockJacobiPC:
    """A ``BlockJacobiPC`` from (n // block, block, block) numpy inverse blocks."""
    inv_blocks = np.asarray(inv_blocks)
    if inv_blocks.ndim != 3 or inv_blocks.shape[1:] != (block, block):
        raise ValueError(f"inv_blocks shape {inv_blocks.shape} != (nb, {block}, {block})")
    return BlockJacobiPC(inv_blocks=_tensor(inv_blocks, device), block=int(block))


def _host_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: carry the bits
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _stacked_groups(cfg: ArchConfig) -> dict:
    """{group: layer count} of the layout's stacked groups: the port's
    per-layer lists (``shared_attn``, one set of weights, is no group)."""
    from .models.zoo import build_model

    return {k: len(v) for k, v in build_model(cfg).layout.items() if isinstance(v, list)}


def _by_port_name(cfg: ArchConfig, tree: Mapping) -> dict:
    """{port parameter name: array} of a JAX-layout LM tree (every stacked
    group unstacked)."""
    out = {}

    def walk(node: Mapping, prefix: str, layer: int | None):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", layer)
            else:
                out[f"{prefix}{k}"] = v if layer is None else np.asarray(v)[layer]

    top = dict(tree)
    groups = _stacked_groups(cfg)
    stacks = {g: top.pop(g) for g in groups}
    walk(top, "", None)
    for g, n in groups.items():
        for i in range(n):
            walk(stacks[g], f"{g}.{i}.", i)
    return out


@torch.no_grad()
def _fill(named: dict, arrays: dict, device: torch.device, what: str) -> None:
    if set(named) != set(arrays):
        raise ValueError(f"{what}: names differ: port-only {sorted(set(named) - set(arrays))}, "
                         f"given-only {sorted(set(arrays) - set(named))}")
    for k, t in named.items():
        src = _host_tensor(arrays[k])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{what} {k}: shape {tuple(src.shape)} != {tuple(t.shape)}")
        t.copy_(src.to(device))


def lm_params_from_arrays(cfg: ArchConfig, tree: Mapping, *, device):
    """The port's parameters (a ``ParamTree``, in ``cfg.dtype``) from a
    JAX-layout LM parameter tree of numpy arrays (any ported family)."""
    from .models.zoo import build_model

    params = build_model(cfg).empty_params(device)
    _fill(dict(params.named_parameters()), _by_port_name(cfg, tree), params.embedding.device,
          "params")
    return params


def _set(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for part in path:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def lm_arrays_from_params(cfg: ArchConfig, params) -> dict:
    """The inverse: a JAX-layout tree of numpy arrays (stacked groups
    stacked; bf16 as float32, which holds every bf16 value exactly)."""
    groups = _stacked_groups(cfg)
    tree: dict = {}
    per_layer: dict = {g: {} for g in groups}
    for name, t in params.named_parameters():
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        head, _, rest = name.partition(".")
        if head in groups:
            i, rest = rest.split(".", 1)
            per_layer[head].setdefault(rest, [None] * groups[head])[int(i)] = a
        else:
            _set(tree, name, a)
    for g, leaves in per_layer.items():
        tree[g] = {}
        for rest, arrays in leaves.items():
            _set(tree[g], rest, np.stack(arrays))
    return tree


def train_state_from_arrays(cfg: ArchConfig, state, *, device):
    """The port's ``TrainState`` from the JAX package's (a ``TrainState``
    of numpy arrays: ``params``, ``opt`` with ``m``, ``v``, ``step`` and
    ``prev_norm``, and ``step``)."""
    from .train.optimizer import AdamWState
    from .train.train_step import TrainState

    dev = resolve_device(device)
    params = lm_params_from_arrays(cfg, state.params, device=dev)
    moments = []
    for key in ("m", "v"):
        arrays = _by_port_name(cfg, getattr(state.opt, key))
        named = {k: torch.empty(np.shape(a), dtype=torch.float32, device=dev)
                 for k, a in arrays.items()}
        _fill(named, arrays, dev, f"opt.{key}")
        moments.append({k: named[k] for k, _ in params.named_parameters()})

    def scalar(a, dtype):
        return torch.tensor(np.asarray(a).item(), dtype=dtype, device=dev)

    return TrainState(
        params=params,
        opt=AdamWState(m=moments[0], v=moments[1], step=scalar(state.opt.step, torch.int32),
                       prev_norm=scalar(state.opt.prev_norm, torch.float32)),
        step=scalar(state.step, torch.int32),
    )


def kv_cache_from_arrays(k: np.ndarray, v: np.ndarray, *, device):
    """The port's ``KVCache`` from the JAX package's (L, B, S, KV, hd) k and
    v arrays (bf16 carried bit for bit)."""
    from .models.attention import KVCache

    k, v = _host_tensor(k), _host_tensor(v)
    if k.ndim != 5 or k.shape != v.shape:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must both be (L, B, S, KV, hd)")
    dev = resolve_device(device)
    return KVCache(k=k.to(dev), v=v.to(dev))


def state_from_arrays(kind, state, *, device):
    """The port's recurrent state or cache of NamedTuple type ``kind``
    (``ZambaState``, ``XLSTMState``, ``EncDecCache``, ``VLMCache``) from the JAX package's NamedTuple of numpy arrays with
    the same fields, each leaf on ``device`` (bf16 carried bit for bit); a
    field whose annotation is itself a NamedTuple (``GLAState``,
    ``KVCache``) is converted to that type."""
    if tuple(state._fields) != kind._fields:
        raise ValueError(f"{kind.__name__} has fields {kind._fields}, the given state "
                         f"{tuple(state._fields)}")
    dev = resolve_device(device)
    hints = typing.get_type_hints(kind)
    return kind(**{f: state_from_arrays(hints[f], getattr(state, f), device=dev)
                   if hasattr(hints[f], "_fields") else _host_tensor(getattr(state, f)).to(dev)
                   for f in kind._fields})
