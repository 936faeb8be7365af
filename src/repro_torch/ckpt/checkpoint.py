"""Checkpoints: one ``.npz`` holding every tensor keyed by its path in the
state, plus a JSON manifest (step, keys, shapes, dtypes), as the JAX
package's ``ckpt/checkpoint.py``. Writes are atomic (a temporary
directory, then a rename), so a job killed mid-save never corrupts the
newest checkpoint.

numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit pattern
(an int16 view) with "bfloat16" in the manifest, and restored bit for bit.
A state is any nest of tensors, dicts, named tuples and modules (their
parameters). Restoring fills a template of that structure IN PLACE and
returns it; the JAX package's reshard-on-restore has no one-card
counterpart.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "available_steps",
           "flatten_state", "host_snapshot", "load_into"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int32, torch.int64,
    torch.int16, torch.int8, torch.uint8, torch.bool)}


def flatten_state(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a nest of tensors, dicts, named tuples and modules."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        return {join(k): t for k, t in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    out: Dict[str, torch.Tensor] = {}
    for k, sub in items:
        out.update(flatten_state(sub, join(k)))
    return out


def host_snapshot(state: Any) -> Dict[str, torch.Tensor]:
    """A copy of every tensor of ``state`` in host memory, taken now."""
    return {k: t.detach().to("cpu", copy=True) for k, t in flatten_state(state).items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a copy, 0-d kept
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t.to(_DTYPES[dtype_name])


@torch.no_grad()
def load_into(template: Any, flat: Dict[str, torch.Tensor], what: str = "snapshot") -> Any:
    """Copy ``flat`` {path: tensor} into the tensors of ``template`` in place."""
    for key, leaf in flatten_state(template).items():
        if key not in flat:
            raise KeyError(f"{what} is missing leaf {key!r}")
        src = flat[key]
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {what} {tuple(src.shape)} vs "
                             f"template {tuple(leaf.shape)}")
        leaf.copy_(src)
    return template


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomically write ``state`` under ckpt_dir/step_<step>."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = flatten_state(state)
    host = {k: _to_numpy(v) for k, v in leaves.items()}
    manifest = {
        "step": int(step),
        "keys": sorted(host),
        "shapes": {k: list(v.shape) for k, v in leaves.items()},
        "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in leaves.items()},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template: Any) -> Any:
    """Fill ``template`` (a state of the saved structure, on any device) with
    the checkpoint's tensors, in place, and return it. Raises KeyError on a
    missing leaf and ValueError on a shape mismatch."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: _from_numpy(data[k], manifest["dtypes"][k])
                for k in flatten_state(template) if k in data}
    return load_into(template, flat, what=f"checkpoint step {manifest['step']}")
