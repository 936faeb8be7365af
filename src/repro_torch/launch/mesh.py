"""The named device mesh, as the JAX package's ``launch/mesh.py``, and a
``shard_map`` over it.

Production meshes: single pod 16 x 16 = 256 devices ("data", "model");
multi-pod 2 x 16 x 16 = 512 ("pod", "data", "model"), the leading "pod"
axis being the data-parallel axis that crosses the slowest links, so a
gradient reduction crosses it once.

:class:`Mesh` is a grid of ``torch.device``s with axis names. With no
devices given, ``make_production_mesh`` builds it of ``meta`` devices:
the counterpart of the JAX dry-run's forced host device count, a mesh
that describes a layout and runs nothing. A mesh of real devices runs
SPMD regions through :func:`shard_map` on the port's own SPMD model, one
host thread per shard (``core/comm.py``); several shards may share a
device.
"""
from __future__ import annotations

import contextlib
import math
from collections import Counter, OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from ..core.comm import ShardComm, SolverMesh

__all__ = ["Mesh", "make_production_mesh", "make_solver_mesh_from", "shard_map", "block_index",
           "entry_axes", "DATA_AXES", "MODEL_AXIS"]

DATA_AXES = ("pod", "data")  # batch shards over whichever of these exist
MODEL_AXIS = "model"


class Mesh:
    """A grid of ``torch.device``s with one name per axis.

    ``shape`` is the ordered {name: size} mapping (JAX's ``Mesh.shape``),
    ``devices`` the grid (a numpy object array), ``counts`` the
    collectives that :func:`shard_map` regions on this mesh ran, by kind
    and tag (each collective once, however many shards join it), and
    ``coll_bytes`` their result bytes a shard, by kind and group size.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, grid.shape))
        self.counts: Counter = Counter()
        self.coll_bytes: Counter = Counter()

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({dict(self.shape)}, devices={kinds})"


def make_production_mesh(multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """The 16 x 16 ("data", "model") or, with ``multi_pod``, the 2 x 16 x 16
    ("pod", "data", "model") mesh: of ``meta`` devices when ``devices`` is
    None, else of the first 256 or 512 of ``devices`` (RuntimeError when
    there are fewer)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        devices = [torch.device("meta")] * n
    devices = list(devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {len(devices)} were given; "
            "make_production_mesh(devices=None) describes it on the meta device")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(shape), axes)


def make_solver_mesh_from(mesh: Mesh) -> SolverMesh:
    """A 1-D "rows" solver mesh over the same devices, in grid order."""
    return SolverMesh(list(mesh.devices.flat))


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh: Mesh, spec, coords: dict, shape) -> tuple:
    """The slices of a global tensor of ``shape`` that the device at
    ``coords`` ({axis: index}) holds under ``spec`` (one entry per leading
    dim; a dim split over several axes is split row-major over them)."""
    index = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = entry_axes(entry)
        parts, at = 1, 0
        for a in axes:  # row-major over the entry's axes
            at = at * mesh.shape[a] + coords[a]
            parts *= mesh.shape[a]
        if dim % parts:
            raise ValueError(f"dim {dim} does not split {parts} ways over {axes}")
        size = dim // parts
        index.append(slice(at * size, (at + 1) * size))
    return tuple(index)


def shard_map(body: Callable, mesh: Mesh, in_specs: Sequence, out_specs: Sequence) -> Callable:
    """``jax.shard_map``'s counterpart for the port: the returned function
    slices each global input by its in-spec (a view where the shard's
    device holds the input), runs ``body(comm, *blocks)`` on one host
    thread per shard (``comm`` is its ``core.comm.ShardComm``:
    ``axis_index(name)``, and ``allreduce(t, axes=...).wait()`` for a
    ``psum``), and assembles each output from its out-spec: blocks along the axes it
    names, concatenated in coordinate order on the first input's device,
    and along the axes it does not name taken from coordinate 0 (those
    shards hold equal values, as JAX's replication check assumes). The
    region's collectives are added to ``mesh.counts`` and
    ``mesh.coll_bytes``.

    Each shard's thread runs under the caller's grad mode and the
    caller's ``TorchDispatchMode``s (both are thread-local), as the
    region would run inline: a forward region under ``torch.no_grad``
    records no graph, and a census (``launch.roofline.analyze_program``)
    counts every shard's ops."""
    names = mesh.axis_names
    solver = SolverMesh(list(mesh.devices.flat), axes=mesh.shape)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} in_specs")
        grad = torch.is_grad_enabled()
        modes = _get_current_dispatch_mode_stack()

        def shard_body(sc: ShardComm):
            with torch.set_grad_enabled(grad), contextlib.ExitStack() as stack:
                for mode in modes:
                    stack.enter_context(mode)
                coords = solver.coords(sc.rank)
                blocks = [a[block_index(mesh, spec, coords, a.shape)].to(sc.device)
                          for a, spec in zip(args, in_specs)]
                return body(sc, *blocks)

        # a census counting one device's share (launch/roofline) places the
        # inputs at their in-specs and counts the region at one shard's share
        census = [m for m in modes if hasattr(m, "enter_region")]
        for c in census:
            c.enter_region(mesh, args, in_specs)
        outs = None
        try:
            results, comm = solver.run(shard_body)
            mesh.counts.update(comm.counts)
            mesh.coll_bytes.update(comm.coll_bytes)
            home = args[0].device
            outs = []
            for i, spec in enumerate(out_specs):
                named = {a for e in spec for a in entry_axes(e)}
                parts = {}
                for rank, res in enumerate(results):
                    coords = solver.coords(rank)
                    if any(coords[a] for a in names if a not in named):
                        continue  # a replica along an axis the output does not name
                    parts[tuple(coords[a] for a in names)] = res[i]
                outs.append(_assemble(mesh, spec, parts, home))
        finally:
            for c in census:
                c.leave_region(mesh, outs, out_specs)
        return tuple(outs)

    return run


def _assemble(mesh: Mesh, spec, parts: dict, device) -> torch.Tensor:
    """The global tensor from the blocks of the shards in ``parts``
    ({coordinates: block}), each dim concatenated over its spec entry's
    axes in row-major order."""
    names = mesh.axis_names
    first = next(iter(parts.values()))
    out = torch.empty(
        tuple(s * math.prod(mesh.shape[a] for a in entry_axes(e))
              for s, e in zip(first.shape, tuple(spec) + (None,) * (first.dim() - len(spec)))),
        dtype=first.dtype, device=device)
    for key, block in parts.items():
        coords = dict(zip(names, key))
        out[block_index(mesh, spec, coords, out.shape)] = block.to(device)
    return out
