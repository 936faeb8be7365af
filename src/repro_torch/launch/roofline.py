"""Peak rates of the card the port runs on, the roofline terms, and the
census of a step program run on the ``meta`` device.

``HW`` holds the NVIDIA H100 SXM's data-sheet figures (dense rates, no
sparsity, at the full 700 W power limit; a card set below it runs slower
under load):

* ``peak_flops``     989e12 bf16 FLOP/s on the tensor cores;
* ``peak_f32_flops`` 67e12 float32 FLOP/s outside the tensor cores;
* ``hbm_bw``         3.35e12 B/s of HBM3;
* ``link_bw``        450e9 B/s a direction over NVLink 4 (900 GB/s both ways);
* ``host_link_bw``   64e9 B/s a direction over PCIe Gen5 x16, the link
                     a card-plus-host mesh (``core.comm``) crosses.

:func:`analyze_program` is the counterpart of the JAX package's
``analyze_hlo``, which parses the compiled program's HLO. The port has no
compiler between the program and the card: eager PyTorch runs each aten
op as its own kernel. So the census runs the real program on ``meta``
tensors under a ``TorchDispatchMode`` and counts what each aten op would
do:

* FLOPs: the matmul-class ops at 2 * |result| * contraction, by
  ``torch.utils.flop_counter``'s formulas, the count ``FlopCounterMode``
  gives (``analyze_hlo`` counts ``dot`` alike; elementwise FLOPs are left
  out in both);
* HBM bytes: each tensor input read once and each output written once,
  over every op that is not a view or an allocation. The op boundary is
  eager PyTorch's traffic model, as the fusion boundary is XLA's;
* the peak of live storages: each storage an op creates counts from its
  creation until its last reference goes; a view adds nothing (with
  placements, a storage cut finer by a later read is held at the finer
  block, but for an all-reduce's result, which XLA's CPU program keeps
  whole and slices: it forms no reduce-scatter);
* the collectives of the ``shard_map`` regions on a given mesh (counted
  by ``core.comm``): their count, and their wire bytes a device by
  ``analyze_hlo``'s ring factors (2 (n - 1) / n of the payload for an
  all-reduce over n devices).

Given the arguments' shardings, the census counts one device's share, as
JAX's figures are those of the SPMD-partitioned program: each tensor's
placement is propagated op by op (``launch/spmd.py``), every op is counted
at the block one device holds (FLOPs by the same formulas on the local
shapes, bytes and live storages at local sizes), and the collectives the
placements imply are counted beside the regions'. A ``shard_map`` region
is one device's share already: its ops count once a shard, at 1/n each.

A gradient takes its forward tensor's placement, as the partitioner gives
a cotangent its primal's sharding. The hook goes on the forward tensor
when an op on the home thread first reads it, after that op's rule: a
``TorchDispatchMode`` sees tensors below autograd, so an op's outputs have
no ``grad_fn`` yet when the census records them, but its inputs do. (A
``TorchFunctionMode`` would see the outputs, at a Python call for every
torch function and none for the aten ops a composite one runs; the
backward nodes' saved tensors miss every tensor autograd saves nothing
of.) Each tensor that autograd tracks and the placements cut gets one
tensor hook holding its placement, taken then: its storage may be freed
before the gradient comes. The gradient, when it comes, is reduced if it
is a partial sum, then takes that placement (``Propagator.constrain``: a
coarser gradient is cut by a local slice, and the matmul that made it is
recounted at the finer block) unless it is cut finer already (a cut that
a later read gave a view of the tensor, an einsum's heads, say, is not
the tensor's own). A replicated tensor gets no hook, nor does any read in
the backward (``torch._C._current_graph_task_id``), so the forward that
``torch.utils.checkpoint`` reruns there hooks nothing twice, and the hooks
keep the placements the first forward gave. Ops in a ``shard_map`` region
or on another thread take no hint. An argument's gradient takes the argument's
placement through a hook of :func:`analyze_program`'s own.

Loops need no trip-count fit: eager code runs every iteration.
"""
from __future__ import annotations

import math
import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .sharding import NamedSharding
from .spmd import _FACTORY, Placement, Propagator

__all__ = ["HW", "roofline_terms", "ProgramAnalysis", "analyze_program", "wire_bytes"]

HW = {
    "name": "NVIDIA H100 SXM",
    "peak_flops": 989e12,
    "peak_f32_flops": 67e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "host_link_bw": 64e9,
}


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float, wire_bytes_per_chip: float,
                   hw: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The three lower bounds of one step, in seconds: compute (FLOPs at
    the bf16 peak), memory (HBM bytes) and collective (wire bytes over
    ``link_bw``); ``dominant`` names the largest and ``bound_s`` is it."""
    hw = HW if hw is None else hw
    compute = flops_per_chip / hw["peak_flops"]
    memory = hbm_bytes_per_chip / hw["hbm_bw"]
    collective = wire_bytes_per_chip / hw["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = max(compute, memory, collective)
    return terms


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one device sends for one collective whose result holds
    ``result_bytes`` a device, over a group of ``group`` devices
    (``analyze_hlo``'s ring factors)."""
    if kind == "allreduce":
        return 2.0 * result_bytes * (group - 1) / max(group, 1)
    if kind in ("allgather", "alltoall"):
        return result_bytes * (group - 1) / max(group, 1)
    return float(result_bytes)  # a shift (collective-permute)


@dataclass
class ProgramAnalysis:
    flops: float = 0.0            # matmul-class: the whole program, or one device's share
    hbm_bytes: float = 0.0        # inputs + outputs of every op not a view or an allocation
    peak_live_bytes: float = 0    # the most bytes of storages the program created, alive at once
    wire_bytes: float = 0.0       # per device: the regions' collectives and the placements'
    coll_by_kind_bytes: Dict[str, float] = field(default_factory=dict)
    coll_by_kind_count: Dict[str, int] = field(default_factory=dict)
    region_counts: Dict[str, int] = field(default_factory=dict)  # the regions' own, by kind.tag
    region_wire_bytes: float = 0.0  # per device, the regions' collectives alone
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    ops_by_class: Dict[str, int] = field(default_factory=dict)
    n_ops: int = 0
    grad_hooks: int = 0           # forward tensors whose gradient took their placement
    devices: set = field(default_factory=set)  # device types the ops ran on


# ops that only allocate (no byte of the storage is read or written)
_ALLOC = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
          "aten.new_empty_strided", "aten.resize_"}
_COPY = {"aten.copy_", "aten._to_copy", "aten.clone", "aten.lift_fresh_copy"}
_INDEX = ("index", "gather", "scatter", "embedding", "sort", "topk", "searchsorted", "take",
          "masked")
_CIA = torch._C.DispatchKey.CompositeImplicitAutograd
_MM_FLOPS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"}
_SCATTER = {"aten.scatter", "aten.scatter_add"}


class _Op:
    """What the census needs of one aten overload, worked out once."""

    __slots__ = ("name", "flop_fn", "decomposes", "view", "mutable", "cls")

    def __init__(self, func):
        packet = func._overloadpacket
        self.name = str(packet)
        self.flop_fn = flop_registry.get(packet)
        # func.decompose's own test: a Python or C++ CompositeImplicitAutograd kernel
        self.decomposes = (func is not torch.ops.prim.device.default
                           and (_CIA in func.py_kernels
                                or torch._C._dispatch_has_kernel_for_dispatch_key(
                                    func.name(), _CIA)))
        self.view = func.is_view
        self.mutable = func._schema.is_mutable
        self.cls = ("matmul" if self.flop_fn else "alloc" if self.name in _ALLOC
                    else "copy" if self.name in _COPY
                    else "index" if any(s in self.name for s in _INDEX) else None)


_OPS: Dict[object, _Op] = {}


def _tensors(x, acc: list) -> list:
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, acc)
    return acc


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Census(TorchDispatchMode):
    """Counts every aten op run under it (see the module docstring). The
    counters take a lock: ``shard_map`` regions run it on one thread a
    shard. With a :class:`~.spmd.Propagator` it counts one device's share:
    ops on the thread that entered it at their local blocks, ops of a
    ``shard_map`` region (another thread, or the region's own assembly) at
    1/n of each shard's."""

    def __init__(self, spmd: Optional[Propagator] = None):
        super().__init__()
        self.out = ProgramAnalysis()
        self.spmd = spmd
        self._lock = threading.RLock()  # a storage may die (and _free run) inside
        self._live: Dict[int, float] = {}  # storage -> bytes, created under the census
        self._refs: Dict[int, weakref.ref] = {}
        self._now = 0
        self._by_op: Counter = Counter()
        self._by_class: Counter = Counter()
        self._home = threading.get_ident()
        self._region_depth = 0   # > 0 while the home thread runs a shard_map region
        self._region_size = 1
        # a factory's storage (zeros, empty, ...) counts from its first reader,
        # at the cut the placements give it by then (as XLA materializes it)
        self._pending: Dict[int, int] = {}
        self._hooked: Dict[int, weakref.ref] = {}  # forward tensors whose gradient is hooked
        if spmd is not None:
            spmd.on_refine = self._shrink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _OPS.get(func)
        if op is None:
            op = _OPS[func] = _Op(func)
        # FlopCounterMode's order: an op that decomposes is counted as its parts
        if op.decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self._record(op, func, args, kwargs, out)
        return out

    # -- the hooks of launch/mesh.shard_map and models/common.shard_hint --
    def _propagating(self) -> bool:
        return (self.spmd is not None and self._region_depth == 0
                and threading.get_ident() == self._home)

    def placement_hint(self, t: torch.Tensor, sharding) -> None:
        if self._propagating():
            with self._lock:
                self.spmd.hint(t, sharding)

    def _grad_hint(self, t: torch.Tensor, pl) -> None:
        if self._propagating():
            with self._lock:
                self.spmd.constrain(t, pl)

    def _forward_hint(self, g: torch.Tensor, want) -> None:
        """A forward tensor's gradient ``g`` arrived: a partial sum is
        reduced, then ``g`` takes the tensor's placement ``want`` unless it
        is cut finer already."""
        if self._propagating():
            with self._lock:
                sp = self.spmd
                if not want.finer(sp.reduce(g, sp.get(g))):
                    sp.constrain(g, want)

    def _hook_grads(self, ins) -> None:
        """Hook the gradient of each input the forward made that autograd
        tracks and the placements cut, once a tensor, with its placement
        after this op read it (see the module docstring)."""
        if not torch.is_grad_enabled() or torch._C._current_graph_task_id() != -1:
            return  # no graph, the backward, or the forward remat reruns in it
        sp = self.spmd
        for t in ins:
            if not t.requires_grad or t.is_leaf or id(t) in self._hooked:
                continue  # no gradient, a leaf (an argument's own hook), or hooked
            pl = sp.get(t)
            if pl.used():  # a replicated tensor's gradient needs no hint
                self._hooked[id(t)] = weakref.ref(t, lambda _, i=id(t): self._hooked.pop(i, None))
                self.out.grad_hooks += 1
                t.register_hook(lambda g, want=Placement(pl.dims): self._forward_hint(g, want))

    def enter_region(self, mesh, args, in_specs) -> None:
        if self._propagating() and mesh.shape == self.spmd.layout.mesh.shape:
            with self._lock:
                for a, spec in zip(args, in_specs):
                    self.spmd.constrain(a, self.spmd.layout.placement(
                        NamedSharding(mesh, spec), a.shape))
        if threading.get_ident() == self._home:
            self._region_depth += 1
            self._region_size = mesh.size

    def leave_region(self, mesh, outs, out_specs) -> None:
        if threading.get_ident() != self._home:
            return
        self._region_depth -= 1
        if self._propagating() and outs is not None \
                and mesh.shape == self.spmd.layout.mesh.shape:
            with self._lock:
                for o, spec in zip(outs, out_specs):
                    self.spmd.place(o, NamedSharding(mesh, spec))

    # -- counting -------------------------------------------------------
    def _record(self, op: _Op, func, args, kwargs, out) -> None:
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        in_list = [_key(t) for t in ins]
        in_keys = set(in_list)
        out_keys = [_key(t) for t in outs]
        cls, is_view = op.cls, False
        if op.view or (not op.mutable and outs and all(k in in_keys for k in out_keys)):
            cls, is_view = "view", True
        weight = 1.0
        local = None  # (read placements, output placements) on one device
        if self.spmd is not None:
            if self._propagating():
                with self._lock:
                    local = self.spmd.rule(op.name, func, args, kwargs, ins, outs)
                    self._hook_grads(ins)
            else:
                weight = 1.0 / self._region_size if self._region_size > 1 else 1.0
        if local is None:
            flops = op.flop_fn(*args, **kwargs, out_val=out) if op.flop_fn else 0
            out_b = [_nbytes(t) for t in outs]
            in_b = [_nbytes(t) for t in ins] if not is_view else ()
        else:
            read, placed = local
            sp = self.spmd
            out_b = [sp.local_bytes(t, p) for t, p in zip(outs, placed)]
            in_b = [sp.local_bytes(t, p) for t, p in zip(ins, read)] if not is_view else ()
            flops = self._local_flops(op, args, kwargs, out, ins, read, outs, placed) \
                if op.flop_fn else 0
        moved = 0
        if not is_view and cls != "alloc":
            moved = sum(in_b) + sum(out_b)
            if cls is None:
                cls = ("reduction" if ins and outs and
                       max(t.numel() for t in outs) < max(t.numel() for t in ins)
                       else "elementwise")
        if weight != 1.0:
            flops, moved = flops * weight, moved * weight
        with self._lock:
            # a scatter into a fresh factory's tensor stays unmaterialized too
            lazy = (local is not None and op.name in _SCATTER and bool(ins)
                    and in_list[0] in self._pending)
            if local is not None and self._pending:
                for i, (t, k) in enumerate(zip(ins, in_list)):
                    if k in self._pending and not (lazy and i == 0):
                        nb = self._pending.pop(k) * self.spmd.local_numel(t, self.spmd.get(t)) \
                            / max(t.numel(), 1)
                        self._live[k] = nb
                        self._now += nb
                        self.out.peak_live_bytes = max(self.out.peak_live_bytes, self._now)
            if local is not None:
                for t, p in zip(outs, placed):
                    if p.origin is None and op.flop_fn and len(outs) == 1:
                        p.origin = {"flops": flops, "out_bytes": out_b[0],
                                    "cut": frozenset(p.used() | p.partial)}
                    self.spmd.set(t, p)
            o = self.out
            o.n_ops += 1
            o.flops += flops
            o.hbm_bytes += moved
            for t in outs or ins:
                o.devices.add(t.device.type)
            self._by_class[cls] += 1
            if moved:
                self._by_op[op.name] += moved
            for t, k, b in zip(outs, out_keys, out_b):
                if k in in_keys or k in self._live:
                    continue  # written in place, or a second view of a new storage
                st = t.untyped_storage()
                nb = st.nbytes()
                self._refs[k] = weakref.ref(st, lambda _, k=k: self._free(k))
                if local is not None and (lazy or op.name in _FACTORY):
                    self._pending[k] = nb
                    continue
                if local is not None and (n := _nbytes(t)) and b != n:
                    nb = nb * b / n  # the storage at the output's local share
                if weight != 1.0:
                    nb = nb * weight
                self._live[k] = nb
                self._now += nb
                o.peak_live_bytes = max(o.peak_live_bytes, self._now)

    def _local_flops(self, op, args, kwargs, out, ins, read, outs, placed) -> float:
        """The op's FLOPs on the blocks one device holds (the formula of
        ``flop_registry`` on meta tensors of the local shapes)."""
        sp = self.spmd
        if op.name in _MM_FLOPS:  # flop_registry's formula: 2 * out * contraction
            (a, b) = [sp.local_shape(t, p) for t, p in zip(ins, read)][-2:]
            return 2 * math.prod(a) * b[-1]
        swap = {}
        for t, p in zip(ins + outs, read + placed):
            shape = sp.local_shape(t, p)
            if shape != tuple(t.shape):
                swap[id(t)] = torch.empty(shape, dtype=t.dtype, device="meta")
        if not swap:
            return op.flop_fn(*args, **kwargs, out_val=out)

        def sub(x):
            if isinstance(x, torch.Tensor):
                return swap.get(id(x), x)
            if isinstance(x, (list, tuple)):
                return type(x)(sub(y) for y in x)
            return x

        return op.flop_fn(*sub(list(args)), **{k: sub(v) for k, v in kwargs.items()},
                          out_val=sub(out))

    def _shrink(self, t: torch.Tensor, factor: int) -> None:
        """``t`` was cut ``factor`` times finer: a storage it spans whole
        is held at the finer block (XLA materializes the value so)."""
        k = _key(t)
        if k in self._live and _nbytes(t) == t.untyped_storage().nbytes():
            cut = self._live[k] * (1 - 1 / factor)
            self._live[k] -= cut
            self._now -= cut

    def _free(self, k: int) -> None:
        with self._lock:
            self._refs.pop(k, None)
            self._pending.pop(k, None)
            self._now -= self._live.pop(k, 0)
            if self.spmd is not None:
                self.spmd.forget(k)

    def result(self) -> ProgramAnalysis:
        with self._lock:
            self.out.bytes_by_op = dict(self._by_op)
            self.out.ops_by_class = dict(self._by_class)
            if self.spmd is not None:
                self.out.flops -= self.spmd.flops_refund
                self.out.hbm_bytes -= self.spmd.bytes_refund
        return self.out


def _add_collectives(out: ProgramAnalysis, counts: Counter, coll_bytes: Counter) -> None:
    for kind in ("allreduce", "allgather", "alltoall", "shift"):
        if counts[kind]:
            out.coll_by_kind_count[kind] = out.coll_by_kind_count.get(kind, 0) + counts[kind]
    for (kind, group), b in coll_bytes.items():
        w = wire_bytes(kind, b, group)
        out.coll_by_kind_bytes[kind] = out.coll_by_kind_bytes.get(kind, 0.0) + w
        out.wire_bytes += w


def analyze_program(fn: Callable, *args, mesh=None, shardings=None, **kwargs) -> ProgramAnalysis:
    """Run ``fn(*args, **kwargs)`` under the census and return what it
    counted (see the module docstring). Give it ``meta`` tensors to count
    a program without running it; on real tensors it runs the program and
    counts the same. ``mesh`` (a ``launch.mesh.Mesh``) adds the
    collectives its ``shard_map`` regions ran during the call.

    ``shardings``, [(tensor, NamedSharding)] of the program's arguments
    on ``mesh``, makes every figure one device's share (the module
    docstring); the gradient of an argument that requires grad takes the
    argument's placement, and that of a forward tensor its own. On a mesh
    of one device every figure is the global count."""
    before_n = Counter(mesh.counts) if mesh is not None else Counter()
    before_b = Counter(mesh.coll_bytes) if mesh is not None else Counter()
    spmd = None
    hooks = []
    if shardings is not None and mesh is None:
        raise ValueError("shardings need the mesh they place the arguments on")
    if shardings is not None and mesh.size > 1:  # one device holds every tensor whole
        spmd = Propagator(mesh)
    census = _Census(spmd)
    if spmd is not None:
        for t, sh in shardings:
            pl = spmd.fix(t, sh)
            if t.requires_grad and t.is_leaf:
                hooks.append(t.register_hook(
                    lambda g, pl=pl: census._grad_hint(g, pl)))
    try:
        with census:
            fn(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    out = census.result()
    if mesh is not None:
        regions = Counter(mesh.counts) - before_n
        _add_collectives(out, regions, Counter(mesh.coll_bytes) - before_b)
        out.region_counts = dict(regions)
        out.region_wire_bytes = out.wire_bytes
    if spmd is not None:
        _add_collectives(out, spmd.counts, spmd.coll_bytes)
    return out
