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
  creation until its last reference goes; a view adds nothing;
* the collectives of the ``shard_map`` regions on a given mesh (counted
  by ``core.comm``): their count, and their wire bytes a device by
  ``analyze_hlo``'s ring factors (2 (n - 1) / n of the payload for an
  all-reduce over n devices).

Loops need no trip-count fit: eager code runs every iteration.
"""
from __future__ import annotations

import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

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
    if kind == "allgather":
        return result_bytes * (group - 1) / max(group, 1)
    return float(result_bytes)  # a shift (collective-permute)


@dataclass
class ProgramAnalysis:
    flops: float = 0.0            # matmul-class, the whole program (every shard's)
    hbm_bytes: float = 0.0        # inputs + outputs of every op not a view or an allocation
    peak_live_bytes: int = 0      # the most bytes of storages the program created, alive at once
    wire_bytes: float = 0.0       # per device, the shard_map regions' collectives
    coll_by_kind_bytes: Dict[str, float] = field(default_factory=dict)
    coll_by_kind_count: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    ops_by_class: Dict[str, int] = field(default_factory=dict)
    n_ops: int = 0
    devices: set = field(default_factory=set)  # device types the ops ran on


# ops that only allocate (no byte of the storage is read or written)
_ALLOC = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
          "aten.new_empty_strided", "aten.resize_"}
_COPY = {"aten.copy_", "aten._to_copy", "aten.clone", "aten.lift_fresh_copy"}
_INDEX = ("index", "gather", "scatter", "embedding", "sort", "topk", "searchsorted", "take",
          "masked")
_CIA = torch._C.DispatchKey.CompositeImplicitAutograd


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
    shard."""

    def __init__(self):
        super().__init__()
        self.out = ProgramAnalysis()
        self._lock = threading.RLock()  # a storage may die (and _free run) inside
        self._live: Dict[int, int] = {}   # storage -> bytes, created under the census
        self._refs: Dict[int, weakref.ref] = {}
        self._now = 0
        self._by_op: Counter = Counter()
        self._by_class: Counter = Counter()

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
        self._record(op, args, kwargs, out)
        return out

    def _record(self, op: _Op, args, kwargs, out) -> None:
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        in_keys = {_key(t) for t in ins}
        out_keys = [_key(t) for t in outs]
        flops = op.flop_fn(*args, **kwargs, out_val=out) if op.flop_fn else 0
        cls, moved = op.cls, 0
        if op.view or (not op.mutable and outs and all(k in in_keys for k in out_keys)):
            cls = "view"
        elif cls != "alloc":
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            if cls is None:
                cls = ("reduction" if ins and outs and
                       max(t.numel() for t in outs) < max(t.numel() for t in ins)
                       else "elementwise")
        with self._lock:
            o = self.out
            o.n_ops += 1
            o.flops += flops
            o.hbm_bytes += moved
            for t in outs or ins:
                o.devices.add(t.device.type)
            self._by_class[cls] += 1
            if moved:
                self._by_op[op.name] += moved
            for t, k in zip(outs, out_keys):
                if k in in_keys or k in self._live:
                    continue  # written in place, or a second view of a new storage
                st = t.untyped_storage()
                self._live[k] = st.nbytes()
                self._refs[k] = weakref.ref(st, lambda _, k=k: self._free(k))
                self._now += self._live[k]
                o.peak_live_bytes = max(o.peak_live_bytes, self._now)

    def _free(self, k: int) -> None:
        with self._lock:
            self._refs.pop(k, None)
            self._now -= self._live.pop(k, 0)

    def result(self) -> ProgramAnalysis:
        with self._lock:
            self.out.bytes_by_op = dict(self._by_op)
            self.out.ops_by_class = dict(self._by_class)
        return self.out


def analyze_program(fn: Callable, *args, mesh=None, **kwargs) -> ProgramAnalysis:
    """Run ``fn(*args, **kwargs)`` under the census and return what it
    counted (see the module docstring). Give it ``meta`` tensors to count
    a program without running it; on real tensors it runs the program and
    counts the same. ``mesh`` (a ``launch.mesh.Mesh``) adds the
    collectives its ``shard_map`` regions ran during the call."""
    before_n = Counter(mesh.counts) if mesh is not None else Counter()
    before_b = Counter(mesh.coll_bytes) if mesh is not None else Counter()
    census = _Census()
    with census:
        fn(*args, **kwargs)
    out = census.result()
    if mesh is not None:
        for kind in ("allreduce", "allgather", "shift"):
            n = mesh.counts[kind] - before_n[kind]
            if n:
                out.coll_by_kind_count[kind] = n
        for (kind, group), b in (Counter(mesh.coll_bytes) - before_b).items():
            w = wire_bytes(kind, b, group)
            out.coll_by_kind_bytes[kind] = out.coll_by_kind_bytes.get(kind, 0.0) + w
            out.wire_bytes += w
    return out
