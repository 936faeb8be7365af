"""Placements of tensors on a named mesh, propagated one aten op at a time:
the dry run's counterpart of the SPMD partitioner that JAX runs before it
compiles a sharded program.

A placement says how one device's block of a tensor is cut from the
global tensor. Each mesh axis is split into its prime factors (a 2 x 4
("data", "model") mesh has the factors data, model.0 and model.1; an
axis of 16 has four), and a placement gives, for every dim of the
tensor, the factors that split it, major first, plus the factors over
which the tensor is an unreduced sum (``partial``). Factors, not whole
axes, are what the partitioner tiles by: a dim of 384 split four ways
over "model" that is reshaped to (6, 64) keeps the 2-way major factor on
the 6 heads, and the minor factor is gathered, as XLA does.

:class:`Propagator` keeps a placement for every tensor the census sees,
keyed by storage and view geometry (a tensor that autograd saves and
unpacks is the same block). Placements enter from three places:

* arguments: the ``NamedSharding`` of each parameter, optimizer moment,
  batch input and cache leaf;
* hints: ``models.common.shard_hint`` hands the rules' sharding to
  :meth:`Propagator.hint`, JAX's ``with_sharding_constraint``; the
  gradient of an argument that requires grad, or of a tensor the forward
  made and the placements cut, takes that tensor's placement, as the
  partitioner gives a cotangent its primal's sharding (the census's
  hooks, ``launch/roofline.py``);
* the rule table of :meth:`Propagator.rule`, one aten op at a time:
  pointwise ops with broadcasting; ``mm``/``bmm``/``addmm``/``baddbmm``
  (a contraction over a sharded dim gives a partial sum); reductions (a
  sum over a sharded dim stays partial, a max is all-reduced at once);
  views and copies (a sharded dim carries through a reshape where its
  factors still cut whole rows, else its minor factors are gathered);
  softmax, log-softmax and layer norm (their dim is gathered first);
  ``embedding``, ``index_select`` and ``gather`` (a lookup into a dim
  sharded over factors gives a partial sum over them, as a masked lookup
  does); advanced indexing, MoE routing's (``index``: the rows keep the
  index's cut, an operand cut on an indexed dim is gathered or looked up
  masked, whichever moves fewer bytes; ``index_put``: a write into a
  fresh zero buffer stays local where the index is and leaves a partial
  sum); ``copy_`` into a buffer the program made (it
  takes the source's cut); factories (replicated). Any other op has its
  inputs gathered to replicated and its outputs replicated.

A reshard counts the collective it takes, at the bytes of one device's
block, into ``counts`` and ``coll_bytes`` (the keys of a ``Mesh``'s
counters): an all-reduce for a partial sum that an op must read whole,
an all-gather for factors taken off, an all-to-all for a factor that
moves from one dim to another, a collective-permute (``shift``) where a
slice or concatenation of a cut dim moves edges between neighbours.
Adding a factor is a local slice and costs nothing, and the tensor keeps
the finer placement, as a partitioner gives each value the tiling its
users want; when that tensor is the output of a matmul, the matmul is
counted again at the finer block.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh, entry_axes

__all__ = ["Layout", "Placement", "Propagator"]


def _primes(n: int) -> List[int]:
    out, p = [], 2
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out


def _canon(entry) -> tuple:
    """A dim's (factor, block) pairs, coarsest block first."""
    if len(entry) < 2:
        return tuple(entry)
    return tuple(sorted(set(entry), key=_order))


def _order(e):
    return -e[1], e[0]


_NONE = frozenset()


def _factors(entry) -> set:
    return {f for f, _ in entry}


class Layout:
    """A mesh cut into prime factors: ``sizes[f]`` of factor ``f``, and
    ``of_axis[name]``, an axis's factors major first."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.sizes: List[int] = []
        self.of_axis: Dict[str, Tuple[int, ...]] = {}
        self._esize: Dict[tuple, int] = {}
        for name, n in mesh.shape.items():
            ids = []
            for p in _primes(n):
                ids.append(len(self.sizes))
                self.sizes.append(p)
            self.of_axis[name] = tuple(ids)

    def size(self, factors) -> int:
        return math.prod(self.sizes[f] for f in factors)

    def esize(self, entry) -> int:
        if not entry:
            return 1
        n = self._esize.get(entry)
        if n is None:
            n = self._esize[entry] = math.prod(self.sizes[f] for f, _ in entry)
        return n

    def tile(self, n: int, factors) -> tuple:
        """A dim of ``n`` cut into contiguous blocks by ``factors``, major
        first (the tiling of a ``NamedSharding``)."""
        out, blk = [], n
        for f in factors:
            blk //= self.sizes[f]
            out.append((f, blk))
        return tuple(out)

    def placement(self, sharding, shape) -> "Placement":
        """The placement of a ``NamedSharding`` on this mesh."""
        spec = tuple(sharding.spec) + (None,) * max(len(shape) - len(sharding.spec), 0)
        return Placement(tuple(
            self.tile(n, [f for a in entry_axes(spec[i]) for f in self.of_axis[a]])
            for i, n in enumerate(shape)))


class Placement:
    """Per dim, the (factor, block) pairs that cut it: factor ``f`` gives
    a device its coordinate ``(i // block) % size(f)`` along the dim's
    index ``i`` (a plain tiling has blocks n / s1, n / (s1 s2), ...; a dim
    merged from sharded dims keeps each factor's stride). ``partial``: the
    factors over which the value is an unreduced sum; ``origin``: the
    record of the matmul this tensor is the direct output of (see
    :meth:`Propagator.refine`); ``parts``: {dim: the sizes of the dims a
    reshape merged into it, major first}, for a batched matmul's batch
    dim (see :meth:`Propagator._matmul`)."""

    __slots__ = ("dims", "partial", "origin", "parts")

    def __init__(self, dims, partial=frozenset(), origin=None, parts=None):
        self.dims = tuple(dims)  # each entry canonical (``_canon``)
        self.partial = partial if type(partial) is frozenset else frozenset(partial)
        self.origin = origin
        self.parts = parts

    @staticmethod
    def replicated(ndim: int) -> "Placement":
        return Placement(((),) * ndim, _NONE)

    def used(self) -> set:
        return {f for d in self.dims for f, _ in d}

    def same(self, other: "Placement") -> bool:
        return self.dims == other.dims and self.partial == other.partial

    def finer(self, other: "Placement") -> bool:
        """``other``'s dims are this one's cut further along factors this
        one leaves whole (a local slice; a partial sum stays partial)."""
        if len(self.dims) != len(other.dims):
            return False
        if not all(set(h) <= set(w) for h, w in zip(self.dims, other.dims)):
            return False
        added = [f for h, w in zip(self.dims, other.dims) for f, _ in set(w) - set(h)]
        return not (set(added) & (self.used() | self.partial))

    def __repr__(self) -> str:
        return f"Placement({self.dims}, partial={sorted(self.partial)})"


def _adjacent(indices) -> bool:
    """An advanced index of integer tensors on adjacent dims (the output
    takes the index's dims where the indexed dims were)."""
    at = [i for i, t in enumerate(indices) if t is not None]
    return (bool(at) and at == list(range(at[0], at[-1] + 1))
            and all(indices[i].dtype not in (torch.bool, torch.uint8) for i in at))


def _key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape), t.stride(), t.dtype)


def _dims(d, ndim: int) -> List[int]:
    """Normalised dim list of a reduction argument (None: every dim)."""
    if d is None:
        return list(range(ndim))
    if isinstance(d, int):
        d = [d]
    return sorted({x % ndim for x in d}) if ndim else []


def _reshape_groups(old: Sequence[int], new: Sequence[int]):
    """Pair the dims of two shapes of equal size into groups of equal
    products: [(old dims, new dims)]; a size-1 dim forms no group."""
    oi = [i for i, s in enumerate(old) if s != 1]
    ni = [j for j, s in enumerate(new) if s != 1]
    groups, a, b = [], 0, 0
    while a < len(oi) and b < len(ni):
        go, gn = [oi[a]], [ni[b]]
        po, pn = old[oi[a]], new[ni[b]]
        while po != pn:
            if po < pn:
                a += 1
                go.append(oi[a])
                po *= old[oi[a]]
            else:
                b += 1
                gn.append(ni[b])
                pn *= new[ni[b]]
        groups.append((go, gn))
        a += 1
        b += 1
    return groups


# pointwise ops that are linear in every tensor input: a partial sum passes through
_LINEAR = {"aten.add", "aten.sub", "aten.neg", "aten._to_copy", "aten.clone", "aten.alias",
           "aten.detach", "aten.lift_fresh", "aten.copy_", "aten.copy"}
# linear in one tensor input when every other is whole (a scale)
_SCALE = {"aten.mul", "aten.div"}
_MATMUL = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"}
# reduction: (index of the dim argument, index of keepdim, linear)
_REDUCE = {"aten.sum": (1, 2, True), "aten.mean": (1, 2, True), "aten.amax": (1, 2, False),
           "aten.amin": (1, 2, False), "aten.max": (1, 2, False), "aten.min": (1, 2, False),
           "aten.prod": (1, 2, False), "aten.any": (1, 2, False), "aten.all": (1, 2, False),
           "aten.argmax": (1, 2, False), "aten.argmin": (1, 2, False),
           "aten.logsumexp": (1, 2, False), "aten.linalg_vector_norm": (2, 3, False),
           "aten.var": (1, 3, False), "aten.std": (1, 3, False),
           "aten.var_mean": (1, 3, False)}
# the dims an op needs whole: (index of the dim argument)
_WHOLE_DIM = {"aten._softmax": 1, "aten._log_softmax": 1, "aten._softmax_backward_data": 2,
              "aten._log_softmax_backward_data": 2, "aten.cumsum": 1, "aten.sort": 1,
              "aten.topk": 2, "aten.flip": 1}
# ops whose output is cut as their input is
_SAME = {"aten.alias", "aten.detach", "aten.lift_fresh", "aten.clone", "aten._to_copy",
         "aten.copy", "aten.fill", "aten.zero"}
_RESHAPE = {"aten.view", "aten._unsafe_view", "aten._reshape_alias", "aten.reshape",
            "aten.unsqueeze", "aten.squeeze", "aten.flatten", "aten.unflatten",
            "aten.view_copy", "aten._unsafe_view_copy"}
_SPLIT = {"aten.split", "aten.split_with_sizes", "aten.unbind", "aten.chunk",
          "aten.unsafe_split", "aten.split_with_sizes_copy"}
_POINTWISE = {"aten.where", "aten.copy_", "aten.masked_fill", "aten.lerp", "aten.fill_",
              "aten.floor_divide", "aten.tril", "aten.triu", "aten.log_sigmoid_forward",
              "aten.log_sigmoid_backward", "aten.softplus_backward"}
_FACTORY = {"aten.empty", "aten.empty_strided", "aten.zeros", "aten.ones", "aten.full",
            "aten.arange", "aten.scalar_tensor", "aten.rand", "aten.randn", "aten.randint",
            "aten.eye", "aten.linspace", "aten.new_empty", "aten.new_zeros", "aten.new_ones",
            "aten.new_full", "aten.new_empty_strided", "aten.tensor", "aten.lift_fresh_copy",
            "aten._local_scalar_dense"}
_ZEROS = {"aten.zeros", "aten.new_zeros", "aten.zeros_like"}
_INDEX_PUT = {"aten.index_put", "aten.index_put_", "aten._index_put_impl_",
              "aten._unsafe_index_put"}
_LIKE = {"aten.empty_like", "aten.zeros_like", "aten.ones_like", "aten.full_like",
         "aten.rand_like", "aten.randn_like"}


class Propagator:
    """The placement of every tensor an op run under the census touches,
    and the collectives that keep the placements consistent (see the
    module docstring). ``counts``/``coll_bytes`` have the keys of a
    ``Mesh``'s counters."""

    def __init__(self, mesh: Mesh):
        self.layout = Layout(mesh)
        self._pl: Dict[int, Dict[tuple, Placement]] = {}  # storage -> geometry -> placement
        self.counts: Counter = Counter()
        self.coll_bytes: Counter = Counter()
        self._fixed: set = set()  # the arguments' keys
        self._fixed_storage: set = set()
        self._plans: Dict[tuple, tuple] = {}  # reshape plans, by shapes and placement
        self._numel: Dict[tuple, int] = {}
        self.on_refine = None  # on_refine(t, factor): the census shrinks t's storage
        self.flops_refund = 0.0  # FLOPs of matmuls recounted at a finer block
        self.bytes_refund = 0.0
        self._zeros: Dict[int, set] = {}  # storage -> geometries of unwritten zero factories
        self._reduced: set = set()  # storages an all-reduce wrote whole

    # -- the store ------------------------------------------------------
    def get(self, t: torch.Tensor) -> Placement:
        k = _key(t)
        pl = self._pl.get(k[0], {}).get(k[1:])
        return pl if pl is not None else Placement.replicated(t.dim())

    def set(self, t: torch.Tensor, pl: Placement) -> None:
        k = _key(t)
        if k not in self._fixed:
            self._pl.setdefault(k[0], {})[k[1:]] = pl

    def fix(self, t: torch.Tensor, sharding) -> Placement:
        """Place an argument: its placement is the caller's and stays (an
        op that reads it cut otherwise reshards a copy)."""
        pl = self.layout.placement(sharding, t.shape)
        k = _key(t)
        self._pl.setdefault(k[0], {})[k[1:]] = pl
        self._fixed.add(k)
        self._fixed_storage.add(k[0])
        return pl

    def forget(self, storage: int) -> None:
        self._pl.pop(storage, None)
        self._zeros.pop(storage, None)
        self._reduced.discard(storage)

    def _fresh(self, t: torch.Tensor) -> bool:
        """``t`` is a zero factory's output nothing has written into yet."""
        k = _key(t)
        return k[1:] in self._zeros.get(k[0], ())

    def _written(self, t: torch.Tensor) -> None:
        k = _key(t)
        geoms = self._zeros.get(k[0])
        if geoms is not None:
            geoms.discard(k[1:])
            if not geoms:
                del self._zeros[k[0]]

    def place(self, t: torch.Tensor, sharding) -> None:
        """Give ``t`` a sharding's placement (a ``shard_map`` output its
        out-spec's)."""
        self.set(t, self.layout.placement(sharding, t.shape))

    # -- sizes and collectives -----------------------------------------
    def local_shape(self, t, pl: Placement) -> Tuple[int, ...]:
        es = self.layout.esize
        return tuple(-(-s // es(d)) if d else s for s, d in zip(t.shape, pl.dims))

    def local_numel(self, t, pl: Placement) -> int:
        if not any(pl.dims):
            return t.numel()
        key = (tuple(t.shape), pl.dims)
        n = self._numel.get(key)
        if n is None:
            n = self._numel[key] = math.prod(self.local_shape(t, pl))
        return n

    def local_bytes(self, t, pl: Placement) -> int:
        return self.local_numel(t, pl) * t.element_size()

    def _coll(self, kind: str, t, pl: Placement, factors) -> None:
        group = self.layout.size(set(factors))
        if group > 1:
            self.counts[kind] += 1
            self.coll_bytes[(kind, group)] += self.local_bytes(t, pl)

    def reduce(self, t, pl: Placement) -> Placement:
        """``pl`` summed over its partial factors (an all-reduce, once: the
        tensor keeps the sum)."""
        if not pl.partial:
            return pl
        out = Placement(pl.dims)
        self._coll("allreduce", t, out, pl.partial)
        self.set(t, out)
        self._reduced.add(_key(t)[0])
        return out

    def reshard(self, t, pl: Placement, target: Placement) -> Placement:
        """Move ``t`` from ``pl`` to ``target``, counting the collectives:
        an all-reduce of a partial sum ``target`` does not keep, an
        all-gather of the factors taken off, an all-to-all of those that
        move to another dim or block (adding one is a local slice)."""
        if pl.partial and pl.partial != target.partial:
            pl = self.reduce(t, pl)
        if pl.dims == target.dims:
            return Placement(target.dims, pl.partial, pl.origin)
        gathered, moved = self._moves(pl, target)
        if gathered:  # all-gather: the block after the gather
            mid = Placement(tuple(tuple(e for e in d if e[0] not in gathered) for d in pl.dims))
            self._coll("allgather", t, mid, gathered)
        if moved:
            self._coll("alltoall", t, target, moved)
        return Placement(target.dims, pl.partial)

    @staticmethod
    def _moves(pl: Placement, target: Placement):
        """(the factors ``pl`` has and ``target`` does not: gathered; those
        ``target`` has on another dim or block: moved)."""
        have = [(i, e) for i, d in enumerate(pl.dims) for e in d]
        want = {(i, e) for i, d in enumerate(target.dims) for e in d}
        gone = {e[0] for i, e in have if (i, e) not in want}
        kept = {e[0] for i, e in have if (i, e) in want}
        moved = gone & ({e[0] for i, e in want} - kept)
        return gone - moved, moved

    def without(self, pl: Placement, factors) -> Placement:
        return Placement(tuple(tuple(e for e in d if e[0] not in factors) for d in pl.dims),
                         pl.partial)

    # -- hints and finer tilings ---------------------------------------
    def constrain(self, t: torch.Tensor, target: Placement) -> None:
        """Reshard ``t`` to ``target`` in place (a hint)."""
        pl = self.get(t)
        if pl.same(target):
            return
        if pl.finer(target):
            self.refine(t, pl, target)
            return
        self.set(t, self.reshard(t, pl, target))

    def hint(self, t: torch.Tensor, sharding) -> None:
        if sharding.mesh.shape != self.layout.mesh.shape:
            return
        self.constrain(t, self.layout.placement(sharding, t.shape))

    def refine(self, t: torch.Tensor, pl: Placement, target: Placement) -> Placement:
        """``t`` cut finer (a local slice): it keeps ``target``. When ``t``
        is a matmul's output or a reshape or permutation of it, the matmul
        is recounted at the finer block (the added factors were whole in
        both its operands), once for each factor however many views of the
        output are cut by it. The census holds ``t``'s storage at the finer
        block, but for an all-reduce's result, which stays whole (XLA's
        CPU program slices the sum; it forms no reduce-scatter)."""
        new = Placement(target.dims, pl.partial)
        added = {f for h, w in zip(pl.dims, target.dims) for f, _ in set(w) - set(h)}
        extra = self.layout.size(added)
        rec = pl.origin
        once = self.layout.size(added - rec["cut"]) if rec is not None else 1
        if rec is not None and once > 1:
            rec["cut"] = rec["cut"] | added  # another view of the output may be cut alike
            cut = rec["flops"] * (1 - 1 / once)
            cut_b = rec["out_bytes"] * (1 - 1 / once)
            rec["flops"] -= cut
            rec["out_bytes"] -= cut_b
            self.flops_refund += cut
            self.bytes_refund += cut_b
        new.origin = rec
        if extra > 1 and self.on_refine is not None and _key(t)[0] not in self._reduced:
            self.on_refine(t, extra)
        self.set(t, new)
        return new

    def _read(self, t, pl, target, *, keep=True) -> Placement:
        """Bring input ``t`` from ``pl`` to ``target``: a finer cut is kept
        on the tensor (:meth:`refine`), anything else is a reshard (kept
        too when ``keep``: the value has one placement, as in XLA)."""
        if pl.partial and pl.partial != target.partial:
            pl = self.reduce(t, pl)
        if pl.same(target):
            return pl
        if pl.finer(target):
            return self.refine(t, pl, target) if keep else target
        out = self.reshard(t, pl, target)
        if keep:
            self.set(t, out)
        return out

    def _fit(self, t, dims) -> Placement:
        """``dims`` (an output's, aligned to the right) as seen by an input
        ``t`` that broadcasts into it."""
        off = len(dims) - t.dim()
        return Placement(tuple(() if t.shape[i] == 1 else dims[i + off]
                               for i in range(t.dim())))

    def _join(self, shape, cands) -> Tuple[tuple, ...]:
        """The finest placement of an output of ``shape`` that the
        candidates (dims aligned to the right, first wins) agree on: each
        factor on one dim, at one block."""
        nd = len(shape)
        full = [cd for cd in cands if any(cd)]
        if len(full) == 1 and len(full[0]) == nd:  # one input is split: its placement
            return tuple(() if shape[j] == 1 else d for j, d in enumerate(full[0]))
        if full and len(full[0]) == nd and all(cd == full[0] for cd in full[1:]):
            return tuple(() if shape[j] == 1 else d for j, d in enumerate(full[0]))
        dims: List[set] = [set() for _ in range(nd)]
        used: set = set()
        for cd in cands:
            off = nd - len(cd)
            for i, d in enumerate(cd):
                j = i + off
                if shape[j] == 1:
                    continue
                for f, b in d:
                    if f not in used:
                        used.add(f)
                        dims[j].add((f, b))
        return tuple(_canon(d) for d in dims)

    # -- the rule table -------------------------------------------------
    def rule(self, name: str, func, args, kwargs, ins: List[torch.Tensor],
             outs: List[torch.Tensor]):
        """(the placements the op reads its tensor inputs ``ins`` (those of
        ``args`` then ``kwargs``) at; the placements of ``outs``)."""
        pls = [self.get(t) for t in ins]
        if name in _ZEROS:
            self._zeros.setdefault(_key(outs[0])[0], set()).add(_key(outs[0])[1:])
        elif self._zeros and outs and name not in _INDEX_PUT and func._schema.is_mutable:
            self._written(outs[0])  # written in place: no longer a fresh zero buffer
        if name in _FACTORY or not ins:
            return pls, [Placement.replicated(o.dim()) for o in outs]
        if name in _LIKE:  # the input's cut, none of its values
            return pls, [Placement(pls[0].dims) for _ in outs]
        if name in _MATMUL:
            return self._matmul(name, args, ins, pls, outs)
        if name in _REDUCE:
            return self._reduction(name, args, kwargs, ins, pls, outs)
        if name in _WHOLE_DIM:
            i = _WHOLE_DIM[name]
            d = args[i] if len(args) > i else kwargs.get("dim", -1)
            return self._whole(ins, pls, outs, _dims(d, ins[0].dim()))
        if name in ("aten.native_layer_norm", "aten.native_layer_norm_backward"):
            bwd = name.endswith("backward")
            nd = len(args[2] if bwd else args[1])
            x = ins[1] if bwd else ins[0]
            return self._whole(ins, pls, outs, list(range(x.dim() - nd, x.dim())),
                               lead=1 if bwd else 0)
        if name in ("aten.embedding", "aten.embedding_dense_backward", "aten.index_select",
                    "aten.gather"):
            return self._index(name, args, ins, pls, outs)
        if name == "aten.cat":
            return self._cat(args, kwargs, ins, pls, outs)
        if name == "aten.stack":
            return self._stack(args, kwargs, ins, pls, outs)
        if name in _SPLIT:
            return self._split(name, args, kwargs, ins, pls, outs)
        if name in ("aten.scatter", "aten.scatter_add"):
            return self._scatter(args, ins, pls, outs)
        if name == "aten.index" and _adjacent(args[1]):
            return self._index_rows(args, ins, pls, outs)
        if name in _INDEX_PUT and _adjacent(args[1]):
            return self._index_put(args, ins, pls, outs)
        if name in ("aten.slice_backward", "aten.select_backward"):
            return self._slice_backward(name, args, ins, pls, outs)
        if func.is_view or name in _SAME or name in _RESHAPE:
            return self._view(name, args, ins, pls, outs)
        if name == "aten.copy_" and ins[0].shape == ins[1].shape \
                and _key(ins[0])[0] not in self._fixed_storage:
            # a whole overwrite of a buffer the program made: it holds the
            # source's blocks (XLA gives a dynamic-update-slice the update's
            # sharding); an argument's buffer keeps its own (below)
            return [pls[1], pls[1]], [Placement(pls[1].dims, pls[1].partial)]
        if torch.Tag.pointwise in func.tags or name in _POINTWISE:
            return self._pointwise(name, func, ins, pls, outs)
        return self._fallback(func, ins, pls, outs)

    def _fallback(self, func, ins, pls, outs):
        mutated = func._schema.is_mutable and outs and _key(outs[0]) == _key(ins[0])
        if mutated:  # an in-place op keeps its target's placement
            tgt = self.reduce(ins[0], pls[0])
            read = [tgt] + [self._read(t, p, Placement.replicated(t.dim()))
                            for t, p in zip(ins[1:], pls[1:])]
            return read, [tgt] + [Placement.replicated(o.dim()) for o in outs[1:]]
        read = [self._read(t, p, Placement.replicated(t.dim())) for t, p in zip(ins, pls)]
        return read, [Placement.replicated(o.dim()) for o in outs]

    def _pointwise(self, name, func, ins, pls, outs):
        out = outs[0] if outs else ins[0]
        mutated = func._schema.is_mutable and outs and _key(outs[0]) == _key(ins[0])
        parts = {p.partial for p in pls if p.partial}
        partial = frozenset()
        if len(parts) == 1:
            (part,) = parts
            n_part = sum(bool(p.partial) for p in pls)
            if name in _LINEAR and n_part == len(pls):
                partial = part
            elif name in _SCALE and n_part == 1 and (name == "aten.mul" or pls[0].partial):
                partial = part
        if mutated:
            dims = (pls[0] if partial else self.reduce(ins[0], pls[0])).dims
        elif len(ins) == 1:
            dims = pls[0].dims if ins[0].shape == out.shape else \
                self._join(out.shape, [pls[0].dims])
        else:
            order = sorted(range(len(ins)), key=lambda i: -ins[i].numel())
            dims = self._join(out.shape, [pls[i].dims for i in order])
        if partial & {f for d in dims for f, _ in d}:  # a sum cut by its own factor
            partial = frozenset()
        read = []
        for t, p in zip(ins, pls):
            if not p.partial and p.dims == dims and t.shape == out.shape:
                read.append(p)  # read as it lies
                continue
            want = self._fit(t, dims)
            if p.partial and p.partial == partial:
                want.partial = partial
            elif p.partial:
                p = self.reduce(t, p)
            read.append(self._read(t, p, want))
        return read, [Placement(dims, partial)] + [
            Placement(dims) if x.shape == out.shape else Placement.replicated(x.dim())
            for x in outs[1:]]

    def _matmul(self, name, args, ins, pls, outs):
        """mm (M,K)x(K,N), bmm (B,M,K)x(B,K,N), and their add-forms: the
        operands' placements are merged dim by dim (a factor only one of
        them has is a local slice of the other), each factor on one dim; a
        contraction over a split dim leaves a partial sum. Where the
        operands want one factor on different dims, the output's own dims
        take it first, then the batch, then the contraction: the other
        operand is resharded, as XLA's partitioner keeps an output dim's
        cut and spares the partial sum's all-reduce.

        A bmm whose batch dim a reshape merged from several dims (an
        einsum's batch letters) keeps a cut on each of them, as XLA's
        dot_general does (:meth:`_spread`): the batch takes a factor first
        where that moves fewer bytes, and it takes the factors of operands
        that were partial sums, whole on each device of them after the
        all-reduce."""
        ia = 1 if name in ("aten.addmm", "aten.baddbmm") else 0
        a, b = args[ia], args[ia + 1]
        summed = pls[ia].partial | pls[ia + 1].partial
        pa = self.reduce(a, pls[ia])
        pb = self.reduce(b, pls[ia + 1])
        roles = "MNBK" if a.dim() == 3 else "MNK"
        tb, tm, tn, tk = self._mm_plan(pa, pb, roles, b.numel() >= a.numel())
        parts = pls[ia].parts or pls[ia + 1].parts
        if parts and a.dim() == 3:
            # a batch merged from several dims (an einsum's): the batch may
            # take a factor first, where that moves fewer bytes
            alt = self._mm_plan(pa, pb, "BMNK", b.numel() >= a.numel())
            if alt != (tb, tm, tn, tk) and \
                    self._plan_cost(a, b, pa, pb, alt) < self._plan_cost(a, b, pa, pb,
                                                                         (tb, tm, tn, tk)):
                tb, tm, tn, tk = alt
        if tb and summed:
            tb = self._spread(a.shape[0], tb[0], summed - {f for d in (tb[0], tm, tn, tk)
                                                          for f, _ in d}, parts)
        ra = self._read(a, pa, Placement(tb + (tm, tk)))
        rb = self._read(b, pb, Placement(tb + (tk, tn)))
        o = Placement(tb + (tm, tn), _factors(tk))
        read = [ra, rb]
        if ia:  # the added input of addmm/baddbmm: added once, to the whole sum
            if o.partial:
                o = self.reduce(outs[0], o)
            read.insert(0, self._read(ins[0], self.reduce(ins[0], pls[0]),
                                      self._fit(ins[0], o.dims)))
        return read, [o]

    def _plan_cost(self, a, b, pa, pb, plan) -> int:
        """Bytes a matmul plan's operand reads move (a gather's block after
        it, a move's target block; a finer cut is free)."""
        tb, tm, tn, tk = plan
        cost = 0
        for t, p, want in ((a, pa, Placement(tb + (tm, tk))), (b, pb, Placement(tb + (tk, tn)))):
            if p.dims == want.dims or p.finer(want):
                continue
            gathered, moved = self._moves(p, want)
            if gathered:
                cost += self.local_bytes(t, self.without(p, gathered))
            if moved:
                cost += self.local_bytes(t, want)
        return cost

    def _spread(self, n, entry, free, parts):
        """(The batch dim's entry ``entry`` with the ``free`` factors added
        on the first uncut dim of those a reshape merged into it (``parts``)
        that they divide,), or unchanged where none is."""
        parts = (parts or {}).get(0)
        if not free or not parts:
            return (entry,)
        size = self.layout.size(free)
        inner = n
        for s in parts:
            inner //= s
            cut = any(inner <= blk < inner * s for _, blk in entry)
            if not cut and s % size == 0:
                new = [(f, blk * inner) for f, blk in self.layout.tile(s, sorted(free))]
                return (_canon(set(entry) | set(new)),)
        return (entry,)

    @staticmethod
    def _mm_plan(pa, pb, order, b_big=True):
        """((batch,), M, N, K) entries of a matmul, the roles taking their
        factors in ``order`` (batch and contraction merge both operands')."""
        used: set = set()
        got = {}
        for role in order:
            if role in "BK":
                x, y = ((pa.dims[0], pb.dims[0]) if role == "B" else (pa.dims[-1], pb.dims[-2]))
                u = set(x) | set(y)
                if len(_factors(u)) != len(u) or (_factors(u) & used):
                    # cut alike in neither: the bigger operand's cut, else the common one
                    u = set(y if b_big else x)
                    if _factors(u) & used:
                        u = set(x) & set(y)
            else:
                u = set(pa.dims[-2] if role == "M" else pb.dims[-1])
            u = {e for e in u if e[0] not in used}
            used.update(_factors(u))
            got[role] = _canon(u)
        tb = (got["B"],) if "B" in got else ()
        return tb, got["M"], got["N"], got["K"]

    def _reduction(self, name, args, kwargs, ins, pls, outs):
        di, ki, linear = _REDUCE[name]
        x, p = ins[0], pls[0]
        if p.partial and not linear:
            p = self.reduce(x, p)
        d = kwargs["dim"] if "dim" in kwargs else (args[di] if len(args) > di else None)
        keep = bool(kwargs["keepdim"] if "keepdim" in kwargs else
                    (args[ki] if len(args) > ki else False))
        red = _dims(d, x.dim())
        over = {f for i in red for f, _ in p.dims[i]}
        kept = [() if i in red else p.dims[i] for i in range(x.dim())]
        if not keep:
            kept = [kept[i] for i in range(x.dim()) if i not in red]
        partial = frozenset(over) | (p.partial if linear else frozenset())
        placed = []
        for o in outs:
            pl = Placement(tuple(kept) if o.dim() == len(kept) else ((),) * o.dim(), partial)
            if not linear and over:
                pl = self.reduce(o, pl)
            placed.append(pl)
        return [p] + pls[1:], placed

    def _whole(self, ins, pls, outs, whole, lead=None):
        """An op that needs the ``whole`` dims of its first (or ``lead``)
        input unsplit: those dims are gathered, the rest carry."""
        lead = lead or 0
        x = ins[lead]
        p = self.reduce(x, pls[lead])
        dims = tuple(() if i in whole else d for i, d in enumerate(p.dims))
        read = []
        for t, q in zip(ins, pls):
            q = self.reduce(t, q)
            want = Placement(dims) if t.shape == x.shape else Placement.replicated(t.dim())
            read.append(self._read(t, q, want, keep=t is x))
        placed = [Placement(dims) if o.shape == x.shape else
                  Placement(tuple(() if o.shape[i] == 1 else dims[i] for i in range(o.dim())))
                  if o.dim() == x.dim() else Placement.replicated(o.dim()) for o in outs]
        return read, placed

    def _index(self, name, args, ins, pls, outs):
        o = outs[0]
        if name == "aten.embedding":
            w, idx = args[0], args[1]
            pw, pi = self.reduce(w, pls[0]), self.reduce(idx, pls[1])
            used = pi.used()
            emb = tuple(e for e in pw.dims[1] if e[0] not in used)
            vocab = _factors(pw.dims[0]) - used
            return [pw, pi], [Placement(pi.dims + (emb,), vocab)]
        if name == "aten.embedding_dense_backward":
            g, idx = args[0], args[1]
            pg, pi = self.reduce(g, pls[0]), self.reduce(idx, pls[1])
            tok = {f for d in pg.dims[:-1] for f, _ in d} | pi.used()
            emb = tuple(e for e in pg.dims[-1] if e[0] not in tok)
            return [pg, pi], [Placement(((), emb), tok)]
        # index_select(x, dim, index) / gather(x, dim, index): a lookup into
        # a sharded dim is a masked local lookup, summed over its factors
        x, dim, idx = args[0], args[1] % args[0].dim(), args[2]
        px, pi = self.reduce(x, pls[0]), self.reduce(idx, pls[1])
        over = _factors(px.dims[dim])
        rest = [() if i == dim else d for i, d in enumerate(px.dims)]
        if name == "aten.index_select":
            dims = list(rest)
            dims[dim] = tuple(e for e in (pi.dims[0] if pi.dims else ())
                              if e[0] not in px.used())
        else:
            dims = list(self._join(o.shape, [pi.dims, rest]))
        if {f for d in dims for f, _ in d} & over:
            px = self._read(x, px, Placement(rest))
            over = set()
        read = [px if t is x else pi for t in ins]
        return read, [Placement(tuple(dims), over)]

    def _retile(self, t, p, dim, n_out):
        """``p`` with ``dim`` cut anew for an output of ``n_out`` along it
        (a slice or concatenation of a sharded dim: XLA moves the edges
        between neighbours, a collective-permute), or gathered when the
        cut does not divide."""
        fs = [f for f, _ in p.dims[dim]]
        if not fs:
            return p, ()
        if n_out % self.layout.size(fs):
            return self._read(t, p, self.without(p, set(fs)), keep=False), ()
        return p, self.layout.tile(n_out, fs)

    def _cat(self, args, kwargs, ins, pls, outs):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        o = outs[0]
        dim %= o.dim()
        full = [(t, self.reduce(t, p)) for t, p in zip(ins, pls) if t.dim() == o.dim()]
        dims = list(self._join(o.shape, [p.dims for _, p in full]))
        cut = dims[dim]
        dims[dim] = ()
        read = []
        for t, p in zip(ins, pls):
            if t.dim() != o.dim():
                read.append(self._read(t, self.reduce(t, p), Placement.replicated(t.dim())))
                continue
            want = list(dims)
            want[dim] = self.layout.tile(t.shape[dim], [f for f, _ in cut]) \
                if cut and t.shape[dim] % self.layout.esize(cut) == 0 else ()
            read.append(self._read(t, self.reduce(t, p), Placement(want), keep=False))
        if cut and all(r.dims[dim] for r, t in zip(read, ins) if t.dim() == o.dim()):
            dims[dim] = self.layout.tile(o.shape[dim], [f for f, _ in cut])
            self._coll("shift", o, Placement(dims), _factors(cut))
        return read, [Placement(dims)]

    def _stack(self, args, kwargs, ins, pls, outs):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        dim %= outs[0].dim()
        dims = self._join(ins[0].shape, [self.reduce(t, p).dims for t, p in zip(ins, pls)])
        read = [self._read(t, self.reduce(t, p), Placement(dims), keep=False)
                for t, p in zip(ins, pls)]
        return read, [Placement(dims[:dim] + ((),) + dims[dim:])]

    def _split(self, name, args, kwargs, ins, pls, outs):
        x, p = ins[0], self.reduce(ins[0], pls[0])
        i = 1 if name == "aten.unbind" else 2
        dim = (args[i] if len(args) > i else kwargs.get("dim", 0)) % x.dim()
        if name == "aten.unbind":
            p = self._read(x, p, self.without(p, _factors(p.dims[dim])), keep=False)
            return [p], [Placement(p.dims[:dim] + p.dims[dim + 1:]) for _ in outs]
        placed = []
        for o in outs:
            q, cut = self._retile(x, p, dim, o.shape[dim])
            dims = list(q.dims)
            dims[dim] = cut
            if cut and o.shape[dim] != x.shape[dim]:
                self._coll("shift", o, Placement(dims), _factors(cut))
            placed.append(Placement(dims))
        return [p], placed

    def _scatter(self, args, ins, pls, outs):
        """scatter(self, dim, index, src): a write into ``self``'s block
        (into a split ``dim`` too, each device writing what lands in its
        block), cut where ``self``, the index and the source agree."""
        x, dim = args[0], args[1] % args[0].dim()
        ps = [self.reduce(t, p) for t, p in zip(ins, pls)]
        rest = [tuple(() if i == dim else d for i, d in enumerate(p.dims)) for p in ps[1:]]
        dims = self._join(outs[0].shape, [ps[0].dims] + rest)
        lookup = tuple(() if i == dim else d for i, d in enumerate(dims))
        read = [self._read(x, ps[0], Placement(dims))]
        read += [self._read(t, p, Placement(lookup), keep=False) for t, p in zip(ins[1:], ps[1:])]
        return read, [Placement(dims)]

    def _index_rows(self, args, ins, pls, outs):
        """x[..., i0, i1, ..., ...] (``aten.index``): a gather of rows. The
        output's index dims keep the (joined) cut of the index tensors. A
        factor that cuts an indexed dim of x is either gathered or kept as
        a masked local lookup summed over it (a partial sum), whichever
        moves fewer bytes: x's block gathered, or the output's block later
        all-reduced (XLA's two ways to partition a gather whose operand is
        cut along a sliced dim). x's other dims keep their cut, but for a
        factor the index already uses, which x gives up."""
        x, indices, o = args[0], args[1], outs[0]
        at = [i for i, t in enumerate(indices) if t is not None]
        k0, k1 = at[0], at[-1] + 1
        ni = o.dim() - (x.dim() - (k1 - k0))
        px = self.reduce(x, pls[0])
        pis = [self.reduce(t, p) for t, p in zip(ins[1:], pls[1:])]
        rows = self._join(o.shape[k0:k0 + ni], [p.dims for p in pis])
        used = {f for d in rows for f, _ in d}
        keep = [tuple(e for e in d if e[0] not in used) for d in px.dims]
        over = {f for d in keep[k0:k1] for f, _ in d}
        out = Placement(tuple(keep[:k0]) + rows + tuple(keep[k1:]))
        if over:
            gathered = Placement(tuple(() if k0 <= i < k1 else d for i, d in enumerate(keep)))
            if self.local_bytes(x, gathered) < self.local_bytes(o, out):
                keep, over = list(gathered.dims), set()
            else:
                out.partial = frozenset(over)
        read = [self._read(x, px, Placement(tuple(keep)))]
        read += [self._read(t, p, self._fit(t, rows)) for t, p in zip(ins[1:], pis)]
        return read, [out]

    def _index_put(self, args, ins, pls, outs):
        """x[..., i0, i1, ..., ...] = v (``index_put``, in place or not;
        ``accumulate`` adds): a write into x's block, which the output
        keeps (into a cut indexed dim too, each device writing what lands
        in its block). Into a fresh zero buffer the write stays local where
        the index is: the index rows keep the cut of the index tensors (or
        of v where the index is whole), each device writes its own rows,
        and the buffer is a partial sum over the rows' factors and v's.
        Into anything else the index and v are read whole on the rows."""
        x, indices, v = args[0], args[1], ins[-1]
        at = [i for i, t in enumerate(indices) if t is not None]
        k0, k1 = at[0], at[-1] + 1
        idx = ins[1:-1]
        shape = torch.broadcast_shapes(*(t.shape for t in idx))
        ni = len(shape)
        fresh = self._fresh(x)
        self._written(outs[0] if outs else x)
        px, pv = pls[0], pls[-1]
        if not fresh:
            px, pv = self.reduce(x, px), self.reduce(v, pv)
        pidx = [self.reduce(t, p) for t, p in zip(idx, pls[1:-1])]
        off = x.dim() - (k1 - k0) + ni - v.dim()  # v's dims, aligned as the write's
        rows = ((),) * ni
        if fresh:
            vrows = tuple(pv.dims[i - off] if i >= off and v.shape[i - off] != 1 else ()
                          for i in range(k0, k0 + ni))
            taken = px.used() | pv.partial
            rows = tuple(tuple(e for e in d if e[0] not in taken)
                         for d in self._join(shape, [p.dims for p in pidx] + [vrows]))
        write = tuple(px.dims[:k0]) + rows + tuple(px.dims[k1:])
        want_v = Placement(tuple(() if v.shape[i] == 1 else write[i + off]
                                 for i in range(v.dim())), pv.partial if fresh else _NONE)
        read = [px] + [self._read(t, p, self._fit(t, rows)) for t, p in zip(idx, pidx)]
        read.append(self._read(v, pv, want_v))
        partial = frozenset({f for d in rows for f, _ in d}) | want_v.partial
        return read, [Placement(px.dims, partial)]

    def _slice_backward(self, name, args, ins, pls, outs):
        """The gradient of a slice (or select): the output's cut is the
        gradient's, the sliced dim cut anew for the whole size."""
        g, p = ins[0], self.reduce(ins[0], pls[0])
        o = outs[0]
        dim = args[2] % o.dim()
        if name == "aten.select_backward":
            return [p], [Placement(p.dims[:dim] + ((),) + p.dims[dim:])]
        q, cut = self._retile(g, p, dim, o.shape[dim])
        dims = list(q.dims)
        dims[dim] = cut
        if cut:
            self._coll("shift", o, Placement(dims), _factors(cut))
        return [q], [Placement(dims)]

    def _view(self, name, args, ins, pls, outs):
        x, p = ins[0], pls[0]
        o = outs[0] if outs else x
        if name in _SAME:
            return [p], [Placement(p.dims, p.partial, parts=p.parts) if q.shape == x.shape else
                         Placement.replicated(q.dim()) for q in outs]
        if name in ("aten.permute", "aten.transpose", "aten.t", "aten.numpy_T"):
            if name == "aten.permute":
                perm = [d % x.dim() for d in args[1]]
            elif name in ("aten.t", "aten.numpy_T") or x.dim() < 2:
                perm = list(range(x.dim()))[::-1]
            else:
                d0, d1 = args[1] % x.dim(), args[2] % x.dim()
                perm = list(range(x.dim()))
                perm[d0], perm[d1] = perm[d1], perm[d0]
            parts = {j: p.parts[i] for j, i in enumerate(perm) if i in p.parts} if p.parts \
                else None
            return [p], [Placement(tuple(p.dims[i] for i in perm), p.partial, p.origin,
                                   parts or None)]
        if name == "aten.expand":
            off = o.dim() - x.dim()
            dims = ((),) * off + tuple(() if x.shape[i] == 1 else p.dims[i]
                                       for i in range(x.dim()))
            return [p], [Placement(dims, p.partial)]
        if name in ("aten.slice", "aten.narrow"):
            dim = args[1] % x.dim() if len(args) > 1 else 0
            q, cut = self._retile(x, p, dim, o.shape[dim])
            dims = list(q.dims)
            dims[dim] = cut
            if cut and o.shape[dim] != x.shape[dim]:
                self._coll("shift", o, Placement(dims), _factors(cut))
            return [q], [Placement(tuple(dims), q.partial)]
        if name == "aten.select":
            dim = args[1] % x.dim()
            q = self._read(x, p, self.without(p, _factors(p.dims[dim])), keep=False)
            return [q], [Placement(q.dims[:dim] + q.dims[dim + 1:], q.partial)]
        if name in _RESHAPE:
            return self._reshape(x, p, o)
        q = self._read(x, p, Placement.replicated(x.dim()), keep=False)
        return [q], [Placement.replicated(t.dim()) for t in outs]

    def _reshape(self, x, p, o):
        """A factor carries into the new shape where its blocks are whole
        rows of the dims minor to it and its period fits in one new dim;
        otherwise it is gathered first."""
        key = (tuple(x.shape), tuple(o.shape), p.dims)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._reshape_plan(*key)
        gathered, dims, parts = plan
        if gathered:
            p = self._read(x, p, self.without(p, gathered), keep=False)
        return [p], [Placement(dims, p.partial, None if gathered else p.origin, parts)]

    def _reshape_plan(self, old, new, pdims):
        out: List[set] = [set() for _ in new]
        gathered: set = set()
        parts = {}
        for go, gn in _reshape_groups(old, new):
            if len(gn) == 1 and len(go) > 1:
                parts[gn[0]] = tuple(old[i] for i in go)
            flat, inner = [], 1
            for i in reversed(go):
                flat += [(f, b * inner) for f, b in pdims[i]]
                inner *= old[i]
            inner_new, inner = {}, 1
            for j in reversed(gn):
                inner_new[j] = inner
                inner *= new[j]
            for f, blk in flat:
                s = self.layout.sizes[f]
                for j in gn:
                    unit = inner_new[j]
                    if blk % unit == 0 and (unit * new[j]) % (blk * s) == 0:
                        out[j].add((f, blk // unit))
                        break
                else:
                    gathered.add(f)
        return frozenset(gathered), tuple(_canon(d) for d in out), parts or None
