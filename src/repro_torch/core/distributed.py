"""Distributed PIPECG on a mesh of the card and the host's cores — the
paper's hybrid methods, plus the communication-reduced deep pipelines and
the hierarchical reduction.

Rows of the banded operator are split across the shards of a
:class:`~repro_torch.core.comm.SolverMesh`; each method is configuration
of the shared solver loops: a reduction strategy (``core.reduce``), a
distributed SPMV strategy and a pipeline depth (``core.iteration``):

    method   reduction            SPMV         depth  (analogue)
    ------   ------------------   ----------   -----  ------------------------
    "h1"     3 separate sums      all_gather   1      Hybrid-PIPECG-1
    "h2"     1 packed sum         all_gather   1      Hybrid-PIPECG-2
    "h3"     1 packed sum         halo         1      Hybrid-PIPECG-3 (2-D)
    "h4"     hierarchical 2-st.   halo         1      intra-pod + inter-pod
    "pl2"    1 packed Gram sum    halo         2      deep pipeline, 1 red/2 it
    "pl3"    1 packed Gram sum    halo         3      deep pipeline, 1 red/3 it

The JAX package runs each method as one ``shard_map``-ped program. The
port runs one host thread per shard (``SolverMesh.run``), each running the
shared loop (``run_pipecg``, or the depth-l loop of
``make_deep_pipecg_core``) on its own block: SPMD, with the collectives of
``core.comm`` in place of ``psum``/``all_gather``/``ppermute``. The
paper's three methods run in one process on a node's cores and one GPU,
and so does this; a CUDA rank's halo crosses the host either way.

Each shard runs the engine of its device. A card shard's core is "cuda"
(the ``fused_vma`` kernel; its lane entry under ``solve_batched``), and
its SPMV's part 1, the local band, is the ``spmv_dia`` kernel on its block
(zero outside the block's rows, as the JAX package's ``_shift_segment``);
a host shard runs the plain versions (its SPMV reads windows of the
zero-padded vector, one multiply-add per diagonal). ``engine="auto"`` resolves per shard
so; "fused_iter" is refused, since that kernel computes the whole SPMV
without a halo. ``pl2``/``pl3`` run the coordinate loop (plain torch; its
SPMV's part 1 still takes the kernel on a card shard).

SPMV strategies (``register_dist_spmv``), called as
``fn(shard, x, comm, hops=..., active=...)`` on one rank:

``allgather`` — gather the whole vector, then multiply this shard's rows
    (N elements cross per SPMV, like the paper's full-vector copies);
    equal shards only.
``halo`` — post the boundary slabs to the ring neighbours, run part 1
    (the local band, the paper's nnz1) while they travel, then wait for
    them and add part 2, the boundary corrections (nnz2), in the order of
    the JAX package's ``spmv_halo``. When every shard holds at least the
    bandwidth ``hw`` rows each neighbour sends one slab of ``hw``;
    otherwise (equal shards only) ``hops = ceil(hw / rows)`` whole blocks
    come from each side (multi-hop). Each correction is one more DIA SPMV,
    over the ``hw`` boundary rows and the halo.

With ``nrhs=k`` the loop runs over (k, rows) lanes inside every shard, so
each reduction carries all k systems' partials at once.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..sparse.formats import DIAMatrix
from ..sparse.partition import ShardedDIA
from .comm import RENDEZVOUS_TIMEOUT_S, ShardComm, SolverMesh
from .iteration import get_core, make_deep_pipecg_core, run_pipecg
from .reduce import make_reducer, reducer_names, reducer_needs_subaxis
from .types import SolveResult

__all__ = [
    "pipecg_distributed",
    "build_distributed_solver",
    "make_solver_mesh",
    "ShardBlock",
    "spmv_halo",
    "spmv_allgather",
    "DistMethod",
    "get_method",
    "register_dist_spmv",
    "register_method",
    "method_names",
    "reductions_per_iteration",
]


def make_solver_mesh(n_shards: int, sub: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> SolverMesh:
    """The mesh of a distributed solve: one device per shard.

    ``devices=None`` puts shard 0 on the card and shards 1..n-1 on the
    host's cores: the paper's CPU+GPU layout, and on a machine with one
    card the counterpart of "the first n devices". It raises where there
    is no CUDA device (pass ``devices=("cpu",) * n`` for a host-only
    mesh). ``sub=k`` groups the ranks into pods of k (the hierarchical
    "h4" reducer's 2-D mesh), keeping the linear ring order.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the default solver mesh puts shard 0 on the card and CUDA is not available; "
                f"pass devices=('cpu',) * {n_shards} for a host-only mesh"
            )
        devices = ("cuda",) + ("cpu",) * (n_shards - 1)
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return SolverMesh([resolve_device(d) for d in devices], sub=sub)


# ---------------------------------------------------------------------------
# one rank's block, and the distributed SPMV strategies
# ---------------------------------------------------------------------------

def _local_spmv(A: DIAMatrix, x: torch.Tensor, active=None) -> torch.Tensor:
    """The DIA SPMV of a block on a card: the spmv_dia kernel (its lane
    entry for (k, n) x)."""
    from ..kernels.spmv_dia import spmv_dia_batched, spmv_dia_cuda

    return spmv_dia_batched(A, x, active) if x.dim() == 2 else spmv_dia_cuda(A, x)


def _window_spmv(data: torch.Tensor, offsets, v: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """y[i] = sum_j data[j, i] * v[lo + i + offsets[j]] for i < rows: a DIA
    SPMV read from a window of the extended vector v (row 0 at entry lo).
    The host's plain version: one multiply-add per diagonal over views of
    v, where the plain ``spmv_dia`` builds a shifted copy per diagonal."""
    y = v.new_zeros(*v.shape[:-1], rows)
    for j, o in enumerate(offsets):
        y.addcmul_(data[j], v[..., lo + o: lo + o + rows])
    return y


class ShardBlock:
    """Rank p's rows of a :class:`ShardedDIA` and the bands its SPMV
    strategies multiply, built once per runner on the shard's device.

    On a card (the kernel's operands):

    * ``local`` — the block as a rows x rows operator (SPMV part 1), its
      diagonals that reach inside the block.
    * ``left_band`` / ``right_band`` — the boundary corrections: the
      negative (positive) offsets on the first (last) ``min(hw, rows)``
      rows, next to ``hw`` zero rows where the halo goes, so one DIA SPMV
      of the halo (local entries zero) gives every halo term of those rows.
    * ``gather_band`` — the block between ``hw`` zero rows on each side,
      for the gathered vector's window [lo - hw, hi + hw).

    On the host the block is multiplied from windows of the vector
    zero-padded by ``hw`` on each side (:func:`_window_spmv`), and each
    correction is one multiply-add per offset on the rows it reaches, the
    JAX package's part 2; no band is built.
    """

    def __init__(self, As: ShardedDIA, p: int):
        self.data = As.blocks[p]
        self.offsets = As.offsets
        self.rows = As.rows[p]
        self.lo = As.boundaries[p]
        self.hw = As.bandwidth
        self.device = self.data.device
        self.on_card = self.device.type == "cuda"
        self.edge = min(self.hw, self.rows)  # rows that read a halo

    @cached_property
    def local(self) -> DIAMatrix:
        # part 1 reads only columns inside the block: a diagonal at least a
        # block away (a band wider than the shard) adds nothing there
        near = [j for j, o in enumerate(self.offsets) if abs(o) < self.rows]
        if len(near) == len(self.offsets):
            return DIAMatrix(self.data, self.offsets, self.rows)
        return DIAMatrix(self.data[near].contiguous(), tuple(self.offsets[j] for j in near),
                         self.rows)

    def _band(self, sign: int) -> Optional[DIAMatrix]:
        idx = [j for j, o in enumerate(self.offsets) if o * sign > 0]
        if not idx:
            return None
        zeros = self.data.new_zeros(len(idx), self.hw)
        if sign < 0:
            data = torch.cat([zeros, self.data[idx, : self.edge]], dim=1)
        else:
            data = torch.cat([self.data[idx, self.rows - self.edge:], zeros], dim=1)
        return DIAMatrix(data.contiguous(), tuple(self.offsets[j] for j in idx),
                         self.edge + self.hw)

    @cached_property
    def left_band(self) -> Optional[DIAMatrix]:
        return self._band(-1)

    @cached_property
    def right_band(self) -> Optional[DIAMatrix]:
        return self._band(+1)

    @cached_property
    def gather_band(self) -> DIAMatrix:
        zeros = self.data.new_zeros(self.data.shape[0], self.hw)
        return DIAMatrix(torch.cat([zeros, self.data, zeros], dim=1).contiguous(), self.offsets,
                         self.rows + 2 * self.hw)


def spmv_allgather(shard: ShardBlock, x: torch.Tensor, comm: ShardComm, *,
                   hops: Optional[int] = None, active=None) -> torch.Tensor:
    """Full-vector SPMV: all_gather x, then multiply this shard's rows.

    The h1/h2 pattern (N elements cross per SPMV, like the paper's
    full-vector copies); the JAX package indexes the gathered vector by
    p·R, so it takes equal shards only. ``hops`` is unused (a gather has
    no hop structure). Any band width: the window covers every offset.
    """
    del hops
    full = torch.cat(comm.allgather(x).wait(), dim=-1)
    hw, R = shard.hw, shard.rows
    window = torch.nn.functional.pad(full, (hw, hw))[..., shard.lo: shard.lo + R + 2 * hw]
    if not shard.on_card:
        return _window_spmv(shard.data, shard.offsets, window, hw, R)
    return _local_spmv(shard.gather_band, window.contiguous(), active)[..., hw: hw + R]


def spmv_halo(shard: ShardBlock, x: torch.Tensor, comm: ShardComm, *,
              hops: Optional[int] = None, active=None) -> torch.Tensor:
    """2-D decomposed SPMV: the local band (nnz1) plus halo corrections (nnz2).

    Posts the halo first, runs part 1 while it travels, then waits for it
    and adds part 2. ``hops=None`` (every shard holds at least ``hw``
    rows): one ``hw`` slab from each ring neighbour, the head of the right
    one and the tail of the left one. ``hops=k`` (equal shards narrower
    than the band): k whole blocks from each side. Edge shards read zeros,
    the DIA zero-outside-the-matrix convention.
    """
    hw, R, p, P = shard.hw, shard.rows, comm.rank, comm.n_shards
    lanes = x.shape[:-1]
    # --- post the halo exchange (independent of part 1) ---
    if hops is None:
        right = [comm.shift(x[..., :hw], +1)]       # the right neighbour's head
        left = [comm.shift(x[..., R - hw:], -1)]    # the left neighbour's tail
    else:
        right = [comm.shift(x, +d) for d in range(1, hops + 1)]    # blocks p+1 .. p+hops
        left = [comm.shift(x, -d) for d in range(hops, 0, -1)]     # blocks p-hops .. p-1

    # --- SPMV part 1: local columns only (the paper's nnz1) ---
    if shard.on_card:
        y = _local_spmv(shard.local, x, active)
    else:
        v = torch.nn.functional.pad(x, (hw, hw))  # zero outside the block
        y = _window_spmv(shard.data, shard.offsets, v, hw, R)

    # --- SPMV part 2: boundary corrections (the paper's nnz2) ---
    def gathered(handles, width):
        got = [h.wait() for h in handles]
        return torch.cat([g if g is not None else x.new_zeros(*lanes, width) for g in got],
                         dim=-1)

    width = hw if hops is None else R
    right_buf = gathered(right, width)[..., :hw]
    left_buf = gathered(left, width)
    left_buf = left_buf[..., left_buf.shape[-1] - hw:]
    if not shard.on_card:
        # the halo fills the window's padding; each offset adds its terms on
        # the rows it reaches across the block's edge
        v[..., :hw] = left_buf
        v[..., hw + R:] = right_buf
        for j, o in enumerate(shard.offsets):
            k = min(abs(o), R)
            if o < 0 and p > 0:
                y[..., :k].addcmul_(shard.data[j, :k], v[..., hw + o: hw + o + k])
            elif o > 0 and p < P - 1:
                y[..., R - k:].addcmul_(shard.data[j, R - k:], v[..., hw + R - k + o: hw + R + o])
        return y
    m = shard.edge
    if shard.left_band is not None and p > 0:
        v = torch.cat([left_buf, x.new_zeros(*lanes, m)], dim=-1)
        y[..., :m] += _local_spmv(shard.left_band, v, active)[..., hw:]
    if shard.right_band is not None and p < P - 1:
        v = torch.cat([x.new_zeros(*lanes, m), right_buf], dim=-1)
        y[..., R - m:] += _local_spmv(shard.right_band, v, active)[..., :m]
    return y


_DIST_SPMV = {"allgather": spmv_allgather, "halo": spmv_halo}
# strategies that index the gathered vector by p*R: all shards one size
_EQUAL_ONLY_SPMV = {"allgather"}


def register_dist_spmv(name: str, fn, *, overwrite: bool = False,
                       equal_shards_only: bool = False) -> None:
    """Register a distributed SPMV strategy ``fn(shard, x, comm, *, hops,
    active) -> y`` (see the module docstring). Raises ValueError if
    ``name`` is taken, unless ``overwrite=True``."""
    if name in _DIST_SPMV and not overwrite:
        raise ValueError(
            f"distributed SPMV strategy {name!r} already registered; pass "
            f"overwrite=True to replace it"
        )
    _DIST_SPMV[name] = fn
    if equal_shards_only:
        _EQUAL_ONLY_SPMV.add(name)


# ---------------------------------------------------------------------------
# methods = (reduction, SPMV, pipeline depth) configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DistMethod:
    """A distributed execution strategy for the shared solver loops.

    ``pipeline_depth`` selects the loop: 1 = PIPECG (``run_pipecg``, one
    reduction per iteration, overlapped with one SPMV); l >= 2 = the
    depth-l loop (``make_deep_pipecg_core``, one packed Gram reduction per
    l iterations).
    """

    reduce: str  # core.reduce strategy name
    spmv: str  # key into _DIST_SPMV
    equal_shards_only: bool  # allgather indexes by p*R: all shards one size
    pipeline_depth: int = 1  # iterations amortized per global reduction


_METHODS = {
    "h1": DistMethod(reduce="separate", spmv="allgather", equal_shards_only=True),
    "h2": DistMethod(reduce="packed", spmv="allgather", equal_shards_only=True),
    "h3": DistMethod(reduce="packed", spmv="halo", equal_shards_only=False),
    "h4": DistMethod(reduce="h4", spmv="halo", equal_shards_only=False),
    "pl2": DistMethod(reduce="packed", spmv="halo", equal_shards_only=False,
                      pipeline_depth=2),
    "pl3": DistMethod(reduce="packed", spmv="halo", equal_shards_only=False,
                      pipeline_depth=3),
}


def register_method(name: str, method: DistMethod, *, overwrite: bool = False) -> None:
    """Register a (reducer, spmv, depth) combination as a named method.
    Raises ValueError if ``name`` is taken, unless ``overwrite=True``."""
    if name in _METHODS and not overwrite:
        raise ValueError(
            f"distributed method {name!r} already registered; pass "
            f"overwrite=True to replace it"
        )
    if method.spmv not in _DIST_SPMV:
        raise ValueError(
            f"unknown SPMV strategy {method.spmv!r}; register it first via "
            f"register_dist_spmv (have {tuple(sorted(_DIST_SPMV))})"
        )
    if method.reduce not in reducer_names():
        raise ValueError(
            f"unknown reduction strategy {method.reduce!r}; register it first "
            f"via core.reduce.register_reducer (have {reducer_names()})"
        )
    if method.pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {method.pipeline_depth}")
    _METHODS[name] = method


def method_names() -> Tuple[str, ...]:
    return tuple(sorted(_METHODS))


def get_method(name: str) -> DistMethod:
    """Look up a registered distributed method."""
    if name not in _METHODS:
        raise ValueError(f"method must be one of {method_names()}, got {name}")
    return _METHODS[name]


def reductions_per_iteration(stats: dict) -> float:
    """All-reduce collectives per iteration of a solve's loop body, from a
    runner's ``last_stats`` (the communicator's counter of the collectives
    the loop tags "loop", over the iterations its steps advanced): h1 3,
    h2/h3 1, h4 2, pl2 1/2, pl3 1/3."""
    return stats["counts"].get("allreduce.loop", 0) / max(stats["steps"], 1)


# ---------------------------------------------------------------------------
# the distributed solver: one thread per shard around the shared loop
# ---------------------------------------------------------------------------

_SHARD_ENGINES = ("auto", "torch", "cuda")


def _shard_core_name(engine: str, device: torch.device) -> str:
    if engine == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return engine


def build_distributed_solver(
    As: ShardedDIA,
    *,
    mesh: SolverMesh,
    method: str = "h3",
    engine: str = "auto",
    maxiter: int = 10000,
    reducer: Optional[str] = None,
    spmv: Optional[str] = None,
    replace_every: int = 0,
    nrhs: Optional[int] = None,
    timeout: float = RENDEZVOUS_TIMEOUT_S,
):
    """Build (once) the solver of one sharded operator on ``mesh``.

    The set-up half of the plan/execute split: validation, strategy
    lookup, the per-shard bands and cores happen here; the returned
    ``runner(b_parts, inv_parts, atol, rtol, maxiter=None)`` only
    executes (``maxiter`` overrides the built one for one call).
    ``b_parts``/``inv_parts`` hold one block per shard on its device
    (``shard_vector``); the result's ``x`` is the tuple of per-shard
    blocks (``unshard_vector`` joins them) and the other fields are rank
    0's (every rank's are equal). ``runner.last_stats`` holds the last
    solve's wall seconds, per-shard loop seconds and wait seconds by
    collective kind, the communicator's counts and the steps taken;
    ``runner.shards`` holds each rank's :class:`ShardBlock`.
    ``timeout`` bounds every rendezvous (``core.comm``).

    ``reducer``/``spmv`` override the method's strategies;
    ``replace_every`` threads residual replacement through every method
    (recommended, e.g. 50, for ``pl2``/``pl3``). ``nrhs=k`` builds the
    batched solver: blocks of shape (k, rows), the loop over lanes inside
    every shard, each reduction carrying all k systems' partials.
    """
    cfg = get_method(method)
    depth = cfg.pipeline_depth
    reduce_name = cfg.reduce if reducer is None else reducer
    spmv_name = cfg.spmv if spmv is None else spmv
    if spmv_name not in _DIST_SPMV:
        raise ValueError(f"unknown SPMV strategy {spmv_name!r}; have {tuple(sorted(_DIST_SPMV))}")
    if engine not in _SHARD_ENGINES:
        if engine == "fused_iter":
            raise ValueError(
                "engine 'fused_iter' computes the whole SPMV inside its kernel, with no halo; "
                "a distributed solve runs the 'cuda' core (fused_vma) and the spmv_dia kernel "
                "on a card shard: use engine='auto' or 'cuda'"
            )
        raise ValueError(f"unknown engine {engine!r} for a distributed solve; "
                         f"have {_SHARD_ENGINES}")
    P = As.n_shards
    sizes = np.asarray(As.rows)
    hw = As.bandwidth
    equal = bool((sizes == sizes[0]).all())
    if (cfg.equal_shards_only or spmv_name in _EQUAL_ONLY_SPMV) and not equal:
        raise ValueError(f"{method} requires equal shards (use balanced_rows); sizes={sizes}")
    if mesh.n_shards != P:
        raise ValueError(f"mesh has {mesh.n_shards} devices but the operator is sharded {P} ways")
    if tuple(As.devices) != tuple(mesh.devices):
        raise ValueError(f"the blocks lie on {As.devices}, the mesh's devices are {mesh.devices}")
    if reducer_needs_subaxis(reduce_name) and mesh.sub is None:
        raise ValueError(
            f"reducer {reduce_name!r} is hierarchical and needs a 2-D (pod, sub) mesh; "
            "build one with make_solver_mesh(n_shards, sub=...)"
        )
    if not equal and int(sizes.min()) < hw:
        raise ValueError(
            f"bandwidth {hw} > shard rows {int(sizes.min())} needs equal shards for the "
            "multi-hop halo path (use balanced_rows)"
        )
    # halo reach: one hw slab when every shard holds hw rows, else whole
    # blocks from ceil(hw / rows) neighbours a side (equal shards)
    hops = None if int(sizes.min()) >= hw else -(-hw // int(sizes[0]))

    if depth > 1:
        if engine not in ("torch", "auto"):
            raise ValueError(
                f"deep-pipeline method {method!r} runs the coordinate loop (no {engine!r} core); "
                "use engine='torch'/'auto'"
            )
        loop = make_deep_pipecg_core(depth)
        cores = [None] * P
    else:
        loop = run_pipecg
        cores = [get_core(_shard_core_name(engine, d)) for d in mesh.devices]
    shards = [ShardBlock(As, p) for p in range(P)]
    raw_spmv = _DIST_SPMV[spmv_name]
    for shard in shards:  # build a card's bands once, outside every solve
        if shard.on_card:
            _ = (shard.gather_band if spmv_name == "allgather"
                 else (shard.local, shard.left_band, shard.right_band))
    if any(d.type == "cuda" for d in mesh.devices):
        from ..kernels.common import library

        library()  # build the kernels here, not inside a rendezvous

    default_maxiter = maxiter

    def runner(b_parts, inv_parts, atol: float = 1e-5, rtol: float = 0.0,
               maxiter: Optional[int] = None) -> SolveResult:
        iters = default_maxiter if maxiter is None else int(maxiter)
        want = [(s.rows,) if nrhs is None else (nrhs, s.rows) for s in shards]
        got = [tuple(b.shape) for b in b_parts]
        if got != want:
            raise ValueError(f"rhs blocks of shapes {got}, expected {want}")

        def shard_solve(comm: ShardComm):
            p = comm.rank
            shard, b, inv = shards[p], b_parts[p], inv_parts[p]
            kwargs = dict(
                spmv_fn=lambda v, active=None: raw_spmv(shard, v, comm, hops=hops, active=active),
                pc_fn=lambda r: inv * r,
                reducer=make_reducer(reduce_name, comm),
                inv_diag=inv,  # the Jacobi PC fused into the core
                atol=float(atol), rtol=float(rtol), maxiter=iters,
                replace_every=replace_every,
            )
            if cores[p] is not None:
                kwargs["core"] = cores[p]
            t0 = time.perf_counter()
            out = loop(b, torch.zeros_like(b), **kwargs)
            if shard.device.type == "cuda":
                torch.cuda.synchronize(shard.device)
            return out, time.perf_counter() - t0

        t0 = time.perf_counter()
        results, comm = mesh.run(shard_solve, timeout=timeout)
        wall = time.perf_counter() - t0
        (i, _, norm, conv, hist, steps), _ = results[0]
        runner.last_stats = {
            "wall_s": wall,
            "shard_s": [r[1] for r in results],
            "wait_s": [dict(w) for w in comm.wait_s],
            "counts": dict(comm.counts),
            "steps": steps,
        }
        return SolveResult(x=tuple(r[0][1] for r in results), iterations=i, residual_norm=norm,
                           converged=conv, history=hist, steps=steps)

    runner.pipeline_depth = depth
    runner.reduce_name = reduce_name
    runner.spmv_name = spmv_name
    runner.cores = tuple("coordinate" if c is None else _shard_core_name(engine, d)
                         for c, d in zip(cores, mesh.devices))
    runner.hops = hops
    runner.shards = tuple(shards)
    runner.last_stats = None
    return runner


def pipecg_distributed(
    As: ShardedDIA,
    b_parts,
    inv_parts,
    *,
    mesh: SolverMesh,
    method: str = "h3",
    engine: str = "auto",
    atol: float = 1e-5,
    rtol: float = 0.0,
    maxiter: int = 10000,
    reducer: Optional[str] = None,
    spmv: Optional[str] = None,
    replace_every: int = 0,
) -> SolveResult:
    """One-shot distributed PIPECG on a row-sharded banded A: builds the
    solver (:func:`build_distributed_solver`) and runs it once.

    As        — ShardedDIA from ``shard_dia(A, bounds, mesh.devices)``
                (halo methods take performance-model, unequal partitions;
                allgather methods equal ones).
    b_parts   — the rhs blocks (``shard_vector(b, bounds, mesh.devices)``).
    inv_parts — the Jacobi inverse diagonal's blocks (ones for no PC).
    Returns a SolveResult whose x is the tuple of per-shard blocks; join
    them with ``unshard_vector``.
    """
    runner = build_distributed_solver(
        As, mesh=mesh, method=method, engine=engine, maxiter=maxiter,
        reducer=reducer, spmv=spmv, replace_every=replace_every,
    )
    return runner(b_parts, inv_parts, atol, rtol)
