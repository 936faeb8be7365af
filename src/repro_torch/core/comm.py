"""The solver mesh: one host thread per shard, and in-process collectives.

The JAX package runs a distributed solve as one ``shard_map``-ped program
over a device mesh, and its collectives are ``psum``, ``all_gather``,
``ppermute`` and ``axis_index``. The port runs the same SPMD shape in one
process: :class:`SolverMesh` holds one ``torch.device`` per shard (the
card and the host's cores may mix: the paper's CPU+GPU layout), and
:meth:`SolverMesh.run` starts one host thread per shard, each running the
shared solver loop on its own block. Torch ops and the kernels' ``ctypes``
calls release the interpreter lock, so host shards and the card overlap.

:class:`Communicator` is the counterpart of those collectives. Every
collective is split into a *post*, which hands this rank's tensor over
and returns at once, and a *wait*, which blocks until the ranks it needs
have posted and returns the result on this rank's device. Between the
two a rank runs whatever does not depend on the result: the SPMV the
paper overlaps with the dot reduction, or the local band of the halo
SPMV. The k-th collective one rank posts meets the k-th of every other
rank (SPMD); a rank that posts another kind there raises.

* A card rank's post copies its tensor to pinned host memory without
  blocking and records a CUDA event; the host reads it after the event.
  A host rank's post takes a copy, so later in-place updates cannot
  reach what its peers read; with a card in the mesh that copy, and
  every all-reduce result, is pinned, so the copy to the card is
  asynchronous too and the card's thread does not wait for its stream.
* An all-reduce is added once, on the host, in rank order with ``+``
  (the hierarchical form adds each pod in rank order, then the pod sums
  in pod order), and every rank gets those same bits on its device. Each
  rank's convergence test then reads the same numbers, so no shard stops
  while another waits. Over a mesh with named axes an all-reduce may sum
  over some of them only (``psum(t, "model")``): each group of ranks that
  share their other coordinates adds in rank order, and the whole is one
  collective.
* No hang: a rank that raises aborts the communicator, and every wait
  then raises :class:`MeshAborted`; every wait gives up after
  ``RENDEZVOUS_TIMEOUT_S`` (a first call may build the CUDA kernels
  inside it, which takes a minute or two). :meth:`SolverMesh.run`
  re-raises the first rank's error in the caller.

Counters: ``counts`` (collectives by kind, and by ``kind.tag``: the solver
loops tag the reductions of their loop body "loop"), ``coll_bytes`` (each
collective's result bytes a rank, by kind and group size: what a wire-byte
model reads), and per rank the seconds spent blocked in waits, by kind
(``wait_s``). On ``meta`` tensors a collective stages nothing and returns
the rank's own part: shapes only, for a program that is counted, not run.
"""
from __future__ import annotations

import math
import threading
import time
from collections import Counter, defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "RENDEZVOUS_TIMEOUT_S",
    "MeshAborted",
    "SolverMesh",
    "Communicator",
    "ShardComm",
]

RENDEZVOUS_TIMEOUT_S = 300.0  # a rank waits this long for its peers, then the solve raises


class MeshAborted(RuntimeError):
    """A peer rank failed (or a rendezvous timed out): this rank stops."""


class _Part:
    """One rank's posted tensor, staged where the host can read it."""

    __slots__ = ("tensor", "event")

    def __init__(self, t: torch.Tensor, pin: bool):
        self.event = None
        if t.is_meta:  # shapes only: nothing to stage or protect (and no op to count)
            self.tensor = t
            return
        t = t.detach()
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
            self.tensor = host
        elif pin:  # a card reads it: pinned, so its copy to the card does not block
            self.tensor = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.tensor.copy_(t)
        else:
            self.tensor = t.clone()

    def host(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.tensor


class _Slot:
    __slots__ = ("kind", "parts", "posted", "waited", "lock", "result")

    def __init__(self, kind: str, n: int):
        self.kind = kind
        self.parts: List[Optional[_Part]] = [None] * n
        self.posted = 0
        self.waited = 0
        self.lock = threading.Lock()
        self.result = None


_NOTHING = object()  # a posted "nothing" (a shift whose receiver is off the edge)


class Handle:
    """A posted collective; :meth:`wait` returns its result on this rank's device."""

    def __init__(self, comm: "Communicator", rank: int, seq: int, finish: Callable):
        self._comm, self._rank, self._seq, self._finish = comm, rank, seq, finish

    def wait(self):
        return self._comm._wait(self._rank, self._seq, self._finish)


class Communicator:
    """Collectives of one run over a :class:`SolverMesh` (see the module
    docstring); rank r talks through ``comm.rank(r)``."""

    def __init__(self, mesh: "SolverMesh", timeout: float = RENDEZVOUS_TIMEOUT_S):
        self.mesh = mesh
        self.n = mesh.n_shards
        self.timeout = float(timeout)
        self.counts: Counter = Counter()
        self.coll_bytes: Counter = Counter()  # (kind, group size) -> result bytes a rank
        self.wait_s = [defaultdict(float) for _ in range(self.n)]
        self._cv = threading.Condition()
        self._slots: dict = {}
        self._seq = [0] * self.n
        self._error: Optional[BaseException] = None
        # with a card in the mesh, every staged tensor is pinned host memory
        self.pin = any(d.type == "cuda" for d in mesh.devices)
        # on meta nothing runs in parallel: the ranks take turns, handing over
        # in each wait, rather than trade the interpreter lock at every op
        self.turn = (threading.Lock() if all(d.type == "meta" for d in mesh.devices)
                     else None)

    def rank(self, r: int) -> "ShardComm":
        return ShardComm(self, r)

    def abort(self, error: BaseException) -> None:
        """Wake every waiting rank with :class:`MeshAborted`."""
        with self._cv:
            if self._error is None:
                self._error = error
            self._cv.notify_all()

    # -- the rendezvous ----------------------------------------------------

    def _post(self, rank: int, kind: str, tensor, count: int = 1, tag: str = "",
              payload=()) -> int:
        """Post rank's part of its next collective; rank 0 also counts it
        (``count`` collectives) and adds ``payload``, ((group size, result
        bytes a rank), ...), to ``coll_bytes``."""
        part = _NOTHING if tensor is None else _Part(tensor, self.pin)
        with self._cv:
            if self._error is not None:
                raise MeshAborted(f"rank {rank}: a peer failed") from self._error
            seq = self._seq[rank]
            self._seq[rank] += 1
            slot = self._slots.get(seq)
            if slot is None:
                slot = self._slots[seq] = _Slot(kind, self.n)
            elif slot.kind != kind:
                err = RuntimeError(f"rank {rank} posted {kind!r} where a peer posted "
                                   f"{slot.kind!r} (collective {seq}): the ranks diverged")
                self._error = err
                self._cv.notify_all()
                raise err
            slot.parts[rank] = part
            slot.posted += 1
            if rank == 0:
                self.counts[kind] += count
                if tag:
                    self.counts[f"{kind}.{tag}"] += count
                for group, nbytes in payload:
                    self.coll_bytes[(kind, group)] += nbytes
            if slot.posted == self.n:  # waiters need every part: wake them once
                self._cv.notify_all()
        return seq

    def _wait(self, rank: int, seq: int, finish: Callable):
        t0 = time.perf_counter()
        deadline = t0 + self.timeout
        if self.turn is not None:
            self.turn.release()
        try:
            with self._cv:
                slot = self._slots[seq]
                while slot.posted < self.n:
                    if self._error is not None:
                        raise MeshAborted(f"rank {rank}: a peer failed") from self._error
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        err = TimeoutError(
                            f"rank {rank} waited {self.timeout:.0f} s for its peers at "
                            f"collective {seq} ({slot.kind}); posted: "
                            f"{[r for r, p in enumerate(slot.parts) if p is not None]}")
                        self._error = err
                        self._cv.notify_all()
                        raise err
                    self._cv.wait(left)
        finally:
            if self.turn is not None:
                self.turn.acquire()
        out = finish(slot)
        with self._cv:
            slot.waited += 1
            if slot.waited == self.n:
                del self._slots[seq]
        self.wait_s[rank][slot.kind] += time.perf_counter() - t0
        return out


def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class ShardComm:
    """Rank ``rank``'s side of a :class:`Communicator` (the counterpart of
    a mesh axis name inside ``shard_map``: ``axis_index`` is ``.rank``)."""

    def __init__(self, comm: Communicator, rank: int):
        self.comm = comm
        self.rank = rank
        self.device = comm.mesh.devices[rank]

    @property
    def n_shards(self) -> int:
        return self.comm.n

    @property
    def sub(self) -> Optional[int]:
        return self.comm.mesh.sub

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on the mesh axis ``name``."""
        return self.comm.mesh.coords(self.rank)[name]

    def allreduce(self, t: torch.Tensor, *, hierarchical: bool = False, axes=None,
                  tag: str = "") -> Handle:
        """Post ``t`` to a sum over all ranks (``psum``). ``hierarchical``
        adds within each pod of ``sub`` ranks first, then across pods:
        two collectives, counted as two. ``axes`` (a mesh axis name, or a
        tuple of them) sums only over the ranks that share this rank's
        coordinates on the other axes (``psum(t, axes)``), in rank order:
        one collective."""
        if hierarchical and self.sub is None:
            raise ValueError("a hierarchical all-reduce needs a (pod, sub) mesh "
                             "(make_solver_mesh(n, sub=...))")
        if hierarchical and axes is not None:
            raise ValueError("an all-reduce is hierarchical or over named axes, not both")
        group = None if axes is None else self.comm.mesh.group(self.rank, axes)
        nbytes = t.numel() * t.element_size()
        if hierarchical:
            payload = ((self.sub, nbytes), (self.n_shards // self.sub, nbytes))
        else:
            payload = ((self.n_shards if group is None else len(group), nbytes),)
        seq = self.comm._post(self.rank, "allreduce", t, 2 if hierarchical else 1, tag, payload)
        sub, dev = self.sub, self.device

        def finish(slot):
            if t.is_meta:  # every group's sum has the shape of its parts
                return slot.parts[self.rank].tensor
            with slot.lock:
                if group is not None:  # one sum a group, in rank order
                    if slot.result is None:
                        slot.result = {}
                    if group not in slot.result:
                        total = _sum_in_order([slot.parts[r].host() for r in group])
                        slot.result[group] = total.pin_memory() if self.comm.pin else total
                    return slot.result[group].to(dev, non_blocking=True)
                if slot.result is None:
                    parts = [p.host() for p in slot.parts]
                    if hierarchical:
                        pods = [_sum_in_order(parts[i:i + sub]) for i in range(0, len(parts), sub)]
                        total = _sum_in_order(pods)
                    else:
                        total = _sum_in_order(parts)
                    slot.result = total.pin_memory() if self.comm.pin else total
            return slot.result.to(dev, non_blocking=True)

        return Handle(self.comm, self.rank, seq, finish)

    def allgather(self, t: torch.Tensor) -> Handle:
        """Post ``t``; the wait returns every rank's tensor, in rank order,
        on this rank's device (its own as it was posted)."""
        n, nbytes = self.n_shards, t.numel() * t.element_size()
        seq = self.comm._post(self.rank, "allgather", t, payload=((n, n * nbytes),))
        rank, dev = self.rank, self.device

        def finish(slot):
            return [t if r == rank else p.host().to(dev, non_blocking=True)
                    for r, p in enumerate(slot.parts)]

        return Handle(self.comm, self.rank, seq, finish)

    def shift(self, t: torch.Tensor, d: int) -> Handle:
        """Receive rank ``rank + d``'s ``t`` and send this rank's to
        ``rank - d`` (one ``ppermute``); the wait returns the received
        tensor on this rank's device, or None at the edge of the ring."""
        n, rank, dev = self.n_shards, self.rank, self.device
        receiver = 0 <= rank - d < n
        seq = self.comm._post(rank, "shift", t if receiver else None,
                              payload=((n, t.numel() * t.element_size()),))
        src = rank + d

        def finish(slot):
            if not 0 <= src < n:
                return None
            return slot.parts[src].host().to(dev, non_blocking=True)

        return Handle(self.comm, rank, seq, finish)


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the current card's "cuda:i": what a tensor's device
    reads, and what ``torch.cuda.set_device`` takes."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class SolverMesh:
    """One ``torch.device`` per shard, optionally as a (pod, sub) grid or
    as a grid of named axes.

    ``devices`` lists the shards' devices in rank order (a device may
    repeat: several host shards, or several shards on one card). With
    ``sub=k`` the ranks form ``n // k`` pods of k consecutive ranks, the
    2-D mesh the hierarchical "h4" reducer needs; the linear rank order is
    kept, so every SPMV strategy keeps its ring order. ``axes`` (an
    ordered {name: size} mapping whose sizes multiply to the shard count)
    lays the ranks out row-major over named axes, as a ``shard_map`` mesh
    (``launch/mesh.py``), for all-reduces over some of them.
    """

    def __init__(self, devices: Sequence, sub: Optional[int] = None, axes=None):
        self.devices: Tuple[torch.device, ...] = tuple(_indexed(torch.device(d))
                                                       for d in devices)
        n = len(self.devices)
        if n < 1:
            raise ValueError("a mesh needs at least one device")
        if sub is not None and (sub < 1 or n % sub):
            raise ValueError(f"sub-axis size {sub} must divide the shard count {n} "
                             "(pods of equal size)")
        if axes is not None and (sub is not None or math.prod(axes.values()) != n):
            raise ValueError(f"named axes {dict(axes)} must multiply to the shard count {n}, "
                             "without sub")
        self.sub = sub
        self.axes = None if axes is None else dict(axes)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.axes is not None:
            return tuple(self.axes.values())
        return (self.n_shards,) if self.sub is None else (self.n_shards // self.sub, self.sub)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        if self.axes is not None:
            return tuple(self.axes)
        return ("rows",) if self.sub is None else ("pod", "rows")

    def coords(self, rank: int) -> dict:
        """{axis name: coordinate} of ``rank`` (row-major over the axes)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.shape))):
            rank, out[name] = divmod(rank, size)
        return {name: out[name] for name in self.axis_names}

    def group(self, rank: int, axes) -> Tuple[int, ...]:
        """The ranks, in order, that share ``rank``'s coordinates on every
        axis but ``axes`` (a name or a tuple of names): a ``psum(., axes)``
        group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axis {sorted(unknown)} in {self.axis_names}")
        mine = self.coords(rank)
        return tuple(r for r in range(self.n_shards)
                     if all(c == mine[a] for a, c in self.coords(r).items() if a not in axes))

    def run(self, fn: Callable[[ShardComm], object],
            timeout: float = RENDEZVOUS_TIMEOUT_S) -> Tuple[list, Communicator]:
        """Run ``fn(shard_comm)`` on one host thread per rank; returns the
        per-rank results in rank order and the communicator (its counters).
        The first rank's error is raised here after every thread stopped or
        ``timeout`` passed."""
        comm = Communicator(self, timeout)
        results: list = [None] * self.n_shards
        errors: List[Optional[BaseException]] = [None] * self.n_shards

        def body(rank: int) -> None:
            if comm.turn is not None:
                comm.turn.acquire()
            try:
                dev = self.devices[rank]
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                results[rank] = fn(comm.rank(rank))
            except BaseException as e:  # noqa: BLE001 - handed to the caller below
                errors[rank] = e
                comm.abort(e)
            finally:
                if comm.turn is not None:
                    comm.turn.release()

        threads = [threading.Thread(target=body, args=(r,), name=f"solver-shard-{r}", daemon=True)
                   for r in range(self.n_shards)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                while t.is_alive():
                    t.join(0.5)
                    if comm._error is not None:
                        # a rank failed: the others leave their next wait; give
                        # one still inside a long native call the timeout
                        t.join(comm.timeout)
                        break
        except BaseException as e:
            comm.abort(e)
            raise
        failed = [e for e in errors if e is not None]
        if failed or comm._error is not None:
            first = next((e for e in failed if not isinstance(e, MeshAborted)),
                         failed[0] if failed else comm._error)
            raise first
        if any(t.is_alive() for t in threads):
            raise TimeoutError("a shard thread did not finish")
        return results, comm

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"SolverMesh([{devs}], shape={self.shape})"
