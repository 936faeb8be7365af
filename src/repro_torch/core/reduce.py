"""Reduction strategies for the PIPECG dot products.

One PIPECG iteration produces three scalar partials — gamma = (r, u),
delta = (w, u) and ||u||^2 = (u, u). How they become global scalars is
the axis along which the paper's hybrid methods differ, so it is a
strategy the solver loops take (``core.iteration.run_pipecg``):

``local``     identity: the partials already are the global dots
              (single device).
``separate``  three all-reduces (Hybrid-PIPECG-1: the paper's three
              separate copies; 3 collectives a step).
``packed``    the three partials stacked into one length-3 all-reduce
              (Hybrid-PIPECG-2/3: 3 collectives -> 1).
``h4``        hierarchical, on a (pod, sub) mesh: one packed sum within
              each pod, then one across pods (2 collectives a step). The
              result is consumed only at the next iteration's scalar step,
              so the slack of the pipelined recurrence hides both.

A mesh reducer is bound to one rank's side of the communicator
(``core.comm.ShardComm``, the counterpart of the JAX package's mesh axis
name) and is split in two: ``reducer.post(g, d, nn)`` hands the partials
over and returns ``wait``, which returns the sums. ``run_pipecg`` posts
before the SPMV of line 22 and waits after it: that is the overlap the
paper is about. Calling the reducer posts and waits at once. Every
reducer also has ``.array``: the same strategy on one stacked array,
which the depth-l loops (``make_deep_pipecg_core``) reduce once per l
iterations. The loop body's reductions are tagged "loop" in the
communicator's counters.

New strategies plug in through ``register_reducer``; factories flagged
``needs_subaxis = True`` (like ``h4``) need a mesh built with ``sub=``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "Reducer",
    "make_reducer",
    "register_reducer",
    "reducer_names",
    "reducer_needs_subaxis",
]

# A Reducer maps the three local dot partials to the three global dots.
Reducer = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _local(g, d, nn):
    return g, d, nn


_local.array = lambda a: a


class _MeshReducer:
    """``separate``, ``packed`` or ``h4`` on one rank of a mesh."""

    def __init__(self, comm, packed: bool, hierarchical: bool = False):
        self.comm = comm
        self.packed = packed
        self.hierarchical = hierarchical

    def post(self, g, d, nn, tag: str = "loop") -> Callable[[], Tuple]:
        comm = self.comm
        if not self.packed:
            handles = [comm.allreduce(v, tag=tag) for v in (g, d, nn)]
            return lambda: tuple(h.wait() for h in handles)
        handle = comm.allreduce(torch.stack([g, d, nn]), hierarchical=self.hierarchical, tag=tag)

        def wait():
            packed = handle.wait()
            return packed[0], packed[1], packed[2]

        return wait

    def __call__(self, g, d, nn):
        return self.post(g, d, nn, tag="setup")()

    def array(self, a: torch.Tensor) -> torch.Tensor:
        # one array is one collective under "separate" too
        return self.comm.allreduce(a, hierarchical=self.hierarchical, tag="loop").wait()


def _hierarchical(comm):
    if comm is None or getattr(comm, "sub", None) is None:
        raise ValueError(
            "reduction strategy 'h4' needs a 2-D mesh: build one with "
            "make_solver_mesh(n, sub=...)"
        )
    return _MeshReducer(comm, packed=True, hierarchical=True)


_hierarchical.needs_subaxis = True

# factory(comm) -> Reducer; comm is None for strategies that need no mesh,
# one rank's ShardComm otherwise
_REDUCERS: Dict[str, Callable] = {
    "local": lambda comm: _local,
    "separate": lambda comm: _MeshReducer(comm, packed=False),
    "packed": lambda comm: _MeshReducer(comm, packed=True),
    "h4": _hierarchical,
}


def register_reducer(name: str, factory: Callable, *, overwrite: bool = False) -> None:
    """Register a reduction strategy: ``factory(comm) -> Reducer``.

    The reducer should also expose ``.array`` (the strategy on one stacked
    array) for the depth-l loops, and may expose ``.post`` (split phase);
    flag the factory ``needs_subaxis = True`` when it needs a (pod, sub)
    mesh. Raises ValueError if ``name`` is taken, unless ``overwrite=True``.
    """
    if name in _REDUCERS and not overwrite:
        raise ValueError(
            f"reduction strategy {name!r} already registered; pass overwrite=True to replace it"
        )
    _REDUCERS[name] = factory


def reducer_names() -> Tuple[str, ...]:
    return tuple(sorted(_REDUCERS))


def reducer_needs_subaxis(strategy: str) -> bool:
    """True if ``strategy`` needs a 2-D (pod, sub) mesh (e.g. "h4")."""
    if strategy not in _REDUCERS:
        raise ValueError(f"unknown reduction strategy {strategy!r}; have {reducer_names()}")
    return bool(getattr(_REDUCERS[strategy], "needs_subaxis", False))


def make_reducer(strategy: str, axis=None) -> Reducer:
    """Build the Reducer for ``strategy`` on one rank's communicator
    ``axis`` (a ``core.comm.ShardComm``; None for "local")."""
    if strategy not in _REDUCERS:
        raise ValueError(f"unknown reduction strategy {strategy!r}; have {reducer_names()}")
    if strategy != "local" and axis is None:
        raise ValueError(f"reduction strategy {strategy!r} needs a mesh (a rank's ShardComm)")
    return _REDUCERS[strategy](axis)
