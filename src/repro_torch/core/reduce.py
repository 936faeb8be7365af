"""Reduction strategies for the PIPECG dot products.

One PIPECG iteration produces three scalar partials — gamma = (r, u),
delta = (w, u) and ||u||^2 = (u, u). How they become global scalars is
the axis along which the paper's hybrid methods differ. Only ``local``
(single device: the partials already are the global dots) is ported;
the mesh reducers wait for the distributed slice.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["Reducer", "make_reducer", "reducer_names"]

Reducer = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _local(g, d, nn):
    return g, d, nn


_REDUCERS = {"local": _local}


def reducer_names() -> Tuple[str, ...]:
    return tuple(sorted(_REDUCERS))


def make_reducer(strategy: str) -> Reducer:
    if strategy not in _REDUCERS:
        raise ValueError(f"unknown reduction strategy {strategy!r}; have {reducer_names()}")
    return _REDUCERS[strategy]
