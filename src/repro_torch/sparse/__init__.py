from .formats import DIAMatrix
from .spmv import (
    register_spmv,
    resolve_engine,
    shifted,
    spmv,
    spmv_dia,
    spmv_dia_bf16,
    spmv_engines,
)
from .stencil import poisson7, poisson27, poisson125, poisson_dia, stencil_offsets

__all__ = [
    "DIAMatrix",
    "poisson7",
    "poisson27",
    "poisson125",
    "poisson_dia",
    "register_spmv",
    "resolve_engine",
    "shifted",
    "spmv",
    "spmv_dia",
    "spmv_dia_bf16",
    "spmv_engines",
    "stencil_offsets",
]
