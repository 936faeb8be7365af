from .ops import spmv_dia_cuda
from .ref import spmv_dia_ref

__all__ = ["spmv_dia_cuda", "spmv_dia_ref"]
