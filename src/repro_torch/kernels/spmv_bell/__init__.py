from .ops import spmv_bell_batched, spmv_bell_cuda
from .ref import spmv_bell_batched_ref, spmv_bell_ref

__all__ = ['spmv_bell_batched', 'spmv_bell_batched_ref', 'spmv_bell_cuda', 'spmv_bell_ref']
