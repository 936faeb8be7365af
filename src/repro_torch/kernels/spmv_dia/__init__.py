from .ops import spmv_dia_batched, spmv_dia_batched_bf16, spmv_dia_cuda
from .ref import spmv_dia_batched_bf16_ref, spmv_dia_batched_ref, spmv_dia_ref

__all__ = ['spmv_dia_batched', 'spmv_dia_batched_bf16', 'spmv_dia_batched_bf16_ref',
           'spmv_dia_batched_ref', 'spmv_dia_cuda', 'spmv_dia_ref']
