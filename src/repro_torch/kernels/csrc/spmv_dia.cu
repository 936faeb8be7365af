// Banded (DIA) SPMV: y[i] = sum_j data[j, i] * x[i + off_j], zero outside [0, n).
//
// Replaces the TPU kernel src/repro/kernels/spmv_dia/kernel.py:spmv_dia_padded.
//
// Bound on this card: bytes. Per row it reads k diagonal entries and
// one x, and writes one y (f32, k = 125: 508 B/row), against 2k flops,
// far below the H100's operations-per-byte line.
//
// Design: one thread per row; the loop over the k diagonals reads
// data row-major (k, n), so each diagonal's read is coalesced across
// the warp; x[i + off] is read straight from global memory and the
// L1/L2 caches serve its reuse between neighbouring diagonals (the
// TPU kernel's three-tile window and its "tile >= bandwidth" rule are
// BlockSpec artifacts and are not carried over). The column is guarded
// explicitly: the DIA zero convention makes the product 0, but does
// not make an out-of-range load legal. Accumulation is f32 for f32 and
// bf16 storage alike, in the order of the diagonals, as in the plain
// version.
#include "common.cuh"

template <typename T, typename OutT>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_dia_kernel(const __grid_constant__ DiagOffsets offs, const T* __restrict__ data,
                const T* __restrict__ x, OutT* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int j = 0; j < offs.k; ++j) {
    const int64_t c = i + offs.off[j];
    const float xv = (c >= 0 && c < n) ? to_f32(x[c]) : 0.f;
    acc += to_f32(data[(int64_t)j * n + i]) * xv;
  }
  y[i] = from_f32<OutT>(acc);
}

template <typename T, typename OutT>
static int launch_spmv(const int* offsets, int k, const void* data, const void* x, void* y,
                       int64_t n, void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const DiagOffsets offs = make_offsets(offsets, k);
  spmv_dia_kernel<T, OutT><<<(unsigned)repro_blocks(n), REPRO_BLOCK, 0, (cudaStream_t)stream>>>(
      offs, (const T*)data, (const T*)x, (OutT*)y, n);
  return (int)cudaGetLastError();
}

extern "C" {

int spmv_dia_f32_f32(const int* offsets, int k, const void* data, const void* x, void* y,
                     int64_t n, void* stream) {
  return launch_spmv<float, float>(offsets, k, data, x, y, n, stream);
}

int spmv_dia_bf16_f32(const int* offsets, int k, const void* data, const void* x, void* y,
                      int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, float>(offsets, k, data, x, y, n, stream);
}

int spmv_dia_bf16_bf16(const int* offsets, int k, const void* data, const void* x, void* y,
                       int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, __nv_bfloat16>(offsets, k, data, x, y, n, stream);
}

}  // extern "C"
