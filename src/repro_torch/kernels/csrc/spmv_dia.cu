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
// version. These entries take bf16 storage; f32 goes through the lane
// entry below, a single vector being one lane.
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

int spmv_dia_bf16_f32(const int* offsets, int k, const void* data, const void* x, void* y,
                      int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, float>(offsets, k, data, x, y, n, stream);
}

int spmv_dia_bf16_bf16(const int* offsets, int k, const void* data, const void* x, void* y,
                       int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, __nv_bfloat16>(offsets, k, data, x, y, n, stream);
}

}  // extern "C"

// ---- lane-batched entries: Y[l] = A X[l] for k right-hand sides ----------
//
// Replaces src/repro/kernels/spmv_dia/kernel.py:spmv_dia_padded, and the
// same kernel under jax.vmap (init, residual replacement and the "cuda"
// engine of a batched solve on a DIA operator; the "bf16" engine's SPMV of
// a batched solve); one vector is k = 1. data and X are both f32 or both
// bf16; the sums are f32 and Y is f32 (spmv_dia_bf16's out_dtype=acc).
//
// Bound on this card: bytes, k_diag * s + 4 (s + 1) K bytes a row (s the
// storage's bytes): the band is read once for all K lanes. Design: the row
// loop above with K sums in registers, each in diagonal order (so
// independent of K, and lane l's bits are the single kernel's on X[l]),
// X staged group by group of nearby diagonals in a lane-interleaved window
// in shared memory (dia_lanes_sum in common.cuh, as fused_iter; bf16 is
// converted to f32 on its way in, through registers, since cp.async copies
// 4 bytes at least). A lane whose flag is 0 reads nothing and gets
// Y[l] = 0, as spmv_bell gives a converged solve; with no flag every lane
// is computed.
template <int K, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_dia_lanes_kernel(const __grid_constant__ DiagRuns runs, const T* __restrict__ data,
                      const T* __restrict__ x, const uint8_t* __restrict__ active,
                      float* __restrict__ y, int64_t n) {
  extern __shared__ __align__(16) float repro_smem[];
  const int64_t i0 = (int64_t)blockIdx.x * REPRO_BLOCK;
  const int64_t i = i0 + threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.f;
  if (live != 0) dia_lanes_sum<K>(runs, data, x, live, i0, n, acc, repro_smem);
  if (i >= n) return;
#pragma unroll
  for (int l = 0; l < K; ++l) y[(int64_t)l * n + i] = ((live >> l) & 1u) ? acc[l] : 0.f;
}

template <int K, typename T>
static cudaError_t launch_dia_lanes(const int* offsets, int k, const void* data, const void* x,
                                    const void* active, void* y, int64_t n, cudaStream_t st) {
  static std::atomic<int> raised{0};
  const DiagRuns runs = lane_runs<K>(offsets, k);
  const size_t smem = dia_window_bytes<K>(runs);
  const cudaError_t err = allow_shared(spmv_dia_lanes_kernel<K, T>, smem, &raised);
  if (err != cudaSuccess) return err;
  spmv_dia_lanes_kernel<K, T><<<(unsigned)repro_blocks(n), REPRO_BLOCK, smem, st>>>(
      runs, (const T*)data, (const T*)x, (const uint8_t*)active, (float*)y, n);
  return cudaGetLastError();
}

template <typename T>
static int spmv_dia_lanes(const int* offsets, int k, int lanes, const void* data, const void* x,
                          const void* active, void* y, int64_t n, void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n < 0 || lanes < 1 || lanes > REPRO_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_DIA_LANES(K) \
  case K: err = launch_dia_lanes<K, T>(offsets, k, data, x, active, y, n, st); break;
  switch (lanes) {
    REPRO_DIA_LANES(1)
    REPRO_DIA_LANES(2)
    REPRO_DIA_LANES(3)
    REPRO_DIA_LANES(4)
    REPRO_DIA_LANES(5)
    REPRO_DIA_LANES(6)
    REPRO_DIA_LANES(7)
    REPRO_DIA_LANES(8)
  }
#undef REPRO_DIA_LANES
  return (int)err;
}

extern "C" {

int spmv_dia_lanes_f32(const int* offsets, int k, int lanes, const void* data, const void* x,
                       const void* active, void* y, int64_t n, void* stream) {
  return spmv_dia_lanes<float>(offsets, k, lanes, data, x, active, y, n, stream);
}

int spmv_dia_lanes_bf16_f32(const int* offsets, int k, int lanes, const void* data,
                            const void* x, const void* active, void* y, int64_t n,
                            void* stream) {
  return spmv_dia_lanes<__nv_bfloat16>(offsets, k, lanes, data, x, active, y, n, stream);
}

}  // extern "C"
