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

// ---- lane-batched entry: Y[l] = A X[l] for k right-hand sides (f32) -------
//
// Replaces src/repro/kernels/spmv_dia/kernel.py:spmv_dia_padded in f32, and
// the same kernel under jax.vmap (init, residual replacement and the "cuda"
// engine of a batched solve on a DIA operator); one vector is k = 1.
//
// Bound on this card: bytes, k_diag * 4 + 8 K bytes a row: the band is read
// once for all K lanes. Design: the row loop above with K sums in
// registers, each in diagonal order (so independent of K), x staged
// in shared memory run by run of nearby diagonals (dia_lanes_sum in
// common.cuh; gathering it through L1 per diagonal and lane ran at 28% of
// the bound at K = 8). A lane whose flag is 0 reads nothing and gets
// Y[l] = 0, as spmv_bell gives a converged solve; with no flag every lane
// is computed.
template <int K>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_dia_lanes_kernel(const __grid_constant__ DiagRuns runs, const float* __restrict__ data,
                      const float* __restrict__ x, const uint8_t* __restrict__ active,
                      float* __restrict__ y, int64_t n) {
  __shared__ float win[K * (REPRO_BLOCK + REPRO_RUN_SPAN)];
  const int64_t i0 = (int64_t)blockIdx.x * REPRO_BLOCK;
  const int64_t i = i0 + threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.f;
  if (live != 0) dia_lanes_sum<K>(runs, data, x, live, i0, n, acc, win);
  if (i >= n) return;
#pragma unroll
  for (int l = 0; l < K; ++l) y[(int64_t)l * n + i] = ((live >> l) & 1u) ? acc[l] : 0.f;
}

extern "C" int spmv_dia_lanes_f32(const int* offsets, int k, int lanes, const void* data,
                                  const void* x, const void* active, void* y, int64_t n,
                                  void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n < 0 || lanes < 1 || lanes > REPRO_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const DiagRuns offs = make_runs(offsets, k);
  const unsigned blocks = (unsigned)repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)data;
  const float* xs = (const float*)x;
  const uint8_t* act = (const uint8_t*)active;
  float* ys = (float*)y;
  switch (lanes) {
    case 1: spmv_dia_lanes_kernel<1><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 2: spmv_dia_lanes_kernel<2><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 3: spmv_dia_lanes_kernel<3><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 4: spmv_dia_lanes_kernel<4><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 5: spmv_dia_lanes_kernel<5><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 6: spmv_dia_lanes_kernel<6><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 7: spmv_dia_lanes_kernel<7><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
    case 8: spmv_dia_lanes_kernel<8><<<blocks, REPRO_BLOCK, 0, st>>>(offs, d, xs, act, ys, n); break;
  }
  return (int)cudaGetLastError();
}
