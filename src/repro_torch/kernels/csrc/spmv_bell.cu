// Block-ELLPACK SPMV: y[i] = sum_r vals[i, r] * x[cols[i, r]], f32 accumulation,
// output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/spmv_bell/kernel.py:spmv_bell_padded.
//
// Bound on this card: bytes. Per row it reads R int32 column indices and
// R values (f32, R = 79: 632 B/row), one x and writes one y, for 2R
// flops, far below the H100's operations-per-byte line.
//
// Design: the operator is row-major (n, R), so a group of G lanes (a
// power of two, 32 when R > 16) works on one row: lane l reads slots l,
// l + G, ..., and neighbouring lanes read neighbouring 4-byte slots of
// one row, where one thread per row would read with a stride of 4R bytes.
// x is gathered through the read-only path (__ldg); the columns of
// neighbouring rows of a banded matrix overlap, so x comes back from L1
// or L2. The G lane sums reduce in a fixed xor-shuffle tree, so every run
// gives the same bits. Padding slots (column 0, value 0) add 0 like any
// other slot. x stays in global memory, so any row count is taken: the TPU
// kernel's 2M-row VMEM limit has no counterpart here. The grid is one
// wave (8 blocks of 256 threads per SM) that strides over the rows, so
// when the device flag `active` is 0 (the solve has converged and the
// host has not polled yet) the launch costs one wave, not 500k blocks:
// the kernel then reads nothing and writes y = 0. Its entry takes bf16;
// its f32 instance is the lane entry's k = 1 (one vector) below.
#include "common.cuh"

#define BELL_BLOCKS_PER_SM 8

template <int G, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_bell_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ x, const uint8_t* __restrict__ active,
                 T* __restrict__ y, int64_t n, int R) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two <= 32");
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t stride = (int64_t)gridDim.x * rows_per_block;
  const int64_t first = (int64_t)blockIdx.x * rows_per_block + threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  if (active != nullptr && *active == 0) {  // the same branch for every thread
    for (int64_t row = first; row < n; row += stride)
      if (lane == 0) y[row] = from_f32<T>(0.f);
    return;
  }
  // the loop bound is the block's first row, so every lane of a warp runs
  // the same trips and takes part in the shuffles; rows past n add 0
  for (int64_t block_row = (int64_t)blockIdx.x * rows_per_block; block_row < n;
       block_row += stride) {
    const int64_t row = block_row + threadIdx.x / G;
    float acc = 0.f;
    if (row < n) {
      const int64_t base = row * R;
      for (int s = lane; s < R; s += G) {
        const int c = __ldg(cols + base + s);
        acc += to_f32(vals[base + s]) * to_f32(__ldg(x + c));
      }
    }
    for (int s = G / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (row < n && lane == 0) y[row] = from_f32<T>(acc);
  }
}

template <int G, typename T>
static int launch_group(const void* cols, const void* vals, const void* x, const void* active,
                        void* y, int64_t n, int R, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t needed = (n + rows_per_block - 1) / rows_per_block;
  const int64_t wave = (int64_t)sms * BELL_BLOCKS_PER_SM;
  const int64_t blocks = needed < wave ? needed : wave;
  spmv_bell_kernel<G, T><<<(unsigned)blocks, REPRO_BLOCK, 0, st>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (const uint8_t*)active, (T*)y, n, R);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_spmv(const void* cols, const void* vals, const void* x, const void* active,
                       void* y, int64_t n, int R, void* stream) {
  if (n < 0 || R < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (R > 16) return launch_group<32, T>(cols, vals, x, active, y, n, R, st);
  if (R > 8) return launch_group<16, T>(cols, vals, x, active, y, n, R, st);
  if (R > 4) return launch_group<8, T>(cols, vals, x, active, y, n, R, st);
  return launch_group<4, T>(cols, vals, x, active, y, n, R, st);
}

extern "C" {

int spmv_bell_bf16(const void* cols, const void* vals, const void* x, const void* active,
                   void* y, int64_t n, int R, void* stream) {
  return launch_spmv<__nv_bfloat16>(cols, vals, x, active, y, n, R, stream);
}

}  // extern "C"

// ---- lane-batched entry: Y[l, i] = sum_s vals[i, s] X[l, cols[i, s]] (f32) --
//
// Replaces src/repro/kernels/spmv_bell/kernel.py:spmv_bell_padded in f32, and
// the same kernel under jax.vmap (the SPMV of a batched solve on a Bell
// operator). One vector (k = 1) runs the kernel above: this one's K = 1
// instance measured 7% slower at Queen_4147 (PERF.md), for the same bits.
//
// Bound on this card: bytes, R (4 + 4) + 8 K bytes a row: cols and vals are
// read once for all K lanes. Design: the grouped, strided kernel above with
// K sums per thread: a slot's column and value are loaded once and gathered
// from each live lane's X (X stays (k, n), so a slot costs one sector per
// lane; a lane-interleaved copy is not staged). Each lane's sums reduce in
// the same xor tree for every K (so a lane's bits do not depend on K). A
// lane whose flag is 0 gathers nothing and gets Y[l] = 0; when none is
// live nothing is read, but the row loop and its shuffles still run: an
// early exit for that case slowed the live launches (PERF.md).
template <int G, int K>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_bell_lanes_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                       const float* __restrict__ x, const uint8_t* __restrict__ active,
                       float* __restrict__ y, int64_t n, int R) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two <= 32");
  static_assert(K >= 2 && K <= REPRO_MAX_LANES, "one lane runs spmv_bell_kernel");
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t stride = (int64_t)gridDim.x * rows_per_block;
  const int lane = threadIdx.x & (G - 1);
  const unsigned live = live_lanes(active, K);
  for (int64_t block_row = (int64_t)blockIdx.x * rows_per_block; block_row < n;
       block_row += stride) {
    const int64_t row = block_row + threadIdx.x / G;
    float acc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = 0.f;
    if (row < n && live != 0) {
      const int64_t base = row * R;
      for (int s = lane; s < R; s += G) {
        const int c = __ldg(cols + base + s);
        const float v = vals[base + s];
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (!((live >> l) & 1u)) continue;
          acc[l] += v * __ldg(x + (int64_t)l * n + c);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < K; ++l)
      for (int s = G / 2; s > 0; s >>= 1) acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], s);
    if (row < n && lane == 0) {
#pragma unroll
      for (int l = 0; l < K; ++l) y[(int64_t)l * n + row] = ((live >> l) & 1u) ? acc[l] : 0.f;
    }
  }
}

template <int G>
static int launch_group_lanes(int lanes, const void* cols, const void* vals, const void* x,
                              const void* active, void* y, int64_t n, int R, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t needed = (n + rows_per_block - 1) / rows_per_block;
  const int64_t wave = (int64_t)sms * BELL_BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(needed < wave ? needed : wave);
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const float* xs = (const float*)x;
  const uint8_t* act = (const uint8_t*)active;
  float* ys = (float*)y;
#define REPRO_BELL_LANES(K)                                                                 \
  case K:                                                                                   \
    spmv_bell_lanes_kernel<G, K><<<blocks, REPRO_BLOCK, 0, st>>>(c, v, xs, act, ys, n, R); \
    break;
  switch (lanes) {
    REPRO_BELL_LANES(2)
    REPRO_BELL_LANES(3)
    REPRO_BELL_LANES(4)
    REPRO_BELL_LANES(5)
    REPRO_BELL_LANES(6)
    REPRO_BELL_LANES(7)
    REPRO_BELL_LANES(8)
  }
#undef REPRO_BELL_LANES
  return (int)cudaGetLastError();
}

extern "C" int spmv_bell_lanes_f32(int lanes, const void* cols, const void* vals, const void* x,
                                   const void* active, void* y, int64_t n, int R, void* stream) {
  if (n < 0 || R < 1 || lanes < 1 || lanes > REPRO_MAX_LANES) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (lanes == 1) return launch_spmv<float>(cols, vals, x, active, y, n, R, stream);
  cudaStream_t st = (cudaStream_t)stream;
  if (R > 16) return launch_group_lanes<32>(lanes, cols, vals, x, active, y, n, R, st);
  if (R > 8) return launch_group_lanes<16>(lanes, cols, vals, x, active, y, n, R, st);
  if (R > 4) return launch_group_lanes<8>(lanes, cols, vals, x, active, y, n, R, st);
  return launch_group_lanes<4>(lanes, cols, vals, x, active, y, n, R, st);
}
