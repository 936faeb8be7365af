// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel runs REPRO_BLOCK threads per block, one thread per row,
// launches on the caller's stream, allocates nothing, and is reached
// through a plain C entry that returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_BLOCK 256
#define REPRO_MAX_DIAGS 256

// DIA offsets passed by value (the bf16 SPMV): every thread of a warp
// reads the same offset, which the constant bank broadcasts. __grid_constant__ keeps
// the dynamically indexed array in parameter space (no local copy).
struct DiagOffsets {
  int k;
  int off[REPRO_MAX_DIAGS];
};

static inline DiagOffsets make_offsets(const int* host_offsets, int k) {
  DiagOffsets d;
  d.k = k;
  for (int j = 0; j < k; ++j) d.off[j] = host_offsets[j];
  return d;
}

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
static __device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// Sums C values over a block of NT threads, each in one fixed tree order
// (a shuffle-down tree in each warp, then warp 0 over the warps' sums); the
// results are valid in thread 0. Every thread of the block must call it.
template <int NT, int C>
static __device__ __forceinline__ void block_sum(float (&v)[C]) {
  static_assert(NT % 32 == 0 && NT <= 1024, "block must be whole warps");
  __shared__ float sh[C][NT / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = warp_sum(v[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) sh[c][wid] = v[c];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = warp_sum(lane < NT / 32 ? sh[c][lane] : 0.f);
  }
}

template <int NT>
static __device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  float v[3] = {a, b, c};
  block_sum<NT, 3>(v);
  a = v[0];
  b = v[1];
  c = v[2];
}

// Second pass of the dot products: block l sums lane l's per-block
// partials (nblocks, 3), stored at partials + 3 * nblocks * l, in a fixed
// order, so every run gives the same bits (no atomics). Launched with one
// block a lane; an inactive lane's dots are 0.
#define REPRO_SUM_THREADS 1024

static __global__ void __launch_bounds__(REPRO_SUM_THREADS)
sum_partials_kernel(const float* __restrict__ partials, int64_t nblocks,
                    const uint8_t* __restrict__ active, float* __restrict__ dots) {
  const int64_t l = blockIdx.x;
  if (active != nullptr && active[l] == 0) {
    if (threadIdx.x < 3) dots[3 * l + threadIdx.x] = 0.f;
    return;
  }
  const float* p = partials + 3 * nblocks * l;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int64_t blk = threadIdx.x; blk < nblocks; blk += REPRO_SUM_THREADS) {
    a += p[3 * blk + 0];
    b += p[3 * blk + 1];
    c += p[3 * blk + 2];
  }
  block_sum3<REPRO_SUM_THREADS>(a, b, c);
  if (threadIdx.x == 0) {
    dots[3 * l + 0] = a;
    dots[3 * l + 1] = b;
    dots[3 * l + 2] = c;
  }
}

static inline int64_t repro_blocks(int64_t n) { return (n + REPRO_BLOCK - 1) / REPRO_BLOCK; }

// ---- lane-batched kernels: k right-hand sides, (k, n) row-major ----------
//
// Every f32 solver kernel takes lanes: lane l of a (k, n) vector starts at
// l * n, and a single right-hand side is the k = 1 case. The DIA and Bell
// kernels keep one sum per lane in registers, so they take at most
// REPRO_MAX_LANES lanes per launch (a template argument); the wrappers run
// larger k in chunks.
#define REPRO_MAX_LANES 8

// DIA offsets in runs for the lane-batched kernels: run g holds the
// consecutive diagonals [start[g], start[g + 1]) whose offsets lie within
// REPRO_RUN_SPAN of the run's lowest, lo[g] (the 5 x-neighbours of a 3-D
// stencil row are one run). A block stages, run by run, the window of each
// lane's vector that the run's diagonals read for its rows in shared
// memory, so K lanes' gathers come from shared memory and each vector
// element is loaded once per run and block, not once per diagonal.
#define REPRO_RUN_SPAN 32

struct DiagRuns {
  int k;
  int runs;
  int off[REPRO_MAX_DIAGS];
  int start[REPRO_MAX_DIAGS + 1];
  int lo[REPRO_MAX_DIAGS];
};

static inline DiagRuns make_runs(const int* host_offsets, int k) {
  DiagRuns d;
  d.k = k;
  d.runs = 0;
  int lo = 0, hi = 0;
  for (int j = 0; j < k; ++j) {
    const int o = host_offsets[j];
    d.off[j] = o;
    const int nlo = o < lo ? o : lo, nhi = o > hi ? o : hi;
    if (j == 0 || nhi - nlo > REPRO_RUN_SPAN) {  // open a run
      d.start[d.runs] = j;
      d.lo[d.runs] = o;
      ++d.runs;
      lo = hi = o;
    } else {
      lo = nlo;
      hi = nhi;
      d.lo[d.runs - 1] = lo;
    }
  }
  d.start[d.runs] = k;
  return d;
}

// acc[l] += sum_j data[j, i] * x[l, i + off_j] over every diagonal, in j
// order and with x zero outside [0, n): the same operations for every K, so
// a lane's sum does not depend on how many lanes share the launch. Lanes
// not in `live` are not read. Every thread of the block calls it (it
// synchronises); rows i >= n stage but do not accumulate. `win` is
// K * (REPRO_BLOCK + REPRO_RUN_SPAN) floats of shared memory. One lane
// gathers x through L1 instead: staging it measured 13% slower (PERF.md).
template <int K>
static __device__ __forceinline__ void dia_lanes_sum(const DiagRuns& dr,
                                                     const float* __restrict__ data,
                                                     const float* __restrict__ x, unsigned live,
                                                     int64_t i0, int64_t n, float (&acc)[K],
                                                     float* __restrict__ win) {
  constexpr int W = REPRO_BLOCK + REPRO_RUN_SPAN;
  const int64_t i = i0 + threadIdx.x;
  if constexpr (K == 1) {
    if (i < n) {
      for (int j = 0; j < dr.k; ++j) {
        const int64_t c = i + dr.off[j];
        const float xv = (c >= 0 && c < n) ? x[c] : 0.f;
        acc[0] += data[(int64_t)j * n + i] * xv;
      }
    }
    return;
  }
  for (int g = 0; g < dr.runs; ++g) {
    const int lo = dr.lo[g];
    for (int t = threadIdx.x; t < W; t += REPRO_BLOCK) {
      const int64_t c = i0 + lo + t;
      const bool in = c >= 0 && c < n;
#pragma unroll
      for (int l = 0; l < K; ++l)
        win[l * W + t] = (in && ((live >> l) & 1u)) ? x[(int64_t)l * n + c] : 0.f;
    }
    __syncthreads();
    if (i < n) {
      for (int j = dr.start[g]; j < dr.start[g + 1]; ++j) {
        const int d = dr.off[j] - lo + threadIdx.x;
        const float dv = data[(int64_t)j * n + i];
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (!((live >> l) & 1u)) continue;
          acc[l] += dv * win[l * W + d];
        }
      }
    }
    __syncthreads();
  }
}

// Bit l set when lane l is still running (all lanes when active is NULL).
static __device__ __forceinline__ unsigned live_lanes(const uint8_t* __restrict__ active,
                                                     int lanes) {
  unsigned live = 0;
  for (int l = 0; l < lanes; ++l)
    if (active == nullptr || active[l] != 0) live |= 1u << l;
  return live;
}
