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

// DIA offsets passed by value: every thread of a warp reads the same
// offset, which the constant bank broadcasts. __grid_constant__ keeps
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

// Sums three values over a block of NT threads in a fixed tree order;
// the result is valid in thread 0. Every thread of the block must call it.
template <int NT>
static __device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  static_assert(NT % 32 == 0 && NT <= 1024, "block must be whole warps");
  __shared__ float sh[3][NT / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    sh[0][wid] = a;
    sh[1][wid] = b;
    sh[2][wid] = c;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < NT / 32 ? sh[0][lane] : 0.f;
    b = lane < NT / 32 ? sh[1][lane] : 0.f;
    c = lane < NT / 32 ? sh[2][lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
  }
}

// Second pass of the dot products: one block sums the per-block
// partials (nblocks, 3) in a fixed order, so every run gives the same
// bits (no atomics). Writes zeros when the solve is no longer active.
#define REPRO_SUM_THREADS 1024

static __global__ void __launch_bounds__(REPRO_SUM_THREADS)
sum_partials_kernel(const float* __restrict__ partials, int64_t nblocks,
                    const uint8_t* __restrict__ active, float* __restrict__ dots) {
  if (active != nullptr && *active == 0) {
    if (threadIdx.x < 3) dots[threadIdx.x] = 0.f;
    return;
  }
  float a = 0.f, b = 0.f, c = 0.f;
  for (int64_t blk = threadIdx.x; blk < nblocks; blk += REPRO_SUM_THREADS) {
    a += partials[3 * blk + 0];
    b += partials[3 * blk + 1];
    c += partials[3 * blk + 2];
  }
  block_sum3<REPRO_SUM_THREADS>(a, b, c);
  if (threadIdx.x == 0) {
    dots[0] = a;
    dots[1] = b;
    dots[2] = c;
  }
}

static inline int64_t repro_blocks(int64_t n) { return (n + REPRO_BLOCK - 1) / REPRO_BLOCK; }
