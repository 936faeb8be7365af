// Fused triple dot product: float32 [(r, u), (w, u), (u, u)] in one pass
// over the three vectors (PIPECG lines 18-20), f32 or bf16 inputs, f32
// accumulation.
//
// Replaces the TPU kernel src/repro/kernels/fused_dot/kernel.py:fused_dots_padded.
//
// Bound on this card: bytes. It reads 3 vectors once (12 B per element
// in f32) for 6 flops per element.
//
// Design: one thread per element, so neighbouring threads read
// neighbouring addresses and u is read once for all three products. Each
// block leaves its three partial sums through the warp-shuffle block
// reduction of common.cuh into (blocks, 3); a second one-block pass sums
// them in a fixed order, without atomics, so every run gives the same
// bits. Any length: the last block masks its tail.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(REPRO_BLOCK)
fused_dots_kernel(const T* __restrict__ r, const T* __restrict__ u, const T* __restrict__ w,
                  float* __restrict__ partials, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x;
  float g = 0.f, d = 0.f, uu = 0.f;
  if (i < n) {
    const float uv = to_f32(u[i]);
    g = to_f32(r[i]) * uv;
    d = to_f32(w[i]) * uv;
    uu = uv * uv;
  }
  block_sum3<REPRO_BLOCK>(g, d, uu);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = g;
    partials[3 * blockIdx.x + 1] = d;
    partials[3 * blockIdx.x + 2] = uu;
  }
}

template <typename T>
static int launch_dots(const void* r, const void* u, const void* w, void* partials, void* dots,
                       int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  fused_dots_kernel<T><<<(unsigned)blocks, REPRO_BLOCK, 0, st>>>(
      (const T*)r, (const T*)u, (const T*)w, (float*)partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, REPRO_SUM_THREADS, 0, st>>>((const float*)partials, blocks, nullptr,
                                                       (float*)dots);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_dots_f32(const void* r, const void* u, const void* w, void* partials, void* dots,
                   int64_t n, void* stream) {
  return launch_dots<float>(r, u, w, partials, dots, n, stream);
}

int fused_dots_bf16(const void* r, const void* u, const void* w, void* partials, void* dots,
                    int64_t n, void* stream) {
  return launch_dots<__nv_bfloat16>(r, u, w, partials, dots, n, stream);
}

}  // extern "C"
