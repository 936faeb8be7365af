// Fused PIPECG iteration core: the 8 VMAs, the Jacobi PC and the three
// dot partials (r,u), (w,u), (u,u) in one pass (Alg. 2 lines 10-21).
//
// Replaces the TPU kernel src/repro/kernels/fused_vma/kernel.py:fused_vma_dots_padded.
//
// Bound on this card: bytes. It reads 11 vectors and writes 9 (80 B per
// row in f32) for about 25 flops per row.
//
// Design: elementwise, one thread per row, every vector updated in
// place (each thread reads its row before it writes it, and no thread
// reads another's row). The dot partials leave each block through a
// warp-shuffle block reduction into (blocks, 3); a second one-block
// pass sums them in a fixed order, without atomics, so every run gives
// the same bits. alpha and beta are read through device pointers, so
// the solver loop never copies a scalar to the host. When the device
// flag `active` is 0 the kernel does nothing and the dots are 0: the
// solve has converged and the host has not polled yet.
#include "common.cuh"

__global__ void __launch_bounds__(REPRO_BLOCK)
fused_vma_kernel(float* __restrict__ z, float* __restrict__ q, float* __restrict__ s,
                 float* __restrict__ p, float* __restrict__ x, float* __restrict__ r,
                 float* __restrict__ u, float* __restrict__ w, const float* __restrict__ nv,
                 float* __restrict__ m, const float* __restrict__ inv,
                 const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
                 const uint8_t* __restrict__ active, float* __restrict__ partials, int64_t n) {
  if (active != nullptr && *active == 0) return;
  const int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x;
  float g = 0.f, d = 0.f, uu = 0.f;
  if (i < n) {
    const float alpha = *alpha_p;
    const float beta = *beta_p;
    const float wv = w[i];
    const float uv = u[i];
    const float zv = nv[i] + beta * z[i];
    const float qv = m[i] + beta * q[i];
    const float sv = wv + beta * s[i];
    const float pv = uv + beta * p[i];
    x[i] = x[i] + alpha * pv;
    const float rv = r[i] - alpha * sv;
    const float un = uv - alpha * qv;
    const float wn = wv - alpha * zv;
    z[i] = zv;
    q[i] = qv;
    s[i] = sv;
    p[i] = pv;
    r[i] = rv;
    u[i] = un;
    w[i] = wn;
    m[i] = inv[i] * wn;
    g = rv * un;
    d = wn * un;
    uu = un * un;
  }
  block_sum3<REPRO_BLOCK>(g, d, uu);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = g;
    partials[3 * blockIdx.x + 1] = d;
    partials[3 * blockIdx.x + 2] = uu;
  }
}

extern "C" int fused_vma_f32(void* z, void* q, void* s, void* p, void* x, void* r, void* u,
                             void* w, const void* nv, void* m, const void* inv,
                             const void* alpha, const void* beta, const void* active,
                             void* partials, void* dots, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  fused_vma_kernel<<<(unsigned)blocks, REPRO_BLOCK, 0, st>>>(
      (float*)z, (float*)q, (float*)s, (float*)p, (float*)x, (float*)r, (float*)u, (float*)w,
      (const float*)nv, (float*)m, (const float*)inv, (const float*)alpha, (const float*)beta,
      (const uint8_t*)active, (float*)partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, REPRO_SUM_THREADS, 0, st>>>(
      (const float*)partials, blocks, (const uint8_t*)active, (float*)dots);
  return (int)cudaGetLastError();
}
