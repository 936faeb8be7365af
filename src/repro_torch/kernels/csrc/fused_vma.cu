// Fused PIPECG iteration core: the 8 VMAs, the Jacobi PC and the three
// dot partials (r,u), (w,u), (u,u) in one pass (Alg. 2 lines 10-21), for
// k right-hand sides; a single solve is k = 1.
//
// Replaces the TPU kernel src/repro/kernels/fused_vma/kernel.py:fused_vma_dots_padded,
// and the same kernel under jax.vmap (the "cuda" core of a batched solve:
// Bell and CSR operators, or a preconditioner the loop applies itself).
//
// Bound on this card: bytes. Per lane it reads 10 vectors and writes 9,
// and inv is read once for all lanes (L2 serves it to the later ones):
// 76 k + 4 B a row in f32, for about 25 flops per row and lane.
//
// Design: elementwise over a grid of (row blocks, k lanes), one thread per
// row; blockIdx.y picks the lane, its alpha and beta (read through device
// pointers, so the solver loop never copies a scalar to the host) and its
// flag. Every vector is updated in place (each thread reads its row before
// it writes it, and no thread reads another's row). The dot partials leave
// each block through a warp-shuffle block reduction into (k, blocks, 3); a
// second pass (one block a lane) sums them in a fixed order, without
// atomics, so every run gives the same bits. A block whose lane's device
// flag is 0 returns at once and leaves its rows untouched, and that lane's
// dots are 0: it has converged and the host has not polled yet.
#include "common.cuh"

__global__ void __launch_bounds__(REPRO_BLOCK)
fused_vma_kernel(float* __restrict__ z, float* __restrict__ q, float* __restrict__ s,
                 float* __restrict__ p, float* __restrict__ x, float* __restrict__ r,
                 float* __restrict__ u, float* __restrict__ w, const float* __restrict__ nv,
                 float* __restrict__ m, const float* __restrict__ inv,
                 const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
                 const uint8_t* __restrict__ active, float* __restrict__ partials, int64_t n) {
  const int64_t l = blockIdx.y;
  if (active != nullptr && active[l] == 0) return;
  const int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x;
  const int64_t o = l * n + i;
  float g = 0.f, d = 0.f, uu = 0.f;
  if (i < n) {
    const float alpha = alpha_p[l];
    const float beta = beta_p[l];
    const float wv = w[o];
    const float uv = u[o];
    const float zv = nv[o] + beta * z[o];
    const float qv = m[o] + beta * q[o];
    const float sv = wv + beta * s[o];
    const float pv = uv + beta * p[o];
    x[o] = x[o] + alpha * pv;
    const float rv = r[o] - alpha * sv;
    const float un = uv - alpha * qv;
    const float wn = wv - alpha * zv;
    z[o] = zv;
    q[o] = qv;
    s[o] = sv;
    p[o] = pv;
    r[o] = rv;
    u[o] = un;
    w[o] = wn;
    m[o] = inv[i] * wn;
    g = rv * un;
    d = wn * un;
    uu = un * un;
  }
  block_sum3<REPRO_BLOCK>(g, d, uu);
  if (threadIdx.x == 0) {
    float* pl = partials + 3 * (l * gridDim.x + blockIdx.x);
    pl[0] = g;
    pl[1] = d;
    pl[2] = uu;
  }
}

// (lanes, n) vectors; alpha, beta and active (may be NULL) one entry a lane;
// partials (lanes, blocks, 3), dots (lanes, 3).
extern "C" int fused_vma_f32(int lanes, void* z, void* q, void* s, void* p, void* x, void* r,
                             void* u, void* w, const void* nv, void* m, const void* inv,
                             const void* alpha, const void* beta, const void* active,
                             void* partials, void* dots, int64_t n, void* stream) {
  if (n <= 0 || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const int64_t blocks = repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  fused_vma_kernel<<<dim3((unsigned)blocks, (unsigned)lanes), REPRO_BLOCK, 0, st>>>(
      (float*)z, (float*)q, (float*)s, (float*)p, (float*)x, (float*)r, (float*)u, (float*)w,
      (const float*)nv, (float*)m, (const float*)inv, (const float*)alpha, (const float*)beta,
      (const uint8_t*)active, (float*)partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)lanes, REPRO_SUM_THREADS, 0, st>>>(
      (const float*)partials, blocks, (const uint8_t*)active, (float*)dots);
  return (int)cudaGetLastError();
}
