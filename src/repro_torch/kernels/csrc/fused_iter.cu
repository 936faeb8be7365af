// One whole PIPECG iteration per launch for K right-hand sides: the banded
// SPMV n = A m, the 8 VMAs, the Jacobi PC m' = inv * w and the three dot
// partials, per lane. A single solve is K = 1.
//
// Replaces the TPU kernel src/repro/kernels/fused_iter/kernel.py:fused_iter_padded,
// and the same kernel under jax.vmap (the serving tier's solve_batched on a
// DIA operator).
//
// Bound on this card: bytes. Per row the band (k_diag entries) and inv are
// read once for all K lanes; each lane reads 9 vectors and writes 9:
// 504 + 72 K bytes a row at 125 diagonals (576 B at K = 1, where the band
// is nearly 90% of it, so the kernel should run only a little faster than
// spmv_dia followed by fused_vma).
//
// Design: one thread per row, K sums in registers: each diagonal entry is
// loaded once (coalesced: data is (k_diag, n) row-major) and multiplied into
// every live lane's m, in diagonal order, so a lane's result does not depend
// on K. At K = 1, m[i + off] is gathered through L1/L2 with an explicit
// column guard; for K > 1 the block stages each run of nearby diagonals'
// window of every live lane's m in shared memory (dia_lanes_sum in
// common.cuh; gathering K lanes through L1 per diagonal ran at 30% of the
// bound at K = 8). Then fused_vma's body runs per lane with that lane's
// alpha and beta. m must ping-pong between two buffers, because
// neighbouring blocks read m_in's halo while this block writes its rows of
// m; the other 8 vectors are updated in place. The TPU kernel's three-tile
// window is not carried over. Dot partials go through the fixed-order
// two-pass sum (sum_partials_kernel, no atomics). A lane whose device flag
// is 0 (converged, the host has not polled yet) is left exactly as it is:
// m_in is copied to m_out, its dots are 0 and its m is never read; when no
// lane is live the band is not read at all.
#include "common.cuh"

template <int K>
__global__ void __launch_bounds__(REPRO_BLOCK)
fused_iter_kernel(const __grid_constant__ DiagRuns runs, const float* __restrict__ data,
                  const float* __restrict__ m_in, float* __restrict__ m_out, float* __restrict__ z,
                  float* __restrict__ q, float* __restrict__ s, float* __restrict__ p,
                  float* __restrict__ x, float* __restrict__ r, float* __restrict__ u,
                  float* __restrict__ w, const float* __restrict__ inv,
                  const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
                  const uint8_t* __restrict__ active, float* __restrict__ partials, int64_t n) {
  __shared__ float win[K * (REPRO_BLOCK + REPRO_RUN_SPAN)];
  const int64_t i0 = (int64_t)blockIdx.x * REPRO_BLOCK;
  const int64_t i = i0 + threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.f;
  if (live != 0) dia_lanes_sum<K>(runs, data, m_in, live, i0, n, acc, win);
  float dots[3 * K];
#pragma unroll
  for (int c = 0; c < 3 * K; ++c) dots[c] = 0.f;
  if (i < n) {
    const float iv = live != 0 ? inv[i] : 0.f;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int64_t o = (int64_t)l * n + i;
      if (!((live >> l) & 1u)) {
        m_out[o] = m_in[o];
        continue;
      }
      const float alpha = alpha_p[l];
      const float beta = beta_p[l];
      const float wv = w[o];
      const float uv = u[o];
      const float zv = acc[l] + beta * z[o];
      const float qv = m_in[o] + beta * q[o];
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
      m_out[o] = iv * wn;
      dots[3 * l + 0] = rv * un;
      dots[3 * l + 1] = wn * un;
      dots[3 * l + 2] = un * un;
    }
  }
  if (live == 0) return;  // the same branch for the whole grid
  block_sum<REPRO_BLOCK, 3 * K>(dots);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      float* pl = partials + 3 * ((int64_t)l * gridDim.x + blockIdx.x);
      pl[0] = dots[3 * l + 0];
      pl[1] = dots[3 * l + 1];
      pl[2] = dots[3 * l + 2];
    }
  }
}

template <int K>
static void launch_fused_iter(const DiagRuns& runs, int64_t blocks, cudaStream_t st,
                              const void* data, const void* m_in, void* m_out, void* z, void* q,
                              void* s, void* p, void* x, void* r, void* u, void* w, const void* inv,
                              const void* alpha, const void* beta, const void* active,
                              void* partials, int64_t n) {
  fused_iter_kernel<K><<<(unsigned)blocks, REPRO_BLOCK, 0, st>>>(
      runs, (const float*)data, (const float*)m_in, (float*)m_out, (float*)z, (float*)q,
      (float*)s, (float*)p, (float*)x, (float*)r, (float*)u, (float*)w, (const float*)inv,
      (const float*)alpha, (const float*)beta, (const uint8_t*)active, (float*)partials, n);
}

// `lanes` (1..REPRO_MAX_LANES) rows of (lanes, n) vectors; alpha, beta and
// active (may be NULL) hold one entry a lane; partials is (lanes, blocks, 3)
// and dots (lanes, 3).
extern "C" int fused_iter_f32(const int* offsets, int k, int lanes, const void* data,
                              const void* m_in, void* m_out, void* z, void* q, void* s, void* p,
                              void* x, void* r, void* u, void* w, const void* inv,
                              const void* alpha, const void* beta, const void* active,
                              void* partials, void* dots, int64_t n, void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n <= 0 || lanes < 1 || lanes > REPRO_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  const DiagRuns runs = make_runs(offsets, k);
  const int64_t blocks = repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FUSED_ITER(K)                                                                \
  case K:                                                                                  \
    launch_fused_iter<K>(runs, blocks, st, data, m_in, m_out, z, q, s, p, x, r, u, w, inv, \
                         alpha, beta, active, partials, n);                                \
    break;
  switch (lanes) {
    REPRO_FUSED_ITER(1)
    REPRO_FUSED_ITER(2)
    REPRO_FUSED_ITER(3)
    REPRO_FUSED_ITER(4)
    REPRO_FUSED_ITER(5)
    REPRO_FUSED_ITER(6)
    REPRO_FUSED_ITER(7)
    REPRO_FUSED_ITER(8)
  }
#undef REPRO_FUSED_ITER
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)lanes, REPRO_SUM_THREADS, 0, st>>>(
      (const float*)partials, blocks, (const uint8_t*)active, (float*)dots);
  return (int)cudaGetLastError();
}
