// One whole PIPECG iteration per launch for K right-hand sides: the banded
// SPMV n = A m, the 8 VMAs, the Jacobi PC m' = inv * w and the three dot
// partials, per lane. A single solve is K = 1.
//
// Replaces the TPU kernel src/repro/kernels/fused_iter/kernel.py:fused_iter_padded,
// and the same kernel under jax.vmap (the serving tier's solve_batched on a
// DIA operator).
//
// The band is f32 (fused_iter_f32) or bf16 (fused_iter_bf16band_f32, the
// reference's make_fused_iter_core(A, data_dtype=bfloat16)): each entry is
// upcast to f32 before its product, the vectors and sums stay f32.
//
// Bound on this card: bytes. Per row the band (k_diag entries) and inv are
// read once for all K lanes; each lane reads 9 vectors and writes 9:
// 504 + 72 K bytes a row at 125 diagonals with an f32 band (576 B at K = 1,
// where the band is nearly 90% of it, so the kernel should run only a
// little faster than spmv_dia followed by fused_vma), 254 + 72 K with bf16.
//
// Design: one thread per row, K sums in registers: each diagonal entry is
// loaded once (coalesced: data is (k_diag, n) row-major) and multiplied into
// every live lane's m, in diagonal order, so a lane's result does not depend
// on K. At K = 1, m[i + off] is gathered through L1/L2 with an explicit
// column guard. For K > 1 the block copies, group by group of nearby
// diagonals, the window of every live lane's m that the group reads for its
// 256 rows into shared memory, lane-interleaved (a diagonal's 8 lane values
// are two 16-byte loads), the next group's window with cp.async while the
// current one is read (dia_lanes_sum in common.cuh). The groups are as wide
// as two windows in 64 KB allow: poisson125 at n = 128 takes 5 (one per
// z-plane), 5 barriers a block. The first lane design gathered K lanes
// through L1 per diagonal (30% of the bound at K = 8); the second staged
// runs of diagonals within 32 columns, one window a lane (25 runs, 50
// barriers, 49%). Then fused_vma's body runs per lane with that lane's
// alpha and beta; for K > 1 the band and the 8 vectors stream (evict-first
// in L2), so L2 keeps m for the windows of neighbouring blocks. m must
// ping-pong between two buffers, because neighbouring blocks read m_in's
// halo while this block writes its rows of m; the other 8 vectors are
// updated in place. The TPU kernel's three-tile window is not carried over.
// One thread a row and 256-row dot partials through block_sum and the
// fixed-order two-pass sum (sum_partials_kernel, no atomics) keep each
// lane's z, ..., m and dots bit for bit the K = 1 kernel's. A lane whose
// device flag is 0 (converged, the host has not polled yet) is left exactly
// as it is: m_in is copied to m_out, its dots are 0 and its m is never
// read; when no lane is live the band is not read at all.
#include "common.cuh"

template <int K, typename TD>
__global__ void __launch_bounds__(REPRO_BLOCK)
fused_iter_kernel(const __grid_constant__ DiagRuns runs, const TD* __restrict__ data,
                  const float* __restrict__ m_in, float* __restrict__ m_out, float* __restrict__ z,
                  float* __restrict__ q, float* __restrict__ s, float* __restrict__ p,
                  float* __restrict__ x, float* __restrict__ r, float* __restrict__ u,
                  float* __restrict__ w, const float* __restrict__ inv,
                  const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
                  const uint8_t* __restrict__ active, float* __restrict__ partials, int64_t n) {
  extern __shared__ __align__(16) float repro_smem[];
  constexpr bool S = K > 1;  // stream the band and the vectors
  const int64_t i0 = (int64_t)blockIdx.x * REPRO_BLOCK;
  const int64_t i = i0 + threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.f;
  if (live != 0) dia_lanes_sum<K>(runs, data, m_in, live, i0, n, acc, repro_smem);
  float dots[3 * K];
#pragma unroll
  for (int c = 0; c < 3 * K; ++c) dots[c] = 0.f;
  if (i < n) {
    const float iv = live != 0 ? ld_lane<S>(inv + i) : 0.f;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int64_t o = (int64_t)l * n + i;
      if (!((live >> l) & 1u)) {
        m_out[o] = m_in[o];
        continue;
      }
      const float alpha = alpha_p[l];
      const float beta = beta_p[l];
      const float wv = ld_lane<S>(w + o);
      const float uv = ld_lane<S>(u + o);
      const float zv = acc[l] + beta * ld_lane<S>(z + o);
      const float qv = m_in[o] + beta * ld_lane<S>(q + o);
      const float sv = wv + beta * ld_lane<S>(s + o);
      const float pv = uv + beta * ld_lane<S>(p + o);
      st_lane<S>(x + o, ld_lane<S>(x + o) + alpha * pv);
      const float rv = ld_lane<S>(r + o) - alpha * sv;
      const float un = uv - alpha * qv;
      const float wn = wv - alpha * zv;
      st_lane<S>(z + o, zv);
      st_lane<S>(q + o, qv);
      st_lane<S>(s + o, sv);
      st_lane<S>(p + o, pv);
      st_lane<S>(r + o, rv);
      st_lane<S>(u + o, un);
      st_lane<S>(w + o, wn);
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

template <int K, typename TD>
static cudaError_t launch_fused_iter(const int* offsets, int k, int64_t blocks, cudaStream_t st,
                                     const void* data, const void* m_in, void* m_out, void* z,
                                     void* q, void* s, void* p, void* x, void* r, void* u,
                                     void* w, const void* inv, const void* alpha,
                                     const void* beta, const void* active, void* partials,
                                     int64_t n) {
  static std::atomic<int> raised{0};
  const DiagRuns runs = lane_runs<K>(offsets, k);
  const size_t smem = dia_window_bytes<K>(runs);
  const cudaError_t err = allow_shared(fused_iter_kernel<K, TD>, smem, &raised);
  if (err != cudaSuccess) return err;
  fused_iter_kernel<K, TD><<<(unsigned)blocks, REPRO_BLOCK, smem, st>>>(
      runs, (const TD*)data, (const float*)m_in, (float*)m_out, (float*)z, (float*)q,
      (float*)s, (float*)p, (float*)x, (float*)r, (float*)u, (float*)w, (const float*)inv,
      (const float*)alpha, (const float*)beta, (const uint8_t*)active, (float*)partials, n);
  return cudaGetLastError();
}

// `lanes` (1..REPRO_MAX_LANES) rows of (lanes, n) vectors; alpha, beta and
// active (may be NULL) hold one entry a lane; partials is (lanes, blocks, 3)
// and dots (lanes, 3).
template <typename TD>
static int fused_iter(const int* offsets, int k, int lanes, const void* data, const void* m_in,
                      void* m_out, void* z, void* q, void* s, void* p, void* x, void* r,
                      void* u, void* w, const void* inv, const void* alpha, const void* beta,
                      const void* active, void* partials, void* dots, int64_t n,
                      void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n <= 0 || lanes < 1 || lanes > REPRO_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = repro_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_FUSED_ITER(K)                                                                   \
  case K:                                                                                     \
    err = launch_fused_iter<K, TD>(offsets, k, blocks, st, data, m_in, m_out, z, q, s, p, x, r, \
                                   u, w, inv, alpha, beta, active, partials, n);              \
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
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)lanes, REPRO_SUM_THREADS, 0, st>>>(
      (const float*)partials, blocks, (const uint8_t*)active, (float*)dots);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_iter_f32(const int* offsets, int k, int lanes, const void* data, const void* m_in,
                   void* m_out, void* z, void* q, void* s, void* p, void* x, void* r, void* u,
                   void* w, const void* inv, const void* alpha, const void* beta,
                   const void* active, void* partials, void* dots, int64_t n, void* stream) {
  return fused_iter<float>(offsets, k, lanes, data, m_in, m_out, z, q, s, p, x, r, u, w, inv,
                           alpha, beta, active, partials, dots, n, stream);
}

int fused_iter_bf16band_f32(const int* offsets, int k, int lanes, const void* data,
                            const void* m_in, void* m_out, void* z, void* q, void* s, void* p,
                            void* x, void* r, void* u, void* w, const void* inv,
                            const void* alpha, const void* beta, const void* active,
                            void* partials, void* dots, int64_t n, void* stream) {
  return fused_iter<__nv_bfloat16>(offsets, k, lanes, data, m_in, m_out, z, q, s, p, x, r, u, w,
                                   inv, alpha, beta, active, partials, dots, n, stream);
}

}  // extern "C"
