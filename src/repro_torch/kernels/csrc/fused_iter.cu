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
// Three designs share the epilogue (iter_row: fused_vma's body per lane
// with that lane's alpha and beta) and the dot partials' bits.
//
// K = 1, either band: fused_iter_kernel<1, TD>, one thread a row,
// m[i + off] gathered through L1/L2 with an explicit column guard.
//
// K = 2..8, f32 band: fused_iter_kernel<K, float>, one thread a row, K sums
// in registers; the block copies, group by group of nearby diagonals, the
// window of every live lane's m that the group reads for its 256 rows into
// shared memory, lane-interleaved, the next group's window by cp.async while
// the current one is read (dia_lanes_sum in common.cuh): 5 groups and 5
// barriers a block at poisson125(128). The first lane design gathered K
// lanes through L1 per diagonal (30% of the bound at K = 8), the second
// staged runs within 32 columns, one window a lane (49%); this one 65%.
//
// K = 2..8, bf16 band: fused_iter_tile_kernel<K>, on spmv_dia's row tiles
// (dia_tile_sum in common.cuh; spmv_dia.cu's note): 1024 rows a block, 4
// consecutive rows a thread, planar f32 windows of m by 16-byte cp.async
// into a 2-stage ring on mbarriers, register tiles over chunks of 5
// diagonals (96 B of shared reads a row and chunk at 8 lanes, against 160 B
// for one lane-interleaved column a diagonal), summed 4 lanes a branch-free
// block, the band one 8-byte load a diagonal for the thread's 4 rows; then
// the epilogue moves the 8 vectors as 16-byte loads and stores where
// n % 4 == 0. The one-thread-a-row design (fused_iter_kernel<K, bf16>)
// reached 46-50% of the bound at K = 2-8, and at K = 8 no faster than the
// f32 band: halving the band's bytes bought nothing, so its shared reads
// and halo, not the band, held it. This one reaches 67-73% (PERF.md). Its
// SPMV and its epilogue take about the same time at K = 8 and overlap only
// across the two blocks an SM holds; prefetching the band or the next
// lane's vectors into L2 ran slower, and staggering the blocks' start paid
// at K = 8 only.
//
// For K > 1 the band and the 8 vectors stream (evict-first in L2), so L2
// keeps m for the windows of neighbouring blocks. m must ping-pong between
// two buffers, because neighbouring blocks read m_in's halo while this
// block writes its rows of m; the other 8 vectors are updated in place. The
// TPU kernel's three-tile window is not carried over.
//
// Dots, bit for bit. Each lane's z, ..., m and dots are the K = 1 kernel's
// bits: rows sum their products in diagonal order, each dot term is one
// rounded product (__fmul_rn, so no product is fused into a sum in one
// kernel and not in another), and the partials are one per 256 rows, in
// block_sum<256, 3>'s tree, summed by sum_partials_kernel in a fixed order
// (no atomics). The row-tile kernel, whose thread holds 4 rows, runs each
// 32-row warp's shuffle tree as 3 shuffles across threads and 2 adds in a
// thread (rows_sum32), and the tree over a quarter's 8 warp sums through the
// same warp_sum.
//
// A lane whose device flag is 0 (converged, the host has not polled yet)
// is left exactly as it is: m_in is copied to m_out, its dots are 0 and its
// m is never read; when no lane is live the band is not read at all.
#include <type_traits>

#include "common.cuh"

// One row of the iteration after the SPMV (nv = (A m)[i], mv = m[i]): the
// 8 vectors are updated in place, m_new = inv * w', and d the row's three
// dot terms (r', u'), (w', u'), (u', u'), each one rounded product.
struct IterRow {
  float z, q, s, p, x, r, u, w;
};

static __device__ __forceinline__ float iter_row(IterRow& v, float nv, float mv, float iv,
                                                 float alpha, float beta, float (&d)[3]) {
  const float wv = v.w;
  const float uv = v.u;
  const float zv = nv + beta * v.z;
  const float qv = mv + beta * v.q;
  const float sv = wv + beta * v.s;
  const float pv = uv + beta * v.p;
  v.x = v.x + alpha * pv;
  const float rv = v.r - alpha * sv;
  const float un = uv - alpha * qv;
  const float wn = wv - alpha * zv;
  v.z = zv;
  v.q = qv;
  v.s = sv;
  v.p = pv;
  v.r = rv;
  v.u = un;
  v.w = wn;
  d[0] = __fmul_rn(rv, un);
  d[1] = __fmul_rn(wn, un);
  d[2] = __fmul_rn(un, un);
  return iv * wn;
}

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
      IterRow v = {ld_lane<S>(z + o), ld_lane<S>(q + o), ld_lane<S>(s + o), ld_lane<S>(p + o),
                   ld_lane<S>(x + o), ld_lane<S>(r + o), ld_lane<S>(u + o), ld_lane<S>(w + o)};
      float d[3];
      m_out[o] = iter_row(v, acc[l], m_in[o], iv, alpha_p[l], beta_p[l], d);
      st_lane<S>(z + o, v.z);
      st_lane<S>(q + o, v.q);
      st_lane<S>(s + o, v.s);
      st_lane<S>(p + o, v.p);
      st_lane<S>(x + o, v.x);
      st_lane<S>(r + o, v.r);
      st_lane<S>(u + o, v.u);
      st_lane<S>(w + o, v.w);
#pragma unroll
      for (int c = 0; c < 3; ++c) dots[3 * l + c] = d[c];
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

// A thread's 4 rows r0..r0+3 of one vector (r0 < n): one 16-byte access
// where `vec`, else one a row below n (0 above it).
template <bool STREAM>
static __device__ __forceinline__ void load_rows(float (&v)[DIA_ROWS], const float* __restrict__ p,
                                                 int64_t r0, int64_t n, bool vec) {
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p + r0);
    const float4 t = STREAM ? __ldcs(p4) : *p4;
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < DIA_ROWS; ++e) v[e] = r0 + e < n ? ld_lane<STREAM>(p + r0 + e) : 0.f;
  }
}

template <bool STREAM>
static __device__ __forceinline__ void store_rows(float* __restrict__ p,
                                                  const float (&v)[DIA_ROWS], int64_t r0,
                                                  int64_t n, bool vec) {
  if (vec) {
    float4* p4 = reinterpret_cast<float4*>(p + r0);
    const float4 t = make_float4(v[0], v[1], v[2], v[3]);
    if (STREAM) __stcs(p4, t);
    else *p4 = t;
  } else {
#pragma unroll
    for (int e = 0; e < DIA_ROWS; ++e)
      if (r0 + e < n) st_lane<STREAM>(p + r0 + e, v[e]);
  }
}

// Levels 16, 8, 4, 2, 1 of a warp_sum over 32 rows, for rows held 4 a
// thread (row 4t + e at thread t, element e): thread 8h then holds the
// shuffle tree's sum of the rows of threads 8h..8h+7, as lane 0 of a
// one-row-a-thread warp over those 32 rows would, bit for bit.
static __device__ __forceinline__ float rows_sum32(float (&e)[DIA_ROWS]) {
#pragma unroll
  for (int t = 4; t > 0; t >>= 1)
#pragma unroll
    for (int j = 0; j < DIA_ROWS; ++j) e[j] += __shfl_down_sync(0xffffffffu, e[j], t);
  e[0] += e[2];
  e[1] += e[3];
  return e[0] + e[1];
}

// The bf16-band lanes at K = 2..8 on row tiles (see the note at the top).
// Its partials are those of the 256-row blocks of the K = 1 kernel: 4 a
// tile, partials + 3 * (l * nb + 4 * blockIdx.x + quarter), nb = ceil(n / 256).
template <int K>
__global__ void __launch_bounds__(REPRO_BLOCK, 2)
fused_iter_tile_kernel(const __grid_constant__ DiaTilePlan plan,
                       const __nv_bfloat16* __restrict__ data, const float* __restrict__ m_in,
                       float* __restrict__ m_out, float* __restrict__ z, float* __restrict__ q,
                       float* __restrict__ s, float* __restrict__ p, float* __restrict__ x,
                       float* __restrict__ r, float* __restrict__ u, float* __restrict__ w,
                       const float* __restrict__ inv, const float* __restrict__ alpha_p,
                       const float* __restrict__ beta_p, const uint8_t* __restrict__ active,
                       float* __restrict__ partials, int64_t n, int ws) {
  constexpr int GROUPS = DIA_TILE_ROWS / 32;  // 32-row groups of the K = 1 warps
  extern __shared__ __align__(16) unsigned char repro_tile_smem[];
  __shared__ float warps[K][3][GROUPS];
  const int64_t i0 = (int64_t)blockIdx.x * DIA_TILE_ROWS;
  const int64_t r0 = i0 + DIA_ROWS * threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K][DIA_ROWS];
  dia_tile_sum<K>(plan, data, m_in, live, i0, n, ws, acc,
                  reinterpret_cast<float*>(repro_tile_smem));
  const bool vec = (n & 3) == 0 &&
                   (((uintptr_t)m_in | (uintptr_t)m_out | (uintptr_t)z | (uintptr_t)q |
                     (uintptr_t)s | (uintptr_t)p | (uintptr_t)x | (uintptr_t)r | (uintptr_t)u |
                     (uintptr_t)w | (uintptr_t)inv) & 15) == 0;
  const bool mine = r0 < n;  // the thread has rows
  float iv[DIA_ROWS] = {0.f, 0.f, 0.f, 0.f};
  if (mine && live != 0) load_rows<true>(iv, inv, r0, n, vec);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const int64_t o = (int64_t)l * n;
    float mv[DIA_ROWS];
    if (mine) load_rows<false>(mv, m_in + o, r0, n, vec);
    if (!((live >> l) & 1u)) {  // the same branch for the whole grid
      if (mine) store_rows<false>(m_out + o, mv, r0, n, vec);
      continue;
    }
    float d[3][DIA_ROWS];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < DIA_ROWS; ++e) d[c][e] = 0.f;
    if (mine) {
      float vz[DIA_ROWS], vq[DIA_ROWS], vs[DIA_ROWS], vp[DIA_ROWS], vx[DIA_ROWS], vr[DIA_ROWS],
          vu[DIA_ROWS], vw[DIA_ROWS], mo[DIA_ROWS];
      load_rows<true>(vz, z + o, r0, n, vec);
      load_rows<true>(vq, q + o, r0, n, vec);
      load_rows<true>(vs, s + o, r0, n, vec);
      load_rows<true>(vp, p + o, r0, n, vec);
      load_rows<true>(vx, x + o, r0, n, vec);
      load_rows<true>(vr, r + o, r0, n, vec);
      load_rows<true>(vu, u + o, r0, n, vec);
      load_rows<true>(vw, w + o, r0, n, vec);
      const float alpha = alpha_p[l];
      const float beta = beta_p[l];
#pragma unroll
      for (int e = 0; e < DIA_ROWS; ++e) {
        if (r0 + e >= n) {  // past n: the K = 1 kernel's dots are 0 there
          mo[e] = 0.f;
          continue;
        }
        IterRow v = {vz[e], vq[e], vs[e], vp[e], vx[e], vr[e], vu[e], vw[e]};
        float de[3];
        mo[e] = iter_row(v, acc[l][e], mv[e], iv[e], alpha, beta, de);
        vz[e] = v.z; vq[e] = v.q; vs[e] = v.s; vp[e] = v.p;
        vx[e] = v.x; vr[e] = v.r; vu[e] = v.u; vw[e] = v.w;
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c][e] = de[c];
      }
      store_rows<true>(z + o, vz, r0, n, vec);
      store_rows<true>(q + o, vq, r0, n, vec);
      store_rows<true>(s + o, vs, r0, n, vec);
      store_rows<true>(p + o, vp, r0, n, vec);
      store_rows<true>(x + o, vx, r0, n, vec);
      store_rows<true>(r + o, vr, r0, n, vec);
      store_rows<true>(u + o, vu, r0, n, vec);
      store_rows<true>(w + o, vw, r0, n, vec);
      store_rows<false>(m_out + o, mo, r0, n, vec);
    }
    // every thread, rows or not: the shuffles take the whole warp
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = rows_sum32(d[c]);
      if ((threadIdx.x & 7) == 0) warps[l][c][threadIdx.x >> 3] = t;
    }
  }
  if (live == 0) return;  // the same branch for the whole grid
  __syncthreads();
  // block_sum's last level over the 8 warp sums of each 256-row quarter
  const int lane = threadIdx.x & 31;
  const int64_t nb = (n + REPRO_BLOCK - 1) / REPRO_BLOCK;  // the K = 1 kernel's blocks
  for (int t = threadIdx.x >> 5; t < K * 12; t += REPRO_BLOCK / 32) {
    const int l = t / 12, quarter = (t % 12) / 3, c = t % 3;
    if (!((live >> l) & 1u)) continue;
    const float v = warp_sum(lane < 8 ? warps[l][c][8 * quarter + lane] : 0.f);
    const int64_t b = 4 * (int64_t)blockIdx.x + quarter;
    if (lane == 0 && b < nb) partials[3 * ((int64_t)l * nb + b) + c] = v;
  }
}

template <int K>
static cudaError_t launch_fused_iter_tiles(const int* offsets, int k, cudaStream_t st,
                                           const void* data, const void* m_in, void* m_out,
                                           void* z, void* q, void* s, void* p, void* x, void* r,
                                           void* u, void* w, const void* inv, const void* alpha,
                                           const void* beta, const void* active, void* partials,
                                           int64_t n) {
  static std::atomic<int> raised{0};
  static std::atomic<bool> carved{false};
  const DiaTilePlan plan = make_tile_plan<float>(offsets, k, K);
  const int ws = tile_lane_elems<float>(plan.span);
  const size_t smem = tile_window_bytes<K, float>(ws);
  const cudaError_t err = allow_tile_shared(fused_iter_tile_kernel<K>, smem, &raised, &carved);
  if (err != cudaSuccess) return err;
  fused_iter_tile_kernel<K><<<(unsigned)tile_blocks(n), REPRO_BLOCK, smem, st>>>(
      plan, (const __nv_bfloat16*)data, (const float*)m_in, (float*)m_out, (float*)z, (float*)q,
      (float*)s, (float*)p, (float*)x, (float*)r, (float*)u, (float*)w, (const float*)inv,
      (const float*)alpha, (const float*)beta, (const uint8_t*)active, (float*)partials, n, ws);
  return cudaGetLastError();
}

template <int K, typename TD>
static cudaError_t launch_fused_iter(const int* offsets, int k, int64_t blocks, cudaStream_t st,
                                     const void* data, const void* m_in, void* m_out, void* z,
                                     void* q, void* s, void* p, void* x, void* r, void* u,
                                     void* w, const void* inv, const void* alpha,
                                     const void* beta, const void* active, void* partials,
                                     int64_t n) {
  if constexpr (K > 1 && std::is_same_v<TD, __nv_bfloat16>) {  // the bf16-band lanes
    return launch_fused_iter_tiles<K>(offsets, k, st, data, m_in, m_out, z, q, s, p, x, r, u, w,
                                      inv, alpha, beta, active, partials, n);
  } else {
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
