// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel runs REPRO_BLOCK threads per block, one thread per row,
// launches on the caller's stream, allocates nothing, and is reached
// through a plain C entry that returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// Bit l set when lane l is still running (all lanes when active is NULL).
static __device__ __forceinline__ unsigned live_lanes(const uint8_t* __restrict__ active,
                                                     int lanes) {
  unsigned live = 0;
  for (int l = 0; l < lanes; ++l)
    if (active == nullptr || active[l] != 0) live |= 1u << l;
  return live;
}

// ---- lane-interleaved windows in shared memory ------------------------------
//
// The DIA and Bell lane kernels stage, per block, a window of consecutive
// columns of every live lane's vector in shared memory, interleaved: column
// t's K values are one row of KP floats (K rounded up to 2, 4 or 8), so a
// diagonal's or slot's K lane values are one or two 16-byte shared loads
// instead of K global gathers. At KP = 8 the two 16-byte halves of a row
// swap places when bit 2 of t is set: eight threads reading eight
// consecutive rows then hit 32 distinct banks (unswizzled, two of them
// share each bank). Staging goes through cp.async (4 bytes an element,
// transposing on the way in) so the next window loads while the current
// one is read; columns outside [0, n) and dead or padding lanes are zero-
// filled without a read. Windows start at a multiple of 8 columns, so
// every 8 consecutive threads copy one 32-byte sector of one lane.
template <int K>
static __host__ __device__ constexpr int lane_pad() {
  static_assert(K >= 2 && K <= REPRO_MAX_LANES, "lane windows hold 2 to 8 lanes");
  return K <= 2 ? 2 : (K <= 4 ? 4 : 8);
}

template <int KP>
static __device__ __forceinline__ int lane_slot(int t, int l) {
  if constexpr (KP == 8) return t * 8 + (l ^ (t & 4));
  else return t * KP + l;
}

template <int KP>
static __device__ __forceinline__ void load_lane_row(const float* __restrict__ win, int t,
                                                     float (&v)[KP]) {
  if constexpr (KP == 8) {
    const float4 a = *reinterpret_cast<const float4*>(win + t * 8 + (t & 4));
    const float4 b = *reinterpret_cast<const float4*>(win + t * 8 + ((t & 4) ^ 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (KP == 4) {
    const float4 a = *reinterpret_cast<const float4*>(win + t * 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(win + t * 2);
    v[0] = a.x; v[1] = a.y;
  }
}

static __device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_async_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One element of an f32 window through cp.async (0 where !ok, not read).
static __device__ __forceinline__ void stage_one(float* dst, const float* __restrict__ x,
                                                 int64_t at, bool ok) {
  cp_async4(dst, ok ? x + at : x, ok ? 4 : 0);
}

// Stages columns [lo, lo + W) of lanes 0..K-1 of an f32 x into win (W
// rows of KP), lo a multiple of 8; lanes not in `live` and columns outside
// [0, n) are 0. Every thread of the block calls it; the caller commits and
// waits.
template <int K, int KP>
static __device__ __forceinline__ void stage_lanes(float* __restrict__ win,
                                                   const float* __restrict__ x, unsigned live,
                                                   int64_t lo, int W, int64_t n) {
  // element e: chunk e / (8 KP) of 8 columns, lane (e / 8) % KP, column e % 8
  const int total = ((W + 7) >> 3) * 8 * KP;
  for (int e = threadIdx.x; e < total; e += REPRO_BLOCK) {
    const int t = ((e / (8 * KP)) << 3) | (e & 7);
    const int l = (e >> 3) & (KP - 1);
    if (t >= W) continue;
    const int64_t c = lo + t;
    const bool ok = l < K && ((live >> l) & 1u) && c >= 0 && c < n;
    stage_one(win + lane_slot<KP>(t, l), x, (int64_t)l * n + c, ok);
  }
}

// ---- the DIA lane sum --------------------------------------------------------
//
// DIA offsets in groups for the lane-batched kernels: group g holds the
// consecutive diagonals [start[g], start[g + 1]) whose offsets lie within
// `max_span` of each other (lo[g] the lowest, hi[g] the highest). A block
// reads, group by group, the window of every lane's vector that the
// group's diagonals touch for its rows: REPRO_BLOCK + hi - lo columns. The
// span comes from a shared-memory budget, not from the stencil:
// REPRO_WINDOW_BYTES holds two windows of the widest group (double
// buffering), so at 8 lanes a group spans up to 768 columns (poisson125 at
// n = 128: one group per z-plane, its 5 x 5 diagonals; Queen_4147's DIA
// band: one group).
#define REPRO_WINDOW_BYTES (64 * 1024)
// Band entries a thread loads before it multiplies them in: a diagonal
// loop that waits for each load keeps too few bytes in flight for HBM at
// the 24-32 warps an SM holds with these windows. 25 is a poisson125
// group's 5 x 5 diagonals at once; 8 and 16 ran slower for fused_iter at 8
// lanes on the H100 (PERF.md).
#define REPRO_DIA_AHEAD 25

struct DiagRuns {
  int k;
  int runs;
  int off[REPRO_MAX_DIAGS];
  int span;  // the widest group's hi - lo
  int lo[REPRO_MAX_DIAGS];
  int hi[REPRO_MAX_DIAGS];
  uint16_t start[REPRO_MAX_DIAGS + 1];
};

// The widest group a window of KP-float rows takes: two windows of
// REPRO_BLOCK + span + 8 columns (8 for the alignment of the start).
static inline int dia_max_span(int kp) {
  return REPRO_WINDOW_BYTES / (2 * kp * (int)sizeof(float)) - REPRO_BLOCK - 8;
}

static inline DiagRuns make_runs(const int* host_offsets, int k, int max_span) {
  DiagRuns d;
  d.k = k;
  d.runs = 0;
  d.span = 0;
  int lo = 0, hi = 0;
  for (int j = 0; j < k; ++j) {
    const int o = host_offsets[j];
    d.off[j] = o;
    const int nlo = o < lo ? o : lo, nhi = o > hi ? o : hi;
    if (j == 0 || (int64_t)nhi - nlo > max_span) {  // open a group
      d.start[d.runs] = (uint16_t)j;
      ++d.runs;
      lo = hi = o;
    } else {
      lo = nlo;
      hi = nhi;
    }
    d.lo[d.runs - 1] = lo;
    d.hi[d.runs - 1] = hi;
    if (hi - lo > d.span) d.span = hi - lo;
  }
  d.start[d.runs] = (uint16_t)k;
  return d;
}

// The groups of a K-lane launch (one lane reads none).
template <int K>
static inline DiagRuns lane_runs(const int* host_offsets, int k) {
  if constexpr (K == 1) return make_runs(host_offsets, k, 0);
  else return make_runs(host_offsets, k, dia_max_span(lane_pad<K>()));
}

// Shared memory a K-lane DIA launch needs: two windows of the widest group.
template <int K>
static inline size_t dia_window_bytes(const DiagRuns& dr) {
  if constexpr (K == 1) return 0;
  else return 2 * (size_t)(REPRO_BLOCK + dr.span + 8) * lane_pad<K>() * sizeof(float);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB the
// attribute must be raised first); `raised` remembers the largest value set.
template <typename F>
static cudaError_t allow_shared(F* kernel, size_t bytes, std::atomic<int>* raised) {
  if (bytes <= 48 * 1024 || (int)bytes <= raised->load()) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) raised->store((int)bytes);
  return err;
}

// Streamed loads and stores (read or written once a launch) of the lane
// kernels: cache-streaming, so L2 keeps the vectors that the windows re-read.
template <bool STREAM, typename T>
static __device__ __forceinline__ T ld_lane(const T* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return *p;
}
template <bool STREAM>
static __device__ __forceinline__ void st_lane(float* p, float v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

// acc[l] += sum_j data[j, i] * x[l, i + off_j] over every diagonal, in j
// order and with x zero outside [0, n): the same operations for every K, so
// a lane's sum does not depend on how many lanes share the launch (and at
// K = 1 they are the single-vector kernel's). The band (TD) is f32 or bf16,
// upcast per product; x (TX) is f32 for K > 1 (the windows hold f32), f32
// or bf16 at K = 1. Lanes not in `live` are not
// read (their sums are junk: the caller discards them). Every thread of the
// block calls it (it synchronises); rows i >= n stage but do not
// accumulate. `wins` is dia_window_bytes<K> of dynamic shared memory, not
// read after the return (no barrier closes the last group). One
// lane gathers x through L1 instead: staging it measured 13% slower
// (PERF.md). For K > 1 the next group's window is copied in (cp.async)
// while the current one is read: one barrier a group.
template <int K, typename TD, typename TX>
static __device__ __forceinline__ void dia_lanes_sum(const DiagRuns& dr,
                                                     const TD* __restrict__ data,
                                                     const TX* __restrict__ x, unsigned live,
                                                     int64_t i0, int64_t n, float (&acc)[K],
                                                     float* __restrict__ wins) {
  const int64_t i = i0 + threadIdx.x;
  if constexpr (K == 1) {
    if (i < n) {
      for (int j = 0; j < dr.k; ++j) {
        const int64_t c = i + dr.off[j];
        const float xv = (c >= 0 && c < n) ? to_f32(x[c]) : 0.f;
        acc[0] += to_f32(data[(int64_t)j * n + i]) * xv;
      }
    }
  } else {
    constexpr int KP = lane_pad<K>();
    const int stride = (REPRO_BLOCK + dr.span + 8) * KP;  // floats a window
    // group g's window starts at i0 + lo[g] rounded down to 8 columns
    auto stage = [&](int g) {
      const int shift = dr.lo[g] & 7;
      stage_lanes<K, KP>(wins + (g & 1) * stride, x, live, i0 + dr.lo[g] - shift,
                         REPRO_BLOCK + dr.hi[g] - dr.lo[g] + shift, n);
      cp_async_group();
    };
    stage(0);
    for (int g = 0; g < dr.runs; ++g) {
      cp_async_wait_all();
      __syncthreads();  // window g is in; every thread is done with g - 1's
      if (g + 1 < dr.runs) stage(g + 1);
      if (i < n) {
        const float* win = wins + (g & 1) * stride;
        const int base = (dr.lo[g] & 7) - dr.lo[g] + (int)threadIdx.x;
        const int j1 = dr.start[g + 1];
        // REPRO_DIA_AHEAD band loads in flight a thread, then their sums
        for (int j0 = dr.start[g]; j0 < j1; j0 += REPRO_DIA_AHEAD) {
          float dv[REPRO_DIA_AHEAD];
#pragma unroll
          for (int u = 0; u < REPRO_DIA_AHEAD; ++u)
            dv[u] = j0 + u < j1 ? to_f32(ld_lane<true>(data + (int64_t)(j0 + u) * n + i)) : 0.f;
#pragma unroll
          for (int u = 0; u < REPRO_DIA_AHEAD; ++u) {
            if (j0 + u < j1) {
              float xv[KP];
              load_lane_row<KP>(win, base + dr.off[j0 + u], xv);
#pragma unroll
              for (int l = 0; l < K; ++l) acc[l] += dv[u] * xv[l];
            }
          }
        }
      }
    }
  }
}
