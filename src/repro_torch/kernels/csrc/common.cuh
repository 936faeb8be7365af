// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel runs REPRO_BLOCK threads per block, one thread per row (the
// DIA row-tile kernels: DIA_ROWS rows a thread), launches on the caller's
// stream, allocates nothing, and is reached through a plain C entry that
// returns cudaGetLastError().
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

// ---- the DIA row tile ------------------------------------------------------
//
// The DIA sum of the lane kernels at K = 2..8 (spmv_dia_tile_kernel, and
// fused_iter's bf16-band lanes): a block covers DIA_TILE_ROWS rows, a
// thread DIA_ROWS consecutive ones; each live lane's window of x goes into
// shared memory, planar, by 16-byte cp.async on mbarriers, and the
// diagonals are summed in register tiles of up to DIA_CHUNK consecutive
// offsets. spmv_dia.cu's note has the design; dia_tile_sum below is it.
#define DIA_ROWS 4                               // consecutive rows a thread sums
#define DIA_TILE_ROWS (REPRO_BLOCK * DIA_ROWS)   // rows a block covers
#define DIA_CHUNK 5                              // diagonals a thread sums per window load
#define DIA_STAGES 2                             // windows in flight a block
#define DIA_STAGE_BYTES (50 * 1024)              // one window of every lane
#define DIA_LANES_F32 2                          // lanes a branch-free block sums: f32
#define DIA_LANES_F32_BF16BAND 4                 // f32 windows with a bf16 band
#define DIA_LANES_BF16 8                         // bf16 (lanes_a_block)

// A row-tile kernel's plan: groups of diagonals (one window each, in j
// order), each cut into chunks of consecutive j whose offsets rise by 1.
struct DiaTilePlan {
  int groups;
  int chunks;
  int span;                          // the widest group's hi - lo
  int lo[REPRO_MAX_DIAGS];           // group g's lowest offset
  uint16_t width[REPRO_MAX_DIAGS];   // its highest offset - lo
  uint16_t end[REPRO_MAX_DIAGS];     // one past its last chunk
  uint16_t rel[REPRO_MAX_DIAGS];     // chunk c's first offset - its group's lo
  uint8_t len[REPRO_MAX_DIAGS];      // chunk c's diagonals, 1..DIA_CHUNK
};

// Elements of one 16-byte piece of a window.
template <typename T>
static __host__ __device__ constexpr int tile_vec() { return 16 / (int)sizeof(T); }

// Elements of one lane's window for a group of width `span`: the tile's
// rows plus the span, the shift (< one piece) and the 12 elements the
// last thread's three loads reach from a 4-element boundary, in whole pieces.
template <typename T>
static inline int tile_lane_elems(int span) {
  constexpr int V = tile_vec<T>();
  return (DIA_TILE_ROWS + span + V + 7 + V - 1) / V * V;
}

template <typename T>
static inline DiaTilePlan make_tile_plan(const int* offsets, int k, int lanes) {
  constexpr int V = tile_vec<T>();
  const int max_span = DIA_STAGE_BYTES / (lanes * (int)sizeof(T)) - DIA_TILE_ROWS - 2 * V - 8;
  const DiagRuns g = make_runs(offsets, k, max_span);
  DiaTilePlan p;
  p.groups = g.runs;
  p.chunks = 0;
  p.span = g.span;
  for (int q = 0; q < g.runs; ++q) {
    p.lo[q] = g.lo[q];
    p.width[q] = (uint16_t)(g.hi[q] - g.lo[q]);
    const int j1 = g.start[q + 1];
    for (int j = g.start[q]; j < j1;) {
      int len = 1;
      while (len < DIA_CHUNK && j + len < j1 && offsets[j + len] == offsets[j + len - 1] + 1)
        ++len;
      p.rel[p.chunks] = (uint16_t)(offsets[j] - g.lo[q]);
      p.len[p.chunks] = (uint8_t)len;
      ++p.chunks;
      j += len;
    }
    p.end[q] = (uint16_t)p.chunks;
  }
  return p;
}

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals: one a thread and stage).
static __device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Elements between a lane's window start (element `at` of x) and the
// 16-byte boundary at or below it.
template <typename T>
static __device__ __forceinline__ int lane_shift(const T* x, int64_t at) {
  return (int)((((uintptr_t)x + (uintptr_t)(at * (int64_t)sizeof(T))) & 15u) / sizeof(T));
}

// Copies `pieces` 16-byte pieces of one lane's x (xl, n columns), from
// column `first` (its address 16-byte aligned), into dst; elements outside
// [0, n) are 0. Every thread of the block takes every REPRO_BLOCK-th piece.
template <typename T>
static __device__ __forceinline__ void stage_window(T* __restrict__ dst, const T* __restrict__ xl,
                                                    int64_t first, int pieces, int64_t n) {
  constexpr int V = tile_vec<T>();
  for (int q = threadIdx.x; q < pieces; q += REPRO_BLOCK) {
    const int64_t c = first + (int64_t)q * V;
    if (c >= 0 && c + V <= n) {
      cp_async16(dst + q * V, xl + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        dst[q * V + e] = (c + e >= 0 && c + e < n) ? xl[c + e] : from_f32<T>(0.f);
    }
  }
}

// Four consecutive entries: a band quad (4 rows of a diagonal) or 4 window
// elements, as loaded (float4 or 4 bf16 in a uint2) and as f32.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using raw = float4;
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(raw v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ raw load4(const float* __restrict__ p, int64_t r0,
                                              int64_t n) {
    raw v;
    v.x = r0 < n ? __ldcs(p + r0) : 0.f;
    v.y = r0 + 1 < n ? __ldcs(p + r0 + 1) : 0.f;
    v.z = r0 + 2 < n ? __ldcs(p + r0 + 2) : 0.f;
    v.w = r0 + 3 < n ? __ldcs(p + r0 + 3) : 0.f;
    return v;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using raw = uint2;
  static __device__ __forceinline__ raw zero() { return make_uint2(0u, 0u); }
  // bf16 -> f32 is exact: the 16 bits become the high half of the float
  static __device__ __forceinline__ void unpack(raw v, float* f) {
    f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ raw load4(const __nv_bfloat16* __restrict__ p, int64_t r0,
                                              int64_t n) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) e[r] = r0 + r < n ? (unsigned)__ldcs(h + r0 + r) : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
};

// The band entries of chunk diagonals j..j+len-1 for rows r0..r0+3
// (streamed: read once a launch); 0 past len and past n.
template <typename T>
static __device__ __forceinline__ void load_band(typename Quad<T>::raw (&b)[DIA_CHUNK],
                                                 const T* __restrict__ data, int j, int len,
                                                 int64_t r0, int64_t n, bool vec) {
#pragma unroll
  for (int u = 0; u < DIA_CHUNK; ++u) {
    const T* p = data + (int64_t)(j + u) * n;
    if (u >= len) b[u] = Quad<T>::zero();
    else if (vec) b[u] = r0 < n ? __ldcs(reinterpret_cast<const typename Quad<T>::raw*>(p + r0))
                                : Quad<T>::zero();
    else b[u] = Quad<T>::load4(p, r0, n);
  }
}

// acc[r] += d[u][r] * w[A + r + u] for u < L (L = DIA_CHUNK: a full chunk,
// no branch) or u < len (L = 0), in u order, where w holds the window from
// a 4-element boundary: the loads cover A + DIA_ROWS + DIA_CHUNK - 1
// elements.
template <int A, int L, typename T>
static __device__ __forceinline__ void chunk_sum(float (&acc)[DIA_ROWS], const T* __restrict__ w,
                                                 const float (&d)[DIA_CHUNK][DIA_ROWS], int len) {
  constexpr int NQ = (A + DIA_ROWS + DIA_CHUNK - 2) / 4 + 1;
  float xv[4 * NQ];
  const typename Quad<T>::raw* wq = reinterpret_cast<const typename Quad<T>::raw*>(w);
#pragma unroll
  for (int q = 0; q < NQ; ++q) Quad<T>::unpack(wq[q], xv + 4 * q);
#pragma unroll
  for (int u = 0; u < DIA_CHUNK; ++u) {
    if (L == DIA_CHUNK || u < len) {
#pragma unroll
      for (int r = 0; r < DIA_ROWS; ++r) acc[r] += d[u][r] * xv[A + r + u];
    }
  }
}

// Lanes summed in one branch-free block (window type T, band TD): more
// lanes keep more shared loads in flight, as long as their window values fit
// in registers with the rest (an f32 value takes twice the registers of a
// bf16 one, and the next chunk of an f32 band twice those of a bf16 band:
// all 8 f32 lanes in one block spill; 4 fit beside a bf16 band, in 127
// registers at K = 8, and ran faster than 2 in fused_iter's lanes).
template <typename TD, typename T>
static __host__ __device__ constexpr int lanes_a_block() {
  if constexpr (sizeof(T) == 2) return DIA_LANES_BF16;
  else return sizeof(TD) == 2 ? DIA_LANES_F32_BF16BAND : DIA_LANES_F32;
}

// One chunk for lanes l0..l0+G-1 of those whose windows share the
// misalignment A: lane l's window at w + lane[l]. Dead lanes are summed too
// (their windows hold stale values, their sums are not stored), so the
// group's loads and products form one branch-free block.
template <int A, int L, int G, int K, typename T>
static __device__ __forceinline__ void chunk_lanes(float (&acc)[K][DIA_ROWS], int l0,
                                                   const T* __restrict__ w, const int (&lane)[K],
                                                   const float (&d)[DIA_CHUNK][DIA_ROWS],
                                                   int len) {
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (l0 + i < K) chunk_sum<A, L>(acc[l0 + i], w + lane[l0 + i], d, len);
}

// Every lane of a chunk, G at a time, each group under a switch of its own
// on the misalignment a (made opaque per group, so the compiler does not
// merge the groups into one block).
template <int G, int L, int K, typename T>
static __device__ __forceinline__ void chunk_groups(int a, float (&acc)[K][DIA_ROWS],
                                                    const T* __restrict__ w, const int (&lane)[K],
                                                    const float (&d)[DIA_CHUNK][DIA_ROWS],
                                                    int len) {
#pragma unroll
  for (int l0 = 0; l0 < K; l0 += G) {
    int ag = a;
    asm volatile("" : "+r"(ag));
    switch (ag) {
      case 0: chunk_lanes<0, L, G>(acc, l0, w, lane, d, len); break;
      case 1: chunk_lanes<1, L, G>(acc, l0, w, lane, d, len); break;
      case 2: chunk_lanes<2, L, G>(acc, l0, w, lane, d, len); break;
      default: chunk_lanes<3, L, G>(acc, l0, w, lane, d, len); break;
    }
  }
}

// acc[l][r] = sum_j data[j, r0 + r] * x[l, r0 + r + off_j] over every
// diagonal, in j order (the K = 1 kernel's order), with x zero outside
// [0, n), for the thread's rows r0 = i0 + DIA_ROWS * threadIdx.x; the band
// TD is read once for all lanes and upcast per product, the windows hold x
// in its own type T (`ws` elements a lane, DIA_STAGES stages: `wins` is
// tile_window_bytes<K, T>(ws) of dynamic shared memory). Lanes not in
// `live` are not staged (their sums are junk), and with no live lane
// nothing is read and acc is 0. Every thread of the block calls it (it
// synchronises); rows >= n stage but sum junk. The ring is not read after
// the return, but no barrier closes the last group.
template <int K, typename TD, typename T>
static __device__ __forceinline__ void dia_tile_sum(const DiaTilePlan& plan,
                                                    const TD* __restrict__ data,
                                                    const T* __restrict__ x, unsigned live,
                                                    int64_t i0, int64_t n, int ws,
                                                    float (&acc)[K][DIA_ROWS],
                                                    T* __restrict__ wins) {
  constexpr int V = tile_vec<T>();
  using Raw = typename Quad<TD>::raw;
  __shared__ __align__(8) uint64_t full[DIA_STAGES];
  const int64_t r0 = i0 + DIA_ROWS * threadIdx.x;
  // 8- or 16-byte band quads where every diagonal's rows stay aligned
  const bool vec = (n & 3) == 0 && ((uintptr_t)data & (4 * sizeof(TD) - 1)) == 0;
#pragma unroll
  for (int l = 0; l < K; ++l)
#pragma unroll
    for (int r = 0; r < DIA_ROWS; ++r) acc[l][r] = 0.f;
  if (live == 0 || plan.chunks == 0) return;  // the same branch for the whole grid
  if (threadIdx.x == 0)
    for (int s = 0; s < DIA_STAGES; ++s) mbar_init(&full[s], REPRO_BLOCK);
  Raw next[DIA_CHUNK];
  load_band<TD>(next, data, 0, plan.len[0], r0, n, vec);  // in flight over the first window
  __syncthreads();  // the barriers are initialised
  // group g's window of every live lane into stage g % DIA_STAGES
  auto stage = [&](int g) {
    T* win = wins + (g % DIA_STAGES) * K * ws;
    const int64_t c0 = i0 + plan.lo[g];
    const int cols = DIA_TILE_ROWS + plan.width[g];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (!((live >> l) & 1u)) continue;
      const int sh = lane_shift(x, (int64_t)l * n + c0);
      stage_window<T>(win + l * ws, x + (int64_t)l * n, c0 - sh, (sh + cols + V - 1) / V, n);
    }
    mbar_arrive_copies(&full[g % DIA_STAGES]);
  };
  stage(0);
  int c = 0, j = 0;
  for (int g = 0; g < plan.groups; ++g) {
    // every thread is done with window g - 1, whose buffer stage g + 1
    // takes, and the element-wise edges of window g are written
    __syncthreads();
    if (g + 1 < plan.groups) stage(g + 1);
    mbar_wait(&full[g % DIA_STAGES], (unsigned)(g / DIA_STAGES) & 1u);
    const T* win = wins + (g % DIA_STAGES) * K * ws;
    // lane l's window in this stage: lane[l] + its shift (sh[l] elements)
    int sh[K], lane[K];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      sh[l] = lane_shift(x, (int64_t)l * n + i0 + plan.lo[g]);
      lane[l] = l * ws + (sh[l] & ~3);
    }
    for (; c < plan.end[g]; ++c) {
      const int len = plan.len[c];
      float d[DIA_CHUNK][DIA_ROWS];
#pragma unroll
      for (int u = 0; u < DIA_CHUNK; ++u) Quad<TD>::unpack(next[u], d[u]);
      j += len;
      if (c + 1 < plan.chunks) load_band<TD>(next, data, j, plan.len[c + 1], r0, n, vec);
      const int rel = DIA_ROWS * (int)threadIdx.x + plan.rel[c];
      if ((n & 3) == 0) {  // every lane's shift is the same modulo 4
        const int at = rel + (sh[0] & 3);
        constexpr int G = lanes_a_block<TD, T>();
        if (len == DIA_CHUNK)
          chunk_groups<G, DIA_CHUNK>(at & 3, acc, win + (at & ~3), lane, d, len);
        else
          chunk_groups<G, 0>(at & 3, acc, win + (at & ~3), lane, d, len);
      } else {  // lane by lane
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (!((live >> l) & 1u)) continue;
          const int at = rel + sh[l];
          const T* w = win + l * ws + (at & ~3);
          switch (at & 3) {
            case 0: chunk_sum<0, 0>(acc[l], w, d, len); break;
            case 1: chunk_sum<1, 0>(acc[l], w, d, len); break;
            case 2: chunk_sum<2, 0>(acc[l], w, d, len); break;
            default: chunk_sum<3, 0>(acc[l], w, d, len); break;
          }
        }
      }
    }
  }
}

// Dynamic shared memory of a row-tile launch: DIA_STAGES windows of K lanes.
template <int K, typename T>
static inline size_t tile_window_bytes(int ws) {
  return (size_t)DIA_STAGES * K * ws * sizeof(T);
}

static inline int64_t tile_blocks(int64_t n) { return (n + DIA_TILE_ROWS - 1) / DIA_TILE_ROWS; }

// allow_shared, and once per kernel all of the SM's 228 KB as shared
// memory, so that two blocks of 8-lane f32 windows fit an SM.
template <typename F>
static cudaError_t allow_tile_shared(F* kernel, size_t bytes, std::atomic<int>* raised,
                                     std::atomic<bool>* carved) {
  cudaError_t err = allow_shared(kernel, bytes, raised);
  if (err != cudaSuccess || carved->load()) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) carved->store(true);
  return err;
}
