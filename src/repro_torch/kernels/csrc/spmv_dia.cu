// Banded (DIA) SPMV: y[i] = sum_j data[j, i] * x[i + off_j], zero outside [0, n).
//
// Replaces the TPU kernel src/repro/kernels/spmv_dia/kernel.py:spmv_dia_padded.
//
// Bound on this card: bytes. Per row it reads k diagonal entries and
// one x, and writes one y (f32, k = 125: 508 B/row), against 2k flops,
// far below the H100's operations-per-byte line.
//
// Design: one thread per row; the loop over the k diagonals reads
// data row-major (k, n), so each diagonal's read is coalesced across
// the warp; x[i + off] is read straight from global memory and the
// L1/L2 caches serve its reuse between neighbouring diagonals (the
// TPU kernel's three-tile window and its "tile >= bandwidth" rule are
// BlockSpec artifacts and are not carried over). The column is guarded
// explicitly: the DIA zero convention makes the product 0, but does
// not make an out-of-range load legal. Accumulation is f32 for f32 and
// bf16 storage alike, in the order of the diagonals, as in the plain
// version. These entries take bf16 storage; f32 goes through the lane
// entry below, a single vector being one lane.
#include "common.cuh"

template <typename T, typename OutT>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_dia_kernel(const __grid_constant__ DiagOffsets offs, const T* __restrict__ data,
                const T* __restrict__ x, OutT* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int j = 0; j < offs.k; ++j) {
    const int64_t c = i + offs.off[j];
    const float xv = (c >= 0 && c < n) ? to_f32(x[c]) : 0.f;
    acc += to_f32(data[(int64_t)j * n + i]) * xv;
  }
  y[i] = from_f32<OutT>(acc);
}

template <typename T, typename OutT>
static int launch_spmv(const int* offsets, int k, const void* data, const void* x, void* y,
                       int64_t n, void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const DiagOffsets offs = make_offsets(offsets, k);
  spmv_dia_kernel<T, OutT><<<(unsigned)repro_blocks(n), REPRO_BLOCK, 0, (cudaStream_t)stream>>>(
      offs, (const T*)data, (const T*)x, (OutT*)y, n);
  return (int)cudaGetLastError();
}

extern "C" {

int spmv_dia_bf16_f32(const int* offsets, int k, const void* data, const void* x, void* y,
                      int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, float>(offsets, k, data, x, y, n, stream);
}

int spmv_dia_bf16_bf16(const int* offsets, int k, const void* data, const void* x, void* y,
                       int64_t n, void* stream) {
  return launch_spmv<__nv_bfloat16, __nv_bfloat16>(offsets, k, data, x, y, n, stream);
}

}  // extern "C"

// ---- lane-batched entries: Y[l] = A X[l] for k right-hand sides ----------
//
// Replaces src/repro/kernels/spmv_dia/kernel.py:spmv_dia_padded, and the
// same kernel under jax.vmap (init, residual replacement and the "cuda"
// engine of a batched solve on a DIA operator; the "bf16" engine's SPMV of
// a batched solve); one vector is k = 1. data and X are both f32 or both
// bf16; the sums are f32 and Y is f32 (spmv_dia_bf16's out_dtype=acc). A
// lane whose flag is 0 reads nothing and gets Y[l] = 0, as spmv_bell gives
// a converged solve; with no flag every lane is computed.
//
// Bound on this card: bytes, k_diag * s + (s + 4) K bytes a row (s the
// storage's bytes): the band is read once for all K lanes of a launch.
//
// K = 1, every single-rhs f32 SPMV, is spmv_dia_lanes_kernel<1, T>: one
// thread a row, x gathered through L1 (dia_lanes_sum in common.cuh).
//
// K = 2..8 is spmv_dia_tile_kernel<K, T>:
// - Row tiles. A block covers DIA_TILE_ROWS = 1024 rows, a thread
//   DIA_ROWS = 4 consecutive ones. A window of x is read from L2 once per
//   block and group of diagonals, so at poisson125(128) (5 groups, each a
//   z-plane's 25 diagonals over 516 columns) the halo is a third of a
//   1540-column window instead of two thirds at 256 rows.
// - Windows. The groups are consecutive diagonals whose offsets lie within
//   the span that DIA_STAGE_BYTES allows for K lanes (make_runs, as
//   fused_iter's). Each live lane's window goes into shared memory planar
//   (lane-major) and in the storage type (bf16 stays bf16), by 16-byte
//   cp.async.cg, into a ring of DIA_STAGES buffers, each completed on an
//   mbarrier (cp.async.mbarrier.arrive.noinc). A lane's window starts at the
//   16-byte boundary at or below its first column and keeps that shift
//   (lane l starts at element l * n, and n need not be a multiple of 4 or
//   8); 16-byte pieces that cross the edges of [0, n) are written element by
//   element, 0 outside. Dead lanes are not staged. Two stages of a
//   poisson125 window at 8 f32 lanes take 99,328 B: two blocks an SM.
// - Register tiles. The diagonals of a group run in chunks of up to
//   DIA_CHUNK whose offsets rise by 1 (poisson125: 25 runs of 5). For a
//   chunk and a lane a thread loads the DIA_ROWS + chunk - 1 columns its
//   products need as three 16-byte (f32) or 8-byte (bf16) shared loads,
//   consecutive threads on consecutive addresses (no bank conflict, no
//   swizzle needed), for DIA_ROWS x chunk products: 96 B of shared reads a
//   row and chunk of 5 at 8 f32 lanes, against 160 B for one column per
//   diagonal. The loads' misalignment within 4 elements is the same for the
//   whole block (the lane's shift plus the chunk's offset), so the sum is
//   unrolled once for each of its 4 values and picked by a switch. Where
//   n % 4 == 0 every lane has the same misalignment, and the lanes are
//   summed in branch-free groups (lanes_a_block: 2 f32 lanes, 8 bf16 ones,
//   the most that fit in 128 registers without spilling), so one lane's
//   shared loads overlap another's products; otherwise lane by lane.
// - The band. A chunk's entries of the thread's 4 rows are one 16-byte
//   (f32) or 8-byte (bf16) load a diagonal where n % 4 == 0, else 4
//   scalar loads; the next chunk's are loaded while the current one is
//   summed, and the first chunk's before the first window is waited for.
// Each (lane, row) sum adds its products in diagonal order, as the K = 1
// kernel does: every lane is bit for bit the single kernel on X[l].
template <int K, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_dia_lanes_kernel(const __grid_constant__ DiagRuns runs, const T* __restrict__ data,
                      const T* __restrict__ x, const uint8_t* __restrict__ active,
                      float* __restrict__ y, int64_t n) {
  extern __shared__ __align__(16) float repro_smem[];
  const int64_t i0 = (int64_t)blockIdx.x * REPRO_BLOCK;
  const int64_t i = i0 + threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K];
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.f;
  if (live != 0) dia_lanes_sum<K>(runs, data, x, live, i0, n, acc, repro_smem);
  if (i >= n) return;
#pragma unroll
  for (int l = 0; l < K; ++l) y[(int64_t)l * n + i] = ((live >> l) & 1u) ? acc[l] : 0.f;
}

template <int K, typename T>
static cudaError_t launch_dia_lanes(const int* offsets, int k, const void* data, const void* x,
                                    const void* active, void* y, int64_t n, cudaStream_t st) {
  static std::atomic<int> raised{0};
  const DiagRuns runs = lane_runs<K>(offsets, k);
  const size_t smem = dia_window_bytes<K>(runs);
  const cudaError_t err = allow_shared(spmv_dia_lanes_kernel<K, T>, smem, &raised);
  if (err != cudaSuccess) return err;
  spmv_dia_lanes_kernel<K, T><<<(unsigned)repro_blocks(n), REPRO_BLOCK, smem, st>>>(
      runs, (const T*)data, (const T*)x, (const uint8_t*)active, (float*)y, n);
  return cudaGetLastError();
}

#define DIA_ROWS 4                               // consecutive rows a thread sums
#define DIA_TILE_ROWS (REPRO_BLOCK * DIA_ROWS)   // rows a block covers
#define DIA_CHUNK 5                              // diagonals a thread sums per window load
#define DIA_STAGES 2                             // windows in flight a block
#define DIA_STAGE_BYTES (50 * 1024)              // one window of every lane
#define DIA_LANES_F32 2                          // lanes a branch-free block sums, f32
#define DIA_LANES_BF16 8                         // and bf16 (lanes_a_block)

// The tile kernel's plan: groups of diagonals (one window each, in j
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

// Lanes summed in one branch-free block: more lanes keep more shared loads
// in flight, as long as their window values fit in registers with the rest
// (an f32 value takes twice the registers of a bf16 one; all 8 f32 lanes in
// one block spill).
template <typename T>
static __host__ __device__ constexpr int lanes_a_block() {
  return sizeof(T) == 4 ? DIA_LANES_F32 : DIA_LANES_BF16;
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

// Every lane of a chunk, lanes_a_block<T>() at a time, each group under a
// switch of its own on the misalignment a (made opaque per group, so the
// compiler does not merge the groups into one block).
template <int L, int K, typename T>
static __device__ __forceinline__ void chunk_groups(int a, float (&acc)[K][DIA_ROWS],
                                                    const T* __restrict__ w, const int (&lane)[K],
                                                    const float (&d)[DIA_CHUNK][DIA_ROWS],
                                                    int len) {
  constexpr int G = lanes_a_block<T>();
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

template <int K, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK, 2)
spmv_dia_tile_kernel(const __grid_constant__ DiaTilePlan plan, const T* __restrict__ data,
                     const T* __restrict__ x, const uint8_t* __restrict__ active,
                     float* __restrict__ y, int64_t n, int ws) {
  constexpr int V = tile_vec<T>();
  using Raw = typename Quad<T>::raw;
  extern __shared__ __align__(16) unsigned char repro_tile_smem[];
  __shared__ __align__(8) uint64_t full[DIA_STAGES];
  T* wins = reinterpret_cast<T*>(repro_tile_smem);
  const int64_t i0 = (int64_t)blockIdx.x * DIA_TILE_ROWS;
  const int64_t r0 = i0 + DIA_ROWS * threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  // 16-byte band quads and y stores where every lane's rows stay aligned
  const bool vec = (n & 3) == 0 && ((uintptr_t)data & (4 * sizeof(T) - 1)) == 0 &&
                   ((uintptr_t)y & 15) == 0;
  float acc[K][DIA_ROWS];
#pragma unroll
  for (int l = 0; l < K; ++l)
#pragma unroll
    for (int r = 0; r < DIA_ROWS; ++r) acc[l][r] = 0.f;

  if (live != 0 && plan.chunks > 0) {  // the same branch for the whole grid
    if (threadIdx.x == 0)
      for (int s = 0; s < DIA_STAGES; ++s) mbar_init(&full[s], REPRO_BLOCK);
    Raw next[DIA_CHUNK];
    load_band<T>(next, data, 0, plan.len[0], r0, n, vec);  // in flight over the first window
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
        for (int u = 0; u < DIA_CHUNK; ++u) Quad<T>::unpack(next[u], d[u]);
        j += len;
        if (c + 1 < plan.chunks) load_band<T>(next, data, j, plan.len[c + 1], r0, n, vec);
        const int rel = DIA_ROWS * (int)threadIdx.x + plan.rel[c];
        if ((n & 3) == 0) {  // every lane's shift is the same modulo 4
          const int at = rel + (sh[0] & 3);
          if (len == DIA_CHUNK)
            chunk_groups<DIA_CHUNK>(at & 3, acc, win + (at & ~3), lane, d, len);
          else
            chunk_groups<0>(at & 3, acc, win + (at & ~3), lane, d, len);
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
  if (r0 >= n) return;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const bool on = (live >> l) & 1u;
    float* yl = y + (int64_t)l * n + r0;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(yl), on ? make_float4(acc[l][0], acc[l][1], acc[l][2],
                                                             acc[l][3])
                                               : make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
#pragma unroll
      for (int r = 0; r < DIA_ROWS; ++r)
        if (r0 + r < n) __stcs(yl + r, on ? acc[l][r] : 0.f);
    }
  }
}

template <int K, typename T>
static cudaError_t launch_dia_tiles(const int* offsets, int k, const void* data, const void* x,
                                    const void* active, void* y, int64_t n, cudaStream_t st) {
  static std::atomic<int> raised{0};
  static std::atomic<bool> carved{false};
  const DiaTilePlan plan = make_tile_plan<T>(offsets, k, K);
  const int ws = tile_lane_elems<T>(plan.span);
  const size_t smem = (size_t)DIA_STAGES * K * ws * sizeof(T);
  cudaError_t err = allow_shared(spmv_dia_tile_kernel<K, T>, smem, &raised);
  if (err != cudaSuccess) return err;
  if (!carved.load()) {  // all of the SM's 228 KB as shared memory: two blocks an SM
    err = cudaFuncSetAttribute(spmv_dia_tile_kernel<K, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carved.store(true);
  }
  const int64_t blocks = (n + DIA_TILE_ROWS - 1) / DIA_TILE_ROWS;
  spmv_dia_tile_kernel<K, T><<<(unsigned)blocks, REPRO_BLOCK, smem, st>>>(
      plan, (const T*)data, (const T*)x, (const uint8_t*)active, (float*)y, n, ws);
  return cudaGetLastError();
}

template <typename T>
static int spmv_dia_lanes(const int* offsets, int k, int lanes, const void* data, const void* x,
                          const void* active, void* y, int64_t n, void* stream) {
  if (k < 0 || k > REPRO_MAX_DIAGS || n < 0 || lanes < 1 || lanes > REPRO_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_DIA_LANES(K) \
  case K: err = launch_dia_tiles<K, T>(offsets, k, data, x, active, y, n, st); break;
  switch (lanes) {
    case 1: err = launch_dia_lanes<1, T>(offsets, k, data, x, active, y, n, st); break;
    REPRO_DIA_LANES(2)
    REPRO_DIA_LANES(3)
    REPRO_DIA_LANES(4)
    REPRO_DIA_LANES(5)
    REPRO_DIA_LANES(6)
    REPRO_DIA_LANES(7)
    REPRO_DIA_LANES(8)
  }
#undef REPRO_DIA_LANES
  return (int)err;
}

extern "C" {

int spmv_dia_lanes_f32(const int* offsets, int k, int lanes, const void* data, const void* x,
                       const void* active, void* y, int64_t n, void* stream) {
  return spmv_dia_lanes<float>(offsets, k, lanes, data, x, active, y, n, stream);
}

int spmv_dia_lanes_bf16_f32(const int* offsets, int k, int lanes, const void* data,
                            const void* x, const void* active, void* y, int64_t n,
                            void* stream) {
  return spmv_dia_lanes<__nv_bfloat16>(offsets, k, lanes, data, x, active, y, n, stream);
}

}  // extern "C"
