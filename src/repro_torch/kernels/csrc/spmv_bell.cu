// Block-ELLPACK SPMV: y[i] = sum_r vals[i, r] * x[cols[i, r]], f32 accumulation,
// output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/spmv_bell/kernel.py:spmv_bell_padded.
//
// Bound on this card: bytes. Per row it reads R int32 column indices and
// R values (f32, R = 79: 632 B/row), one x and writes one y, for 2R
// flops, far below the H100's operations-per-byte line.
//
// Design: the operator is row-major (n, R), so a group of G lanes (a
// power of two, 32 when R > 16) works on one row: lane l reads slots l,
// l + G, ..., and neighbouring lanes read neighbouring 4-byte slots of
// one row, where one thread per row would read with a stride of 4R bytes.
// x is gathered through the read-only path (__ldg); the columns of
// neighbouring rows of a banded matrix overlap, so x comes back from L1
// or L2. The G lane sums reduce in a fixed xor-shuffle tree, so every run
// gives the same bits. Padding slots (column 0, value 0) add 0 like any
// other slot. x stays in global memory, so any row count is taken: the TPU
// kernel's 2M-row VMEM limit has no counterpart here. The grid is one
// wave (8 blocks of 256 threads per SM) that strides over the rows, so
// when the device flag `active` is 0 (the solve has converged and the
// host has not polled yet) the launch costs one wave, not 500k blocks:
// the kernel then reads nothing and writes y = 0. Its entry takes bf16;
// its f32 instance is the lane entry's k = 1 (one vector) below.
#include "common.cuh"

#define BELL_BLOCKS_PER_SM 8

template <int G, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_bell_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ x, const uint8_t* __restrict__ active,
                 T* __restrict__ y, int64_t n, int R) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two <= 32");
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t stride = (int64_t)gridDim.x * rows_per_block;
  const int64_t first = (int64_t)blockIdx.x * rows_per_block + threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  if (active != nullptr && *active == 0) {  // the same branch for every thread
    for (int64_t row = first; row < n; row += stride)
      if (lane == 0) y[row] = from_f32<T>(0.f);
    return;
  }
  // the loop bound is the block's first row, so every lane of a warp runs
  // the same trips and takes part in the shuffles; rows past n add 0
  for (int64_t block_row = (int64_t)blockIdx.x * rows_per_block; block_row < n;
       block_row += stride) {
    const int64_t row = block_row + threadIdx.x / G;
    float acc = 0.f;
    if (row < n) {
      const int64_t base = row * R;
      for (int s = lane; s < R; s += G) {
        const int c = __ldg(cols + base + s);
        acc += to_f32(vals[base + s]) * to_f32(__ldg(x + c));
      }
    }
    for (int s = G / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (row < n && lane == 0) y[row] = from_f32<T>(acc);
  }
}

template <int G, typename T>
static int launch_group(const void* cols, const void* vals, const void* x, const void* active,
                        void* y, int64_t n, int R, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int64_t rows_per_block = REPRO_BLOCK / G;
  const int64_t needed = (n + rows_per_block - 1) / rows_per_block;
  const int64_t wave = (int64_t)sms * BELL_BLOCKS_PER_SM;
  const int64_t blocks = needed < wave ? needed : wave;
  spmv_bell_kernel<G, T><<<(unsigned)blocks, REPRO_BLOCK, 0, st>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (const uint8_t*)active, (T*)y, n, R);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_spmv(const void* cols, const void* vals, const void* x, const void* active,
                       void* y, int64_t n, int R, void* stream) {
  if (n < 0 || R < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (R > 16) return launch_group<32, T>(cols, vals, x, active, y, n, R, st);
  if (R > 8) return launch_group<16, T>(cols, vals, x, active, y, n, R, st);
  if (R > 4) return launch_group<8, T>(cols, vals, x, active, y, n, R, st);
  return launch_group<4, T>(cols, vals, x, active, y, n, R, st);
}

extern "C" {

int spmv_bell_bf16(const void* cols, const void* vals, const void* x, const void* active,
                   void* y, int64_t n, int R, void* stream) {
  return launch_spmv<__nv_bfloat16>(cols, vals, x, active, y, n, R, stream);
}

}  // extern "C"

// ---- lane-batched entry: Y[l, i] = sum_s vals[i, s] X[l, cols[i, s]] (f32) --
//
// Replaces src/repro/kernels/spmv_bell/kernel.py:spmv_bell_padded in f32, and
// the same kernel under jax.vmap (the SPMV of a batched solve on a Bell
// operator). One vector (k = 1) runs the kernel above: a K = 1 instance of
// the first lane kernel measured 7% slower at Queen_4147 (PERF.md), for the
// same bits.
//
// Bound on this card: bytes, R (4 + 4) + 8 K bytes a row: cols and vals are
// read once for all K lanes. The first lane kernel gathered every slot's K
// values from the (k, n) layout, one 32-byte L1 sector request a lane and
// slot (about 290 a row at K = 8), which bound it at 22% of the bound.
//
// Design: a block walks tiles of BELL_TILE consecutive rows (a persistent
// grid, as many blocks as fit on the card, striding over the tiles). For
// each tile it holds in shared memory the window of columns [tile - half,
// tile + BELL_TILE + half) of every live lane's X, lane-interleaved (one
// slot's 8 lane values are two 16-byte shared loads), where half is the
// operator's column span (max |col - row| over its nonzero slots, rounded
// up to 8) capped by BELL_SMEM_BYTES; the next tile's window is copied in
// with cp.async while the current one is read. A slot whose column lies
// outside the window (a padding slot at column 0, or a band wider than the
// cap) is gathered from global memory as before: the same value, so the
// window is a cache, not a second path. Within a tile the rows run as in
// the kernel above: a group of G threads a row, thread `lane` summing slots
// lane, lane + G, ... in order, then the xor tree; the tree runs on the K
// sums at once by halving (at each step a thread keeps half of its sums
// and trades the other half with its partner: 9 shuffles at K = 8, G = 32,
// against 40 for K separate trees), which pairs the same values in the same
// order, so lane l is bit for bit the single kernel's y on X[l]. The tile's
// K x BELL_TILE results leave through shared memory, coalesced. A lane
// whose flag is 0 gathers nothing and gets Y[l] = 0; when none is live the
// launch reads nothing and writes zeros. At K = 8 the shared loads (79 x
// 32 B a row), the shuffles and the loads of cols and vals all issue
// through the load/store pipe; PERF.md reckons that is what holds the
// kernel near 57% of the bound.
#define BELL_TILE 256
#define BELL_SMEM_BYTES (56 * 1024)
// Slots a thread's loads cover for a row (the rest of a longer row is read
// in order after them); the next row's are issued before this row's sums.
// 3 covers Queen_4147's 79 slots at G = 32 (4 ran slower there, its fourth
// loads all predicated off; PERF.md).
#define BELL_AHEAD 3

template <int G>
static __device__ __forceinline__ void load_slots(const int32_t* __restrict__ cols,
                                                  const float* __restrict__ vals, int64_t row,
                                                  int64_t n, int R, int lane,
                                                  int (&c)[BELL_AHEAD], float (&v)[BELL_AHEAD]) {
#pragma unroll
  for (int u = 0; u < BELL_AHEAD; ++u) {
    const int s = lane + u * G;
    const bool ok = row < n && s < R;
    c[u] = ok ? __ldcs(cols + row * R + s) : 0;
    v[u] = ok ? __ldcs(vals + row * R + s) : 0.f;
  }
}

// Sums v[0..KP) of the G threads of a group in the xor tree's order, by
// halving: after it a thread holds lanes first .. first + max(KP / G, 1) - 1
// in v[0..], the threads whose low log2(G / KP) bits differ holding the same.
template <int S, int CNT, int KP>
static __device__ __forceinline__ void lane_tree_sum(float (&v)[KP], int lane, int& first) {
  if constexpr (S > 0) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = (lane & S) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
      }
      if (up) first += H;
      lane_tree_sum<S / 2, H, KP>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
      lane_tree_sum<S / 2, 1, KP>(v, lane, first);
    }
  }
}

// Slot (c, v) of a row into the K sums: x's column c from the window
// [lo, lo + W), or from X outside it.
template <int K, int KP>
static __device__ __forceinline__ void bell_slot(const float* __restrict__ win,
                                                 const float* __restrict__ x, unsigned live,
                                                 int64_t lo, int W, int64_t n, int c, float v,
                                                 float (&acc)[KP]) {
  const int64_t d = c - lo;
  if ((uint64_t)d < (uint64_t)W) {
    float xv[KP];
    load_lane_row<KP>(win, (int)d, xv);
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] += v * xv[l];
  } else {
#pragma unroll
    for (int l = 0; l < K; ++l)
      if ((live >> l) & 1u) acc[l] += v * __ldg(x + (int64_t)l * n + c);
  }
}

template <int G, int K>
__global__ void __launch_bounds__(REPRO_BLOCK)
spmv_bell_lanes_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                       const float* __restrict__ x, const uint8_t* __restrict__ active,
                       float* __restrict__ y, int64_t n, int R, int W) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two <= 32");
  constexpr int KP = lane_pad<K>();
  constexpr int ROWS = REPRO_BLOCK / G;                 // rows a trip
  constexpr int HELD = KP > G ? KP / G : 1;             // sums a thread keeps
  constexpr int SHARE = KP < G ? G / KP : 1;            // threads holding the same
  extern __shared__ __align__(16) float repro_smem[];
  float* ybuf = repro_smem;                             // (KP, BELL_TILE)
  float* wins = repro_smem + KP * BELL_TILE;            // two (W, KP) windows
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const unsigned live = live_lanes(active, K);          // the same for the whole grid
  const int64_t tiles = (n + BELL_TILE - 1) / BELL_TILE;
  const int half = (W - BELL_TILE) / 2;                 // a multiple of 8
  if (live == 0) {
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      for (int e = threadIdx.x; e < K * BELL_TILE; e += REPRO_BLOCK) {
        const int64_t row = tile * BELL_TILE + e % BELL_TILE;
        if (row < n) y[(int64_t)(e / BELL_TILE) * n + row] = 0.f;
      }
    return;
  }
  int64_t tile = blockIdx.x;
  if (tile < tiles) stage_lanes<K, KP>(wins, x, live, tile * BELL_TILE - half, W, n);
  cp_async_group();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile's window is in; the last tile's reads are done
    const int64_t next = tile + gridDim.x;
    if (next < tiles)
      stage_lanes<K, KP>(wins + (buf ^ 1) * W * KP, x, live, next * BELL_TILE - half, W, n);
    cp_async_group();
    const float* win = wins + buf * W * KP;
    const int64_t tile_lo = tile * BELL_TILE;
    const int64_t lo = tile_lo - half;
    int cn[BELL_AHEAD];
    float vn[BELL_AHEAD];
    load_slots<G>(cols, vals, tile_lo + grp, n, R, lane, cn, vn);
    for (int t = grp; t < BELL_TILE; t += ROWS) {
      const int64_t row = tile_lo + t;
      int c[BELL_AHEAD];
      float v[BELL_AHEAD];
#pragma unroll
      for (int u = 0; u < BELL_AHEAD; ++u) {
        c[u] = cn[u];
        v[u] = vn[u];
      }
      if (t + ROWS < BELL_TILE) load_slots<G>(cols, vals, row + ROWS, n, R, lane, cn, vn);
      float acc[KP];
#pragma unroll
      for (int l = 0; l < KP; ++l) acc[l] = 0.f;
      if (row < n) {  // slots lane, lane + G, ... in order
#pragma unroll
        for (int u = 0; u < BELL_AHEAD; ++u)
          if (lane + u * G < R) bell_slot<K, KP>(win, x, live, lo, W, n, c[u], v[u], acc);
        const int64_t base = row * R;
        // not unrolled: unrolled, ptxas spilled 16 B at G = 32, K = 2 (some
        // instances of G <= 16, K <= 4 spill 4-12 B either way; PERF.md)
#pragma unroll 1
        for (int s = lane + BELL_AHEAD * G; s < R; s += G)
          bell_slot<K, KP>(win, x, live, lo, W, n, __ldcs(cols + base + s),
                           __ldcs(vals + base + s), acc);
      }
      int first = 0;
      lane_tree_sum<G / 2, KP, KP>(acc, lane, first);
      if ((lane & (SHARE - 1)) == 0) {
#pragma unroll
        for (int j = 0; j < HELD; ++j) ybuf[(first + j) * BELL_TILE + t] = acc[j];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * BELL_TILE; e += REPRO_BLOCK) {
      const int l = e / BELL_TILE, t = e % BELL_TILE;
      const int64_t row = tile_lo + t;
      if (row < n) y[(int64_t)l * n + row] = ((live >> l) & 1u) ? ybuf[l * BELL_TILE + t] : 0.f;
    }
  }
}

// The window's width for a column span: BELL_TILE + 2 half, half the span
// rounded up to 8 and capped so two windows and the results fit in
// BELL_SMEM_BYTES.
static inline int bell_window(int span, int kp) {
  const int64_t cap = ((int64_t)BELL_SMEM_BYTES / (int64_t)(kp * sizeof(float)) - BELL_TILE) / 2;
  int64_t half = ((int64_t)(span < 0 ? 0 : span) + 7) / 8 * 8;
  const int64_t cap_half = (cap - BELL_TILE) / 2 / 8 * 8;
  if (half > cap_half) half = cap_half;
  return (int)(BELL_TILE + 2 * half);
}

template <int G, int K>
static cudaError_t launch_bell_lanes(const int32_t* cols, const float* vals, const float* x,
                                     const uint8_t* active, float* y, int64_t n, int R, int span,
                                     cudaStream_t st) {
  static std::atomic<int> raised{0};
  // the resident grid for the last (device, smem) launched: smem << 40 |
  // device << 32 | blocks, so a solve's launches query the occupancy once
  static std::atomic<uint64_t> grid{0};
  constexpr int KP = lane_pad<K>();
  const int W = bell_window(span, KP);
  const size_t smem = (size_t)(2 * W + BELL_TILE) * KP * sizeof(float);
  auto kernel = spmv_bell_lanes_kernel<G, K>;
  cudaError_t err = allow_shared(kernel, smem, &raised);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t key = (uint64_t)smem << 40 | (uint64_t)(dev & 0xff) << 32;
  uint64_t g = grid.load();
  if ((g & ~0xffffffffull) != key) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, REPRO_BLOCK, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g = key | (uint32_t)(sms * per_sm);
    grid.store(g);
  }
  const int64_t tiles = (n + BELL_TILE - 1) / BELL_TILE;
  const int64_t wave = (int64_t)(uint32_t)g;
  kernel<<<(unsigned)(tiles < wave ? tiles : wave), REPRO_BLOCK, smem, st>>>(cols, vals, x, active,
                                                                          y, n, R, W);
  return cudaGetLastError();
}

template <int G>
static int launch_group_lanes(int lanes, const void* cols, const void* vals, const void* x,
                              const void* active, void* y, int64_t n, int R, int span,
                              cudaStream_t st) {
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const float* xs = (const float*)x;
  const uint8_t* act = (const uint8_t*)active;
  float* ys = (float*)y;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_BELL_LANES(K) \
  case K: err = launch_bell_lanes<G, K>(c, v, xs, act, ys, n, R, span, st); break;
  switch (lanes) {
    REPRO_BELL_LANES(2)
    REPRO_BELL_LANES(3)
    REPRO_BELL_LANES(4)
    REPRO_BELL_LANES(5)
    REPRO_BELL_LANES(6)
    REPRO_BELL_LANES(7)
    REPRO_BELL_LANES(8)
  }
#undef REPRO_BELL_LANES
  return (int)err;
}

// `span`: max |col - row| over the operator's nonzero slots (any value
// gives the same result; it sizes the window).
extern "C" int spmv_bell_lanes_f32(int lanes, const void* cols, const void* vals, const void* x,
                                   const void* active, void* y, int64_t n, int R, int span,
                                   void* stream) {
  if (n < 0 || R < 1 || lanes < 1 || lanes > REPRO_MAX_LANES) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (lanes == 1) return launch_spmv<float>(cols, vals, x, active, y, n, R, stream);
  cudaStream_t st = (cudaStream_t)stream;
  if (R > 16) return launch_group_lanes<32>(lanes, cols, vals, x, active, y, n, R, span, st);
  if (R > 8) return launch_group_lanes<16>(lanes, cols, vals, x, active, y, n, R, span, st);
  if (R > 4) return launch_group_lanes<8>(lanes, cols, vals, x, active, y, n, R, span, st);
  return launch_group_lanes<4>(lanes, cols, vals, x, active, y, n, R, span, st);
}
