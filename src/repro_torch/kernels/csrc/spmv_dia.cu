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
// K = 2..8 is spmv_dia_tile_kernel<K, T>, whose sum (dia_tile_sum and its
// helpers, in common.cuh) fused_iter's bf16-band lanes share:
// - Row tiles. A block covers DIA_TILE_ROWS = 1024 rows, a thread
//   DIA_ROWS = 4 consecutive ones. A window of x is read from L2 once per
//   block and group of diagonals, so at poisson125(128) (5 groups, each a
//   z-plane's 25 diagonals over 516 columns) the halo is a third of a
//   1540-column window instead of two thirds at 256 rows.
// - Windows. The groups are consecutive diagonals whose offsets lie within
//   the span that DIA_STAGE_BYTES allows for K lanes (make_tile_plan, on
//   make_runs). Each live lane's window goes into shared memory planar
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
//   the most that fit in 128 registers without spilling; fused_iter's f32
//   windows beside a bf16 band take 4), so one lane's
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

template <int K, typename T>
__global__ void __launch_bounds__(REPRO_BLOCK, 2)
spmv_dia_tile_kernel(const __grid_constant__ DiaTilePlan plan, const T* __restrict__ data,
                     const T* __restrict__ x, const uint8_t* __restrict__ active,
                     float* __restrict__ y, int64_t n, int ws) {
  extern __shared__ __align__(16) unsigned char repro_tile_smem[];
  const int64_t i0 = (int64_t)blockIdx.x * DIA_TILE_ROWS;
  const int64_t r0 = i0 + DIA_ROWS * threadIdx.x;
  const unsigned live = live_lanes(active, K);  // the same for the whole grid
  float acc[K][DIA_ROWS];
  dia_tile_sum<K>(plan, data, x, live, i0, n, ws, acc, reinterpret_cast<T*>(repro_tile_smem));
  if (r0 >= n) return;
  // 16-byte y stores where every lane's rows stay aligned
  const bool vec = (n & 3) == 0 && ((uintptr_t)y & 15) == 0;
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
  const size_t smem = tile_window_bytes<K, T>(ws);
  const cudaError_t err = allow_tile_shared(spmv_dia_tile_kernel<K, T>, smem, &raised, &carved);
  if (err != cudaSuccess) return err;
  spmv_dia_tile_kernel<K, T><<<(unsigned)tile_blocks(n), REPRO_BLOCK, smem, st>>>(
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
