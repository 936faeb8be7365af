// Flash attention: softmax(q k^T / sqrt(hd) + mask) v with an online
// softmax in f32, causal or full, GQA (query head h reads kv-head
// h / (H / KV)). q (B, Tq, H, hd), k/v (B, Tk, KV, hd), f32 or bf16, all
// contiguous; the output has q's shape and dtype. hd <= 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:65
// (flash_attention_padded).
//
// Bound on this card: Q, K, V read once and O written once against
// 4 hd flops per (query, key) pair under the mask. At the trainer's shape
// (8, 512, 16, 8, 128) causal that is 0.0150 ms of bytes in bf16 against
// 0.0087 ms of bf16 tensor-core operations, and at (1, 4096, 16, 8, 128)
// 0.0695 ms of operations; in f32 it is the operations at the 67 TFLOP/s
// of the CUDA cores (0.1285 ms at the trainer's shape). So the products
// decide it: the design keeps every operand of both products on chip and
// feeds the product units from registers and shared memory.
//
// Both entries share one tile loop. A block owns 128 queries of one
// (head, batch); the keys and values stream through shared memory in
// 64-key tiles, in a two-stage ring filled with cp.async (16-byte copies,
// zero-filled past Tk and past hd), so tile t + 1 is in flight while tile
// t is multiplied. Each warp keeps the running max m, sum l and
// accumulator of its query rows in f32 registers for the whole key loop,
// so device memory sees Q, K and V once per block and O once. Masked
// scores are -1e30, as on the TPU; the output divides by max(l, 1e-30).
// Under the causal mask a block stops at its last query row, a warp skips
// the tiles past its own last row (every score there is masked, so they
// add nothing), and only tiles that cross the diagonal or Tk are masked
// element by element. The first tile holds key 0, so the running max is
// finite after it. The grid's first wave holds the longest (last) causal
// query tiles, so the last wave is short. Each output element is written
// once, with no atomics: results repeat bit for bit.
//
// bf16 entry (4 warps of 32 query rows, two blocks per SM): both products
// on the tensor cores, mma.sync m16n8k16 bf16 with f32 sums (bf16 x bf16
// products are exact in f32, so S is the TPU kernel's f32 product up to
// summation order). A warp's rows are two 16-row tiles, so every K and V
// fragment loaded from shared memory (ldmatrix, ldmatrix.trans for V)
// feeds two products: shared-memory reads per product are what bound a
// 16-row warp. Q fragments are reloaded with ldmatrix at each k-step
// rather than held: with 128 accumulators and 64 scores a thread has no
// registers left for them. Rows of shared memory are padded by 16 bytes,
// so the eight row addresses of an ldmatrix fall in distinct banks. The
// running max is kept on the raw scores and one FMA per score folds
// 1/sqrt(hd) and log2(e) into the exponent of ex2 on the SFU. (The TPU
// kernel scales q in f32 before the product; scaling the f32 score
// afterwards moves it by about one f32 ulp.) P goes from the score (C)
// fragment layout to the A fragment layout in registers, rounded to bf16
// as the JAX oracle and the plain version round it (the TPU kernel keeps
// P in f32: chip_smoke.py prints the distance from an f32-probability
// result, about 3e-3 of a row's norm, so no hi/lo split of P is needed).
// The output is staged through shared memory for 16-byte stores. What
// holds it back is mma.sync itself: a warp's products wait on its own
// softmax, and Hopper's full tensor rate needs wgmma fed by TMA, with warp
// specialisation (a later design).
//
// f32 entry (8 warps of 16 query rows): the products on the CUDA cores in f32
// (TF32 stays off: it keeps about three digits), register-blocked: a
// thread holds 4 query rows x 8 keys of S and the same 4 rows x 16
// columns of O, so one 16-byte shared-memory load feeds 4 to 16 FMAs. K
// is stored with its 16-byte chunks XOR-swizzled by key, so the eight
// keys a thread group reads at once fall in distinct banks; P goes
// through shared memory rows private to each warp (no block barrier).
//
// Head dimensions: the kernels are templated on hd rounded up to 32, 64
// or 128; the padded columns are zero in shared memory, add nothing to S,
// and are never stored. An hd whose row of bytes is not a multiple of 16
// (or a pointer not 16-byte aligned) is copied element by element with
// predicated loads in the same kernel.
#include "common.cuh"

#define FA_BK 64  // keys per tile
#define FA_MAX_HD 128
#define FA_NEG (-1e30f)
#define FA16_WARPS 4
#define FA16_MT 2  // 16-row query tiles per bf16 warp
#define FA16_BQ (16 * FA16_MT * FA16_WARPS)
#define FA32_WARPS 8
#define FA32_BQ (16 * FA32_WARPS)

// ---------------------------------------------------------------- PTX helpers
// (smem_addr is common.cuh's)

// 16-byte asynchronous copy; ``bytes`` = 0 writes zeros and reads nothing.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one group (the newest) is still in flight.
static __device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
static __device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (max relative error about 2^-22; flushes results below
// 2^-126 to zero, where a probability adds nothing)
static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- shared pieces

// The block's place in the grid: x = (batch, head), y = query tile,
// counted from the last one so that the longest causal tiles go first.
struct FaBlock {
  int b, h, kvh, q0, n_tiles;
};

template <int BQ>
static __device__ __forceinline__ FaBlock fa_block(int Tk, int H, int KV, int causal) {
  FaBlock f;
  f.b = blockIdx.x / H;
  f.h = blockIdx.x - f.b * H;
  f.kvh = f.h / (H / KV);
  f.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kv_end = causal ? min(Tk, f.q0 + BQ) : Tk;
  f.n_tiles = (kv_end + FA_BK - 1) / FA_BK;
  return f;
}

// Copies ``rows`` rows of hd elements from global rows (row r at
// src + r * stride, r < valid) into shared rows of ``ld`` elements, the
// first HD columns of each; columns >= hd and rows >= valid become zero.
// ``vec``: 16-byte asynchronous copies (hd * sizeof(T) % 16 == 0 and the
// pointers aligned); else element by element. ``swz``: the 16-byte
// chunks of row r are stored at chunk ^ (r & 7). NT threads share it.
template <typename T, int HD, int NT>
static __device__ __forceinline__ void fa_copy_rows(T* dst, int ld, const T* src, int64_t stride,
                                                    int rows, int valid, int hd, int vec,
                                                    bool swz) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = HD / EPC;
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
      const int r = idx / CH, c = idx - r * CH;
      const bool ok = r < valid && c * EPC < hd;
      const int pc = swz ? (c ^ (r & 7)) : c;
      cp_async16(dst + r * ld + pc * EPC, ok ? src + r * stride + c * EPC : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * HD; idx += NT) {
      const int r = idx / HD, c = idx - r * HD;
      T val = from_f32<T>(0.f);
      if (r < valid && c < hd) val = src[r * stride + c];
      const int pc = swz ? (((c / EPC) ^ (r & 7)) * EPC + c % EPC) : c;
      dst[r * ld + pc] = val;
    }
  }
}

// ---------------------------------------------------------------- bf16 entry

template <int HD>
struct FaBf16Smem {
  static constexpr int LD = HD + 8;  // bf16 per shared row: 16 bytes of padding
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (size_t)(FA16_BQ + 4 * FA_BK) * LD;
};

template <int HD>
__global__ void __launch_bounds__(32 * FA16_WARPS, 1)
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int Tq, int Tk, int H, int KV, int hd, float scale_log2, int causal,
                       int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = FaBf16Smem<HD>::LD, NT = 32 * FA16_WARPS, MT = FA16_MT;
  constexpr int KS = HD / 16;  // k-steps of S = Q K^T
  constexpr int NO = HD / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);  // FA16_BQ x LD, later the output's staging
  bf16* Ks = Qs + FA16_BQ * LD;                  // 2 stages x FA_BK x LD
  bf16* Vs = Ks + 2 * FA_BK * LD;                // 2 stages x FA_BK x LD

  const FaBlock f = fa_block<FA16_BQ>(Tk, H, KV, causal);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = 16 * MT * warp;  // the warp's first row in the block
  const int r0 = f.q0 + wrow;       // ... and in the sequence
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KV * hd;
  const bf16* qb = q + ((int64_t)f.b * Tq * H + f.h) * hd;
  const bf16* kb = k + ((int64_t)f.b * Tk * KV + f.kvh) * hd;
  const bf16* vb = v + ((int64_t)f.b * Tk * KV + f.kvh) * hd;

  auto load_tile = [&](int tile) {
    const int k0 = tile * FA_BK, st = tile & 1;
    fa_copy_rows<bf16, HD, NT>(Ks + st * FA_BK * LD, LD, kb + k0 * kv_stride, kv_stride, FA_BK,
                               Tk - k0, hd, vec, false);
    fa_copy_rows<bf16, HD, NT>(Vs + st * FA_BK * LD, LD, vb + k0 * kv_stride, kv_stride, FA_BK,
                               Tk - k0, hd, vec, false);
  };

  fa_copy_rows<bf16, HD, NT>(Qs, LD, qb + (int64_t)f.q0 * q_stride, q_stride, FA16_BQ,
                             Tq - f.q0, hd, vec, false);
  load_tile(0);
  cp_async_commit();  // Q and tile 0: one group, complete at the first wait

  float acc[MT][NO][4];
  float m_r[MT][2], l_r[MT][2];  // rows g and g + 8 of each m-tile: raw running max, sum part
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    m_r[m][0] = m_r[m][1] = FA_NEG;
    l_r[m][0] = l_r[m][1] = 0.f;
  }

  for (int tile = 0; tile < f.n_tiles; ++tile) {
    if (tile + 1 < f.n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // the tile (and at tile 0, Q) is in shared memory
    const int k0 = tile * FA_BK;
    const bf16* Kt = Ks + (tile & 1) * FA_BK * LD;
    const bf16* Vt = Vs + (tile & 1) * FA_BK * LD;
    if (!(causal && k0 > r0 + 16 * MT - 1) && r0 < Tq) {
      // S = Q K^T: per m-tile 16 rows x 64 keys, eight 16x8 fragments; each
      // K fragment feeds both m-tiles. Unrolled by 2 only: a full unroll
      // hoists fragments until the registers spill.
      float s[MT][FA_BK / 8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(qa[m], Qs + (wrow + 16 * m + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < FA_BK / 16; ++jp) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(s[m][2 * jp], qa[m], kf[0], kf[1]);
            mma_bf16(s[m][2 * jp + 1], qa[m], kf[2], kf[3]);
          }
        }
      }
      // online softmax on the fragments: this thread holds rows g and g + 8
      // of each m-tile, keys 8j + 2 t4 + {0, 1}; a row's four threads are a quad
      const bool need_mask = k0 + FA_BK > Tk || (causal && k0 + FA_BK - 1 > r0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (need_mask) {
              const int key = k0 + 8 * j + 2 * t4 + (e & 1);
              const int row = r0 + 16 * m + g + 8 * (e >> 1);
              if (key >= Tk || (causal && key > row)) s[m][j][e] = FA_NEG;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[m][j][e]);
          }
        }
        float corr[2], msc[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_r[m][i], mx[i]);
          corr[i] = ex2((m_r[m][i] - m_new) * scale_log2);
          msc[i] = m_new * scale_log2;
          m_r[m][i] = m_new;
          l_r[m][i] *= corr[i];
        }
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[m][j][e], scale_log2, -msc[e >> 1]));
            l_r[m][e >> 1] += p;
            s[m][j][e] = p;
          }
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[m][j][0] *= corr[0];
          acc[m][j][1] *= corr[0];
          acc[m][j][2] *= corr[1];
          acc[m][j][3] *= corr[1];
        }
      }
      // O += P V: P from the C layout to the A layout in registers; each V
      // fragment feeds both m-tiles
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk) {
        uint32_t pf[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          pf[m][0] = pack_bf16(s[m][2 * kk][0], s[m][2 * kk][1]);
          pf[m][1] = pack_bf16(s[m][2 * kk][2], s[m][2 * kk][3]);
          pf[m][2] = pack_bf16(s[m][2 * kk + 1][0], s[m][2 * kk + 1][1]);
          pf[m][3] = pack_bf16(s[m][2 * kk + 1][2], s[m][2 * kk + 1][3]);
        }
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    16 * jp + (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * jp], pf[m], vf[0], vf[1]);
            mma_bf16(acc[m][2 * jp + 1], pf[m], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: divide, round to bf16 into the warp's own rows of Qs, then
  // 16-byte stores of whole rows
  bf16* Ow = Qs + wrow * LD;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float den[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[m][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      den[i] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(Ow + (16 * m + g) * LD + c) =
          __floats2bfloat162_rn(acc[m][j][0] / den[0], acc[m][j][1] / den[0]);
      *reinterpret_cast<__nv_bfloat162*>(Ow + (16 * m + g + 8) * LD + c) =
          __floats2bfloat162_rn(acc[m][j][2] / den[1], acc[m][j][3] / den[1]);
    }
  }
  __syncwarp();
  bf16* ob = o + ((int64_t)f.b * Tq * H + f.h) * hd;
  for (int idx = lane; idx < 16 * MT * NO; idx += 32) {
    const int r = idx / NO, c = (idx - r * NO) * 8;
    const int row = r0 + r;
    if (row >= Tq || c >= hd) continue;
    bf16* dst = ob + row * q_stride + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(Ow + r * LD + c);
    } else {
      for (int e = 0; e < 8 && c + e < hd; ++e) dst[e] = Ow[r * LD + c + e];
    }
  }
}

// ---------------------------------------------------------------- f32 entry

template <int HD>
struct FaF32Smem {
  static constexpr int LDP = FA_BK + 4;  // floats per row of P
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)FA32_BQ * HD + 4 * (size_t)FA_BK * HD + (size_t)FA32_BQ * LDP);
};

template <int HD>
__global__ void __launch_bounds__(32 * FA32_WARPS, 1)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Tq, int Tk, int H,
                      int KV, int hd, float scale_log2, int causal, int vec) {
  constexpr int LDP = FaF32Smem<HD>::LDP, NT = 32 * FA32_WARPS;
  constexpr int NC = HD / 32;  // float4 column groups of O per thread
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);  // FA32_BQ x HD
  float* Ks = Qs + FA32_BQ * HD;                   // 2 stages x FA_BK x HD, chunks swizzled
  float* Vs = Ks + 2 * FA_BK * HD;                 // 2 stages x FA_BK x HD
  float* Ps = Vs + 2 * FA_BK * HD;                 // FA32_BQ x LDP

  const FaBlock f = fa_block<FA32_BQ>(Tk, H, KV, causal);
  const int warp = threadIdx.x >> 5;
  const int rg = threadIdx.x >> 3;  // rows 4 rg .. 4 rg + 3 of the block
  const int tc = threadIdx.x & 7;   // keys tc + 8 j; columns 4 tc + 32 i + (0..3)
  const int r0 = f.q0 + 16 * warp;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KV * hd;
  const float* qb = q + ((int64_t)f.b * Tq * H + f.h) * hd;
  const float* kb = k + ((int64_t)f.b * Tk * KV + f.kvh) * hd;
  const float* vb = v + ((int64_t)f.b * Tk * KV + f.kvh) * hd;

  auto load_tile = [&](int tile) {
    const int k0 = tile * FA_BK, st = tile & 1;
    fa_copy_rows<float, HD, NT>(Ks + st * FA_BK * HD, HD, kb + k0 * kv_stride, kv_stride,
                                FA_BK, Tk - k0, hd, vec, true);
    fa_copy_rows<float, HD, NT>(Vs + st * FA_BK * HD, HD, vb + k0 * kv_stride, kv_stride,
                                FA_BK, Tk - k0, hd, vec, false);
  };

  fa_copy_rows<float, HD, NT>(Qs, HD, qb + (int64_t)f.q0 * q_stride, q_stride, FA32_BQ,
                              Tq - f.q0, hd, vec, false);
  load_tile(0);
  cp_async_commit();  // Q and tile 0: one group, complete at the first wait

  float acc[4][NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i][0] = acc[r][i][1] = acc[r][i][2] = acc[r][i][3] = 0.f;
  float m_r[4], l_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m_r[r] = FA_NEG, l_r[r] = 0.f;
  const float* Qr = Qs + 4 * rg * HD;
  float* Pr = Ps + 4 * rg * LDP;

  for (int tile = 0; tile < f.n_tiles; ++tile) {
    if (tile + 1 < f.n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int k0 = tile * FA_BK;
    const float* Kt = Ks + (tile & 1) * FA_BK * HD;
    const float* Vt = Vs + (tile & 1) * FA_BK * HD;
    if (!(causal && k0 > r0 + 15) && r0 < Tq) {
      float s[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
#pragma unroll 4
      for (int c4 = 0; c4 < HD / 4; ++c4) {
        float4 qv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(Qr + r * HD + 4 * c4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // key tc + 8 j has (key & 7) == tc: its chunk c4 sits at c4 ^ tc
          const float4 kv =
              *reinterpret_cast<const float4*>(Kt + (tc + 8 * j) * HD + 4 * (c4 ^ tc));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
            s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
            s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
            s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
          }
        }
      }
      const bool need_mask = k0 + FA_BK > Tk || (causal && k0 + FA_BK - 1 > r0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = f.q0 + 4 * rg + r;
        float mx = FA_NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = s[r][j] * scale_log2;
          if (need_mask) {
            const int key = k0 + tc + 8 * j;
            if (key >= Tk || (causal && key > row)) x = FA_NEG;
          }
          s[r][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_r[r], mx);
        const float corr = exp2f(m_r[r] - m_new);
        m_r[r] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = exp2f(s[r][j] - m_new);
          psum += p;
          Pr[r * LDP + tc + 8 * j] = p;
        }
        l_r[r] = l_r[r] * corr + psum;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          acc[r][i][0] *= corr;
          acc[r][i][1] *= corr;
          acc[r][i][2] *= corr;
          acc[r][i][3] *= corr;
        }
      }
      __syncwarp();  // the warp's rows of P are written
#pragma unroll 2
      for (int kk = 0; kk < FA_BK / 4; ++kk) {
        float4 pv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = *reinterpret_cast<const float4*>(Pr + r * LDP + 4 * kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const float4 vv =
                *reinterpret_cast<const float4*>(Vt + (4 * kk + u) * HD + 4 * tc + 32 * i);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float p = u == 0 ? pv[r].x : u == 1 ? pv[r].y : u == 2 ? pv[r].z : pv[r].w;
              acc[r][i][0] = fmaf(p, vv.x, acc[r][i][0]);
              acc[r][i][1] = fmaf(p, vv.y, acc[r][i][1]);
              acc[r][i][2] = fmaf(p, vv.z, acc[r][i][2]);
              acc[r][i][3] = fmaf(p, vv.w, acc[r][i][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and its P) before reuse
  }

  float* ob = o + ((int64_t)f.b * Tq * H + f.h) * hd;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float denom = fmaxf(l, 1e-30f);
    const int row = f.q0 + 4 * rg + r;
    if (row >= Tq) continue;
    float* dst = ob + row * q_stride;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 4 * tc + 32 * i;
      const float4 val = make_float4(acc[r][i][0] / denom, acc[r][i][1] / denom,
                                     acc[r][i][2] / denom, acc[r][i][3] / denom);
      if (vec) {
        if (c < hd) *reinterpret_cast<float4*>(dst + c) = val;
      } else {
        const float vals[4] = {val.x, val.y, val.z, val.w};
        for (int e = 0; e < 4 && c + e < hd; ++e) dst[c + e] = vals[e];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int HD>
static int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
                     int H, int KV, int hd, float scale_log2, int causal, int vec,
                     cudaStream_t stream) {
  const int bq = sizeof(T) == 2 ? FA16_BQ : FA32_BQ;
  const int q_tiles = (Tq + bq - 1) / bq;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)q_tiles);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FaBf16Smem<HD>::bytes);
    if (err != cudaSuccess) return (int)err;
    flash_attn_bf16_kernel<HD><<<grid, 32 * FA16_WARPS, FaBf16Smem<HD>::bytes, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, Tq, Tk, H, KV, hd, scale_log2, causal, vec);
  } else {
    err = cudaFuncSetAttribute(flash_attn_f32_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FaF32Smem<HD>::bytes);
    if (err != cudaSuccess) return (int)err;
    flash_attn_f32_kernel<HD><<<grid, 32 * FA32_WARPS, FaF32Smem<HD>::bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Tq, Tk, H, KV, hd,
        scale_log2, causal, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_flash(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                        int Tk, int H, int KV, int hd, float sm_scale, int causal,
                        void* stream) {
  if (B < 0 || Tq < 0 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > FA_MAX_HD || (int64_t)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaSuccess;
  // 16-byte copies need whole 16-byte rows and aligned bases
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const int vec = (hd * (int)sizeof(T)) % 16 == 0 && align % 16 == 0;
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e) / sqrt(hd)
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32) return launch_hd<T, 32>(q, k, v, o, B, Tq, Tk, H, KV, hd, scale_log2, causal, vec, s);
  if (hd <= 64) return launch_hd<T, 64>(q, k, v, o, B, Tq, Tk, H, KV, hd, scale_log2, causal, vec, s);
  return launch_hd<T, 128>(q, k, v, o, B, Tq, Tk, H, KV, hd, scale_log2, causal, vec, s);
}

extern "C" {

int flash_attn_f32(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
                   int H, int KV, int hd, float sm_scale, int causal, void* stream) {
  return launch_flash<float>(q, k, v, o, B, Tq, Tk, H, KV, hd, sm_scale, causal, stream);
}

int flash_attn_bf16(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
                    int H, int KV, int hd, float sm_scale, int causal, void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, KV, hd, sm_scale, causal,
                                     stream);
}

}  // extern "C"
