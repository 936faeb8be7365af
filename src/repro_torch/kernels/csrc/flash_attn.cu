// Flash attention: softmax(q k^T / sqrt(hd) + mask) v with an online
// softmax in f32, causal or full, GQA (query head h reads kv-head
// h / (H / KV)). q (B, Tq, H, hd), k/v (B, Tk, KV, hd), f32 or bf16, all
// contiguous; the output has q's shape and dtype. hd <= 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:flash_attention_padded.
//
// Bound on this card: at the model's shapes (hd = 128, T >= 512) the
// operations, about 4 B H Tq Tk hd flops (half of it under the causal
// mask) against Q + K + V + O bytes read and written once. In bf16 that
// bound is the tensor cores' rate; this first kernel runs its products on
// the CUDA cores in f32, so it sits far above it (mma.sync, wgmma and TMA
// are later work).
//
// Design: one block of 256 threads per (64-query tile, head, batch). The
// query tile, scaled by 1/sqrt(hd), stays in shared memory in f32; the
// keys and values stream through shared memory in 32-row tiles, converted
// to f32 once. Four threads own one query row: each scores 8 of the 32
// keys of a tile, the row's max and sum meet through two xor shuffles,
// and each thread keeps 32 of the row's hd accumulators in registers. The
// running max m, sum l and accumulator stay in f32 registers for the
// whole key loop, so device memory sees Q, K, V once per block and O once.
// Rows of shared memory are padded by one float, so the four key rows and
// eight query rows a warp reads fall in distinct banks. Masked scores are
// -1e30 and the output divides by max(l, 1e-30), as the TPU kernel does;
// under the causal mask the key tiles after the query tile's last row are
// skipped (every score there is masked, so they add nothing), and the
// first tile always holds key 0, so the running max is finite after it.
// Ragged Tq, Tk: queries past Tq are not written, keys past Tk are masked.
#include "common.cuh"

#define FA_BQ 64
#define FA_BK 32
#define FA_THREADS 256
#define FA_MAX_HD 128
#define FA_NEG (-1e30f)

static_assert(FA_THREADS == 4 * FA_BQ, "four threads per query row");

static inline size_t fa_smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) * ((size_t)FA_BQ * ld + (size_t)FA_BK * ld + (size_t)FA_BK * hd +
                          (size_t)FA_BQ * (FA_BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Tq, int Tk, int H, int KV, int hd, float sm_scale,
                  int causal) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;               // FA_BQ x ld
  float* Ks = Qs + FA_BQ * ld;    // FA_BK x ld
  float* Vs = Ks + FA_BK * ld;    // FA_BK x hd
  float* Ps = Vs + FA_BK * hd;    // FA_BQ x (FA_BK + 1)

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // the query row of this thread
  const int sub = tid & 3;  // its quarter of the row
  const int qpos = q0 + r;

  for (int idx = tid; idx < FA_BQ * hd; idx += FA_THREADS) {
    const int rr = idx / hd, c = idx - rr * hd;
    const int qi = q0 + rr;
    float val = 0.f;
    if (qi < Tq) val = to_f32(q[(((int64_t)b * Tq + qi) * H + h) * hd + c]) * sm_scale;
    Qs[rr * ld + c] = val;
  }

  float acc[FA_MAX_HD / 4];
#pragma unroll
  for (int j = 0; j < FA_MAX_HD / 4; ++j) acc[j] = 0.f;
  float m_i = FA_NEG, l_i = 0.f;

  const int kv_end = causal ? min(Tk, q0 + FA_BQ) : Tk;
  const int n_tiles = (kv_end + FA_BK - 1) / FA_BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int idx = tid; idx < FA_BK * hd; idx += FA_THREADS) {
      const int rr = idx / hd, c = idx - rr * hd;
      const int ki = k0 + rr;
      float kx = 0.f, vx = 0.f;
      if (ki < Tk) {
        const int64_t off = (((int64_t)b * Tk + ki) * KV + kvh) * hd + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[rr * ld + c] = kx;
      Vs[rr * hd + c] = vx;
    }
    __syncthreads();

    float s[FA_BK / 4];
#pragma unroll
    for (int j = 0; j < FA_BK / 4; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * ld;
    for (int d = 0; d < hd; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < FA_BK / 4; ++j) s[j] += qv * Ks[(sub + 4 * j) * ld + d];
    }
    float mx = FA_NEG;
#pragma unroll
    for (int j = 0; j < FA_BK / 4; ++j) {
      const int kp = k0 + sub + 4 * j;
      if (kp >= Tk || (causal && kp > qpos)) s[j] = FA_NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < FA_BK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      Ps[r * (FA_BK + 1) + sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncthreads();  // the whole row of Ps is written

#pragma unroll
    for (int j = 0; j < FA_MAX_HD / 4; ++j) acc[j] *= corr;
    const float* prow = Ps + r * (FA_BK + 1);
    for (int kk = 0; kk < FA_BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * hd;
#pragma unroll
      for (int j = 0; j < FA_MAX_HD / 4; ++j) {
        const int c = sub + 4 * j;
        if (c < hd) acc[j] += p * vrow[c];
      }
    }
  }

  if (qpos < Tq) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* orow = o + (((int64_t)b * Tq + qpos) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < FA_MAX_HD / 4; ++j) {
      const int c = sub + 4 * j;
      if (c < hd) orow[c] = from_f32<T>(acc[j] / denom);
    }
  }
}

template <typename T>
static int launch_flash(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                        int Tk, int H, int KV, int hd, float sm_scale, int causal,
                        void* stream) {
  if (B < 0 || Tq < 0 || Tk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > FA_MAX_HD || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaSuccess;
  const size_t smem = fa_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attn_kernel<T><<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Tq, Tk, H, KV, hd, sm_scale, causal);
  return (int)cudaGetLastError();
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
