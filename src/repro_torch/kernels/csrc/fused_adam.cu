// Fused AdamW: one pass over p, g, m, v per parameter tensor, in place.
//   m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g^2,
//   p' = p - lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd p),
// with hyper = f32[7] = (lr, b1, b2, eps, wd, bc1 = 1 - b1^t, bc2 = 1 - b2^t)
// read from device memory, so a training step never syncs with the host.
//
// Replaces the TPU kernel src/repro/kernels/fused_adam/kernel.py:fused_adamw_padded.
//
// Bound on this card: bytes. Per element it reads p, g (2 B each in bf16,
// 4 in f32), m and v (4 B each) and writes p, m, v: 22 B with bf16 p and
// g, 28 B in f32, for about 15 flops, far below the H100's
// operations-per-byte line.
//
// Design: an elementwise grid-stride loop over one wave (8 blocks of 256
// threads per SM), neighbouring threads on neighbouring elements. It
// updates p, m and v in place (the JAX kernel returns new arrays), which
// saves a second copy of the optimizer state. There is no padding: the
// loop bound masks the tail, where the JAX wrapper pads to 32 x 128. Every
// operation is an IEEE round-to-nearest intrinsic (no FMA contraction, no
// fast math), in the order of ref.py, so the kernel gives the plain
// version's bits. p and g are f32/f32, bf16/bf16, or bf16 p with f32 g
// (the f32 gradients of microbatch accumulation); m and v are f32.
#include "common.cuh"

#define ADAM_BLOCKS_PER_SM 8

template <typename P, typename G>
__global__ void __launch_bounds__(REPRO_BLOCK)
fused_adamw_kernel(const float* __restrict__ hyper, P* __restrict__ p, const G* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v, int64_t n) {
  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3], wd = hyper[4];
  const float bc1 = hyper[5], bc2 = hyper[6];
  const float c1 = __fsub_rn(1.f, b1), c2 = __fsub_rn(1.f, b2);
  const int64_t stride = (int64_t)gridDim.x * REPRO_BLOCK;
  for (int64_t i = (int64_t)blockIdx.x * REPRO_BLOCK + threadIdx.x; i < n; i += stride) {
    const float gf = to_f32(g[i]);
    const float mn = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(c1, gf));
    const float vn = __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(c2, gf), gf));
    const float mhat = __fdiv_rn(mn, bc1);
    const float vhat = __fdiv_rn(vn, bc2);
    const float pf = to_f32(p[i]);
    const float upd = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                                __fmul_rn(wd, pf));
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(lr, upd)));
    m[i] = mn;
    v[i] = vn;
  }
}

template <typename P, typename G>
static int launch_adamw(const void* hyper, void* p, const void* g, void* m, void* v, int64_t n,
                        void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t needed = repro_blocks(n);
  const int64_t wave = (int64_t)sms * ADAM_BLOCKS_PER_SM;
  const int64_t blocks = needed < wave ? needed : wave;
  fused_adamw_kernel<P, G><<<(unsigned)blocks, REPRO_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)hyper, (P*)p, (const G*)g, (float*)m, (float*)v, n);
  return (int)cudaGetLastError();
}

extern "C" {

int fused_adamw_f32(const void* hyper, void* p, const void* g, void* m, void* v, int64_t n,
                    void* stream) {
  return launch_adamw<float, float>(hyper, p, g, m, v, n, stream);
}

int fused_adamw_bf16(const void* hyper, void* p, const void* g, void* m, void* v, int64_t n,
                     void* stream) {
  return launch_adamw<__nv_bfloat16, __nv_bfloat16>(hyper, p, g, m, v, n, stream);
}

int fused_adamw_bf16_f32grad(const void* hyper, void* p, const void* g, void* m, void* v,
                             int64_t n, void* stream) {
  return launch_adamw<__nv_bfloat16, float>(hyper, p, g, m, v, n, stream);
}

}  // extern "C"
