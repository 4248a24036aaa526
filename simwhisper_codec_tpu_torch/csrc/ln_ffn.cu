// Fused LayerNorm -> W1 -> tanh-GELU -> W2 -> layer scale -> residual, bf16.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/fused_convnext.py
// fused_ln_ffn (_kernel + _ln_ffn_body): out = res + gamma * (GELU(LN(x) W1^T + b1) W2^T + b2)
// over (M, C) rows, with W1 (I, C) and W2 (C, I) in nn.Linear layout.
//
// Bound on the H100: the two products (4 M C I operations) against the
// bf16 tensor-core rate; the activations and weights are a few tens of MB.
// The TPU kernel pinned both weights in VMEM; at 4.5-4.7 MB they do not fit
// in shared memory, so this kernel keeps the (BM, I) intermediate on chip
// instead and streams the weights from L2: a block owns BM = 32 rows, one
// warp per row normalises them in f32 and keeps LN(x) as bf16 in shared
// memory, then runs the chain of ln_ffn_chain.cuh over them.
#include "ln_ffn_chain.cuh"

namespace {

using ffn_chain::BM;
using ffn_chain::THREADS;

template <int NT>  // C = 64 * NT
__global__ void __launch_bounds__(THREADS) ln_ffn_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res, const bf16* __restrict__ ln_w,
    const bf16* __restrict__ ln_b, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
    bf16* __restrict__ out, int M, int I, float eps) {
  constexpr int C = 64 * NT;
  constexpr int XS = C + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem);  // BM x XS, then the chain's buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    float v[C / 32];
    warp_layer_norm<C / 32>(x + (size_t)row * C, ln_w, ln_b, eps, row < M, v);
#pragma unroll
    for (int i = 0; i < C / 32; ++i)
      xn_s[r * XS + lane + 32 * i] = __float2bfloat16(row < M ? v[i] : 0.f);
  }
  ffn_chain::run<NT>(xn_s, w1, b1, w2, b2, gamma, res + (size_t)row0 * C, out + (size_t)row0 * C,
                     min(BM, M - row0), I);
}

template <int NT>
cudaError_t launch(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* gamma, void* out, int M,
                   int I, float eps, cudaStream_t stream) {
  const size_t smem = ffn_chain::smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(ln_ffn_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM);
  ln_ffn_kernel<NT><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)res, (const bf16*)ln_w, (const bf16*)ln_b, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (const bf16*)gamma, (bf16*)out, M, I, eps);
  return cudaGetLastError();
}

}  // namespace

// C must be a multiple of 64 up to 768 and I a multiple of 32; all tensors
// contiguous bf16.  Returns the CUDA error of the launch (0 on success).
extern "C" int ln_ffn_bf16(const void* x, const void* res, const void* ln_w, const void* ln_b,
                           const void* w1, const void* b1, const void* w2, const void* b2,
                           const void* gamma, void* out, int M, int C, int I, float eps,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C / 64) {
#define CASE(NT) \
  case NT:       \
    return (int)launch<NT>(x, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, I, eps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
