// Whole Vocos ConvNeXt block in one kernel, bf16: masked depthwise k7 conv
// + bias, LayerNorm, W1 -> tanh-GELU -> W2, layer scale, residual.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/fused_convnext.py
// fused_convnext_block_dw (_kernel_dw):
//   xdw[t] = b_dw + sum_{k=0..6} xm[t + k - 3] * w_dw[k]        (f32, taps in order)
//   out[t] = x[t] + gamma * (GELU(LN(xdw[t]) W1^T + b1) W2^T + b2)
// over x (B, T, C), where xm is x with the rows outside [0, frame_valid)
// zeroed (the virtual right edge of the Vocos convs) and the residual is
// the unmasked x.  xdw enters the LayerNorm in f32, without a bf16
// rounding; each tap is a separate f32 multiply and add (no FMA), as the
// JAX kernel writes them.
//
// Bound on the H100: the two products, 4 B T C I operations against the
// bf16 tensor-core rate (the depthwise sum adds 14 B T C); the activation
// is read once and written once.  The TPU kernel DMA'd a halo window of
// block_t + 6 rows into VMEM and needed block_t to divide T.  Here a block
// owns BM = 32 time rows of one batch item:
//   * it copies the masked window of rows t0 - 3 .. t0 + 34 to shared
//     memory (zeros outside [0, min(frame_valid, T))), so any T works and
//     the last tile may be ragged;
//   * one warp per row forms xdw in f32 registers and normalises it, and
//     writes LN(xdw) as bf16 to shared memory;
//   * the chain of ln_ffn_chain.cuh runs over those rows; the window
//     shares its shared memory with the chain's weight buffers (it is dead
//     once LN(xdw) is written), so a block needs no more shared memory than
//     the chain alone, and the residual rows are read from x in the epilogue;
//   * up to C = 512 the registers are capped for two blocks an SM, as the
//     chain alone gets by itself: left alone, the compiler keeps the 7 x C/32 tap
//     weights of the row loop in registers (207 at C = 512), which halves
//     the blocks an SM holds.
#include "ln_ffn_chain.cuh"

namespace {

using ffn_chain::BM;
using ffn_chain::THREADS;
constexpr int TAPS = 7;
constexpr int HALO = 3;

template <int NT>  // C = 64 * NT
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1) convnext_dw_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dw_w, const bf16* __restrict__ dw_b,
    const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
    const bf16* __restrict__ gamma, bf16* __restrict__ out, int T, int I, int frame_valid, float eps) {
  constexpr int C = 64 * NT;
  constexpr int XS = C + 8;
  constexpr int VPL = C / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem);  // BM x XS
  bf16* win_s = xn_s + BM * XS;                // (BM + 6) x C, inside the chain's weight buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BM, b = blockIdx.y;
  const bf16* xb = x + (size_t)b * T * C;
  const int t_end = min(frame_valid, T);

  for (int i = tid; i < (BM + 2 * HALO) * (C / 8); i += THREADS) {
    const int r = i / (C / 8), cv = i % (C / 8), t = t0 - HALO + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_end) v = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + cv * 8);
    *reinterpret_cast<uint4*>(&win_s[r * C + cv * 8]) = v;
  }
  __syncthreads();

#pragma unroll 1
  for (int r = warp; r < BM; r += THREADS / 32) {
    float v[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      float acc = bf(dw_b[c]);
#pragma unroll
      for (int k = 0; k < TAPS; ++k)
        acc = __fadd_rn(acc, __fmul_rn(bf(win_s[(r + k) * C + c]), bf(dw_w[k * C + c])));
      v[i] = acc;
    }
    warp_layer_norm_regs<VPL>(v, ln_w, ln_b, eps);
    const bool valid = t0 + r < T;
#pragma unroll
    for (int i = 0; i < VPL; ++i) xn_s[r * XS + lane + 32 * i] = __float2bfloat16(valid ? v[i] : 0.f);
  }
  ffn_chain::run<NT>(xn_s, w1, b1, w2, b2, gamma, xb + (size_t)t0 * C, out + ((size_t)b * T + t0) * C,
                     min(BM, T - t0), I);
}

template <int NT>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* ln_w, const void* ln_b,
                   const void* w1, const void* b1, const void* w2, const void* b2, const void* gamma,
                   void* out, int B, int T, int I, int frame_valid, float eps, cudaStream_t stream) {
  static_assert((BM + 2 * HALO) * 64 * NT <= ffn_chain::smem_bytes<NT>() / sizeof(bf16) - BM * (64 * NT + 8),
                "the input window must fit in the chain's weight buffers");
  const size_t smem = ffn_chain::smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(convnext_dw_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, B);
  convnext_dw_kernel<NT><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)dw_w, (const bf16*)dw_b, (const bf16*)ln_w, (const bf16*)ln_b,
      (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (const bf16*)gamma, (bf16*)out,
      T, I, frame_valid, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out (B, T, C), dw_w (7, C), W1 (I, C), W2 (C, I), all contiguous
// bf16; C a multiple of 64 up to 768, I a multiple of 32, frame_valid >= 0.
// Returns the CUDA error of the launch (0 on success).
extern "C" int convnext_dw_bf16(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gamma, void* out, int B, int T, int C, int I,
                                int frame_valid, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C / 64) {
#define CASE(NT) \
  case NT:       \
    return (int)launch<NT>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, T, I, frame_valid, eps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
