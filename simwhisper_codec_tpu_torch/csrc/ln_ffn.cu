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
// instead and streams the weights from L2:
//   * a block owns BM = 32 rows; one warp per row normalises them in f32
//     and keeps LN(x) as bf16 in shared memory;
//   * I is walked in chunks of 32: h = GELU(LN(x) W1[chunk]^T + b1[chunk])
//     goes to shared memory as bf16, then acc += h W2[:, chunk]^T;
//   * acc (BM, C) stays in f32 registers: each of the 8 warps owns C / 8
//     output columns;
//   * the epilogue adds b2, scales by gamma and adds the residual.
// Loads are plain synchronous 16-byte copies; no TMA, no wgmma, no overlap
// of copies with products yet.
#include "common.cuh"

namespace {

constexpr int BM = 32;
constexpr int IC = 32;
constexpr int THREADS = 256;

template <int NT>  // C = 64 * NT
__global__ void __launch_bounds__(THREADS) ln_ffn_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res, const bf16* __restrict__ ln_w,
    const bf16* __restrict__ ln_b, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
    bf16* __restrict__ out, int M, int I, float eps) {
  constexpr int C = 64 * NT;
  constexpr int XS = C + 8;    // row stride (elements) of xn_s and w1_s
  constexpr int WS = IC + 8;   // row stride of w2_s and h_s
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem);  // BM x XS
  bf16* w1_s = xn_s + BM * XS;                 // IC x XS
  bf16* w2_s = w1_s + IC * XS;                 // C  x WS
  bf16* h_s = w2_s + C * WS;                   // BM x WS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    float v[C / 32];
    warp_layer_norm<C / 32>(x + (size_t)row * C, ln_w, ln_b, eps, row < M, v);
#pragma unroll
    for (int i = 0; i < C / 32; ++i)
      xn_s[r * XS + lane + 32 * i] = __float2bfloat16(row < M ? v[i] : 0.f);
  }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_base = warp * (C / 8);  // this warp's output columns in the second product
  for (int c0 = 0; c0 < I; c0 += IC) {
    __syncthreads();  // the previous chunk's operands are consumed (and LN rows written)
    for (int i = tid; i < IC * C / 8; i += THREADS) {
      const int r = i / (C / 8), cv = i % (C / 8);
      *reinterpret_cast<uint4*>(&w1_s[r * XS + cv * 8]) =
          *reinterpret_cast<const uint4*>(&w1[(size_t)(c0 + r) * C + cv * 8]);
    }
    for (int i = tid; i < C * IC / 8; i += THREADS) {
      const int r = i / (IC / 8), cv = i % (IC / 8);
      *reinterpret_cast<uint4*>(&w2_s[r * WS + cv * 8]) =
          *reinterpret_cast<const uint4*>(&w2[(size_t)r * I + c0 + cv * 8]);
    }
    __syncthreads();

    {  // h chunk (BM x IC): warp -> one 16 x 8 tile
      const int mt = warp >> 2, nt = warp & 3;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* A = xn_s + (mt * 16) * XS + 2 * t;
      const bf16* B = w1_s + (nt * 8 + g) * XS + 2 * t;
#pragma unroll 8
      for (int k = 0; k < C; k += 16) {
        uint32_t a[4] = {ld32(A + g * XS + k), ld32(A + (g + 8) * XS + k),
                         ld32(A + g * XS + k + 8), ld32(A + (g + 8) * XS + k + 8)};
        mma_bf16(c, a, ld32(B + k), ld32(B + k + 8));
      }
      const int col = nt * 8 + 2 * t;
      const float bb0 = bf(b1[c0 + col]), bb1 = bf(b1[c0 + col + 1]);
      *reinterpret_cast<uint32_t*>(&h_s[(mt * 16 + g) * WS + col]) =
          pack_bf16(gelu_tanh(c[0] + bb0), gelu_tanh(c[1] + bb1));
      *reinterpret_cast<uint32_t*>(&h_s[(mt * 16 + g + 8) * WS + col]) =
          pack_bf16(gelu_tanh(c[2] + bb0), gelu_tanh(c[3] + bb1));
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < IC; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const bf16* A = h_s + (m * 16) * WS + ks + 2 * t;
        a[m][0] = ld32(A + g * WS);
        a[m][1] = ld32(A + (g + 8) * WS);
        a[m][2] = ld32(A + g * WS + 8);
        a[m][3] = ld32(A + (g + 8) * WS + 8);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* B = w2_s + (n_base + n * 8 + g) * WS + ks + 2 * t;
        const uint32_t b0 = ld32(B), b1v = ld32(B + 8);
        mma_bf16(acc[0][n], a[0], b0, b1v);
        mma_bf16(acc[1][n], a[1], b0, b1v);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + m * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n_base + n * 8 + 2 * t;
        const float y0 = bf(gamma[col]) * (acc[m][n][2 * half] + bf(b2[col]));
        const float y1 = bf(gamma[col + 1]) * (acc[m][n][2 * half + 1] + bf(b2[col + 1]));
        const size_t o = (size_t)row * C + col;
        *reinterpret_cast<uint32_t*>(&out[o]) = pack_bf16(bf(res[o]) + y0, bf(res[o + 1]) + y1);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* gamma, void* out, int M,
                   int I, float eps, cudaStream_t stream) {
  constexpr int C = 64 * NT;
  const size_t smem = sizeof(bf16) * ((size_t)BM * (C + 8) + (size_t)IC * (C + 8) +
                                      (size_t)C * (IC + 8) + (size_t)BM * (IC + 8));
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
