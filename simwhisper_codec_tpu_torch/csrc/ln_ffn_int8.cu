// Fused int8 LayerNorm -> W1 -> tanh-GELU -> W2 -> layer scale -> residual.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/fused_convnext.py
// fused_ln_ffn_int8 (_kernel_int8): LN in f32; per-row absmax int8
// quantisation (scale = max|x| / 127, 1 for a zero row, round half to even
// of x / scale); s8 x s8 -> s32 product with W1q (I, C); times the row scale
// and the per-channel weight scale s1, plus b1; tanh-GELU; per-row
// requantisation over all of I; s8 product with W2q (C, I); times the row
// scale and s2, plus b2; times gamma, plus the residual.
//
// Bound on the H100: the two products (4 M C I integer operations) against
// the int8 tensor-core rate.  The second quantisation needs each row's
// absmax over all of I before the second product; the TPU kernel held the
// whole (block_m, I) f32 block in VMEM, which for I = 4096 is 16 KB a row
// and too much for shared memory at a useful block height.  So the kernel
// makes two passes over I for a block of BM = 32 rows:
//   pass 1 computes h = GELU(...) chunk by chunk and keeps only each row's
//          absmax (integer products are exact, so pass 2 recomputes the same h);
//   pass 2 recomputes h, quantises it with the final row scale into shared
//          memory and accumulates the second product in s32 registers.
// That is 1.5x the products of one pass, at twice the bf16 rate.  Division
// by the scale is a true IEEE division and rounding is rintf (half to even),
// as in the JAX kernel; the h epilogue uses explicitly rounded operations so
// no FMA contraction moves a value across a quantisation boundary.
#include "common.cuh"

namespace {

constexpr int BM = 32;
constexpr int IC = 64;
constexpr int THREADS = 256;

template <int NT>  // C = 64 * NT
struct Smem {
  static constexpr int C = 64 * NT;
  static constexpr int XS = C + 16;   // row stride (bytes) of xq_s and w1_s
  static constexpr int WS = IC + 16;  // row stride of w2_s and hq_s
  static constexpr size_t bytes =
      (size_t)BM * XS + (size_t)IC * XS + (size_t)C * WS + (size_t)BM * WS + 3 * BM * sizeof(float);
};

// h for this warp's two 16 x 8 tiles of the current chunk (rows mt*16.., cols nt0*8..)
template <int C, int XS>
__device__ __forceinline__ void first_product(const int8_t* xq_s, const int8_t* w1_s, int mt, int nt0,
                                              int c[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* A = xq_s + (mt * 16) * XS + 4 * t;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0;
#pragma unroll 4
  for (int k = 0; k < C; k += 32) {
    uint32_t a[4] = {ld32(A + g * XS + k), ld32(A + (g + 8) * XS + k), ld32(A + g * XS + k + 16),
                     ld32(A + (g + 8) * XS + k + 16)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int8_t* B = w1_s + ((nt0 + j) * 8 + g) * XS + 4 * t + k;
      mma_s8(c[j], a, ld32(B), ld32(B + 16));
    }
  }
}

__device__ __forceinline__ float h_value(int acc, float xs, float s1, float b1) {
  return gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn((float)acc, xs), s1), b1));
}

template <int NT>
__global__ void __launch_bounds__(THREADS) ln_ffn_int8_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res, const bf16* __restrict__ ln_w,
    const bf16* __restrict__ ln_b, const int8_t* __restrict__ w1q, const float* __restrict__ s1,
    const bf16* __restrict__ b1, const int8_t* __restrict__ w2q, const float* __restrict__ s2,
    const bf16* __restrict__ b2, const bf16* __restrict__ gamma, bf16* __restrict__ out, int M, int I,
    float eps) {
  using S = Smem<NT>;
  constexpr int C = S::C, XS = S::XS, WS = S::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);  // BM x XS
  int8_t* w1_s = xq_s + BM * XS;                    // IC x XS
  int8_t* w2_s = w1_s + IC * XS;                    // C  x WS
  int8_t* hq_s = w2_s + C * WS;                     // BM x WS
  float* xs_s = reinterpret_cast<float*>(hq_s + BM * WS);
  float* hs_s = xs_s + BM;
  unsigned* hmax_s = reinterpret_cast<unsigned*>(hs_s + BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    float v[C / 32];
    warp_layer_norm<C / 32>(x + (size_t)row * C, ln_w, ln_b, eps, row < M, v);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) amax = fmaxf(amax, fabsf(v[i]));
    amax = warp_max(amax);
    float xs = amax / 127.0f;
    if (xs == 0.f || row >= M) xs = 1.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i)
      xq_s[r * XS + lane + 32 * i] = row < M ? (int8_t)rintf(v[i] / xs) : (int8_t)0;
    if (lane == 0) {
      xs_s[r] = xs;
      hmax_s[r] = 0u;
    }
  }

  const int mt = warp >> 2, nt0 = (warp & 3) * 2;  // first product: 2 tiles of the 32 x 64 chunk
  const int rA = mt * 16 + g, rB = rA + 8;

  // pass 1: each row's absmax of h over all of I
  float hmaxA = 0.f, hmaxB = 0.f;
  for (int c0 = 0; c0 < I; c0 += IC) {
    __syncthreads();
    for (int i = tid; i < IC * C / 16; i += THREADS) {
      const int r = i / (C / 16), cv = i % (C / 16);
      *reinterpret_cast<uint4*>(&w1_s[r * XS + cv * 16]) =
          *reinterpret_cast<const uint4*>(&w1q[(size_t)(c0 + r) * C + cv * 16]);
    }
    __syncthreads();
    int c[2][4];
    first_product<C, XS>(xq_s, w1_s, mt, nt0, c);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + (nt0 + j) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = s1[col + e], bb = bf(b1[col + e]);
        hmaxA = fmaxf(hmaxA, fabsf(h_value(c[j][e], xs_s[rA], sc, bb)));
        hmaxB = fmaxf(hmaxB, fabsf(h_value(c[j][2 + e], xs_s[rB], sc, bb)));
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    hmaxA = fmaxf(hmaxA, __shfl_xor_sync(0xffffffffu, hmaxA, o));
    hmaxB = fmaxf(hmaxB, __shfl_xor_sync(0xffffffffu, hmaxB, o));
  }
  if (t == 0) {  // |h| >= 0, so the float bit patterns order like unsigned ints
    atomicMax(&hmax_s[rA], __float_as_uint(hmaxA));
    atomicMax(&hmax_s[rB], __float_as_uint(hmaxB));
  }
  __syncthreads();
  if (tid < BM) {
    const float hs = __uint_as_float(hmax_s[tid]) / 127.0f;
    hs_s[tid] = hs == 0.f ? 1.f : hs;
  }

  int acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

  // pass 2: requantise h with the row scale, second product
  const int n_base = warp * (C / 8);
  for (int c0 = 0; c0 < I; c0 += IC) {
    __syncthreads();
    for (int i = tid; i < IC * C / 16; i += THREADS) {
      const int r = i / (C / 16), cv = i % (C / 16);
      *reinterpret_cast<uint4*>(&w1_s[r * XS + cv * 16]) =
          *reinterpret_cast<const uint4*>(&w1q[(size_t)(c0 + r) * C + cv * 16]);
    }
    for (int i = tid; i < C * IC / 16; i += THREADS) {
      const int r = i / (IC / 16), cv = i % (IC / 16);
      *reinterpret_cast<uint4*>(&w2_s[r * WS + cv * 16]) =
          *reinterpret_cast<const uint4*>(&w2q[(size_t)r * I + c0 + cv * 16]);
    }
    __syncthreads();
    int c[2][4];
    first_product<C, XS>(xq_s, w1_s, mt, nt0, c);
    const float hsA = hs_s[rA], hsB = hs_s[rB];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int lc = (nt0 + j) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = s1[c0 + lc + e], bb = bf(b1[c0 + lc + e]);
        hq_s[rA * WS + lc + e] = (int8_t)rintf(h_value(c[j][e], xs_s[rA], sc, bb) / hsA);
        hq_s[rB * WS + lc + e] = (int8_t)rintf(h_value(c[j][2 + e], xs_s[rB], sc, bb) / hsB);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < IC; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int8_t* A = hq_s + (m * 16) * WS + ks + 4 * t;
        a[m][0] = ld32(A + g * WS);
        a[m][1] = ld32(A + (g + 8) * WS);
        a[m][2] = ld32(A + g * WS + 16);
        a[m][3] = ld32(A + (g + 8) * WS + 16);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int8_t* B = w2_s + (n_base + n * 8 + g) * WS + ks + 4 * t;
        const uint32_t b0 = ld32(B), b1v = ld32(B + 16);
        mma_s8(acc[0][n], a[0], b0, b1v);
        mma_s8(acc[1][n], a[1], b0, b1v);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + g + 8 * half, row = row0 + r;
      if (row >= M) continue;
      const float hs = hs_s[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n_base + n * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[m][n][2 * half + e], hs), s2[col + e]),
                                    bf(b2[col + e]));
          y[e] = bf(gamma[col + e]) * d;
        }
        const size_t o = (size_t)row * C + col;
        *reinterpret_cast<uint32_t*>(&out[o]) = pack_bf16(bf(res[o]) + y[0], bf(res[o + 1]) + y[1]);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1q,
                   const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
                   const void* gamma, void* out, int M, int I, float eps, cudaStream_t stream) {
  const size_t smem = Smem<NT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ln_ffn_int8_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM);
  ln_ffn_int8_kernel<NT><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)res, (const bf16*)ln_w, (const bf16*)ln_b, (const int8_t*)w1q,
      (const float*)s1, (const bf16*)b1, (const int8_t*)w2q, (const float*)s2, (const bf16*)b2,
      (const bf16*)gamma, (bf16*)out, M, I, eps);
  return cudaGetLastError();
}

}  // namespace

// C must be a multiple of 64 up to 768 and I a multiple of 64; x, res and the
// bf16 vectors contiguous bf16, W1q (I, C) and W2q (C, I) int8, s1 (I,) and
// s2 (C,) f32.  Returns the CUDA error of the launch (0 on success).
extern "C" int ln_ffn_int8(const void* x, const void* res, const void* ln_w, const void* ln_b,
                           const void* w1q, const void* s1, const void* b1, const void* w2q,
                           const void* s2, const void* b2, const void* gamma, void* out, int M, int C,
                           int I, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C / 64) {
#define CASE(NT)                                                                                  \
  case NT:                                                                                        \
    return (int)launch<NT>(x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, out, M, I, eps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
