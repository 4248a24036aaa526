// The bf16 W1 -> tanh-GELU -> W2 -> layer scale -> residual chain of a block
// of BM = 32 normalised rows, as csrc/convnext_dw.cu (B4) runs it after its
// depthwise prologue.  (B2, csrc/ln_ffn.cu, runs the same function as
// passes on the TMA + wgmma core of csrc/ffn_sm90.cuh.)
//
// The caller has written LN(x) of its rows as bf16 into xn_s (BM rows of
// stride C + 8, zeros for rows past the end).  The chain keeps the
// (BM, I) intermediate on chip and streams the weights from L2:
//   * I is walked in chunks of IC = 32: h = GELU(LN(x) W1[chunk]^T + b1[chunk])
//     goes to shared memory as bf16, then acc += h W2[:, chunk]^T;
//   * acc (BM, C) stays in f32 registers: each of the 8 warps owns C / 8
//     output columns;
//   * the epilogue adds b2, scales by gamma and adds the residual.
// Loads are plain synchronous 16-byte copies; no TMA, no wgmma, no overlap
// of copies with products.
#pragma once

#include "common.cuh"

namespace ffn_chain {

constexpr int BM = 32;
constexpr int IC = 32;
constexpr int THREADS = 256;

// dynamic shared memory of the chain for C = 64 * NT: xn_s | w1_s | w2_s | h_s
template <int NT>
constexpr size_t smem_bytes() {
  constexpr size_t C = 64 * NT;
  return sizeof(bf16) * (BM * (C + 8) + IC * (C + 8) + C * (IC + 8) + BM * (IC + 8));
}

// smem: the chain's buffers (xn_s first, already filled by the caller).
// res and out point at the block's first row (row stride C); rows <= BM
// of them are written.
template <int NT>
__device__ __forceinline__ void run(bf16* smem, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                                    const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                                    const bf16* __restrict__ gamma, const bf16* __restrict__ res,
                                    bf16* __restrict__ out, int rows, int I) {
  constexpr int C = 64 * NT;
  constexpr int XS = C + 8;    // row stride (elements) of xn_s and w1_s
  constexpr int WS = IC + 8;   // row stride of w2_s and h_s
  const bf16* xn_s = smem;     // BM x XS
  bf16* w1_s = smem + BM * XS; // IC x XS
  bf16* w2_s = w1_s + IC * XS; // C  x WS
  bf16* h_s = w2_s + C * WS;   // BM x WS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_base = warp * (C / 8);  // this warp's output columns in the second product
  for (int c0 = 0; c0 < I; c0 += IC) {
    __syncthreads();  // the previous chunk's operands are consumed (and the LN rows written)
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
      const int row = m * 16 + g + 8 * half;
      if (row >= rows) continue;
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

}  // namespace ffn_chain
