// The bf16 up and down passes of an LN-FFN chain on the GEMM core of
// csrc/ffn_sm90.cuh, shared by csrc/ln_ffn.cu (B2) and csrc/convnext_dw.cu
// (B4), which differ only in their row kernel (what forms xn):
//   up:   h = bf16(GELU(xn W1^T + b1)) -> workspace (M, I);
//   down: out = bf16(res + gamma (h W2^T + b2));
//   partial down (tensor parallelism: W1's rows and W2's columns are one
//   rank's slice of I, so h W2^T is a partial sum): out = f32 gamma
//   (h W2^T + b2), b2 null on all but one rank, no residual.  The wrapper
//   sums the ranks' partials and adds the residual, rounding once.
// Each source instantiates the pass kernels under its own names
// (FFN_PASS_KERNEL), so that a profile tells B2's launches from B4's.
#pragma once

#include "ffn_sm90.cuh"

namespace ffn_bf16 {

using ffn_sm90::Bf16;

// h = bf16(GELU(acc + b1)), (M, N = I), staged in shared memory for one TMA
// store of the tile (columns past N are computed on zeros and not stored)
struct UpEpilogue {
  static constexpr int STAGED_ITEM = 2;
  const bf16* b1;
  int N;
  FFN_EPILOGUE_APPLY(float)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const float (&d)[BN / 2], const ffn_sm90::Frag& f) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;  // N is even: c + 1 < N with c
      const float bb0 = !CLIP || c < N ? bf(b1[c]) : 0.f, bb1 = !CLIP || c < N ? bf(b1[c + 1]) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ffn_sm90::st_shared(f.smem + ffn_sm90::swizzle128(f.lrow + 8 * r, 2 * (f.lcol + 8 * j), ffn_sm90::BM),
                            pack_bf16(gelu_tanh(d[4 * j + 2 * r] + bb0), gelu_tanh(d[4 * j + 2 * r + 1] + bb1)));
    }
  }
};

// out = bf16(res + gamma (acc + b2)), (M, N = C)
struct DownEpilogue {
  static constexpr int STAGED_ITEM = 0;
  const bf16 *b2, *gamma, *res;
  bf16* out;
  int M, N;
  FFN_EPILOGUE_APPLY(float)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const float (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < M, f.row + 8 < M};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;
      if (CLIP && c >= N) continue;
      const float g0 = bf(gamma[c]), g1 = bf(gamma[c + 1]), bb0 = bf(b2[c]), bb1 = bf(b2[c + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        const size_t o = (size_t)(f.row + 8 * r) * N + c;
        *reinterpret_cast<uint32_t*>(&out[o]) = pack_bf16(bf(res[o]) + g0 * (d[4 * j + 2 * r] + bb0),
                                                          bf(res[o + 1]) + g1 * (d[4 * j + 2 * r + 1] + bb1));
      }
    }
  }
};

// f32 out = gamma (acc + b2), (M, N = C); b2 may be null (adds nothing)
struct PartialDownEpilogue {
  static constexpr int STAGED_ITEM = 0;
  const bf16 *b2, *gamma;
  float* out;
  int M, N;
  FFN_EPILOGUE_APPLY(float)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const float (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < M, f.row + 8 < M};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;  // even, so out + o is 8-byte aligned
      if (CLIP && c >= N) continue;
      const float g0 = bf(gamma[c]), g1 = bf(gamma[c + 1]);
      const float bb0 = b2 ? bf(b2[c]) : 0.f, bb1 = b2 ? bf(b2[c + 1]) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        const size_t o = (size_t)(f.row + 8 * r) * N + c;
        *reinterpret_cast<float2*>(&out[o]) = make_float2(g0 * (d[4 * j + 2 * r] + bb0),
                                                          g1 * (d[4 * j + 2 * r + 1] + bb1));
      }
    }
  }
};

// Passes 2 (up), 4 (down) and 8 (partial down, `out` then f32) of `passes`
// over M rows: `up` is the caller's up kernel (BN = UP_BN),
// down_of(std::integral_constant<int, BN>) its down kernel of width BN and
// partial_of(...) its partial down kernel; g_* the tensor-map geometries of
// xn, W1, h and W2 (ops/fused_convnext.py::ffn_tile_maps).  Returns 0 or the
// first error; 4 and 8 together are an error.
template <class UpKernel, class DownKernelOf, class PartialKernelOf>
int up_down_passes(UpKernel up, DownKernelOf down_of, PartialKernelOf partial_of, const void* xn, const void* w1,
                   const void* b1, void* h, const void* w2, const void* b2, const void* gamma, const void* res,
                   void* out, int M, int C, int I, const long long* g_xn, const long long* g_w1, const long long* g_h,
                   const long long* g_w2, int passes, cudaStream_t s) {
  int err = (passes & 12) == 12 ? (int)cudaErrorInvalidValue : 0;
  if (err == 0 && (passes & 2))
    err = g_w1[11] != ffn_sm90::UP_BN
              ? (int)cudaErrorInvalidValue
              : ffn_sm90::launch_pass<Bf16, ffn_sm90::UP_BN>(up, xn, g_xn, w1, g_w1, h, g_h, {M, I, C},
                                                             UpEpilogue{(const bf16*)b1, I}, s);
  if (err == 0 && (passes & 4)) {
    const DownEpilogue epi{(const bf16*)b2, (const bf16*)gamma, (const bf16*)res, (bf16*)out, M, C};
    err = ffn_sm90::with_block_n(g_w2[11], [&](auto bn) {
      return ffn_sm90::launch_pass<Bf16, decltype(bn)::value>(down_of(bn), h, g_h, w2, g_w2, nullptr, nullptr,
                                                               {M, C, I}, epi, s);
    });
  }
  if (err == 0 && (passes & 8)) {
    const PartialDownEpilogue epi{(const bf16*)b2, (const bf16*)gamma, (float*)out, M, C};
    err = ffn_sm90::with_block_n(g_w2[11], [&](auto bn) {
      return ffn_sm90::launch_pass<Bf16, decltype(bn)::value>(partial_of(bn), h, g_h, w2, g_w2, nullptr, nullptr,
                                                               {M, C, I}, epi, s);
    });
  }
  return err;
}

}  // namespace ffn_bf16
