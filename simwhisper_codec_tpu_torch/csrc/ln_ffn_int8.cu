// int8 LayerNorm -> W1 -> tanh-GELU -> W2 -> layer scale -> residual, in
// four passes on the Hopper GEMM core of csrc/ffn_sm90.cuh.
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
// absmax of h over all of I before any of h can be quantised; the TPU
// kernel held the whole (block_m, I) f32 block in VMEM.  Here the chain is
// split into passes (see csrc/ln_ffn.cu for why no fused chain of
// wgmma-sized blocks fits), and h is formed twice instead of stored in f32
// (which would be 4 M I bytes written and read: 393 MB at 512 x 4096 and
// M = 24000, against ~0.08 ms to recompute one int8 product):
//   1. ln_ffn_int8_rows_kernel: LN, row absmax, xs, xq = rint(v / xs) ->
//      workspaces xq (M, C) s8 and xs (M,) f32; clears the row's hmax.  Its
//      DW instantiation (ln_ffn_int8_dw: the Vocos ConvNeXt block, x its
//      (B, T, C) input and residual) first forms each row's masked
//      depthwise k7 conv in registers from a shared-memory window, rounded
//      where the plain chain rounds (csrc/dw_rows.cuh, BF16_CHAIN), so xq
//      and xs equal those of the plain conv followed by the plain row
//      kernel, and xdw never reaches device memory;
//   2. ln_ffn_int8_upmax_kernel: the s8 product xq W1q^T; its epilogue forms
//      h and keeps only each row's |h| max: quad shuffles, then one
//      atomicMax on the float bits per row and tile (|h| >= 0, so the bit
//      patterns order like unsigned ints);
//   3. ln_ffn_int8_upq_kernel: the same product; its epilogue forms the same
//      h (the integer product is exact and the epilogue deterministic, so h
//      equals pass 2's bit for bit) and writes hq = rint(h / hs) -> workspace
//      (M, I) s8, hs = hmax / 127 (1 for a zero row);
//   4. ln_ffn_int8_down_kernel: the s8 product hq W2q^T;
//      out = res + gamma ((acc hs) s2 + b2).
// Under tensor parallelism W1q's rows (with s1, b1) and W2q's columns are
// one rank's slice of I.  The row max of h must still run over all of I:
// the wrapper launches passes 1-2, all-reduces hmax (MAX, as int32: the
// bits of non-negative floats order as integers) over the model group,
// then launches pass 3 and ln_ffn_int8_down_partial_kernel, which writes
// the f32 partial gamma ((acc hs) s2 + b2), b2 on one rank only; the
// wrapper sums the ranks' partials and adds the residual, rounding once.
// Division by a scale is correctly rounded (a true IEEE division for xq; for
// hq a per-row reciprocal and one exact-remainder correction) and rounding
// is half to even, as in the JAX kernel; h and the rescales use explicitly
// rounded operations so that no FMA contraction moves a value across a
// quantisation boundary.  hq is clamped to [-127, 127], which changes
// nothing when the two passes agree (|h| <= hmax) and keeps an int8 from
// wrapping if they did not.
#include "dw_rows.cuh"
#include "ffn_sm90.cuh"

namespace {

using ffn_sm90::S8;

constexpr int ROWS_THREADS = 256;  // 8 warps, one row each

// a LayerNormed row v (lane l holds channels l, l + 32, ...) -> its xq row,
// xs = max|v| / 127 (1 for a zero row), and the row's hmax cleared
template <int VPL>
__device__ __forceinline__ void quantise_row(const float (&v)[VPL], size_t row, int8_t* __restrict__ xq,
                                             float* __restrict__ xs_out, unsigned* __restrict__ hmax) {
  constexpr int C = VPL * 32;
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = warp_max(amax);
  float xs = amax / 127.0f;
  if (xs == 0.f) xs = 1.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) xq[row * C + lane + 32 * i] = (int8_t)rintf(v[i] / xs);
  if (lane == 0) {
    xs_out[row] = xs;
    hmax[row] = 0u;
  }
}

// C = 64 * NT; DW: x is a Vocos block's (B, T, C) input and each row is its
// depthwise conv (``dw``, a block per ROWS time rows of one item), else x is
// (M, C) rows, one warp a row (``dw`` unread)
template <int NT, bool DW>
__global__ void __launch_bounds__(ROWS_THREADS, DW ? 2 : 1) ln_ffn_int8_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
    int8_t* __restrict__ xq, float* __restrict__ xs_out, unsigned* __restrict__ hmax, int M, float eps,
    dw_rows::Args dw) {
  constexpr int C = 64 * NT;
  if constexpr (DW) {
    dw_rows::rows<NT, dw_rows::Sum::BF16_CHAIN>(
        x, dw, ln_w, ln_b, eps, [&](size_t row, const float(&v)[C / 32]) { quantise_row(v, row, xq, xs_out, hmax); });
  } else {
    const int row = blockIdx.x * (ROWS_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= M) return;
    float v[C / 32];
    warp_layer_norm<C / 32>(x + (size_t)row * C, ln_w, ln_b, eps, true, v);
    quantise_row(v, row, xq, xs_out, hmax);
  }
}

__device__ __forceinline__ float h_value(int acc, float xs, float s1, float b1) {
  return gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn((float)acc, xs), s1), b1));
}

__device__ __forceinline__ float row_scale(const unsigned* hmax, int row) {
  const float hs = __uint_as_float(hmax[row]) / 127.0f;
  return hs == 0.f ? 1.f : hs;
}

// a / b rounded to nearest from y = RN(1 / b): q = RN(a y), then one
// correction with the exact remainder a - b q (an FMA), which gives the
// correctly rounded quotient (Markstein) for the normal, finite operands
// here, at three full-rate operations instead of a division
__device__ __forceinline__ float quotient(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// the first product's operands of one epilogue: row scales and W1's columns
struct UpArgs {
  const float *xs, *s1;
  const bf16* b1;
  unsigned* hmax;
  int M, N;  // N = I
};

// pass 2: each row's max |h| over this tile -> atomicMax into hmax
struct UpMaxEpilogue {
  static constexpr int STAGED_ITEM = 0;
  UpArgs p;
  FFN_EPILOGUE_APPLY(int)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const int (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < p.M, f.row + 8 < p.M};
    const float xs[2] = {in[0] ? p.xs[f.row] : 1.f, in[1] ? p.xs[f.row + 8] : 1.f};
    float mx[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;
      if (CLIP && c >= p.N) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = p.s1[c + e], bb = bf(p.b1[c + e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fabsf(h_value(d[4 * j + 2 * r + e], xs[r], sc, bb)));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((threadIdx.x & 3) == 0 && in[r]) atomicMax(&p.hmax[f.row + 8 * r], __float_as_uint(mx[r]));
    }
  }
};

// pass 3: hq = rint(h / hs), (M, N = I) s8, staged in shared memory for one
// TMA store of the tile (columns past N are computed on zeros and not stored)
struct UpQuantEpilogue {
  static constexpr int STAGED_ITEM = 1;
  UpArgs p;
  FFN_EPILOGUE_APPLY(int)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const int (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < p.M, f.row + 8 < p.M};
    const float xs[2] = {in[0] ? p.xs[f.row] : 1.f, in[1] ? p.xs[f.row + 8] : 1.f};
    const float hs[2] = {in[0] ? row_scale(p.hmax, f.row) : 1.f, in[1] ? row_scale(p.hmax, f.row + 8) : 1.f};
    const float hr[2] = {__frcp_rn(hs[0]), __frcp_rn(hs[1])};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;  // N is even: c + 1 < N with c
      const bool col_in = !CLIP || c < p.N;
      const float sc[2] = {col_in ? p.s1[c] : 0.f, col_in ? p.s1[c + 1] : 0.f};
      const float bb[2] = {col_in ? bf(p.b1[c]) : 0.f, col_in ? bf(p.b1[c + 1]) : 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = h_value(d[4 * j + 2 * r + e], xs[r], sc[e], bb[e]);
          q[e] = min(max(__float2int_rn(quotient(h, hs[r], hr[r])), -127), 127);
        }
        ffn_sm90::st_shared(f.smem + ffn_sm90::swizzle128(f.lrow + 8 * r, f.lcol + 8 * j, ffn_sm90::BM),
                            (uint16_t)((q[0] & 0xff) | ((q[1] & 0xff) << 8)));
      }
    }
  }
};

// pass 4: out = bf16(res + gamma ((acc hs) s2 + b2)), (M, N = C)
struct DownEpilogue {
  static constexpr int STAGED_ITEM = 0;
  const unsigned* hmax;
  const float* s2;
  const bf16 *b2, *gamma, *res;
  bf16* out;
  int M, N;
  FFN_EPILOGUE_APPLY(int)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const int (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < M, f.row + 8 < M};
    const float hs[2] = {in[0] ? row_scale(hmax, f.row) : 1.f, in[1] ? row_scale(hmax, f.row + 8) : 1.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;
      if (CLIP && c >= N) continue;
      const float sc[2] = {s2[c], s2[c + 1]}, bb[2] = {bf(b2[c]), bf(b2[c + 1])};
      const float g[2] = {bf(gamma[c]), bf(gamma[c + 1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = g[e] * __fadd_rn(__fmul_rn(__fmul_rn((float)d[4 * j + 2 * r + e], hs[r]), sc[e]), bb[e]);
        const size_t o = (size_t)(f.row + 8 * r) * N + c;
        *reinterpret_cast<uint32_t*>(&out[o]) = pack_bf16(bf(res[o]) + y[0], bf(res[o + 1]) + y[1]);
      }
    }
  }
};

// pass 4 of the partial mode: f32 out = gamma ((acc hs) s2 + b2), (M, N = C);
// b2 may be null (adds nothing)
struct PartialDownEpilogue {
  static constexpr int STAGED_ITEM = 0;
  const unsigned* hmax;
  const float* s2;
  const bf16 *b2, *gamma;
  float* out;
  int M, N;
  FFN_EPILOGUE_APPLY(int)
  template <int BN, bool CLIP>
  __device__ __forceinline__ void body(const int (&d)[BN / 2], const ffn_sm90::Frag& f) const {
    const bool in[2] = {f.row < M, f.row + 8 < M};
    const float hs[2] = {in[0] ? row_scale(hmax, f.row) : 1.f, in[1] ? row_scale(hmax, f.row + 8) : 1.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = f.col + 8 * j;  // even, so out + o is 8-byte aligned
      if (CLIP && c >= N) continue;
      const float sc[2] = {s2[c], s2[c + 1]};
      const float bb[2] = {b2 ? bf(b2[c]) : 0.f, b2 ? bf(b2[c + 1]) : 0.f};
      const float g[2] = {bf(gamma[c]), bf(gamma[c + 1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = __fmul_rn(g[e], __fadd_rn(__fmul_rn(__fmul_rn((float)d[4 * j + 2 * r + e], hs[r]), sc[e]), bb[e]));
        *reinterpret_cast<float2*>(&out[(size_t)(f.row + 8 * r) * N + c]) = make_float2(y[0], y[1]);
      }
    }
  }
};

FFN_PASS_KERNEL(ln_ffn_int8_upmax_kernel, S8, UpMaxEpilogue)
FFN_PASS_KERNEL(ln_ffn_int8_upq_kernel, S8, UpQuantEpilogue)
FFN_PASS_KERNEL(ln_ffn_int8_down_kernel, S8, DownEpilogue)
FFN_PASS_KERNEL(ln_ffn_int8_down_partial_kernel, S8, PartialDownEpilogue)

// the rows pass over M rows; with DW over x (B, T, C), M = B T, its conv's operands in ``dw``
template <int NT, bool DW>
int rows_pass(const void* x, const void* ln_w, const void* ln_b, void* xq, void* xs, void* hmax, int M, float eps,
              dw_rows::Args dw, cudaStream_t s) {
  const auto kernel = ln_ffn_int8_rows_kernel<NT, DW>;
  int grid = (M + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32), bytes = 0;
  if constexpr (DW) {
    static_assert(ROWS_THREADS == dw_rows::THREADS, "the DW rows pass runs dw_rows' blocks");
    bytes = dw_rows::smem_bytes(64 * NT);
    const cudaError_t e = sm90::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    grid = M / dw.T * dw.tiles;
  }
  kernel<<<grid, ROWS_THREADS, bytes, s>>>((const bf16*)x, (const bf16*)ln_w, (const bf16*)ln_b, (int8_t*)xq,
                                          (float*)xs, (unsigned*)hmax, M, eps, dw);
  return (int)cudaGetLastError();
}

template <bool DW>
int rows_pass_any(int C, const void* x, const void* ln_w, const void* ln_b, void* xq, void* xs, void* hmax, int M,
                  float eps, dw_rows::Args dw, cudaStream_t s) {
  switch (C / 64) {
#define CASE(NT) \
  case NT:       \
    return rows_pass<NT, DW>(x, ln_w, ln_b, xq, xs, hmax, M, eps, dw, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// passes 2-16 of ``passes`` (bit 1, the rows pass, is the caller's), after ``err``
int later_passes(int err, const void* res, const void* w1q, const void* s1, const void* b1, const void* w2q,
                 const void* s2, const void* b2, const void* gamma, void* out, void* xq, void* xs, void* hmax,
                 void* hq, int M, int C, int I, const long long* g_xq, const long long* g_w1, const long long* g_hq,
                 const long long* g_w2, int passes, cudaStream_t s) {
  const UpArgs up{(const float*)xs, (const float*)s1, (const bf16*)b1, (unsigned*)hmax, M, I};
  constexpr int UP_BN = ffn_sm90::UP_BN;
  if (err == 0 && (passes & 6) && g_w1[11] != UP_BN) err = (int)cudaErrorInvalidValue;
  if (err == 0 && (passes & 24) == 24) err = (int)cudaErrorInvalidValue;
  if (err == 0 && (passes & 2))
    err = ffn_sm90::launch_pass<S8, UP_BN>(ln_ffn_int8_upmax_kernel<UP_BN>, xq, g_xq, w1q, g_w1, nullptr, nullptr,
                                           {M, I, C}, UpMaxEpilogue{up}, s);
  if (err == 0 && (passes & 4))
    err = ffn_sm90::launch_pass<S8, UP_BN>(ln_ffn_int8_upq_kernel<UP_BN>, xq, g_xq, w1q, g_w1, hq, g_hq, {M, I, C},
                                           UpQuantEpilogue{up}, s);
  if (err == 0 && (passes & 8)) {
    const DownEpilogue epi{(const unsigned*)hmax, (const float*)s2, (const bf16*)b2, (const bf16*)gamma,
                           (const bf16*)res, (bf16*)out, M, C};
    err = ffn_sm90::with_block_n(g_w2[11], [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      return ffn_sm90::launch_pass<S8, BN>(ln_ffn_int8_down_kernel<BN>, hq, g_hq, w2q, g_w2, nullptr, nullptr,
                                           {M, C, I}, epi, s);
    });
  }
  if (err == 0 && (passes & 16)) {
    const PartialDownEpilogue epi{(const unsigned*)hmax, (const float*)s2, (const bf16*)b2, (const bf16*)gamma,
                                  (float*)out, M, C};
    err = ffn_sm90::with_block_n(g_w2[11], [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      return ffn_sm90::launch_pass<S8, BN>(ln_ffn_int8_down_partial_kernel<BN>, hq, g_hq, w2q, g_w2, nullptr,
                                           nullptr, {M, C, I}, epi, s);
    });
  }
  return err;
}

}  // namespace

// Passes, a bit each (1 rows, 2 up-max, 4 up-quantise, 8 down, 16 partial
// down: out (M, C) f32, b2 may be null, res not read; the wrapper runs all
// but one of the downs, in one launch, or in two around the hmax reduction
// under tensor parallelism; a timer one at a time).  C a multiple of 64 up to 768, I a
// multiple of 64; x, res and the bf16 vectors contiguous bf16, W1q (I, C)
// and W2q (C, I) contiguous int8, s1 (I,) and s2 (C,) f32; workspaces xq
// (M, C) int8, xs (M,) f32, hmax (M,) 32-bit, hq (M, I) int8; g_* the
// tensor-map geometries of xq, W1q, hq and W2q
// (ops/fused_convnext.py::ffn_tile_maps).  Returns 0, or the first error of
// the passes: a CUDA error or sm90::TENSOR_MAP_ERROR + the driver's CUresult.
extern "C" int ln_ffn_int8(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1q,
                           const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
                           const void* gamma, void* out, void* xq, void* xs, void* hmax, void* hq, int M, int C,
                           int I, float eps, const long long* g_xq, const long long* g_w1, const long long* g_hq,
                           const long long* g_w2, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (passes & 1) err = rows_pass_any<false>(C, x, ln_w, ln_b, xq, xs, hmax, M, eps, dw_rows::Args{}, s);
  return later_passes(err, res, w1q, s1, b1, w2q, s2, b2, gamma, out, xq, xs, hmax, hq, M, C, I, g_xq, g_w1, g_hq,
                      g_w2, passes, s);
}

// The Vocos ConvNeXt block's int8 chain with its depthwise conv folded into
// the rows pass: ln_ffn_int8's arguments with x (B, T, C) the block input,
// read by the rows pass as the conv's input and by the down pass as the
// residual (res is x), M = B T, then the conv's taps dw_w (7, C) and bias
// dw_b (C,) contiguous bf16, the edge frame_valid as a device int32 (rows
// [0, min(*frame_valid, T)) unmasked), B and T.  Passes 16 (partial down)
// is refused: under tensor parallelism the chain runs the plain conv.
extern "C" int ln_ffn_int8_dw(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1q,
                              const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
                              const void* gamma, void* out, void* xq, void* xs, void* hmax, void* hq, int M, int C,
                              int I, float eps, const long long* g_xq, const long long* g_w1, const long long* g_hq,
                              const long long* g_w2, const void* dw_w, const void* dw_b, const void* frame_valid,
                              int B, int T, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || T < 1 || M != B * T || (passes & 16)) return (int)cudaErrorInvalidValue;
  const dw_rows::Args dw{(const bf16*)dw_w, (const bf16*)dw_b, (const int*)frame_valid, T,
                         (T + dw_rows::ROWS - 1) / dw_rows::ROWS};
  int err = 0;
  if (passes & 1) err = rows_pass_any<true>(C, x, ln_w, ln_b, xq, xs, hmax, M, eps, dw, s);
  return later_passes(err, res, w1q, s1, b1, w2q, s2, b2, gamma, out, xq, xs, hmax, hq, M, C, I, g_xq, g_w1, g_hq,
                      g_w2, passes, s);
}
