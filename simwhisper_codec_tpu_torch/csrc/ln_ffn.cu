// LayerNorm -> W1 -> tanh-GELU -> W2 -> layer scale -> residual, bf16, in
// three passes on the Hopper GEMM core of csrc/ffn_sm90.cuh.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/fused_convnext.py
// fused_ln_ffn (_kernel + _ln_ffn_body): out = res + gamma * (GELU(LN(x) W1^T + b1) W2^T + b2)
// over (M, C) rows, with W1 (I, C) and W2 (C, I) in nn.Linear layout.
//
// Bound on the H100: the two products (4 M C I operations) against the
// bf16 tensor-core rate.  The TPU kernel pinned both weights in VMEM and
// kept the (block_m, I) intermediate on chip, so no pass touched HBM.  On
// Hopper a fused chain of wgmma-sized blocks (128 rows) would hold a
// (128, C) f32 accumulator, C / 2 registers a thread (384 at C = 768),
// beyond the 255 cap; so the chain is split into passes, each a GEMM that
// Hopper runs well, and the intermediate makes one round trip through
// device memory (2 M I bf16 bytes: 147 MB, ~0.04 ms at 768 x 3072 and
// M = 12000, small next to the products):
//   1. ln_ffn_bf16_rows_kernel: LN in f32 (warp_layer_norm, one warp a row),
//      xn = bf16(LN(x)) -> workspace (M, C).  Its DW instantiation
//      (ln_ffn_bf16_dw: the Vocos ConvNeXt block, x its (B, T, C) input and
//      residual) first forms each row's masked depthwise k7 conv in
//      registers from a shared-memory window, rounded where the plain chain
//      rounds (csrc/dw_rows.cuh, BF16_CHAIN), so xn equals that of the plain
//      conv followed by the plain row kernel, and xdw never reaches device
//      memory (B4, csrc/convnext_dw.cu, sums the conv in f32 instead);
//   2. ln_ffn_bf16_up_kernel: h = bf16(GELU(xn W1^T + b1)) -> workspace (M, I);
//   3. ln_ffn_bf16_down_kernel: out = bf16(res + gamma (h W2^T + b2)), or
//      under tensor parallelism ln_ffn_bf16_down_partial_kernel: the f32
//      partial gamma (h W2^T + b2) of one rank's slice of I (csrc/ffn_bf16.cuh).
// The rounding points are the plain version's: xn and h to bf16, out once.
#include "dw_rows.cuh"
#include "ffn_bf16.cuh"

namespace {

using ffn_bf16::Bf16;
using ffn_bf16::DownEpilogue;
using ffn_bf16::PartialDownEpilogue;
using ffn_bf16::UpEpilogue;

constexpr int ROWS_THREADS = 256;  // 8 warps, one row each

// C = 64 * NT; DW: x is a Vocos block's (B, T, C) input and each row is its
// depthwise conv (``dw``, a block per ROWS time rows of one item), else x is
// (M, C) rows, one warp a row (``dw`` unread)
template <int NT, bool DW>
__global__ void __launch_bounds__(ROWS_THREADS, DW ? 2 : 1) ln_ffn_bf16_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
    bf16* __restrict__ xn, int M, float eps, dw_rows::Args dw) {
  constexpr int C = 64 * NT;
  const int lane = threadIdx.x & 31;
  if constexpr (DW) {
    dw_rows::rows<NT, dw_rows::Sum::BF16_CHAIN>(x, dw, ln_w, ln_b, eps, [&](size_t row, const float(&v)[C / 32]) {
#pragma unroll
      for (int i = 0; i < C / 32; ++i) xn[row * C + lane + 32 * i] = __float2bfloat16(v[i]);
    });
  } else {
    const int row = blockIdx.x * (ROWS_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= M) return;
    float v[C / 32];
    warp_layer_norm<C / 32>(x + (size_t)row * C, ln_w, ln_b, eps, true, v);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) xn[(size_t)row * C + lane + 32 * i] = __float2bfloat16(v[i]);
  }
}

FFN_PASS_KERNEL(ln_ffn_bf16_up_kernel, Bf16, UpEpilogue)
FFN_PASS_KERNEL(ln_ffn_bf16_down_kernel, Bf16, DownEpilogue)
FFN_PASS_KERNEL(ln_ffn_bf16_down_partial_kernel, Bf16, PartialDownEpilogue)

// the rows pass over M rows; with DW over x (B, T, C), M = B T, its conv's operands in ``dw``
template <int NT, bool DW>
int rows_pass(const void* x, const void* ln_w, const void* ln_b, void* xn, int M, float eps, dw_rows::Args dw,
              cudaStream_t s) {
  const auto kernel = ln_ffn_bf16_rows_kernel<NT, DW>;
  int grid = (M + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32), bytes = 0;
  if constexpr (DW) {
    static_assert(ROWS_THREADS == dw_rows::THREADS, "the DW rows pass runs dw_rows' blocks");
    bytes = dw_rows::smem_bytes(64 * NT);
    const cudaError_t e = sm90::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    grid = M / dw.T * dw.tiles;
  }
  kernel<<<grid, ROWS_THREADS, bytes, s>>>((const bf16*)x, (const bf16*)ln_w, (const bf16*)ln_b, (bf16*)xn, M, eps,
                                          dw);
  return (int)cudaGetLastError();
}

template <bool DW>
int rows_pass_any(int C, const void* x, const void* ln_w, const void* ln_b, void* xn, int M, float eps,
                  dw_rows::Args dw, cudaStream_t s) {
  switch (C / 64) {
#define CASE(NT) \
  case NT:       \
    return rows_pass<NT, DW>(x, ln_w, ln_b, xn, M, eps, dw, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// passes 2-8 of ``passes`` (bit 1, the rows pass, is the caller's), after ``err``
int later_passes(int err, const void* res, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* gamma, void* out, void* xn, void* h, int M, int C, int I, const long long* g_xn,
                 const long long* g_w1, const long long* g_h, const long long* g_w2, int passes, cudaStream_t s) {
  if (err != 0) return err;
  return ffn_bf16::up_down_passes(
      ln_ffn_bf16_up_kernel<ffn_sm90::UP_BN>, [](auto bn) { return ln_ffn_bf16_down_kernel<decltype(bn)::value>; },
      [](auto bn) { return ln_ffn_bf16_down_partial_kernel<decltype(bn)::value>; }, xn, w1, b1, h, w2, b2, gamma, res,
      out, M, C, I, g_xn, g_w1, g_h, g_w2, passes, s);
}

}  // namespace

// Passes, a bit each (1 rows, 2 up, 4 down, 8 partial down; the wrapper
// runs rows, up and one of the downs, a timer one at a time).  In the
// partial mode `out` is (M, C) f32 and b2 may be null, res is not read.
// C a multiple of 64 up to 768, I a multiple of 32;
// x, res, the bf16 vectors and the (I, C) W1 / (C, I) W2 contiguous bf16;
// xn (M, C) and h (M, I) bf16 workspaces; g_* the tensor-map geometries of
// xn, W1, h and W2 (ops/fused_convnext.py::ffn_tile_maps).  Returns 0, or
// the first error of the passes: a CUDA error or sm90::TENSOR_MAP_ERROR +
// the driver's CUresult.
extern "C" int ln_ffn_bf16(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* gamma, void* out, void* xn,
                           void* h, int M, int C, int I, float eps, const long long* g_xn, const long long* g_w1,
                           const long long* g_h, const long long* g_w2, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (passes & 1) err = rows_pass_any<false>(C, x, ln_w, ln_b, xn, M, eps, dw_rows::Args{}, s);
  return later_passes(err, res, w1, b1, w2, b2, gamma, out, xn, h, M, C, I, g_xn, g_w1, g_h, g_w2, passes, s);
}

// The Vocos ConvNeXt block's bf16 chain with its depthwise conv folded into
// the rows pass: ln_ffn_bf16's arguments with x (B, T, C) the block input,
// read by the rows pass as the conv's input and by the down pass as the
// residual (res), M = B T, then the conv's taps dw_w (7, C) and bias dw_b
// (C,) contiguous bf16, the edge frame_valid as a device int32 (rows
// [0, min(*frame_valid, T)) unmasked), B and T.  Pass 8 (partial down) is
// refused: under tensor parallelism the chain runs the plain conv.
extern "C" int ln_ffn_bf16_dw(const void* x, const void* res, const void* ln_w, const void* ln_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, const void* gamma, void* out, void* xn,
                              void* h, int M, int C, int I, float eps, const long long* g_xn, const long long* g_w1,
                              const long long* g_h, const long long* g_w2, const void* dw_w, const void* dw_b,
                              const void* frame_valid, int B, int T, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || T < 1 || M != B * T || (passes & 8)) return (int)cudaErrorInvalidValue;
  const dw_rows::Args dw{(const bf16*)dw_w, (const bf16*)dw_b, (const int*)frame_valid, T,
                         (T + dw_rows::ROWS - 1) / dw_rows::ROWS};
  int err = 0;
  if (passes & 1) err = rows_pass_any<true>(C, x, ln_w, ln_b, xn, M, eps, dw, s);
  return later_passes(err, res, w1, b1, w2, b2, gamma, out, xn, h, M, C, I, g_xn, g_w1, g_h, g_w2, passes, s);
}
