// Whole Vocos ConvNeXt block, bf16: masked depthwise k7 conv + bias,
// LayerNorm, W1 -> tanh-GELU -> W2, layer scale, residual, in three passes:
// a row kernel of its own, then B2's up and down passes (csrc/ffn_bf16.cuh
// on the GEMM core of csrc/ffn_sm90.cuh).
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/fused_convnext.py
// fused_convnext_block_dw (_kernel_dw):
//   xdw[t] = b_dw + sum_{k=0..6} xm[t + k - 3] * w_dw[k]        (f32, taps in order)
//   out[t] = x[t] + gamma * (GELU(LN(xdw[t]) W1^T + b1) W2^T + b2)
// over x (B, T, C), where xm is x with the rows outside [0, frame_valid)
// zeroed (the virtual right edge of the Vocos convs) and the residual is
// the unmasked x.  xdw enters the LayerNorm in f32, without a bf16
// rounding; each tap is a separate f32 multiply and add (no FMA), as the
// JAX kernel writes them.  frame_valid is an int32 in device memory that the
// row kernel loads, so one captured CUDA graph serves every chunk width
// (the JAX package traces the width as a scalar for the same reason).
//
// Bound on the H100: the two products, 4 B T C I operations against the
// bf16 tensor-core rate (the depthwise sum adds 14 B T C).  The TPU kernel
// DMA'd a halo window of block_t + 6 rows into VMEM, kept the (block_t, I)
// intermediate there and needed block_t to divide T.  On Hopper the chain
// runs as B2 runs it (see csrc/ln_ffn.cu for why no fused chain fits):
//   1. convnext_dw_rows_kernel: a block owns ROWS time rows of one batch
//      item and copies the masked window of rows t0 - 3 .. t0 + ROWS + 2
//      (zeros outside [0, min(frame_valid, T))) into shared memory, indexed
//      by (b, t), so a halo never reads a neighbouring item's rows and any
//      T works (the last tile may be ragged; rows past T are not stored).
//      The 7 x C taps and the bias sit in shared memory as f32: kept in
//      registers they took 207 of them at C = 512.  A warp forms two
//      neighbouring rows' xdw at once (8 window rows feed both, each tap
//      is read once for both), normalises each with warp_layer_norm_regs
//      and stores xn = bf16(LN(xdw)) -> workspace (B T, C).  Memory-bound:
//      x read once (halos from L2), xn written once.
//   2. convnext_dw_up_kernel: h = bf16(GELU(xn W1^T + b1)) -> workspace (B T, I);
//   3. convnext_dw_down_kernel: out = bf16(x + gamma (h W2^T + b2)), or
//      under tensor parallelism convnext_dw_down_partial_kernel: the f32
//      partial gamma (h W2^T + b2) of one rank's slice of I, the residual
//      added by the wrapper after the ranks' sum (the rows pass runs whole
//      on every rank: C is not sharded).
// The pass kernels are B2's, instantiated here under B4's names.
#include "ffn_bf16.cuh"

namespace {

using ffn_bf16::Bf16;
using ffn_bf16::DownEpilogue;
using ffn_bf16::PartialDownEpilogue;
using ffn_bf16::UpEpilogue;

constexpr int TAPS = 7;
constexpr int HALO = 3;
constexpr int ROWS = 32;  // time rows of a row-kernel block (even: a warp takes two at a time)
constexpr int ROWS_THREADS = 256;
constexpr int WARPS = ROWS_THREADS / 32;
constexpr int WIN = ROWS + 2 * HALO;

// f32 taps (TAPS rows) and bias (one row), then the bf16 window (WIN rows)
constexpr int rows_smem_bytes(int c) { return (TAPS + 1) * c * 4 + WIN * c * 2; }

template <int NT>  // C = 64 * NT
__global__ void __launch_bounds__(ROWS_THREADS, 2) convnext_dw_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dw_w, const bf16* __restrict__ dw_b,
    const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b, bf16* __restrict__ xn, int T, int tiles,
    const int* __restrict__ frame_valid, float eps) {
  constexpr int C = 64 * NT;
  constexpr int VPL = C / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);             // (TAPS + 1) x C: w_dw[0..6], then b_dw
  bf16* win = reinterpret_cast<bf16*>(taps + (TAPS + 1) * C);  // WIN x C: rows t0 - HALO ..

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * ROWS;
  const bf16* xb = x + (size_t)b * T * C;
  const int t_end = min(*frame_valid, T);

  for (int i = tid; i < TAPS * C; i += ROWS_THREADS) taps[i] = bf(dw_w[i]);
  for (int i = tid; i < C; i += ROWS_THREADS) taps[TAPS * C + i] = bf(dw_b[i]);
  for (int i = tid; i < WIN * (C / 8); i += ROWS_THREADS) {
    const int r = i / (C / 8), cv = i % (C / 8), t = t0 - HALO + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_end) v = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + cv * 8);
    *reinterpret_cast<uint4*>(&win[r * C + cv * 8]) = v;
  }
  __syncthreads();

  // warp w: rows 2w and 2w + 1, then 2w + 2 WARPS, ...; output row r reads
  // window rows r .. r + 6, so window row r + k is tap k of row r and tap
  // k - 1 of row r + 1
  const int rows = min(ROWS, T - t0);
#pragma unroll 1
  for (int r = 2 * warp; r < rows; r += 2 * WARPS) {
    float v0[VPL], v1[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      float a0 = taps[TAPS * C + c], a1 = a0, w = 0.f;
#pragma unroll
      for (int k = 0; k <= TAPS; ++k) {
        const float xv = bf(win[(r + k) * C + c]);
        if (k > 0) a1 = __fadd_rn(a1, __fmul_rn(xv, w));  // w = tap k - 1
        if (k < TAPS) {
          w = taps[k * C + c];
          a0 = __fadd_rn(a0, __fmul_rn(xv, w));
        }
      }
      v0[i] = a0;
      v1[i] = a1;
    }
    warp_layer_norm_regs<VPL>(v0, ln_w, ln_b, eps);
    warp_layer_norm_regs<VPL>(v1, ln_w, ln_b, eps);
    bf16* o = xn + ((size_t)b * T + t0 + r) * C;
#pragma unroll
    for (int i = 0; i < VPL; ++i) o[lane + 32 * i] = __float2bfloat16(v0[i]);
    if (r + 1 < rows) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) o[C + lane + 32 * i] = __float2bfloat16(v1[i]);
    }
  }
}

FFN_PASS_KERNEL(convnext_dw_up_kernel, Bf16, UpEpilogue)
FFN_PASS_KERNEL(convnext_dw_down_kernel, Bf16, DownEpilogue)
FFN_PASS_KERNEL(convnext_dw_down_partial_kernel, Bf16, PartialDownEpilogue)

template <int NT>
int rows_pass(const void* x, const void* dw_w, const void* dw_b, const void* ln_w, const void* ln_b, void* xn,
              int B, int T, const int* frame_valid, float eps, cudaStream_t s) {
  constexpr int bytes = rows_smem_bytes(64 * NT);
  const cudaError_t e = sm90::allow_smem(convnext_dw_rows_kernel<NT>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (T + ROWS - 1) / ROWS;
  convnext_dw_rows_kernel<NT><<<B * tiles, ROWS_THREADS, bytes, s>>>(
      (const bf16*)x, (const bf16*)dw_w, (const bf16*)dw_b, (const bf16*)ln_w, (const bf16*)ln_b, (bf16*)xn, T,
      tiles, frame_valid, eps);
  return (int)cudaGetLastError();
}

int rows_pass_any(int C, const void* x, const void* dw_w, const void* dw_b, const void* ln_w, const void* ln_b,
                  void* xn, int B, int T, const int* frame_valid, float eps, cudaStream_t s) {
  switch (C / 64) {
#define CASE(NT) \
  case NT:       \
    return rows_pass<NT>(x, dw_w, dw_b, ln_w, ln_b, xn, B, T, frame_valid, eps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Passes, a bit each (1 rows, 2 up, 4 down, 8 partial down: out f32 and b2
// may be null; the wrapper runs rows, up and one of the downs, a timer one
// at a time).  x and out (B, T, C), dw_w (7, C), W1 (I, C), W2
// (C, I) and the bf16 vectors contiguous; C a multiple of 64 up to 768, I a
// multiple of 32, frame_valid a device int32 (rows [0, min(*frame_valid, T))
// are read); xn (B T, C) and h (B T, I) bf16
// workspaces; g_* the tensor-map geometries of xn, W1, h and W2
// (ops/fused_convnext.py::ffn_tile_maps).  Returns 0, or the first error of
// the passes: a CUDA error or sm90::TENSOR_MAP_ERROR + cuTensorMapEncodeTiled's CUresult.
extern "C" int convnext_dw_bf16(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, void* xn, void* h, int B, int T, int C, int I,
                                const void* frame_valid, float eps, const long long* g_xn, const long long* g_w1,
                                const long long* g_h, const long long* g_w2, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (passes & 1) err = rows_pass_any(C, x, dw_w, dw_b, ln_w, ln_b, xn, B, T, (const int*)frame_valid, eps, s);
  if (err == 0)
    err = ffn_bf16::up_down_passes(
        convnext_dw_up_kernel<ffn_sm90::UP_BN>, [](auto bn) { return convnext_dw_down_kernel<decltype(bn)::value>; },
        [](auto bn) { return convnext_dw_down_partial_kernel<decltype(bn)::value>; }, xn, w1, b1, h, w2, b2, gamma, x,
        out, B * T, C, I, g_xn, g_w1, g_h, g_w2, passes, s);
  return err;
}
