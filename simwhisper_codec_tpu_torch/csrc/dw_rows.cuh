// The row pass of a Vocos ConvNeXt block with its depthwise k7 conv folded
// in, shared by B4's row kernel (csrc/convnext_dw.cu) and the Vocos
// instantiations of B2's and B3's row kernels (csrc/ln_ffn.cu,
// csrc/ln_ffn_int8.cu):
//   xdw[t] = conv(xm)[t]; v = LN(xdw[t]) in f32 (warp_layer_norm_regs)
// over x (B, T, C), xm = x with the rows at or past min(frame_valid, T)
// masked and the rows outside [0, T) zero, so no halo reads a neighbouring
// item.  A block owns ROWS time rows of one batch item: it copies the
// window of rows t0 - 3 .. t0 + ROWS + 2 into shared memory (x read once,
// halos from L2) beside the 7 x C taps and the bias, 4 bytes each (kept in
// registers they took 207 of them at C = 512).  A warp forms two
// neighbouring rows at once (8 window rows feed both, each tap is read once
// for both), normalises each and hands it to the caller's row function.
//
// Two ways to sum a row (Sum):
//   F32: B4's, the JAX kernel's: from the bias, taps 0..6 in order, each
//        tap a separate f32 multiply and add, no rounding before the LN;
//        masked rows are zeros.
//   BF16_CHAIN: the plain chain's bit for bit (vocos.py's edge-mask
//        multiply, then ops/conv.py::depthwise_conv1d_shifts in bf16): each
//        tap product x w rounded to bf16, the running sum from tap 0, each
//        add rounded to bf16, taps 0..6 in order, the bias added last and
//        rounded; a masked row is x * 0 (zeros with x's signs, for finite
//        x).  PyTorch forms each bf16 product and sum in f32 and rounds that
//        to bf16; here each is one bf16x2 instruction (mul.rn / add.rn,
//        never contracted into an fma), which rounds the exact result once,
//        for the two rows of a warp's pair at a time.  The two agree: the
//        f32 product of two bf16 values is exact, and rounding a sum of two
//        bf16 values to f32 (24 bits) and then to bf16 (8) is the same as
//        rounding it once to bf16, since 24 >= 2 * 8 + 2 (double rounding
//        is innocuous then: Figueroa, "When is double rounding innocuous?",
//        SIGNUM 1995); in the subnormal range every sum and product lies on
//        f32's grid.  The taps and the bias sit in shared memory as pairs
//        (w, w).  The rows reach the LN as the bf16 xdw the chain stores.
#pragma once

#include "common.cuh"

namespace dw_rows {

constexpr int TAPS = 7;
constexpr int HALO = 3;
constexpr int ROWS = 32;  // time rows of a block (even: a warp takes two at a time)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIN = ROWS + 2 * HALO;

// taps (TAPS rows) and bias (one row), f32 or bf16 pairs, then the bf16 window (WIN rows)
constexpr int smem_bytes(int c) { return (TAPS + 1) * c * 4 + WIN * c * 2; }

enum class Sum { F32, BF16_CHAIN };

// The conv's operands: taps (7, C) and bias (C,) contiguous bf16, 16-byte aligned, the edge
// as a device int32 (rows [0, min(*frame_valid, T)) are read unmasked), T
// rows an item, ceil(T / ROWS) row tiles an item (the grid is B x tiles).
struct Args {
  const bf16 *w, *b;
  const int* frame_valid;
  int T, tiles;
};

// bf16x2 products and sums, each half rounded once to nearest even
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Rows r and r + 1 of the window's block into v0, v1 (lane l holds channels
// l, l + 32, ...): output row r reads window rows r .. r + 6, so window row
// r + k is tap k of row r and tap k - 1 of row r + 1.
template <int VPL, Sum SUM>
__device__ __forceinline__ void conv_pair(const float* taps, const bf16* win, int r, float (&v0)[VPL],
                                          float (&v1)[VPL]) {
  constexpr int C = VPL * 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if constexpr (SUM == Sum::F32) {
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
    } else {
      const uint16_t* xw = reinterpret_cast<const uint16_t*>(win);
      const uint32_t* w2 = reinterpret_cast<const uint32_t*>(taps);  // (w, w) pairs
      uint32_t xk[TAPS + 1];
#pragma unroll
      for (int k = 0; k <= TAPS; ++k) xk[k] = xw[(r + k) * C + c];
      uint32_t acc = 0u;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {  // (row r, row r + 1) of tap k: window rows r + k, r + k + 1
        const uint32_t p = mul_bf16x2(xk[k] | (xk[k + 1] << 16), w2[k * C + c]);
        acc = k == 0 ? p : add_bf16x2(acc, p);
      }
      acc = add_bf16x2(acc, w2[TAPS * C + c]);
      v0[i] = __uint_as_float(acc << 16);
      v1[i] = __uint_as_float(acc & 0xffff0000u);
    }
  }
}

// The block's tile (blockIdx.x = b * tiles + tile, THREADS threads, dynamic
// shared memory of smem_bytes(C)): each of its rows, LayerNormed, goes to
// out(row, v), row the index into the (B T, C) rows.
template <int NT, Sum SUM, class Out>
__device__ __forceinline__ void rows(const bf16* __restrict__ x, const Args& a, const bf16* __restrict__ ln_w,
                                     const bf16* __restrict__ ln_b, float eps, Out out) {
  constexpr int C = 64 * NT;
  constexpr int VPL = C / 32;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* taps = reinterpret_cast<float*>(dw_smem);             // (TAPS + 1) x C: w[0..6], then b, or (w, w) pairs
  bf16* win = reinterpret_cast<bf16*>(taps + (TAPS + 1) * C);  // WIN x C: rows t0 - HALO ..

  const int tid = threadIdx.x, warp = tid >> 5;
  const int T = a.T, b = blockIdx.x / a.tiles, t0 = (blockIdx.x % a.tiles) * ROWS;
  const bf16* xb = x + (size_t)b * T * C;
  const int t_end = min(*a.frame_valid, T);

  // every load of the prologue is issued before the first store, so that a
  // block waits for memory once: taps and bias (8 at a time), the window
  // (rows in [0, T), masked once the edge has arrived)
  constexpr int TAP_VECS = (TAPS + 1) * C / 8, WIN_VECS = WIN * (C / 8);
  constexpr int TAP_ITERS = (TAP_VECS + THREADS - 1) / THREADS, WIN_ITERS = (WIN_VECS + THREADS - 1) / THREADS;
  uint4 tv[TAP_ITERS], wv[WIN_ITERS];
#pragma unroll
  for (int j = 0; j < TAP_ITERS; ++j) {
    const int i = tid + j * THREADS;
    if (i < TAP_VECS)
      tv[j] = i < TAPS * C / 8 ? reinterpret_cast<const uint4*>(a.w)[i]
                               : reinterpret_cast<const uint4*>(a.b)[i - TAPS * C / 8];
  }
#pragma unroll
  for (int j = 0; j < WIN_ITERS; ++j) {
    const int i = tid + j * THREADS, r = i / (C / 8), cv = i % (C / 8), t = t0 - HALO + r;
    wv[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < WIN_VECS && t >= 0 && t < T) wv[j] = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + cv * 8);
  }
#pragma unroll
  for (int j = 0; j < WIN_ITERS; ++j) {
    const int t = t0 - HALO + (tid + j * THREADS) / (C / 8);
    if (t >= t_end) {  // F32: zero; BF16_CHAIN: x * 0, each bf16's sign bit alone
      const uint32_t keep = SUM == Sum::F32 ? 0u : 0x80008000u;
      wv[j].x &= keep;
      wv[j].y &= keep;
      wv[j].z &= keep;
      wv[j].w &= keep;
    }
  }
#pragma unroll
  for (int j = 0; j < TAP_ITERS; ++j) {
    const int i = tid + j * THREADS;
    if (i >= TAP_VECS) continue;
    const uint32_t h[4] = {tv[j].x, tv[j].y, tv[j].z, tv[j].w};
    uint32_t o[8];  // 8 taps as f32 bits, or as (w, w) pairs
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w16 = (h[e / 2] >> (16 * (e % 2))) & 0xffffu;
      o[e] = SUM == Sum::F32 ? w16 << 16 : w16 * 0x10001u;
    }
    uint4* dst = reinterpret_cast<uint4*>(taps) + 2 * i;
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
#pragma unroll
  for (int j = 0; j < WIN_ITERS; ++j) {
    const int i = tid + j * THREADS;
    if (i < WIN_VECS) reinterpret_cast<uint4*>(win)[i] = wv[j];
  }
  __syncthreads();

  const int n = min(ROWS, T - t0);
#pragma unroll 1
  for (int r = 2 * warp; r < n; r += 2 * WARPS) {
    float v0[VPL], v1[VPL];
    conv_pair<VPL, SUM>(taps, win, r, v0, v1);
    warp_layer_norm_regs<VPL>(v0, ln_w, ln_b, eps);
    warp_layer_norm_regs<VPL>(v1, ln_w, ln_b, eps);
    const size_t row = (size_t)b * T + t0 + r;
    out(row, v0);
    if (r + 1 < n) out(row + 1, v1);
  }
}

}  // namespace dw_rows
