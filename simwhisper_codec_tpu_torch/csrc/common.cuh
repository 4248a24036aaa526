// Shared device helpers of the codec's Hopper kernels (sm_90a).
//
// The warp-level tensor-core product mma.sync m16n8k16 bf16 x bf16 -> f32
// serves B4's chain (ln_ffn_chain.cuh); the other kernels run wgmma
// (sm90.cuh).  Fragment layout (groupID g = lane / 4, t = lane % 4):
//   A (16 x K, row-major): reg0 (row g, k 0..), reg1 (row g+8, k 0..),
//                          reg2 (row g, k + K/2), reg3 (row g+8, k + K/2)
//   B (K x 8, column-major, i.e. K contiguous for each output column n = g):
//                          reg0 (k 0..), reg1 (k + K/2)
//   C (16 x 8): c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at (row g+8, same cols)
// where "k 0.." means elements 2t, 2t+1.  Operands
// are read from shared memory rows whose stride is padded by 16 bytes, so the
// 8 groups of a warp fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// the finite float32 minimum the JAX kernels mask with (never -inf there)
#define NEG_BIG (-3.4028234663852886e38f)

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> packed bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

// tanh-approximate GELU, written as the JAX kernels write it
__device__ __forceinline__ float gelu_tanh(float h) {
  float h3 = h * h * h;
  return 0.5f * h * (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h3)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm of one C-wide f32 row held by one warp, f32 statistics as in
// the JAX kernels: mean, then the mean of squared deviations,
// rsqrt(var + eps), then scale and shift.  Lane l holds elements l, l + 32,
// ... in v[], which is normalised in place.
template <int VPL>
__device__ __forceinline__ void warp_layer_norm_regs(float v[VPL], const bf16* ln_w, const bf16* ln_b,
                                                     float eps) {
  constexpr int C = VPL * 32;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s += v[i];
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = (v[i] - mean) * rstd * bf(ln_w[c]) + bf(ln_b[c]);
  }
}

// The same LayerNorm of one C-wide bf16 row (zeros where !valid).
template <int VPL>
__device__ __forceinline__ void warp_layer_norm(const bf16* row, const bf16* ln_w, const bf16* ln_b,
                                                float eps, bool valid, float v[VPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = valid ? bf(row[lane + 32 * i]) : 0.f;
  warp_layer_norm_regs<VPL>(v, ln_w, ln_b, eps);
}
