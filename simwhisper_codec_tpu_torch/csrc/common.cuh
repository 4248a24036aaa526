// Shared device helpers of the codec's Hopper kernels (sm_90a): bf16
// conversions, the tanh-GELU, warp reductions and the warp LayerNorm.  The
// tensor-core products are wgmma, in sm90.cuh and its users.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// the finite float32 minimum the JAX kernels mask with (never -inf there)
#define NEG_BIG (-3.4028234663852886e38f)

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
