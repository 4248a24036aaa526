// Variable-length attention on (B, H, T, D) q, k, v, bf16, with the weights
// normalised before the value product.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/flash_attention.py
// flash_attention (_attn_kernel): for each (batch, head) and query row,
//   s = q k^T + bias,  bias = +1.0 for keys < length, f32 min otherwise
//   p = bf16(exp(s - max s) / sum exp(s - max s))     (sum over unrounded f32 terms)
//   o = p v                                           (f32 accumulation)
// q arrives pre-scaled by hd^-1/2.  The +1.0 is added in f32, as the JAX
// kernel adds it.  Unlike B1 (csrc/pflash.cu), the weights are rounded to
// bf16 after the division, so the output needs no rescale at the end.
//
// Bound on the H100: 4 B H T^2 hd operations (tens of GFLOP) over ~74 MB,
// so the tensor-core rate.  The TPU kernel held a head's whole K and V in
// VMEM and formed the (block_q, T) scores at once; one head's K + V at
// T = 1536 is 384 KB, beyond shared memory.  A one-pass online softmax
// cannot round normalised weights before it knows a row's final max and
// sum, so this kernel streams the keys twice:
//   * a block of 4 warps owns BQ = 64 query rows of one (batch, head); each
//     warp keeps its 16 rows of q in registers;
//   * pass 1 streams K tiles of 64 keys through shared memory and keeps a
//     running max and a running sum of exp(s - max) per row (only the sum is
//     rescaled when the max grows);
//   * pass 2 streams K and V tiles again (V transposed in shared memory, so
//     both products read K-contiguous B operands), recomputes s, forms
//     p = bf16(exp(s - m) / l) and accumulates p v in f32;
//   * that costs 1.5x the QK^T work of a one-pass kernel;
//   * only tiles below a row's length are visited: keys >= length have
//     weight exactly 0 (their f32-min bias sits ~3.4e38 below any valid
//     score);
//   * a length-0 row (batch padding) gives every key < T the bias f32 min,
//     which absorbs the score, so the row is the uniform average of the T
//     real values (the JAX kernel averages over its T padded to a multiple
//     of 128, zero rows included); finite either way, and dropped
//     downstream;
//   * q, k, v and the output are read and written by stride (the last dim
//     contiguous), so (B, T, H, hd) projections viewed as (B, H, T, hd)
//     need no transposing copy.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

struct Strides {  // in elements: batch, head, time; the head dim is contiguous
  long long b, h, t;
};

// Scores of this warp's 16 query rows against the BK keys in k_s, with the
// key bias applied: -inf past kv_end (weight 0), else s + 1 or s + f32 min.
template <int HD>
__device__ __forceinline__ void tile_scores(float s[BK / 8][4], const uint32_t qa[HD / 16][4],
                                            const bf16* k_s, int k0, int kv_end, bool all_masked) {
  constexpr int S = HD + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const bf16* B = k_s + (n * 8 + g) * S + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma_bf16(s[n], qa[kk], ld32(B + kk * 16), ld32(B + kk * 16 + 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = key >= kv_end ? -INFINITY : s[n][e] + (all_masked ? NEG_BIG : 1.0f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(const bf16* __restrict__ q,
                                                             const bf16* __restrict__ k,
                                                             const bf16* __restrict__ v,
                                                             const int* __restrict__ lengths,
                                                             bf16* __restrict__ out, int T, Strides qs,
                                                             Strides ks, Strides vs, Strides os) {
  constexpr int S = HD + 8;   // row stride (elements) of q_s and k_s
  constexpr int VS = BK + 8;  // row stride of vt_s
  constexpr int VPR = HD / 8; // 16-byte vectors per head row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // BQ x S
  bf16* k_s = q_s + BQ * S;                   // BK x S
  bf16* vt_s = k_s + BK * S;                  // HD x VS  (V transposed: [d][key])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);

  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, cv = i % VPR, row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < T) val = *reinterpret_cast<const uint4*>(qb + row * qs.t + cv * 8);
    *reinterpret_cast<uint4*>(&q_s[r * S + cv * 8]) = val;
  }
  __syncthreads();
  uint32_t qa[HD / 16][4];
  {
    const bf16* A = q_s + (warp * 16) * S + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = ld32(A + g * S + kk * 16);
      qa[kk][1] = ld32(A + (g + 8) * S + kk * 16);
      qa[kk][2] = ld32(A + g * S + kk * 16 + 8);
      qa[kk][3] = ld32(A + (g + 8) * S + kk * 16 + 8);
    }
  }

  // pass 1: row max m and row sum l of exp(s - m)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, cv = i % VPR, key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) kv = *reinterpret_cast<const uint4*>(kb + key * ks.t + cv * 8);
      *reinterpret_cast<uint4*>(&k_s[r * S + cv * 8]) = kv;
    }
    __syncthreads();
    float s[BK / 8][4];
    tile_scores<HD>(s, qa, k_s, k0, kv_end, all_masked);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key k0 < kv_end is in this tile
      l_run[r] *= expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l_run[e >> 1] += expf(s[n][e] - m_run[e >> 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // pass 2: o = sum over keys of bf16(exp(s - m) / l) v
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, cv = i % VPR, key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kb + key * ks.t + cv * 8);
        vv = *reinterpret_cast<const uint4*>(vb + key * vs.t + cv * 8);
      }
      *reinterpret_cast<uint4*>(&k_s[r * S + cv * 8]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(cv * 8 + j) * VS + r] = ve[j];
    }
    __syncthreads();
    float s[BK / 8][4];
    tile_scores<HD>(s, qa, k_s, k0, kv_end, all_masked);
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = expf(s[n][0] - m_run[0]) / l_run[0], p1 = expf(s[n][1] - m_run[0]) / l_run[0];
      const float p2 = expf(s[n][2] - m_run[1]) / l_run[1], p3 = expf(s[n][3] - m_run[1]) / l_run[1];
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const bf16* B = vt_s + (d * 8 + g) * VS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) mma_bf16(o[d], pa[kk], ld32(B + kk * 16), ld32(B + kk * 16 + 8));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    bf16* dst = out + b * os.b + h * os.h + row * os.t + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) = pack_bf16(o[d][2 * r], o[d][2 * r + 1]);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out, int B,
                   int H, int T, Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)(BQ + BK) * (HD + 8) + (size_t)HD * (BK + 8));
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attn_kernel<HD><<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                         (const int*)lengths, (bf16*)out, T, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out are (B, H, T, HD) bf16 tensors given by their batch, head
// and time strides (in elements, multiples of 8; the head dim contiguous and
// 16-byte aligned); lengths (B,) int32; HD in {16, 32, 64, 128}.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* lengths,
                                    void* out, int B, int H, int T, int HD, long long qsb, long long qsh,
                                    long long qst, long long ksb, long long ksh, long long kst,
                                    long long vsb, long long vsh, long long vst, long long osb,
                                    long long osh, long long ost, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst}, os{osb, osh, ost};
  switch (HD) {
    case 16: return (int)launch<16>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, s);
    case 32: return (int)launch<32>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, s);
    case 64: return (int)launch<64>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, s);
    case 128: return (int)launch<128>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
