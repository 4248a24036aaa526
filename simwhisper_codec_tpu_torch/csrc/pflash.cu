// Variable-length attention core on packed (B, T, 3D) QKV, bf16.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/flash_attention.py
// fused_qkv_attention (_pflash_kernel): for each (batch, head), softmax over
// the keys < length of q k^T, times v.  q arrives pre-scaled by hd^-1/2 with
// its bias added; the +1.0 valid-key bias of the reference cancels in the
// softmax, so only the mask matters.  Head h reads columns h*hd (q),
// D + h*hd (k) and 2D + h*hd (v) of the packed tensor by stride and writes
// columns h*hd of the (B, T, D) output: no transposes, no padding copies.
//
// Bound on the H100: 4 B H T^2 hd operations (tens of GFLOP) over 74 MB of
// traffic, so the tensor-core rate.  The TPU kernel kept one head group's
// whole K and V resident in VMEM; one head's K + V at T = 1536 is 384 KB,
// beyond shared memory, so this kernel streams keys instead:
//   * a block of 4 warps owns BQ = 64 query rows of one (batch, head);
//     each warp keeps its 16 rows of q in registers;
//   * K and V tiles of 64 keys are copied to shared memory (V transposed,
//     so both products read K-contiguous B operands); the online softmax
//     keeps a running max and sum per row and rescales the f32 output;
//   * only the tiles below the row's length are visited; masked keys inside
//     the last tile get -inf (their weight is exactly 0, as with the finite
//     mask of the JAX kernel against a finite max);
//   * a length-0 row (batch padding) gives every key < T the finite f32
//     minimum, i.e. the uniform average of its values: finite, never NaN;
//   * the weights are rounded to bf16 before the second product and the row
//     sum is taken over those rounded weights; the 1/sum normalisation is
//     applied once to the output, as in the JAX kernel.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

template <int HD>
__global__ void __launch_bounds__(THREADS) pflash_kernel(const bf16* __restrict__ qkv,
                                                         const int* __restrict__ lengths,
                                                         bf16* __restrict__ out, int T, int H) {
  constexpr int S = HD + 8;   // row stride (elements) of q_s and k_s
  constexpr int VS = BK + 8;  // row stride of vt_s
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // BQ x S
  bf16* k_s = q_s + BQ * S;                   // BK x S
  bf16* vt_s = k_s + BK * S;                  // HD x VS  (V transposed: [d][key])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);

  constexpr int VPR = HD / 8;  // 16-byte vectors per head row
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, cv = i % VPR, q = q0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < T) v = *reinterpret_cast<const uint4*>(base + q * row_stride + h * HD + cv * 8);
    *reinterpret_cast<uint4*>(&q_s[r * S + cv * 8]) = v;
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

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, cv = i % VPR, key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        const bf16* src = base + key * row_stride + h * HD + cv * 8;
        kv = *reinterpret_cast<const uint4*>(src + D);
        vv = *reinterpret_cast<const uint4*>(src + 2 * D);
      }
      *reinterpret_cast<uint4*>(&k_s[r * S + cv * 8]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(cv * 8 + j) * VS + r] = ve[j];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* B = k_s + (n * 8 + g) * S + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma_bf16(s[n], qa[kk], ld32(B + kk * 16), ld32(B + kk * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        float v = s[n][e];
        if (key >= kv_end) v = -INFINITY;
        else if (all_masked) v = NEG_BIG;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key k0 < kv_end is in this tile
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = expf(s[n][0] - m_run[0]), p1 = expf(s[n][1] - m_run[0]);
      const float p2 = expf(s[n][2] - m_run[1]), p3 = expf(s[n][3] - m_run[1]);
      const uint32_t top = pack_bf16(p0, p1), bot = pack_bf16(p2, p3);
      const __nv_bfloat162 tb = *reinterpret_cast<const __nv_bfloat162*>(&top);
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&bot);
      l_run[0] += __low2float(tb) + __high2float(tb);
      l_run[1] += __low2float(bb) + __high2float(bb);
      pa[n >> 1][(n & 1) * 2 + 0] = top;
      pa[n >> 1][(n & 1) * 2 + 1] = bot;
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const bf16* B = vt_s + (d * 8 + g) * VS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) mma_bf16(o[d], pa[kk], ld32(B + kk * 16), ld32(B + kk * 16 + 8));
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + warp * 16 + g + 8 * r;
    if (q >= T) continue;
    bf16* dst = out + ((size_t)b * T + q) * D + h * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) = pack_bf16(o[d][2 * r] * inv[r], o[d][2 * r + 1] * inv[r]);
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const void* lengths, void* out, int B, int T, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)(BQ + BK) * (HD + 8) + (size_t)HD * (BK + 8));
  cudaError_t err = cudaFuncSetAttribute(pflash_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  pflash_kernel<HD><<<grid, THREADS, smem, stream>>>((const bf16*)qkv, (const int*)lengths,
                                                     (bf16*)out, T, H);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, T, 3 H HD) and out (B, T, H HD) contiguous bf16, lengths (B,) int32,
// HD in {16, 32, 64, 128}.  Returns the CUDA error of the launch (0 on success).
extern "C" int pflash_bf16(const void* qkv, const void* lengths, void* out, int B, int T, int H,
                           int HD, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 16: return (int)launch<16>(qkv, lengths, out, B, T, H, s);
    case 32: return (int)launch<32>(qkv, lengths, out, B, T, H, s);
    case 64: return (int)launch<64>(qkv, lengths, out, B, T, H, s);
    case 128: return (int)launch<128>(qkv, lengths, out, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
