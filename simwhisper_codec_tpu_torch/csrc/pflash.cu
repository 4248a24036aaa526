// Variable-length attention core on packed (B, T, 3D) QKV, bf16: TMA + wgmma.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/flash_attention.py
// fused_qkv_attention (_pflash_kernel): for each (batch, head), softmax over
// the keys < length of q k^T, times v.  q arrives pre-scaled by hd^-1/2 with
// its bias added; the +1.0 valid-key bias of the reference cancels in the
// softmax, so only the mask matters.  Head h reads columns h*hd (q),
// D + h*hd (k) and 2D + h*hd (v) of the packed tensor and writes columns
// h*hd of the (B, T, D) output: no transposes, no padding copies.
//
// Bound on the H100: 4 B H T^2 hd operations (tens of GFLOP) over 74 MB of
// traffic, so the tensor-core rate (at hd = 64 the exponentials on the
// special-function units take about as long as the products).  The TPU
// kernel kept a head group's whole K and V in VMEM; one head's K + V at
// T = 1536 is 384 KB, beyond shared memory, so keys stream through the ring
// of csrc/attn_sm90.cuh (see there for the block, the loads and the two
// wgmma products):
//   * the tensor map covers the packed tensor as 3-D (3D, T, B); q, k and v
//     of head h are boxes at columns h*hd, D + h*hd and 2D + h*hd.  Rows >= T
//     fall outside batch b's slab and read as zero, never as the next
//     batch's rows;
//   * online softmax: a running max per row, O rescaled when it grows, the
//     weights rounded to bf16 before P V and the row sum taken over the
//     rounded weights, 1/sum applied once at the output (the JAX kernel's
//     numerics);
//   * only tiles below the row's length are visited; keys >= length inside
//     the last tile get -inf (weight exactly 0, as with the finite mask of
//     the JAX kernel against a finite max);
//   * a length-0 row (batch padding) averages the values of all T keys
//     uniformly: finite, never NaN.
#include "attn_sm90.cuh"

namespace {

using namespace attn;

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
    pflash_sm90_kernel(const __grid_constant__ CUtensorMap qkv_map, const int* __restrict__ lengths,
                       bf16* __restrict__ out, int T, int H) {
  using TL = Tile<HD>;
  using SM = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const Ring<STAGES> ring{base + SM::BAR, base + SM::BAR + 8 * STAGES};
  const uint32_t q_bar = base + SM::BAR + 16 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, D = H * HD;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) init_barriers(ring, q_bar);
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * TL::BYTES);
      for (int wg = 0; wg < 2; ++wg)
        load_tile<HD>(&qkv_map, base + SM::Q + wg * TL::BYTES, q_bar, h * HD, q0 + wg * WG_ROWS, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        ring.wait_empty(i);
        mbar_expect_tx(ring.full_bar(i), 2 * TL::BYTES);
        load_tile<HD>(&qkv_map, base + SM::K + s * TL::BYTES, ring.full_bar(i), D + h * HD, i * BK, b);
        load_tile<HD>(&qkv_map, base + SM::V + s * TL::BYTES, ring.full_bar(i), 2 * D + h * HD, i * BK, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = warp >> 2;
  const uint32_t q_addr = base + SM::Q + wg * TL::BYTES;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = i * BK;
    ring.wait_full(i);
    float sc[32];
    qk_tile<HD>(sc, q_addr, base + SM::K + s * TL::BYTES);
    if (all_masked || k0 + BK > kv_end) mask_tile(sc, k0, kv_end, all_masked);
    float mx0, mx1;
    row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key k0 < kv_end is in this tile
    const float alpha0 = ex2((m0 - mn0) * LOG2E), alpha1 = ex2((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = ex2(fmaf(sc[j], LOG2E, (j & 2) ? -ms1 : -ms0));
    uint32_t pa[4][4];
    pack_weights(sc, pa);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sum0 += pair_sum(pa[kk][0]) + pair_sum(pa[kk][2]);
      sum1 += pair_sum(pa[kk][1]) + pair_sum(pa[kk][3]);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {  // a row's max grew
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
    }
    pv_tile<HD>(o, pa, base + SM::V + s * TL::BYTES);
    ring.release(i);
  }

  const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= T) continue;
    const float inv = r ? inv1 : inv0;
    bf16* dst = out + ((size_t)b * T + q) * D + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const void* qkv, const void* lengths, void* out, int B, int T, int H, const long long* geom,
           cudaStream_t stream) {
  CUtensorMap map;
  const int err = encode_tile_map<HD>(&map, qkv, geom);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(pflash_sm90_kernel<HD>, Smem<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  pflash_sm90_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(map, (const int*)lengths, (bf16*)out, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, T, 3 H HD) and out (B, T, H HD) contiguous bf16, lengths (B,) int32,
// HD in {16, 32, 64, 128}; geom the tensor-map geometry of qkv
// (ops/flash_attention.py::tile_map).  Returns 0 on success, else the CUDA
// error of the launch or sm90::TENSOR_MAP_ERROR + the driver's CUresult.
extern "C" int pflash_bf16(const void* qkv, const void* lengths, void* out, int B, int T, int H, int HD,
                           const long long* geom, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 16: return launch<16>(qkv, lengths, out, B, T, H, geom, s);
    case 32: return launch<32>(qkv, lengths, out, B, T, H, geom, s);
    case 64: return launch<64>(qkv, lengths, out, B, T, H, geom, s);
    case 128: return launch<128>(qkv, lengths, out, B, T, H, geom, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
