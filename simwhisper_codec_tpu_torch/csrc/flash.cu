// Variable-length attention on (B, H, T, hd) q, k, v, bf16, with the weights
// normalised before the value product: TMA + wgmma.
//
// Replaces the TPU kernel simwhisper_codec_tpu/ops/flash_attention.py
// flash_attention (_attn_kernel): for each (batch, head) and query row,
//   s = q k^T + bias,  bias = +1.0 for keys < length, f32 min otherwise
//   p = bf16(exp(s - max s) / sum exp(s - max s))     (sum over unrounded f32 terms)
//   o = p v                                           (f32 accumulation)
// q arrives pre-scaled by hd^-1/2.  The +1.0 is added in f32, as the JAX
// kernel adds it.  Unlike B1 (csrc/pflash.cu), the weights are rounded to
// bf16 after the normalisation, so the output needs no rescale at the end.
//
// It is B1's design (csrc/attn_sm90.cuh: the ring, the TMA loads, both wgmma
// products) with two passes over K.  A one-pass online softmax cannot round
// exp(s - m) / l before it knows the row's final m and l, and S for 64 rows
// x 1500 keys in f32 (384 KB) does not fit in shared memory:
//   * pass 1 streams K tiles alone, runs S = Q K^T and keeps each row's
//     running max m and running sum l of exp(s - m) (only l is rescaled);
//   * pass 2 streams K and V, recomputes S (bit for bit as in pass 1), forms
//     p = bf16(exp(s - m) r) with r = 1/l computed once per row, and
//     accumulates P V in f32.  Normalise, then round, as the JAX kernel
//     does; only the division became a product with one reciprocal, which
//     moves a weight's bf16 rounding only where the f32 quotient lies
//     within an ulp of a bf16 tie (the JAX kernel's e / s on the TPU is no
//     IEEE division either);
//   * so this design's floor is 1.5x B1's tensor-core work, and twice its
//     exponentials.
// Bound on the H100: 4 B H T^2 hd operations over ~74 MB, the tensor-core
// rate, as B1.  Only tiles below a row's length are visited (keys >= length
// have weight exactly 0: their f32-min bias sits ~3.4e38 below any valid
// score); a length-0 row is the uniform average of the T real values (the
// JAX kernel averages over its T padded to a multiple of 128, zero rows
// included; finite either way, and dropped downstream).
//
// The tensor maps are 4-D (hd, T, H, B), built from the batch, head and time
// strides of each (B, H, T, hd) view, so (B, T, H, hd) projections viewed as
// (B, H, T, hd) need no transposing copy; the output is written by stride.
#include "attn_sm90.cuh"

namespace {

using namespace attn;

struct Strides {  // in elements: batch, head, time; the head dim is contiguous
  long long b, h, t;
};

// s = q k^T + 1.0 (f32), masked on the last tile
__device__ __forceinline__ void biased(float (&s)[32], int k0, int kv_end, bool all_masked) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] += 1.0f;
  if (all_masked || k0 + BK > kv_end) mask_tile(s, k0, kv_end, all_masked);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
                      bf16* __restrict__ out, int T, Strides os) {
  using TL = Tile<HD>;
  using SM = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const Ring<STAGES> ring{base + SM::BAR, base + SM::BAR + 8 * STAGES};
  const uint32_t q_bar = base + SM::BAR + 16 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) init_barriers(ring, q_bar);
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: K tiles for pass 1, then K and V tiles
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * TL::BYTES);
      for (int wg = 0; wg < 2; ++wg)
        load_tile<HD>(&q_map, base + SM::Q + wg * TL::BYTES, q_bar, 0, q0 + wg * WG_ROWS, h, b);
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % STAGES;
        const bool with_v = i >= n_tiles;
        const int k0 = (with_v ? i - n_tiles : i) * BK;
        ring.wait_empty(i);
        mbar_expect_tx(ring.full_bar(i), (with_v ? 2 : 1) * TL::BYTES);
        load_tile<HD>(&k_map, base + SM::K + s * TL::BYTES, ring.full_bar(i), 0, k0, h, b);
        if (with_v) load_tile<HD>(&v_map, base + SM::V + s * TL::BYTES, ring.full_bar(i), 0, k0, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = warp >> 2;
  const uint32_t q_addr = base + SM::Q + wg * TL::BYTES;
  mbar_wait(q_bar, 0);

  // pass 1: row max m and row sum l of exp(s - m)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    ring.wait_full(i);
    float sc[32];
    qk_tile<HD>(sc, q_addr, base + SM::K + (i % STAGES) * TL::BYTES);
    ring.release(i);
    biased(sc, i * BK, kv_end, all_masked);
    float mx0, mx1;
    row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key i * BK < kv_end is in this tile
    l0 *= ex2((m0 - mn0) * LOG2E);
    l1 *= ex2((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float e = ex2(fmaf(sc[j], LOG2E, (j & 2) ? -ms1 : -ms0));
      if (j & 2) l1 += e;
      else l0 += e;
    }
  }
  const float r0 = 1.0f / quad_sum(l0), r1 = 1.0f / quad_sum(l1);
  const float ms0 = m0 * LOG2E, ms1 = m1 * LOG2E;

  // pass 2 (ring items n_tiles ...): o = sum over keys of bf16(exp(s - m) r) v
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int it = n_tiles + i, s = it % STAGES;
    ring.wait_full(it);
    float sc[32];
    qk_tile<HD>(sc, q_addr, base + SM::K + s * TL::BYTES);
    biased(sc, i * BK, kv_end, all_masked);
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = ex2(fmaf(sc[j], LOG2E, (j & 2) ? -ms1 : -ms0)) * ((j & 2) ? r1 : r0);
    uint32_t pa[4][4];
    pack_weights(sc, pa);
    pv_tile<HD>(o, pa, base + SM::V + s * TL::BYTES);
    ring.release(it);
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    bf16* dst = out + b * os.b + h * os.h + row * os.t + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out, int B, int H, int T,
           const long long* qg, const long long* kg, const long long* vg, Strides os, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = encode_tile_map<HD>(&q_map, q, qg);
  if (err == 0) err = encode_tile_map<HD>(&k_map, k, kg);
  if (err == 0) err = encode_tile_map<HD>(&v_map, v, vg);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(flash_sm90_kernel<HD>, Smem<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_sm90_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(q_map, k_map, v_map, (const int*)lengths,
                                                                   (bf16*)out, T, os);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k and v are (B, H, T, HD) bf16 tensors given by their tensor-map
// geometries (ops/flash_attention.py::tile_map); out is (B, H, T, HD) bf16
// given by its batch, head and time strides (in elements, multiples of 8;
// the head dim contiguous and 16-byte aligned); lengths (B,) int32; HD in
// {16, 32, 64, 128}.  Returns 0 on success, else the CUDA error of the
// launch or sm90::TENSOR_MAP_ERROR + the driver's CUresult.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* lengths, void* out,
                                    int B, int H, int T, int HD, const long long* qg, const long long* kg,
                                    const long long* vg, long long osb, long long osh, long long ost,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides os{osb, osh, ost};
  switch (HD) {
    case 16: return launch<16>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 32: return launch<32>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 64: return launch<64>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 128: return launch<128>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
