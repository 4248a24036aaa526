// Variable-length attention on float32 activations: the f32 instantiations of
// B1 (pflash_f32, packed (B, T, 3D) QKV, normalisation deferred to the
// output) and B5 (flash_attention_f32, (B, H, T, hd) views, weights
// normalised before the value product), as parity mode runs them with
// attn_impl "pflash" or "flash".
//
// Replaces the TPU kernels simwhisper_codec_tpu/ops/flash_attention.py
// fused_qkv_attention (_pflash_kernel) and flash_attention (_attn_kernel) on
// f32 inputs, where the JAX kernels compute in f32 throughout:
//   B1: s = q k^T, keys >= length masked; e = exp(s - max s);
//       o = (sum e v) * (1 / sum e)
//   B5: s = q k^T + 1.0 on keys < length (f32 minimum elsewhere);
//       p = e / sum e, e = exp(s - max s);  o = sum p v
// q arrives pre-scaled by hd^-1/2.  A length-0 row averages all T values
// uniformly; keys at or beyond the length have weight exactly 0.
//
// Bound on the H100: 4 B H T^2 hd operations (55 GFLOP at 8 x 12 x 1500^2 x
// 64) over ~150 MB.  The tensor cores' TF32 has a 10-bit mantissa, one
// product misses the reference's 1e-5, and f32-accurate work takes three
// TF32 products (a 3 x TF32 split), so the bound is 3 x flops at the TF32
// peak.  This kernel is the simple one: SIMT f32 FMAs (67 TFLOP/s peak),
// exact expf and division, each score a dot product summed in the order of
// the head dim.  What it does about the bound:
//   * a block owns 64 query rows of one (batch, head): 256 consumer threads
//     in a 16 x 16 grid, each with 4 query rows x 4 keys of the 64 x 64 score
//     tile (rows 4 ty + i, keys tx + 16 j) and 4 rows x hd / 16 columns of
//     the output;
//   * one producer warp (lane 0) keeps TMA tile loads in flight: 64 keys x
//     hd of K and V into a 2-stage mbarrier ring (csrc/sm90.cuh); Q once.  A
//     row of a box is at most 128 bytes (32 floats; hd = 64 takes two
//     boxes, hd = 128 four), swizzled 128 B (64 B at hd = 16), so the
//     float4 reads of 16 keys at one head-dim offset fall on distinct banks;
//   * Q K^T reads a float4 of q and of k per 16 multiply-adds; the weights
//     go through shared memory (a 64 x 68 key-major tile) to P V, which
//     reads a float4 of weights and hd / 16 values per key;
//   * B1 is one pass with the online softmax (O and the row sum rescaled
//     when a row's max grows); B5 is two passes over K: the row max and sum
//     first, then p = e / sum (a division, as the JAX kernel divides) and
//     P V, so its floor is 1.5 x B1's work;
//   * only tiles below a row's length are visited.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;             // query rows of a block
constexpr int BK = 64;             // keys of a tile (= rows of every TMA box)
constexpr int CONSUMER_WARPS = 8;  // 256 threads: a 16 x 16 grid
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;
constexpr int STAGES = 2;
constexpr int P_STRIDE = BQ + 4;  // floats per key row of the weight tile (rows 16-byte aligned, 4 banks apart)
constexpr int CONSUMER_BAR = 1;   // named barrier of the consumer threads

// One 64-row x HD f32 tile in shared memory, as the TMA writes it.
template <int HD>
struct Tile {
  static constexpr int BOX_COLS = HD > 32 ? 32 : HD;  // columns of one TMA box
  static constexpr int COL_BOXES = HD / BOX_COLS;
  static constexpr int ROW_BYTES = BOX_COLS * 4;      // = the swizzle span
  static constexpr int BOX_BYTES = BK * ROW_BYTES;
  static constexpr int BYTES = BOX_BYTES * COL_BOXES;
  static constexpr int MASK = ROW_BYTES / 16 - 1;     // the swizzle XORs the 16-byte chunk with (offset >> 7) & MASK
  static constexpr int COLS = HD / 16;                // output columns of a thread
};

// Byte offsets in the block's shared memory, from a 1024-aligned base.
template <int HD>
struct Smem {
  static constexpr int Q = 0;
  static constexpr int K = Q + Tile<HD>::BYTES;
  static constexpr int V = K + STAGES * Tile<HD>::BYTES;
  static constexpr int P = V + STAGES * Tile<HD>::BYTES;
  static constexpr int BAR = P + BK * P_STRIDE * 4;  // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;
};

struct Strides {  // of the output, in elements: batch, head, time; the head dim is contiguous
  long long b, h, t;
};

// Row `row` of a tile, swizzled: the byte offset of column c (< BOX_COLS) of
// the row's first box is row_offset ^ (4 c); box x is x * BOX_BYTES further.
template <int HD>
__device__ __forceinline__ int row_offset(int row) {
  using TL = Tile<HD>;
  const int off = row * TL::ROW_BYTES;
  return off | (((off >> 7) & TL::MASK) << 4);
}

// One 64-row x HD tile: COL_BOXES boxes.  The packed B1 map is 3-D (3D, T, B)
// and the tile's columns start at `col`; B5's maps are 4-D (hd, T, H, B).
template <int HD, bool FLASH>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar, int col, int row,
                                          int h, int b) {
  using TL = Tile<HD>;
#pragma unroll
  for (int x = 0; x < TL::COL_BOXES; ++x) {
    if (FLASH) tma_load(dst + x * TL::BOX_BYTES, map, bar, x * TL::BOX_COLS, row, h, b);
    else tma_load(dst + x * TL::BOX_BYTES, map, bar, col + x * TL::BOX_COLS, row, b);
  }
}

// s[i][j] = q(row 4 ty + i) . k(key tx + 16 j), summed along the head dim
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[4][4], const unsigned char* q, const unsigned char* k,
                                        const int (&qrow)[4], const int (&krow)[4]) {
  using TL = Tile<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const int box = c / TL::BOX_COLS * TL::BOX_BYTES, cb = c % TL::BOX_COLS * 4;
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(q + box + (qrow[i] ^ cb));
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(k + box + (krow[j] ^ cb));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }
}

// B5 adds +1.0 to every score (f32, as the JAX kernel does); keys >= kv_end
// then get -inf (weight 0), and a length-0 row (all_masked) scores every key
// < T the same 0: the uniform weights of the f32-minimum fill.
template <bool FLASH>
__device__ __forceinline__ void bias_and_mask(float (&s)[4][4], int k0, int kv_end, bool all_masked) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (FLASH) s[i][j] += 1.0f;
      if (all_masked || k0 + BK > kv_end) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = key >= kv_end ? -INFINITY : (all_masked ? 0.f : s[i][j]);
      }
    }
}

// over the 16 threads (tx) that share a row: the lanes of one half warp
__device__ __forceinline__ float row_reduce_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_reduce_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The running row max m over one more tile; returns the rescale of the
// state kept so far, exp(m_old - m_new) (0 before the first tile).
__device__ __forceinline__ void update_max(const float (&s)[4][4], float (&m)[4], float (&alpha)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    mx = fmaxf(m[i], row_reduce_max(mx));  // finite: the tile holds a key < kv_end
    alpha[i] = expf(m[i] - mx);
    m[i] = mx;
  }
}

// The weights (S's registers) -> the key-major shared tile, then O += P V.
// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns col(u) = 4 tx + 64 u
// (hd >= 64), 2 tx (hd = 32) or tx (hd = 16).
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[4][Tile<HD>::COLS], const float (&p)[4][4], float* ptile,
                                        const unsigned char* v, int tx, int ty) {
  using TL = Tile<HD>;
  named_barrier(CONSUMER_BAR, CONSUMERS);  // the previous tile's P V has read the weight tile
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(ptile + (tx + 16 * j) * P_STRIDE + 4 * ty) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
  named_barrier(CONSUMER_BAR, CONSUMERS);
  constexpr int C = TL::COLS;
  constexpr int VEC = C >= 4 ? 4 : C;  // floats of one value read
  int vbox[C / VEC], vcb[C / VEC];
#pragma unroll
  for (int u = 0; u < C / VEC; ++u) {
    const int col = C >= 4 ? 4 * tx + 64 * u : C * tx;
    vbox[u] = col / TL::BOX_COLS * TL::BOX_BYTES;
    vcb[u] = col % TL::BOX_COLS * 4;
  }
#pragma unroll 16
  for (int key = 0; key < BK; ++key) {
    const float4 w = *reinterpret_cast<const float4*>(ptile + key * P_STRIDE + 4 * ty);
    const float wr[4] = {w.x, w.y, w.z, w.w};
    const int rx = row_offset<HD>(key);
#pragma unroll
    for (int u = 0; u < C / VEC; ++u) {
      const unsigned char* src = v + vbox[u] + (rx ^ vcb[u]);
      float val[VEC];
      if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        val[0] = t.x, val[1] = t.y, val[2] = t.z, val[3] = t.w;
      } else if constexpr (VEC == 2) {
        const float2 t = *reinterpret_cast<const float2*>(src);
        val[0] = t.x, val[1] = t.y;
      } else {
        val[0] = *reinterpret_cast<const float*>(src);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[i][u * VEC + e] = fmaf(wr[i], val[e], o[i][u * VEC + e]);
    }
  }
}

template <int HD, bool FLASH>
__device__ __forceinline__ void attention_f32(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                              const CUtensorMap* v_map, const int* __restrict__ lengths,
                                              float* __restrict__ out, int T, int H, Strides os) {
  using TL = Tile<HD>;
  using SM = Smem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = smem_base(smem_raw);
  unsigned char* sm = smem_raw + (base - raw);
  const Ring<STAGES> ring{base + SM::BAR, base + SM::BAR + 8 * STAGES};
  const uint32_t q_bar = base + SM::BAR + 16 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    ring.init(CONSUMER_WARPS);
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: Q; then K and V tiles (B5: K tiles for pass 1 first)
    if (lane == 0) {
      const int D = H * HD;
      mbar_expect_tx(q_bar, TL::BYTES);
      load_tile<HD, FLASH>(q_map, base + SM::Q, q_bar, h * HD, q0, h, b);
      const int n_items = FLASH ? 2 * n_tiles : n_tiles;
      for (int i = 0; i < n_items; ++i) {
        const int s = i % STAGES;
        const bool with_v = !FLASH || i >= n_tiles;
        const int k0 = (i >= n_tiles ? i - n_tiles : i) * BK;
        ring.wait_empty(i);
        mbar_expect_tx(ring.full_bar(i), (with_v ? 2 : 1) * TL::BYTES);
        load_tile<HD, FLASH>(k_map, base + SM::K + s * TL::BYTES, ring.full_bar(i), D + h * HD, k0, h, b);
        if (with_v)
          load_tile<HD, FLASH>(v_map, base + SM::V + s * TL::BYTES, ring.full_bar(i), 2 * D + h * HD, k0, h, b);
      }
    }
    return;
  }

  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  int qrow[4], krow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qrow[i] = row_offset<HD>(4 * ty + i);
    krow[i] = row_offset<HD>(tx + 16 * i);
  }
  const unsigned char* q_tile = sm + SM::Q;
  float* ptile = reinterpret_cast<float*>(sm + SM::P);
  float o[4][TL::COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TL::COLS; ++c) o[i][c] = 0.f;
  float m[4], l[4], alpha[4];  // l: this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  mbar_wait(q_bar, 0);

  float s[4][4];
  if (!FLASH) {  // B1: one pass, online softmax, 1/sum at the output
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      ring.wait_full(i);
      qk_tile<HD>(s, q_tile, sm + SM::K + st * TL::BYTES, qrow, krow);
      bias_and_mask<false>(s, i * BK, kv_end, all_masked);
      update_max(s, m, alpha);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = expf(s[r][j] - m[r]);
          sum += s[r][j];
        }
        l[r] = l[r] * alpha[r] + sum;
#pragma unroll
        for (int c = 0; c < TL::COLS; ++c) o[r][c] *= alpha[r];
      }
      pv_tile<HD>(o, s, ptile, sm + SM::V + st * TL::BYTES, tx, ty);
      ring.release(i);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = 1.0f / row_reduce_sum(l[r]);
#pragma unroll
      for (int c = 0; c < TL::COLS; ++c) o[r][c] *= inv;
    }
  } else {  // B5 pass 1: the row max m and the row sum l of exp(s - m)
    for (int i = 0; i < n_tiles; ++i) {
      ring.wait_full(i);
      qk_tile<HD>(s, q_tile, sm + SM::K + (i % STAGES) * TL::BYTES, qrow, krow);
      ring.release(i);
      bias_and_mask<true>(s, i * BK, kv_end, all_masked);
      update_max(s, m, alpha);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[r][j] - m[r]);
        l[r] = l[r] * alpha[r] + sum;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) l[r] = row_reduce_sum(l[r]);
    // pass 2 (ring items n_tiles ...): o = sum over keys of (exp(s - m) / l) v
    for (int i = 0; i < n_tiles; ++i) {
      const int it = n_tiles + i, st = it % STAGES;
      ring.wait_full(it);
      qk_tile<HD>(s, q_tile, sm + SM::K + st * TL::BYTES, qrow, krow);
      bias_and_mask<true>(s, i * BK, kv_end, all_masked);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = __fdiv_rn(expf(s[r][j] - m[r]), l[r]);
      pv_tile<HD>(o, s, ptile, sm + SM::V + st * TL::BYTES, tx, ty);
      ring.release(it);
    }
  }

  constexpr int C = TL::COLS;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= T) continue;
    float* dst = out + b * os.b + h * os.h + row * os.t;
    if constexpr (C >= 4) {
#pragma unroll
      for (int u = 0; u < C / 4; ++u)
        *reinterpret_cast<float4*>(dst + 4 * tx + 64 * u) =
            make_float4(o[r][4 * u], o[r][4 * u + 1], o[r][4 * u + 2], o[r][4 * u + 3]);
    } else if constexpr (C == 2) {
      *reinterpret_cast<float2*>(dst + 2 * tx) = make_float2(o[r][0], o[r][1]);
    } else {
      dst[tx] = o[r][0];
    }
  }
}

// Registers are capped for two blocks an SM at hd <= 32 and one above: at
// hd = 64 one block (168 registers, no spills) ran 8 % faster on the H100
// than two (96 registers, ~300 B of spills).
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 32 ? 2 : 1)
    pflash_f32_kernel(const __grid_constant__ CUtensorMap qkv_map, const int* __restrict__ lengths,
                      float* __restrict__ out, int T, int H) {
  const Strides os{(long long)T * H * HD, HD, (long long)H * HD};
  attention_f32<HD, false>(&qkv_map, &qkv_map, &qkv_map, lengths, out, T, H, os);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 32 ? 2 : 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
                     float* __restrict__ out, int T, Strides os) {
  attention_f32<HD, true>(&q_map, &k_map, &v_map, lengths, out, T, 0, os);
}

// Encode the map of one f32 operand at `base` from the geometry `g` of
// ops/flash_attention.py::tile_map; the box must be the kernel's tile box.
template <int HD>
int encode_tile_map(CUtensorMap* map, const void* base, const long long* g) {
  using TL = Tile<HD>;
  if (g[0] < 3) return (int)cudaErrorInvalidValue;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, g, TL::BOX_COLS, BK, TL::ROW_BYTES);
}

template <int HD>
int launch_pflash(const void* qkv, const void* lengths, void* out, int B, int T, int H, const long long* geom,
                  cudaStream_t stream) {
  CUtensorMap map;
  const int err = encode_tile_map<HD>(&map, qkv, geom);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(pflash_f32_kernel<HD>, Smem<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  pflash_f32_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(map, (const int*)lengths, (float*)out, T, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, const void* lengths, void* out, int B, int H, int T,
                 const long long* qg, const long long* kg, const long long* vg, Strides os, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = encode_tile_map<HD>(&q_map, q, qg);
  if (err == 0) err = encode_tile_map<HD>(&k_map, k, kg);
  if (err == 0) err = encode_tile_map<HD>(&v_map, v, vg);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(flash_f32_kernel<HD>, Smem<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_f32_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(q_map, k_map, v_map, (const int*)lengths,
                                                                  (float*)out, T, os);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, T, 3 H HD) and out (B, T, H HD) contiguous float32, lengths (B,)
// int32, HD in {16, 32, 64, 128}; geom the tensor-map geometry of qkv
// (ops/flash_attention.py::tile_map).  Returns 0 on success, else the CUDA
// error of the launch or sm90::TENSOR_MAP_ERROR + the driver's CUresult.
extern "C" int pflash_f32(const void* qkv, const void* lengths, void* out, int B, int T, int H, int HD,
                          const long long* geom, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 16: return launch_pflash<16>(qkv, lengths, out, B, T, H, geom, s);
    case 32: return launch_pflash<32>(qkv, lengths, out, B, T, H, geom, s);
    case 64: return launch_pflash<64>(qkv, lengths, out, B, T, H, geom, s);
    case 128: return launch_pflash<128>(qkv, lengths, out, B, T, H, geom, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k and v are (B, H, T, HD) float32 tensors given by their tensor-map
// geometries; out is (B, H, T, HD) float32 given by its batch, head and time
// strides (in elements, multiples of 4; the head dim contiguous and 16-byte
// aligned); lengths (B,) int32; HD in {16, 32, 64, 128}.  Returns as
// pflash_f32.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, const void* lengths, void* out,
                                   int B, int H, int T, int HD, const long long* qg, const long long* kg,
                                   const long long* vg, long long osb, long long osh, long long ost, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides os{osb, osh, ost};
  switch (HD) {
    case 16: return launch_flash<16>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 32: return launch_flash<32>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 64: return launch_flash<64>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    case 128: return launch_flash<128>(q, k, v, lengths, out, B, H, T, qg, kg, vg, os, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
