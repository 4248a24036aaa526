// Hopper (sm_90a) machinery of the two attention kernels, csrc/pflash.cu (B1)
// and csrc/flash.cu (B5).
//
// One design serves both:
//   * a block owns BQ = 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, plus one producer warp (288 threads);
//   * lane 0 of the producer warp issues TMA tile loads
//     (cp.async.bulk.tensor) of 64 rows x hd into a STAGES-deep shared-memory
//     ring.  Each stage has a "full" mbarrier, completed by the TMA's
//     transaction bytes, and an "empty" mbarrier, completed by one arrival
//     from each consumer warp once its wgmma reading the stage has finished;
//   * the tiles land swizzled (32, 64 and 128 B at hd = 16, 32 and 64; at
//     hd = 128 a tile is two 64-column boxes of 128 B), which is the layout
//     wgmma reads without bank conflicts.  Rows outside the tensor arrive as
//     zeros (the TMA's bounds check), so no thread copies and the load has no
//     ragged-edge branch;
//   * S = Q K^T is wgmma m64n64k16 with Q and K both K-major in shared memory;
//   * O += P V is wgmma m64n{hd}k16 with A = P taken from registers (the S
//     accumulator's layout, converted to bf16 pairs, is the register-A
//     fragment layout) and B = the V tile as it lies in memory, key-major
//     with hd contiguous, read MN-major (the transpose-B flag): nothing is
//     transposed;
//   * the per-key mask runs only on the last tile below kv_end (and on every
//     tile of a length-0 row); exp is ex2.approx with log2 e folded into the
//     score scale, one FMA per score.
// BQ = 128 (not 64) halves the L2 traffic of K and V, which every query
// block of a head streams again.  What bounds the kernels is the latency of
// each warpgroup's serial chain (tile wait, Q K^T, softmax, P V), so the
// design keeps as many chains an SM as registers allow: at hd <= 64 two
// blocks an SM (__launch_bounds__(288, 2): 9 warps a block, allocated per SM
// sub-partition, cap the consumers at 96 registers), hd = 128 one.  So a
// warpgroup waits for each product: holding the next tile's scores while
// P V runs needs more than 96 registers.  No setmaxnreg: the producer is
// one warp, so giving up its registers frees too few to matter.
//
// The tensor maps are encoded on the host for each call, from the geometry
// that ops/flash_attention.py::tile_map computes (dims, byte strides, box,
// swizzle), and passed to the kernels as __grid_constant__ parameters.  The
// barriers, the ring, the TMA loads, the descriptors and the encoding are
// the shared Hopper primitives of csrc/sm90.cuh.
#pragma once

#include "sm90.cuh"

namespace attn {

using namespace sm90;

constexpr int BQ = 128;            // query rows of a block
constexpr int BK = 64;             // keys of a tile (= rows of every TMA box)
constexpr int WG_ROWS = 64;        // query rows of one consumer warpgroup
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

// One 64-row x HD bf16 tile in shared memory, as the TMA writes it.
template <int HD>
struct Tile {
  static constexpr int BOX_COLS = HD > 64 ? 64 : HD;    // columns of one TMA box
  static constexpr int COL_BOXES = HD / BOX_COLS;       // 2 at HD = 128
  static constexpr int ROW_BYTES = BOX_COLS * 2;        // = the swizzle span
  static constexpr int BOX_BYTES = BK * ROW_BYTES;
  static constexpr int BYTES = BOX_BYTES * COL_BOXES;
  static constexpr int KSTEPS_PER_BOX = ROW_BYTES / 32;  // k16 steps along one box row
  // wgmma descriptor layout code of the swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
};

// Byte offsets in the block's shared memory (from a 1024-aligned base: the
// swizzle pattern repeats every 1024 bytes of address).
template <int HD>
struct Smem {
  static constexpr int Q = 0;  // two tiles, one per consumer warpgroup
  static constexpr int K = Q + 2 * Tile<HD>::BYTES;
  static constexpr int V = K + STAGES * Tile<HD>::BYTES;
  static constexpr int BAR = V + STAGES * Tile<HD>::BYTES;  // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;  // + slack to align the base
};

// One 64-row x HD tile: COL_BOXES boxes at columns col, col + 64.  `outer`
// are the coordinates of the map's outer dims (batch; or head, batch).
template <int HD, class... Outer>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar, int col, int row,
                                          Outer... outer) {
  using TL = Tile<HD>;
#pragma unroll
  for (int x = 0; x < TL::COL_BOXES; ++x)
    tma_load(dst + x * TL::BOX_BYTES, map, bar, col + x * TL::BOX_COLS, row, outer...);
}

// Initialise the ring's and the q barrier (one thread), before the
// __syncthreads that precedes the split into producer and consumers.
__device__ __forceinline__ void init_barriers(const Ring<STAGES>& ring, uint32_t q_bar) {
  ring.init(CONSUMER_WARPS);
  mbar_init(q_bar, 1);
  mbar_fence_init();
}

// D (64 x N, f32) = or += A (64 x 16, K-major smem) B (16 x N, K-major smem)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, MN-major smem)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---- the two products and the softmax pieces -------------------------------
//
// Accumulator layout of wgmma m64nN (thread = lane of warp w of the
// warpgroup, g = lane / 4, t = lane % 4): d[4j + e] holds row 16 w + g
// (+ 8 when e >= 2), column 8 j + 2 t + (e & 1).  A thread so holds two rows
// of S: "row 0" (e < 2) and "row 1" (e >= 2).

// S (64 x 64 f32) = Q (this warpgroup's 64 rows) K^T (64 keys), both tiles
// K-major in shared memory.  A k16 step is 32 bytes along a swizzled row;
// at HD = 128 steps 4..7 are in the second column box.
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
  using TL = Tile<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / TL::KSTEPS_PER_BOX) * TL::BOX_BYTES + (kk % TL::KSTEPS_PER_BOX) * 32;
    wgmma_ss<BK>(s, smem_desc(q_addr + off, 16, 8 * TL::ROW_BYTES, TL::LAYOUT),
                 smem_desc(k_addr + off, 16, 8 * TL::ROW_BYTES, TL::LAYOUT), kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// The per-key mask of a tile starting at key k0: keys >= kv_end get -inf
// (weight exactly 0); in a length-0 row (all_masked) every key < kv_end = T
// gets the same score 0, the uniform weights that the finite f32-minimum
// fill of the plain version gives.
__device__ __forceinline__ void mask_tile(float (&s)[32], int k0, int kv_end, bool all_masked) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
    s[i] = key >= kv_end ? -INFINITY : (all_masked ? 0.f : s[i]);
  }
}

// the maxima of this thread's two rows over the tile (reduced over the 4
// threads that share a row)
__device__ __forceinline__ void row_max(const float (&s)[32], float& mx0, float& mx1) {
  mx0 = -INFINITY;
  mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & 2) mx1 = fmaxf(mx1, s[i]);
    else mx0 = fmaxf(mx0, s[i]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32 weights (S's layout) -> the register-A fragments of the four k16 steps
// of P V: step kk covers keys 16 kk .. 16 kk + 15, i.e. n8 blocks 2 kk and
// 2 kk + 1: a0 (row 0, keys 2t, 2t+1), a1 (row 1, same keys), a2 (row 0,
// keys 8 + 2t, 8 + 2t + 1), a3 (row 1, same keys).
__device__ __forceinline__ void pack_weights(const float (&p)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

// the sum of a packed bf16 pair, in f32
__device__ __forceinline__ float pair_sum(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}

// O (64 x HD f32) += P (64 x 64 keys, registers) V (64 keys x HD).  The V
// tile is key-major with HD contiguous: MN-major for B.  A k16 step is 16
// key rows; the column boxes of HD = 128 are the N atoms (LBO apart).
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2], const uint32_t (&a)[4][4], uint32_t v_addr) {
  using TL = Tile<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, a[kk], smem_desc(v_addr + kk * 16 * TL::ROW_BYTES, TL::BOX_BYTES, 8 * TL::ROW_BYTES, TL::LAYOUT));
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
}

// ---- host: tensor maps ---------------------------------------------------------

// Encode the map of one bf16 operand at `base` from the geometry `g` of
// ops/flash_attention.py::tile_map; the box must be the kernel's tile box.
template <int HD>
int encode_tile_map(CUtensorMap* map, const void* base, const long long* g) {
  using TL = Tile<HD>;
  if (g[0] < 3) return (int)cudaErrorInvalidValue;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, g, TL::BOX_COLS, BK, TL::ROW_BYTES);
}

}  // namespace attn

