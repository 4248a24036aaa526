// Variable-length attention on float32 activations: the f32 instantiations of
// B1 (pflash_f32, packed (B, T, 3D) QKV) and B5 (flash_attention_f32,
// (B, H, T, hd) views), as parity mode runs them with attn_impl "pflash" or
// "flash".
//
// Replaces the TPU kernels simwhisper_codec_tpu/ops/flash_attention.py
// fused_qkv_attention (_pflash_kernel) and flash_attention (_attn_kernel) on
// f32 inputs, where the JAX kernels compute in f32 throughout:
//   B1: s = q k^T, keys >= length masked; e = exp(s - max s);
//       o = (sum e v) * (1 / sum e)
//   B5: s = q k^T + 1.0 on keys < length (f32 minimum elsewhere);
//       p = e / sum e, e = exp(s - max s);  o = sum p v
// q arrives pre-scaled by hd^-1/2.  A length-0 row averages all T values
// uniformly; keys at or beyond the length have weight exactly 0.  Both run
// the same one-pass body: in f32 the JAX kernel's cast of p to v's dtype is a
// no-op, so B5's normalisation before P V and a division of the output by
// sum e at the end differ by f32 rounding only (a few ulps a term), and B5
// is B1 with the +1.0 key bias and its own tensor maps.
//
// Bound on the H100: 4 B H T^2 hd operations (55 GFLOP at 8 x 12 x 1500^2 x
// 64; a length-0 row needs only P V, half of that) over ~150 MB.  One TF32
// product (10-bit mantissa) misses the plain version's 1e-5 by two orders,
// so both products are a 3 x TF32 split on wgmma: x = big + small with big
// = x as wgmma reads an f32 container as tf32 (the low 13 bits dropped) and
// small = x - big (exact in f32), and a b = big_a big_b + big_a small_b +
// small_a big_b.  The bound is 3 x flops at the 494.7 TFLOP/s TF32 peak.
// Accuracy, as measured on the H100 (PERF.md, the f32 kernels' findings):
// the drift fits tensor cores that round each wgmma's f32 sum toward zero,
// ~2^-24 of |O| a wgmma on a running O accumulator; over the 576 wgmma of 1500
// keys that missed the tolerance on the codec's own activations (whose
// values share an offset, so O grows with the keys).  Each tile's P V
// therefore goes into a fresh accumulator (24 wgmma), added into O in
// registers with round-to-nearest.  Rounding big to nearest (cvt.rna) in
// place of the truncation cut max |d| by a quarter more but cost 7 % and
// no tolerance margin, and issuing the correction products first changed
// nothing, so neither is done.  Design,
// on the primitives of csrc/sm90.cuh:
//   * a block owns 64 query rows per consumer warpgroup (two warpgroups at
//     hd <= 64, one at hd = 128) of one (batch, head); its last warpgroup
//     is one producer warp (lane 0 issues the TMA loads) and three
//     transform warps.  setmaxnreg moves registers from that warpgroup to
//     the consumers;
//   * f32 boxes are 32 columns (128 B rows, 128 B swizzle; 16 columns and
//     64 B at hd = 16), which is the K-major layout wgmma reads: a k8 step
//     of tf32 is 32 bytes of a row, four steps a box;
//   * three rings of STAGES stages (2; 1 at hd = 128), each stage with its
//     own mbarriers: K (K as the TMA lands it, which wgmma reads as its big
//     half, and K's small half), the V landing slots, and V^T (big, small).
//     The transform warps write K's small half once K lands, then V^T from
//     the landed V: .tf32 wgmma has no transpose flag, and V lands
//     key-major.  Each write ends in a proxy fence and an arrival on a
//     "ready" barrier.  Q's small half is written once the same way;
//   * the consumers release K after S = Q K^T and V^T after P V, and the
//     transform warps free a V landing slot once transposed, so the
//     producer loads K two tiles ahead of the product that reads it and V
//     before its V^T slot is free: the TMA latency stays off the chain;
//   * S = Q K^T: three m64n64k8 wgmma a k8 step, A and B from shared memory;
//   * O_tile = P V: three m64n{hd}k8 wgmma a k8 step into a fresh
//     accumulator, A = P from registers, B = V^T from shared memory.  The accumulator of S gives a thread keys 2t
//     and 2t + 1 of each 8-key group, the tf32 A fragment wants keys t and
//     t + 4, so V^T's keys are permuted within each 8-key group (key 2m
//     at position m, key 2m + 1 at 4 + m): P never leaves registers;
//   * a software pipeline one tile deep: S of tile i + 1 is issued before
//     P V of tile i and its softmax runs while P V does.  ptxas serialises
//     the wgmma of this order (C7514: it cannot tell that the wait which
//     retires S leaves only P V in flight); without the pipeline it
//     serialised one of the two kernels or the other from build to build
//     (C7511), at about twice the time (PERF.md, the f32 kernels' findings);
//   * online softmax (exact expf, O rescaled only where a row's max grew),
//     1/sum at the output; the mask only on the last tile below kv_end;
//     only tiles below kv_end are visited.  A length-0 row's scores are all
//     overwritten by the mask, so it loads no K and issues no Q K^T.
// Shared memory at hd = 64 (a tile = 64 x 64 f32 = 16 KB): Q and its small
// half for two warpgroups 64 KB; a stage of K 32 KB, of V 16 KB, of V^T
// 32 KB; two stages 160 KB; 224 KB + barriers of the 227 KB.  hd = 128
// doubles every tile and so runs one consumer warpgroup and one stage.
#include "attn_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BK = 64;       // keys of a tile (= rows of every TMA box)
constexpr int WG_ROWS = 64;  // query rows of one consumer warpgroup
constexpr int TRANSFORMERS = 96;  // threads of the transform warps: the last warpgroup but its first warp
constexpr uint32_t TF32_BITS = 0xffffe000u;  // the bits of an f32 that wgmma reads as tf32
// The register-A fragment of a tf32 k8 step: a_r holds row g + 8 (r & 1),
// position t + 4 (r >> 1) (g = lane / 4, t = lane % 4).  Position t is key
// 2t and t + 4 key 2t + 1, so a_r is element frag(r) of the S accumulator's
// n8 block, d[4j + e] = row g + 8 (e >> 1), key 2t + (e & 1).
__host__ __device__ constexpr int frag(int r) { return 2 * (r & 1) + (r >> 1); }

// mbarriers, STAGES of each kind, then q_full and q_ready
enum Bar { K_FULL, K_EMPTY, K_READY, V_FULL, V_FREE, VT_READY, VT_EMPTY, BAR_KINDS };

template <int HD>
struct Cfg {
  static constexpr int WGS = HD == 128 ? 1 : 2;  // consumer warpgroups
  static constexpr int STAGES = HD == 128 ? 1 : 2;
  static constexpr int BQ = WGS * WG_ROWS;
  static constexpr int CONSUMERS = WGS * 128;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warp and the transform warps
  // setmaxnreg at two consumer warpgroups: the block's 384 x 168 registers
  // = 128 x 72 + 256 x 216 (an increase only takes what a decrease released)
  static constexpr int TRANSFORM_REGS = 72, CONSUMER_REGS = 216;
  // a row tile (64 rows x HD, as the TMA writes it; the small halves of Q
  // and K in the same layout)
  static constexpr int BOX_COLS = HD > 32 ? 32 : HD;
  static constexpr int ROW_BYTES = BOX_COLS * 4;  // = the swizzle span
  static constexpr int BOX_BYTES = BK * ROW_BYTES;
  static constexpr int TILE = BK * HD * 4;
  static constexpr int KSTEPS_PER_BOX = ROW_BYTES / 32;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // wgmma swizzle code: 128 B, 64 B
  // a V^T tile: HD rows of 64 key positions, two 32-position boxes of
  // 128-byte rows, swizzled 128 B
  static constexpr int VT_BOX = HD * 128;
  // byte offsets from a 1024-aligned base: Q and its small half (a tile a
  // consumer warpgroup); the K ring (K, K small a stage); the V landing
  // ring (raw V, free once transposed); the V^T ring (big, small a stage)
  static constexpr int Q = 0, QS = WGS * TILE;
  static constexpr int KR = 2 * WGS * TILE;
  static constexpr int VR = KR + STAGES * 2 * TILE;
  static constexpr int VT = VR + STAGES * TILE;
  static constexpr int BAR = VT + STAGES * 2 * TILE;
  static constexpr int BYTES = BAR + 8 * (BAR_KINDS * STAGES + 2) + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

struct Strides {  // of the output, in elements: batch, head, time; the head dim is contiguous
  long long b, h, t;
};

// byte offset of row `row` of a box swizzled by its row width (64 or 128
// bytes): byte c of the row (< ROW_BYTES) is at row_offset ^ c
template <int ROW_BYTES>
__device__ __forceinline__ int row_offset(int row) {
  const int off = row * ROW_BYTES;
  return off | (((off >> 7) & (ROW_BYTES / 16 - 1)) << 4);
}

// One 64-row x HD tile.  The packed B1 map is 3-D (3D, T, B) and the tile's
// columns start at `col`; B5's maps are 4-D (hd, T, H, B).
template <int HD, bool FLASH>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar, int col, int row,
                                          int h, int b) {
  using C = Cfg<HD>;
#pragma unroll
  for (int x = 0; x < HD / C::BOX_COLS; ++x) {
    if (FLASH) tma_load(dst + x * C::BOX_BYTES, map, bar, x * C::BOX_COLS, row, h, b);
    else tma_load(dst + x * C::BOX_BYTES, map, bar, col + x * C::BOX_COLS, row, b);
  }
}

// ---- the 3 x TF32 split --------------------------------------------------------

__device__ __forceinline__ float small_half(float x) { return x - __uint_as_float(__float_as_uint(x) & TF32_BITS); }

__device__ __forceinline__ float4 small_half(float4 x) {
  return make_float4(small_half(x.x), small_half(x.y), small_half(x.z), small_half(x.w));
}

// D (64 x 64 f32) (+)= A (64 x 8 tf32, K-major smem) B (8 x 64, K-major smem)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N f32) (+)= A (64 x 8 tf32, registers) B (8 x N, K-major smem)
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- the transform warps ----------------------------------------------------------

// dst = the small halves of the `bytes` at src, in the same layout
__device__ __forceinline__ void split_tile(unsigned char* sm, int src, int dst, int bytes, int tw) {
  for (int i = tw * 16; i < bytes; i += TRANSFORMERS * 16)
    *reinterpret_cast<float4*>(sm + dst + i) = small_half(*reinterpret_cast<const float4*>(sm + src + i));
}

__device__ __forceinline__ float4 pick(bool c, float4 a, float4 b) {
  return make_float4(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z, c ? a.w : b.w);
}

__device__ __forceinline__ float lane_of(float4 v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

// The V tile (keys x HD) -> V^T big (the raw values) and small, HD rows of
// 64 key positions; key 8g + 2m + par goes to position 8g + 4 par + m.  A
// unit is 4 keys of one position quad (g, par) x 4 columns n0 .. n0 + 3:
// four 16-byte reads, four 16-byte writes to each of V^T big and small.
// The 8 lanes of a quarter warp take par and g & 3 of one (column quad,
// g >> 2): their writes fill the 8 chunks of one V^T row and, as read i
// takes key slot (i + g) & 3, their reads hit 8 distinct swizzled chunks.
template <int HD>
__device__ __forceinline__ void transpose_v(const unsigned char* v, unsigned char* vtb, unsigned char* vts, int tw) {
  using C = Cfg<HD>;
  constexpr int UNITS8 = HD / 2;               // groups of 8 units: HD / 4 column quads x 2 key halves
  constexpr int GROUPS = TRANSFORMERS / 8;     // quarter warps
  const int par = tw & 1, gl = (tw >> 1) & 3;
#pragma unroll
  for (int pass = 0; pass < (UNITS8 + GROUPS - 1) / GROUPS; ++pass) {
    const int u8 = (tw >> 3) + GROUPS * pass;
    if (u8 >= UNITS8) break;
    const int g = 4 * (u8 & 1) + gl, n0 = 4 * (u8 >> 1);
    const unsigned char* src = v + (n0 / C::BOX_COLS) * C::BOX_BYTES;
    const int cb = (n0 % C::BOX_COLS) * 4;
    float4 x[4];  // x[i]: key 8g + 2((i + gl) & 3) + par
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(src + (row_offset<C::ROW_BYTES>(8 * g + 2 * ((i + gl) & 3) + par) ^ cb));
    // rotate by gl: x[m] = key 8g + 2m + par
    const float4 y[4] = {pick(gl & 1, x[3], x[0]), pick(gl & 1, x[0], x[1]), pick(gl & 1, x[1], x[2]),
                         pick(gl & 1, x[2], x[3])};
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = pick(gl & 2, y[(m + 2) & 3], y[m]);
    const int pos = 8 * g + 4 * par;
    const int box = (pos / 32) * C::VT_BOX, pb = (pos % 32) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = make_float4(lane_of(x[0], j), lane_of(x[1], j), lane_of(x[2], j), lane_of(x[3], j));
      const int off = box + (row_offset<128>(n0 + j) ^ pb);
      *reinterpret_cast<float4*>(vtb + off) = w;
      *reinterpret_cast<float4*>(vts + off) = small_half(w);
    }
  }
}

// ---- the consumers' two products ---------------------------------------------

template <int HD>
__device__ __forceinline__ uint64_t row_desc(uint32_t addr) {
  using C = Cfg<HD>;
  return smem_desc(addr, 16, 8 * C::ROW_BYTES, C::LAYOUT);
}

__device__ __forceinline__ uint64_t vt_desc(uint32_t addr) { return smem_desc(addr, 16, 1024, 1); }

// A descriptor the compiler treats as new at each use: the products add
// each k step's offset to it in place, where hoisting would hold the
// descriptors of every stage and k step in registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// Issue S (64 x 64 f32) = Q (this warpgroup's 64 rows) K^T (64 keys), 3 x
// TF32, as one wgmma group.  Arguments: the descriptors of Q, Q small, K and
// K small; a k step's offset (bytes / 16) adds to the address field.
template <int HD>
__device__ __forceinline__ void qk_issue(float (&s)[32], uint64_t q, uint64_t qs, uint64_t k, uint64_t ks) {
  using C = Cfg<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint32_t off = ((kk / C::KSTEPS_PER_BOX) * C::BOX_BYTES + (kk % C::KSTEPS_PER_BOX) * 32) >> 4;
    wgmma_tf32_ss(s, q + off, k + off, kk > 0);
    wgmma_tf32_ss(s, q + off, ks + off, 1);
    wgmma_tf32_ss(s, qs + off, k + off, 1);
  }
  wgmma_commit();
}

// Issue O (64 x HD f32) = P V, 3 x TF32, as one wgmma group into a fresh
// accumulator (the caller adds it into the running O): A = P's big
// (p, as wgmma reads an f32) and small (ps) halves from registers, which
// must stay unchanged until the group completes; B = V^T big / small
// (descriptors vt, vts), K-major, a k8 step 32 bytes along a 128-byte row.
template <int HD>
__device__ __forceinline__ void pv_issue(float (&o)[HD / 2], const float (&p)[32], const float (&ps)[32], uint64_t vt,
                                         uint64_t vts) {
  using C = Cfg<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = ((kk / 4) * C::VT_BOX + (kk % 4) * 32) >> 4;
    uint32_t big[4], small[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      big[r] = __float_as_uint(p[4 * kk + frag(r)]);
      small[r] = __float_as_uint(ps[4 * kk + frag(r)]);
    }
    wgmma_tf32_rs<HD>(o, big, vt + off, kk > 0);
    wgmma_tf32_rs<HD>(o, big, vts + off, 1);
    wgmma_tf32_rs<HD>(o, small, vt + off, 1);
  }
  wgmma_commit();
}

template <int HD, bool FLASH>
__device__ __forceinline__ void attention_f32(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                              const CUtensorMap* v_map, const int* __restrict__ lengths,
                                              float* __restrict__ out, int T, int H, Strides os) {
  using C = Cfg<HD>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  unsigned char* sm = smem_raw + (base - (uint32_t)__cvta_generic_to_shared(smem_raw));
  // barrier of kind `k` for use i of its stage; a use's phase parity; wait
  // for use i, or (producer / transform) until use i - ST has been released
  auto bar = [&](int k, int i) { return base + C::BAR + 8 * (k * ST + i % ST); };
  auto wait_use = [&](int k, int i) { mbar_wait(bar(k, i), (uint32_t)(i / ST) & 1u); };
  auto wait_free = [&](int k, int i) {
    if (i >= ST) mbar_wait(bar(k, i), (uint32_t)(i / ST - 1) & 1u);
  };
  const uint32_t q_full = base + C::BAR + 8 * BAR_KINDS * ST, q_ready = q_full + 8;

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int kv_end = all_masked ? T : min(len, T);
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    constexpr int counts[BAR_KINDS] = {1, C::CONSUMERS / 32, TRANSFORMERS, 1, TRANSFORMERS, TRANSFORMERS,
                                       C::CONSUMERS / 32};
    for (int k = 0; k < BAR_KINDS; ++k)
      for (int s = 0; s < ST; ++s) mbar_init(bar(k, s), counts[k]);
    mbar_init(q_full, 1);
    mbar_init(q_ready, TRANSFORMERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {  // the last warpgroup: the producer warp, then the transform warps
    if constexpr (C::WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::TRANSFORM_REGS));
    const int tw = threadIdx.x - C::CONSUMERS - 32;
    if (tw < 0) {  // lane 0 of the producer warp: Q, then K and V of each tile
      if (tw == -32) {
        const int D = H * HD;
        mbar_expect_tx(q_full, C::WGS * C::TILE);
        for (int w = 0; w < C::WGS; ++w)
          load_tile<HD, FLASH>(q_map, base + C::Q + w * C::TILE, q_full, h * HD, q0 + w * WG_ROWS, h, b);
        for (int i = 0; i < n_tiles; ++i) {
          if (!all_masked) {  // a length-0 row reads no K (see issue_qk)
            wait_free(K_EMPTY, i);
            mbar_expect_tx(bar(K_FULL, i), C::TILE);
            load_tile<HD, FLASH>(k_map, base + C::KR + (i % ST) * 2 * C::TILE, bar(K_FULL, i), D + h * HD, i * BK, h,
                                 b);
          }
          wait_free(V_FREE, i);
          mbar_expect_tx(bar(V_FULL, i), C::TILE);
          load_tile<HD, FLASH>(v_map, base + C::VR + (i % ST) * C::TILE, bar(V_FULL, i), 2 * D + h * HD, i * BK, h,
                               b);
        }
      }
      return;
    }
    mbar_wait(q_full, 0);
    split_tile(sm, C::Q, C::QS, C::WGS * C::TILE, tw);
    fence_proxy_async();
    mbar_arrive(q_ready);
    for (int i = 0; i < n_tiles; ++i) {
      const int k_st = C::KR + (i % ST) * 2 * C::TILE, vt_st = C::VT + (i % ST) * 2 * C::TILE;
      if (!all_masked) {
        wait_use(K_FULL, i);
        split_tile(sm, k_st, k_st + C::TILE, C::TILE, tw);
        fence_proxy_async();
        mbar_arrive(bar(K_READY, i));
      }
      wait_use(V_FULL, i);
      wait_free(VT_EMPTY, i);
      transpose_v<HD>(sm + C::VR + (i % ST) * C::TILE, sm + vt_st, sm + vt_st + C::TILE, tw);
      fence_proxy_async();
      mbar_arrive(bar(V_FREE, i));
      mbar_arrive(bar(VT_READY, i));
    }
    return;
  }
  if constexpr (C::WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));

  // a consumer warpgroup: 64 query rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const uint32_t q_addr = base + C::Q + wg * C::TILE, qs_addr = base + C::QS + wg * C::TILE;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float ot[HD / 2];  // P V of one tile, added into o once it completes
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // the softmax of a score tile in place: bias (B5), mask, the running max
  // and sum, the weights exp(s - max); alpha: the rescale of O so far
  float alpha0, alpha1;
  auto softmax = [&](float (&sc)[32], int k0) {
    if (FLASH) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] += 1.0f;
    }
    if (all_masked || k0 + BK > kv_end) attn::mask_tile(sc, k0, kv_end, all_masked);
    float mx0, mx1;
    attn::row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key k0 < kv_end is in this tile
    alpha0 = expf(m0 - mn0);
    alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = expf(sc[j] - ((j & 2) ? mn1 : mn0));
      if (j & 2) sum1 += sc[j];
      else sum0 += sc[j];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  };
  // S of tile i; a length-0 row's scores are all overwritten by the mask, so
  // it issues no Q K^T (and its K tiles are never loaded)
  auto issue_qk = [&](float (&sc)[32], int i) {
    if (all_masked) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      return;
    }
    const uint32_t k_st = base + C::KR + (i % ST) * 2 * C::TILE;
    wait_use(K_FULL, i);
    wait_use(K_READY, i);
    qk_issue<HD>(sc, opaque(row_desc<HD>(q_addr)), opaque(row_desc<HD>(qs_addr)), opaque(row_desc<HD>(k_st)),
                 opaque(row_desc<HD>(k_st + C::TILE)));
  };

  // Software pipeline, one tile deep: S of tile i + 1 is issued before P V
  // of tile i, and its softmax runs while P V does.
  mbar_wait(q_full, 0);
  mbar_wait(q_ready, 0);
  float s[32], sn[32], ps[32];
  issue_qk(s, 0);
  wgmma_wait();
  fence_regs(s);
  if (lane == 0 && !all_masked) mbar_arrive(bar(K_EMPTY, 0));
  softmax(s, 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) ps[j] = small_half(s[j]);
  for (int i = 0; i < n_tiles; ++i) {
    const bool next = i + 1 < n_tiles;
    if (next) issue_qk(sn, i + 1);
    const uint32_t vt_st = base + C::VT + (i % ST) * 2 * C::TILE;
    wait_use(VT_READY, i);
    pv_issue<HD>(ot, s, ps, opaque(vt_desc(vt_st)), opaque(vt_desc(vt_st + C::TILE)));
    if (next) {
      wgmma_wait<1>();  // S of tile i + 1; P V of tile i may still run
      fence_regs(sn);
      if (lane == 0 && !all_masked) mbar_arrive(bar(K_EMPTY, i + 1));
      softmax(sn, (i + 1) * BK);
    }
    wgmma_wait();
    fence_regs(ot);
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] += ot[j];
    fence_regs(s);
    fence_regs(ps);
    if (lane == 0) mbar_arrive(bar(VT_EMPTY, i));
    if (next) {
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {  // a row's max grew
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = sn[j];
        ps[j] = small_half(s[j]);
      }
    }
  }

  const float inv0 = 1.0f / attn::quad_sum(l0), inv1 = 1.0f / attn::quad_sum(l1);
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= T) continue;
    const float inv = r ? inv1 : inv0;
    float* dst = out + b * os.b + h * os.h + q * os.t + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    pflash_f32_kernel(const __grid_constant__ CUtensorMap qkv_map, const int* __restrict__ lengths,
                      float* __restrict__ out, int T, int H) {
  const Strides os{(long long)T * H * HD, HD, (long long)H * HD};
  attention_f32<HD, false>(&qkv_map, &qkv_map, &qkv_map, lengths, out, T, H, os);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
                     float* __restrict__ out, int T, Strides os) {
  attention_f32<HD, true>(&q_map, &k_map, &v_map, lengths, out, T, 0, os);
}

// Encode the map of one f32 operand at `base` from the geometry `g` of
// ops/flash_attention.py::tile_map; the box must be the kernel's tile box.
template <int HD>
int encode_tile_map(CUtensorMap* map, const void* base, const long long* g) {
  using C = Cfg<HD>;
  if (g[0] < 3) return (int)cudaErrorInvalidValue;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, g, C::BOX_COLS, BK, C::ROW_BYTES);
}

template <int HD>
int launch_pflash(const void* qkv, const void* lengths, void* out, int B, int T, int H, const long long* geom,
                  cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap map;
  const int err = encode_tile_map<HD>(&map, qkv, geom);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(pflash_f32_kernel<HD>, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + C::BQ - 1) / C::BQ, H, B);
  pflash_f32_kernel<HD><<<grid, C::THREADS, C::BYTES, stream>>>(map, (const int*)lengths, (float*)out, T, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, const void* lengths, void* out, int B, int H, int T,
                 const long long* qg, const long long* kg, const long long* vg, Strides os, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap q_map, k_map, v_map;
  int err = encode_tile_map<HD>(&q_map, q, qg);
  if (err == 0) err = encode_tile_map<HD>(&k_map, k, kg);
  if (err == 0) err = encode_tile_map<HD>(&v_map, v, vg);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(flash_f32_kernel<HD>, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + C::BQ - 1) / C::BQ, H, B);
  flash_f32_kernel<HD><<<grid, C::THREADS, C::BYTES, stream>>>(q_map, k_map, v_map, (const int*)lengths,
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
// strides (in elements, even; the head dim contiguous and 8-byte aligned);
// lengths (B,) int32; HD in {16, 32, 64, 128}.  Returns as pflash_f32.
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
