// The Hopper GEMM core of the LN-FFN kernels, csrc/ln_ffn.cu (B2),
// csrc/ln_ffn_int8.cu (B3) and csrc/convnext_dw.cu (B4; B2's bf16 passes,
// csrc/ffn_bf16.cuh): one pass D = A B^T over (M, K) rows A and an
// (N, K) weight B in nn.Linear layout, with an epilogue functor that works
// on the accumulator fragment in registers.
//
//   * a block owns a tile of BM = 128 rows x BN columns (BN = 128 for the up
//     passes, 192 or 256 for the down passes, from the B map's box;
//     ops/fused_convnext.py picks it): two consumer warpgroups of 64 rows
//     and a producer (see Tiling for the threads and blocks an SM);
//   * one producer thread issues TMA loads of 128-byte K slices (64 bf16 or
//     128 s8) of the A tile (128 rows) and the B tile (BN rows) into a ring
//     of 3 or 4 stages (48 KB each at BN = 256), swizzled 128 B, which is
//     the layout wgmma reads without bank conflicts.  Rows past M or N and
//     columns past K arrive as zeros (the TMA's bounds check), so no thread
//     copies and the main loop has no ragged-edge branch;
//   * the consumers run wgmma from shared memory with both operands
//     K-major (the only layout 8-bit wgmma accepts; nothing is transposed):
//     m64nBNk16 bf16 -> f32 and m64nBNk32 s8 -> s32, four k steps of 32
//     bytes a slice.  One slice's products stay in flight while the next
//     slice's are issued (wgmma.wait_group 1), then its stage is released;
//   * the epilogues work on the accumulators in place; the up passes'
//     outputs (h, hq) go through shared memory and one TMA store a tile;
//   * the grid is one block a tile (column tiles fastest, so the blocks
//     that run together share their A rows in L2); not persistent: a
//     tile's epilogue overlaps another tile's main loop where two blocks
//     share an SM (BN = 128).  A persistent ping-pong variant (each
//     warpgroup its own tiles and ring, one block an SM) ran the up passes
//     slower: their epilogues want more warps an SM, not fewer.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace ffn_sm90 {

using namespace sm90;

constexpr int BM = 128;               // rows of a block tile
constexpr int WG_ROWS = 64;           // rows of one consumer warpgroup
constexpr int K_BYTES = 128;          // bytes of one K slice of either operand: the swizzle span
constexpr int CONSUMER_WARPS = 8;     // two warpgroups
constexpr int UP_BN = 128;            // the up passes' block width (see Tiling)

// D (64 x N) += A (64 x k, K-major smem) B (k x N, K-major smem); k = 32 bytes
template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void mma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<192>(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_s8<192>(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Bf16 {
  using Acc = float;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int ITEM = 2;
  template <int N>
  __device__ static __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    mma_bf16<N>(d, da, db, scale_d);
  }
};

struct S8 {
  using Acc = int;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes: TMA does not convert
  static constexpr int ITEM = 1;
  template <int N>
  __device__ static __forceinline__ void mma(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    mma_s8<N>(d, da, db, scale_d);
  }
};

// The tiling of one block width.
//   * BN = 256 and 192 (the down passes, whose long K makes the main loop
//     the larger part): one tile a block, one block an SM; two consumer
//     warpgroups of 64 rows each share every B slice, and a producer
//     warpgroup (384 threads) whose registers setmaxnreg moves to the
//     consumers (128 x 40 + 256 x 232 <= 65536); a 4-stage ring; BN / 2
//     accumulator registers a thread.
//   * BN = 128 (the up passes, whose tanh-GELU epilogues take longer than
//     their short main loops): two blocks an SM, so that one block's
//     epilogue overlaps the other's products and up to 16 warps an SM run
//     epilogues.  256 threads and no producer warp (thread 0 issues the
//     loads between its own products): ptxas compiles every path with the
//     launch bound's count, 128 registers here, so setmaxnreg cannot help
//     (a 9-warp block would get 96); 3 stages.
// Byte offsets in the block's shared memory are from a 1024-aligned base.
template <int BN>
struct Tiling {
  static constexpr bool TWO_BLOCKS = BN == 128;
  static constexpr int BLOCKS_PER_SM = TWO_BLOCKS ? 2 : 1;
  static constexpr int THREADS = TWO_BLOCKS ? 2 * 128 : 3 * 128;
  static constexpr int STAGES = TWO_BLOCKS ? 3 : 4;
  static constexpr int PRODUCER_REGS = 40;   // setmaxnreg, one block an SM
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int A = BM * K_BYTES;  // 16 KB: the A tile of one stage
  static constexpr int STAGE = A + BN * K_BYTES;
  static constexpr int BAR = STAGES * STAGE;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + slack to align the base
};

struct Shape {
  int M, N, K;  // output rows and columns, product depth (elements)
};

// Where a consumer thread's accumulator lies (the accumulator layout of
// wgmma m64nN, g = lane / 4, t = lane % 4): acc[4 j + e] is the element at
// row `row` (+ 8 when e >= 2), column `col` + 8 j + (e & 1), with row = the
// tile's row + 64 wg + 16 (warp % 4) + g and col = the tile's column + 2 t;
// lrow and lcol are the same in the tile.  Rows >= M and columns >= N hold
// zeros.  `full`: the tile lies inside N, so the epilogue need not clip
// columns (and a whole tile's epilogue is one basic block the compiler can
// schedule freely).  `smem`: where a staged epilogue writes its tile.
struct Frag {
  int row, col, lrow, lcol;
  bool full;
  uint32_t smem;
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// One pass over a block tile; every consumer thread calls
// epi.template apply<BN>(acc, frag) on its accumulator.  An epilogue with
// STAGED_ITEM = 0 writes global memory itself.  One with STAGED_ITEM = the
// output's element size writes its 128 x BN tile into shared memory instead,
// swizzled 128 B in boxes of 128 bytes x 128 rows (swizzle128; the ring's
// stages hold it once every product has read them), and thread 0 stores it
// with the TMA through out_map: whole 128-byte rows, clipped to the tensor
// by the TMA, instead of 2- and 4-byte scattered stores.
//
// The accumulator is not zero-filled: the first product overwrites
// (scale_d = 0), and no other instruction may define an accumulator
// register while products are in flight, or ptxas serialises the wgmmas
// (C7515).  One slice's products stay in flight while the next slice's are
// issued (wait_group 1), then its stage is released.
template <class Op, int BN, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* a_map, const CUtensorMap* b_map, const CUtensorMap* out_map,
                                    Shape shape, const Epi& epi) {
  using SM = Tiling<BN>;
  constexpr int STAGES = SM::STAGES;
  constexpr int OUT_ITEM = Epi::STAGED_ITEM;
  static_assert(OUT_ITEM == 0 || (BN * OUT_ITEM % 128 == 0 && BM * BN * OUT_ITEM <= STAGES * SM::STAGE),
                "a staged tile is whole 128-byte boxes and fits in the ring");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const Ring<STAGES> ring{base + SM::BAR, base + SM::BAR + 8 * STAGES};
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (shape.K * Op::ITEM + K_BYTES - 1) / K_BYTES;
  // K slice i into its stage, once slice i - STAGES has been released
  const auto load = [&](int i) {
    constexpr int K_COLS = K_BYTES / Op::ITEM;
    const uint32_t stage = base + (i % STAGES) * SM::STAGE;
    ring.wait_empty(i);
    mbar_expect_tx(ring.full_bar(i), SM::STAGE);
    tma_load(stage, a_map, ring.full_bar(i), i * K_COLS, m0);
    tma_load(stage + SM::A, b_map, ring.full_bar(i), i * K_COLS, n0);
  };
  if (threadIdx.x == 0) {
    ring.init(CONSUMER_WARPS);
    mbar_fence_init();
  }
  __syncthreads();

  if constexpr (!SM::TWO_BLOCKS) {
    if (wg == 2) {  // the producer warpgroup; one thread issues every load
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SM::PRODUCER_REGS));
      if (threadIdx.x == 2 * 128)
        for (int i = 0; i < n_k; ++i) load(i);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SM::CONSUMER_REGS));
  } else if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES && i < n_k; ++i) load(i);
  }

  // a consumer warpgroup: 64 rows x BN
  typename Op::Acc acc[BN / 2];
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    const uint32_t a_addr = base + (i % STAGES) * SM::STAGE + wg * WG_ROWS * K_BYTES;
    const uint32_t b_addr = base + (i % STAGES) * SM::STAGE + SM::A;
    ring.wait_full(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K_BYTES / 32; ++kk)
      Op::template mma<BN>(acc, smem_desc(a_addr + 32 * kk, 16, 8 * K_BYTES, 1),
                           smem_desc(b_addr + 32 * kk, 16, 8 * K_BYTES, 1), i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // slice i - 1's products are done: its stage is free
    if (i > 0) {
      ring.release(i - 1);
      // no producer warp: thread 0 refills the stage once every warp has released it
      if (SM::TWO_BLOCKS && threadIdx.x == 0 && i - 1 + STAGES < n_k) load(i - 1 + STAGES);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int lrow = wg * WG_ROWS + warp * 16 + (lane >> 2), lcol = 2 * (lane & 3);
  if constexpr (OUT_ITEM > 0) named_barrier(1, 2 * 128);  // both warpgroups' products are done with the ring
  epi.template apply<BN>(acc, Frag{m0 + lrow, n0 + lcol, lrow, lcol, n0 + BN <= shape.N, base});
  if constexpr (OUT_ITEM > 0) {
    fence_proxy_async();
    named_barrier(1, 2 * 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int x = 0; x < BN * OUT_ITEM / 128; ++x) tma_store(out_map, base + x * BM * 128, n0 + x * 128 / OUT_ITEM, m0);
      bulk_commit();
      bulk_wait_read();  // the block's shared memory must outlive the stores' reads
    }
  }
}

// An epilogue's apply(): the column-clipping body only for a tile that
// overhangs N.
#define FFN_EPILOGUE_APPLY(ACC)                                                                \
  template <int BN>                                                                            \
  __device__ __forceinline__ void apply(const ACC (&d)[BN / 2], const ffn_sm90::Frag& f) const { \
    if (f.full) body<BN, false>(d, f);                                                         \
    else body<BN, true>(d, f);                                                                 \
  }

// A pass kernel NAME<BN>: run() with operand type OP and epilogue type EPI.
#define FFN_PASS_KERNEL(NAME, OP, EPI)                                                                  \
  template <int BN>                                                                                     \
  __global__ void __launch_bounds__(ffn_sm90::Tiling<BN>::THREADS, ffn_sm90::Tiling<BN>::BLOCKS_PER_SM) \
      NAME(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,        \
           const __grid_constant__ CUtensorMap out_map, ffn_sm90::Shape shape, EPI epi) {               \
    ffn_sm90::run<OP, BN>(&a_map, &b_map, &out_map, shape, epi);                                        \
  }

// ---- host ---------------------------------------------------------------------

// Encode the two operands' maps (geometries from
// ops/fused_convnext.py::operand_map: A boxes of 128 rows, B boxes of BN
// rows, both 128 bytes of K wide) and, for a staged epilogue, the output's
// (boxes of 128 bytes x 128 rows), and launch one pass over an M x N output.
template <class Op, int BN, class Kernel, class Epi>
int launch_pass(Kernel kernel, const void* a, const long long* ga, const void* b, const long long* gb,
                const void* out, const long long* gout, Shape shape, const Epi& epi, cudaStream_t stream) {
  using SM = Tiling<BN>;
  CUtensorMap a_map, b_map, out_map;
  int err = encode_map(&a_map, Op::TYPE, a, ga, K_BYTES / Op::ITEM, BM, K_BYTES);
  if (err == 0) err = encode_map(&b_map, Op::TYPE, b, gb, K_BYTES / Op::ITEM, BN, K_BYTES);
  if (err == 0) err = Epi::STAGED_ITEM ? encode_map(&out_map, Op::TYPE, out, gout, K_BYTES / Op::ITEM, BM, K_BYTES) : 0;
  if (err != 0) return err;
  if (!Epi::STAGED_ITEM) out_map = a_map;  // unused
  const cudaError_t e = allow_smem(kernel, SM::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((shape.N + BN - 1) / BN, (shape.M + BM - 1) / BM);
  kernel<<<grid, SM::THREADS, SM::BYTES, stream>>>(a_map, b_map, out_map, shape, epi);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, BN>{}) for the block width `bn` a pass's
// B map was built with (its box rows); an unsupported width is an error.
template <class F>
int with_block_n(long long bn, F f) {
  switch (bn) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ffn_sm90
