// Hopper (sm_90a) primitives shared by the TMA + wgmma kernels: the
// attention machinery of csrc/attn_sm90.cuh (B1, B5) and the GEMM core of
// csrc/ffn_sm90.cuh (B2, B3, B4).
//
//   * mbarriers and a STAGES-deep ring of shared-memory buffers, each with a
//     "full" barrier (completed by the TMA's transaction bytes) and an
//     "empty" barrier (one arrival from each consumer warp);
//   * TMA tile loads (cp.async.bulk.tensor, 2-D to 4-D) and 2-D tile stores
//     from 128 B-swizzled shared memory;
//   * wgmma shared-memory descriptors and the fence / commit / wait steps;
//   * on the host, cuTensorMapEncodeTiled from the driver through the
//     runtime's entry-point query (cudaGetDriverEntryPointByVersion from
//     CUDA 12.5 on, cudaGetDriverEntryPoint before), so no library links
//     -lcuda, and the encoding of one map from the geometry that the Python
//     wrappers compute (rank, dims, byte strides, box, swizzle).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace sm90 {

// a failed cuTensorMapEncodeTiled returns this plus its CUresult
constexpr int TENSOR_MAP_ERROR = 10000;

// the block's shared memory from a 1024-aligned base: the swizzle pattern
// repeats every 1024 bytes of address
__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return ((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u;
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The ring of STAGES buffers: use n of stage s is item i = s + n STAGES.
template <int STAGES>
struct Ring {
  uint32_t full, empty;
  __device__ __forceinline__ uint32_t full_bar(int i) const { return full + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t empty_bar(int i) const { return empty + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t parity(int i) const { return (uint32_t)(i / STAGES) & 1u; }
  // one thread, before the __syncthreads that precedes the split into
  // producer and consumers: full barriers take one arrival (the producer's
  // expect_tx), empty ones one from each of `consumer_warps`
  __device__ __forceinline__ void init(uint32_t consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumer_warps);
    }
  }
  // producer: wait until item i - STAGES has been released
  __device__ __forceinline__ void wait_empty(int i) const {
    if (i >= STAGES) mbar_wait(empty_bar(i), (uint32_t)(i / STAGES - 1) & 1u);
  }
  __device__ __forceinline__ void wait_full(int i) const { mbar_wait(full_bar(i), parity(i)); }
  // consumer warp: release item i (one arrival per warp, from lane 0)
  __device__ __forceinline__ void release(int i) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar(i));
  }
};

// ---- TMA ----------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// box of shared memory at src -> the map's tile at (c0, c1): a bulk group of
// this thread; rows and columns outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// makes this thread's shared-memory writes visible to the TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// barrier `id` (1..15) among `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of byte `b` of row `row` in a tile of 128-byte-wide boxes of
// `rows` rows each, swizzled 128 B as the TMA lays them out (the 16-byte
// chunk index XOR row % 8).
__device__ __forceinline__ uint32_t swizzle128(int row, int b, int rows) {
  return (uint32_t)((b >> 7) * rows * 128 + row * 128 + ((((b & 127) >> 4) ^ (row & 7)) << 4) + (b & 15));
}

// ---- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout code (1 = 128 B, 2 = 64 B,
// 3 = 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups are still running
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encode the map of the operand at `base` from the geometry `g` (the int64
// array of ops/flash_attention.py::TileMap.as_c): rank, dims[5] (elements,
// innermost first), byte strides[4] (of dims 1..), box[5], swizzle bytes.
// The box must be box_cols x box_rows (x 1 in the outer dims) and the
// swizzle `swizzle_bytes`, the kernel's tile; returns 0 or an error code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, const long long* g,
                      int box_cols, int box_rows, int swizzle_bytes) {
  const int rank = (int)g[0];
  if (rank < 2 || rank > 5 || g[10] != box_cols || g[11] != box_rows || g[15] != swizzle_bytes)
    return (int)cudaErrorInvalidValue;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    dims[i] = (cuuint64_t)g[1 + i];
    box[i] = (cuuint32_t)g[10 + i];
    elem[i] = 1;
    if (i > 0) strides[i - 1] = (cuuint64_t)g[5 + i];
    if (i > 1 && box[i] != 1) return (int)cudaErrorInvalidValue;
  }
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const CUresult res = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace sm90
