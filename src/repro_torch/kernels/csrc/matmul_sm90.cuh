// Hopper building blocks of B1 (matmul.cu) and B5 (quantized_matmul.cu):
// mbarriers, TMA tile loads and stores, wgmma descriptors and the
// m64n128k16 bf16 product, cp.async copies (also decode_attention.cu's),
// and on the host tensor-map encoding and the launch with a dynamic
// shared-memory opt-in.
//
// Shared-memory layout of the bf16 tiles.  Every 16-bit tile is stored as
// rows of 128 bytes in TMA's 128-byte swizzle: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) of that row, within a buffer aligned to 1024
// bytes.  TMA writes this layout itself; the masked path (strides that are
// not multiples of 16 bytes) writes the same bytes with `swizzle128`, so
// the products read identical tiles whichever path filled them.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of byte x of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swizzle128(uint32_t r, uint32_t x) {
  return r * 128u + ((((x >> 4) ^ (r & 7u)) << 4) | (x & 15u));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// generic-proxy stores to shared memory made visible to the async proxy
// (wgmma reads its operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- TMA
// a 2-D tile at element coordinates (c0 innermost, c1) into shared memory;
// completion is counted on `bar` in bytes (out-of-bounds elements arrive
// as zeros and count too)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// a 3-D tile at element coordinates (c0 innermost, c1, c2); with a box
// one plane deep in c2 (a group of B1's grouped route), a tile never reads
// into the next plane and zeros arrive past the plane's own edges
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 2-D tile of shared memory stored into a 3-D tensor at element
// coordinates (c0 innermost, c1, c2), as one bulk async-group of this
// thread once committed; elements past the tensor's edges are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// this thread's uncommitted bulk stores as one group (an empty group if
// there are none)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// returns once at most N of this thread's bulk groups still read their
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// returns once at most N of this thread's bulk groups are unfinished
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle.  lbo and sbo in bytes:
// sbo is the stride between groups of 8 rows of 128 bytes; lbo the stride
// between 64-element atoms along M/N of an MN-major operand (unused by the
// K-major ones).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until every committed group of products has finished
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_R8(b)                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 rows x 128 columns, fp32) += A (64 x 16) @ B (16 x 128);
// TRANS_B = 1 when B's tile is N-contiguous (MN-major), 0 when K-major;
// TRANS_A likewise for A (M-contiguous: 1)
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n}"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32),
        SM90_R8(40), SM90_R8(48), SM90_R8(56)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

#undef SM90_R8

// ---------------------------------------------------------------- cp.async
// 16 bytes, of which the first src_bytes are read and the rest zero-filled
// (src 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, or a zero when src_bytes == 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 8 bytes (src 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// -------------------------------------------------------------------- host
// a row-major 2-D tensor map of `type`: `inner` contiguous elements per
// row, `outer` rows `row_bytes` apart, boxes of box_inner x box_outer,
// zeros out of bounds
inline bool encode_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          CUtensorMapSwizzle swizzle, const void* base,
                          uint64_t inner, uint64_t outer, uint64_t row_bytes,
                          uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 tiles' map: 128-byte swizzle
inline bool encode_map(CUtensorMap* map, const void* base, uint64_t inner,
                       uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                       uint32_t box_outer) {
  return encode_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       CU_TENSOR_MAP_SWIZZLE_128B, base, inner, outer,
                       row_bytes, box_inner, box_outer);
}

// a stack of `planes` such row-major bf16 matrices, `plane_bytes` apart,
// boxes one plane deep (128-byte swizzle)
inline bool encode_map_3d(CUtensorMap* map, const void* base, uint64_t inner,
                          uint64_t outer, uint64_t planes, uint64_t row_bytes,
                          uint64_t plane_bytes, uint32_t box_inner,
                          uint32_t box_outer) {
  const cuuint64_t dims[3] = {inner, outer, planes};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p, long long stride_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_bytes % 16 == 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
