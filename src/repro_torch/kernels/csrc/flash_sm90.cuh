// Hopper building blocks of the bf16 flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) and of the paged prefill
// kernel's wgmma route (prefill_attention.cu), beside B1's in
// matmul_sm90.cuh (mbarriers, TMA, descriptors, fences).
//
// Tiles.  q, k, v (and the backward's bf16 halves of dO) are read as 3-D
// tensors (hd, S, batch x head) by TMA in boxes of 64 head-width elements
// (one 128-byte swizzled row) by `rows` sequence positions: a tile of
// `rows` x hd is hd / 64 such atoms, rows x 128 bytes each, one after the
// other.  Positions past S arrive as zeros.
//   - As a K-major operand (the contraction over hd: Q and K in Q K^T, dO
//     and V in dO V^T) the k-step kk (16 elements) starts at atom kk / 4,
//     byte 32 (kk % 4); 8-row groups lie 1024 bytes apart (sbo).
//   - As an MN-major operand (the contraction over the sequence: V in
//     P V, K in dS K, dO and Q in the dK/dV sweep) the k-step kk starts at
//     row 16 kk of atom 0; the atoms along hd lie rows x 128 bytes apart
//     (lbo) and 8-row groups 1024 bytes apart (sbo).
//
// Fragments.  The fp32 accumulator of m64nNk16 gives lane l of warp w
// (of the warpgroup) register i at row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2.  The bf16 A operand from
// registers wants, for the k-step kk, rows l / 4 (+8) and columns
// 16 kk + 2 (l % 4) (+1, +8): exactly registers 8 kk .. 8 kk + 7 of an
// accumulator, packed in pairs (`a_frag`).  So P and dS go from the
// softmax straight into the next product without shared memory.
#pragma once

#include "matmul_sm90.cuh"

namespace sm90 {

constexpr int ATOM = 64;  // bf16 elements in one 128-byte swizzled row

// a 4-D tile at element coordinates (c0 innermost, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a rows x hd tile of (batch x head) `bh` from sequence position `row0`:
// hd / 64 boxes into consecutive atoms
template <int HD>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int bh) {
#pragma unroll
  for (int a = 0; a < HD / ATOM; ++a)
    tma_load_3d(dst + a * rows * 128, map, bar, a * ATOM, row0, bh);
}

// arrive at named barrier `id` without waiting (the waiters bar.sync it)
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// K-major operand: k-step kk of a tile of `rows` rows
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int rows,
                                                int kk) {
  return wgmma_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major operand: k-step kk (rows 16 kk ..) of a tile of `rows` rows
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile,
                                                 int rows, int kk) {
  return wgmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// keeps the compiler from moving register reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A operand of k-step kk from an accumulator, rounded to bf16
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[R],
                                       int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

#define FA_R8(b)                                                          \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 32, fp32) (+)= A (64 x 16, K-major, shared) @ B (16 x 32,
// K-major, shared); the product overwrites d when scale_d == 0
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15} "
      ", %16, %17, p, 1, 1, 0, 0;\n}"
      : FA_R8(0), FA_R8(8)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 16, K-major, shared) @ B (16 x 64,
// K-major, shared); the product overwrites d when scale_d == 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31} "
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : FA_R8(0), FA_R8(8), FA_R8(16), FA_R8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16 bf16 in registers, `a_frag`'s layout)
// @ B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31} "
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : FA_R8(0), FA_R8(8), FA_R8(16), FA_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16 bf16 in registers, `a_frag`'s layout)
// @ B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : FA_R8(0), FA_R8(8), FA_R8(16), FA_R8(24),
        FA_R8(32), FA_R8(40), FA_R8(48), FA_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16 bf16 in registers, `a_frag`'s layout)
// @ B (16 x 256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127} "
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : FA_R8(0), FA_R8(8), FA_R8(16), FA_R8(24),
        FA_R8(32), FA_R8(40), FA_R8(48), FA_R8(56),
        FA_R8(64), FA_R8(72), FA_R8(80), FA_R8(88),
        FA_R8(96), FA_R8(104), FA_R8(112), FA_R8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef FA_R8

// d (64 x HD) += A (registers) @ B (16 x HD, MN-major), HD 64, 128 or 256
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, desc_b);
  if constexpr (HD == 256) wgmma_rs_n256(d, a, desc_b);
}

// the 1024-byte boundary at or after p (the 128-byte swizzle's atoms)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

}  // namespace sm90

// (hd, S, BH) bf16 tensor map with boxes of 64 x rows x 1, 128-byte
// swizzle, zeros out of bounds; false if cuTensorMapEncodeTiled refuses it
inline bool encode_bhsd_map(CUtensorMap* map, const void* base, int BH, int S,
                            int hd, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(S) * hd * 2};
  const cuuint32_t box[3] = {sm90::ATOM, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
