// The bf16 tensor-core tile of B1 (matmul.cu, B in bf16) and of B5
// (quantized_matmul.cu, B in int8): one block computes a 128 x 128 output
// tile of A (bf16) @ B over its split's K slice in fp32 accumulators and
// hands each element to the caller's epilogue.
//
// 64-deep K steps through a ring of shared-memory stages.  A producer
// warpgroup fills the ring with TMA (128-byte swizzle, completion on
// mbarriers); two consumer warpgroups, 64 rows each, run wgmma m64n128k16
// with fp32 accumulators in registers.  B is read MN-major (weights,
// sbn == 1) or K-major (the tied head's embed.T, sbk == 1) through
// wgmma's transpose bit, without a copy.  Rows past M arrive as TMA's zero
// fill; a warpgroup whose rows all lie past M skips its products.  Where a
// stride or a base is not a 16-byte multiple, the producer warpgroup
// copies each stage itself into the bytes TMA would write (the masked
// path): the products read identical tiles whichever path filled them.
//
// int8 B (MN-major only).  TMA brings each 64 x 128 int8 tile unswizzled
// into the second half of the stage's bf16 tile; four more producer warps
// load all of it into registers, sync, and write it back widened over the
// whole tile, in the same swizzled MN-major layout as bf16 B, then arrive
// on the stage's `wide` barrier.  A stage stays 32 KiB (a separate raw
// slot would make it 40 and the ring 5 deep).  TMA's A box covers only
// the rows M can fill (a_rows), so a decode stage moves 1 KiB of A rather
// than 16.  The widening is exact (every int8 value is a bf16 integer) and
// so are bf16 x bf16 products in fp32: B5's function does not change.
#pragma once

#include <type_traits>

#include "matmul_sm90.cuh"

namespace wgmma_tile {

constexpr int BM = 128, BN = 128;
constexpr int BK = 64;  // 64 bf16 = one 128-byte swizzled row
constexpr int CONSUMERS = 256;  // warpgroups 0, 1; then the producers
constexpr int TILE_A = BM * BK * 2;  // 16 KiB
constexpr int TILE_B = BK * BN * 2;  // 16 KiB of bf16, as wgmma reads it

template <typename TB>
struct Ring {  // bf16 B: TMA writes the tile wgmma reads
  static constexpr bool WIDEN = false;
  static constexpr int PRODUCERS = 128;  // one issues TMA
  static constexpr int STAGES = 6;
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr int BARRIERS = 2;  // full, empty
};
template <>
struct Ring<int8_t> {  // int8 B: TMA's raw tile, widened into the bf16 one
  static constexpr bool WIDEN = true;
  static constexpr int PRODUCERS = 160;  // one TMA warp, 4 widening warps
  static constexpr int STAGES = 6;
  static constexpr int RAW = BK * BN;  // 8 KiB, at TILE_B - RAW in the tile
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr int BARRIERS = 3;  // full, empty, wide
};

template <typename TB>
constexpr int threads() {
  return CONSUMERS + Ring<TB>::PRODUCERS;
}

template <typename TB>
constexpr int smem_bytes() {
  return 1024 + Ring<TB>::STAGES * Ring<TB>::STAGE +
         Ring<TB>::BARRIERS * Ring<TB>::STAGES * 8;
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16(static_cast<float>(x));  // exact
}

// bytes i and i + 1 of u (int8 values plus 128, as unsigned bytes) as two
// bf16: each byte becomes the low mantissa byte of the fp32 2^23 + byte,
// minus 2^23 + 128 gives the int8 value exactly, and its fp32 upper half
// is its bf16 (|x| <= 128 has at most 8 significant bits).  Byte permutes
// and adds, no int-to-float conversion.
__device__ __forceinline__ uint32_t widen2(uint32_t u, uint32_t i) {
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651u + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// 8 int8 (n, n + 1, ..., n + 7 of one k) as 8 bf16
__device__ __forceinline__ uint4 widen8(uint2 q) {
  const uint32_t u0 = q.x ^ 0x80808080u, u1 = q.y ^ 0x80808080u;
  return make_uint4(widen2(u0, 0), widen2(u0, 2), widen2(u1, 0),
                    widen2(u1, 2));
}

// the masked path's copy of one stage, by `threads` threads: the bytes TMA
// (and, for int8 B, the widening) would write
template <bool B_KMAJOR, int THREADS, typename TB>
__device__ void fill_stage_masked(uint8_t* sa, uint8_t* sb,
                                  const __nv_bfloat16* __restrict__ a,
                                  const TB* __restrict__ b, int M, int N,
                                  int K, long long lda, long long sbk,
                                  long long sbn, int m0, int n0, int k0,
                                  int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < BM * BK; e += THREADS) {
    const int r = e / BK, k = e % BK;
    const int gm = m0 + r, gk = k0 + k;
    const __nv_bfloat16 v = (gm < M && gk < K) ? a[gm * lda + gk] : zero;
    *reinterpret_cast<__nv_bfloat16*>(sa + sm90::swizzle128(r, 2 * k)) = v;
  }
  for (int e = tid; e < BK * BN; e += THREADS) {
    int k, n;
    uint32_t off;
    if (B_KMAJOR) {  // rows of n, 64 k each
      n = e / BK;
      k = e % BK;
      off = sm90::swizzle128(n, 2 * k);
    } else {  // two boxes of 64 n, rows of k
      k = e / BN;
      n = e % BN;
      off = (n / 64) * (BK * 128) + sm90::swizzle128(k, 2 * (n % 64));
    }
    const int gk = k0 + k, gn = n0 + n;
    const __nv_bfloat16 v =
        (gk < K && gn < N) ? to_bf16(b[gk * sbk + gn * sbn]) : zero;
    *reinterpret_cast<__nv_bfloat16*>(sb + off) = v;
  }
}

constexpr int WIDENERS = 128;
// the raw int8 tile (64 rows of k x 128 n, unswizzled, in the second half
// of sb) widened over all of sb, the bf16 tile's two swizzled boxes of 64
// n, by WIDENERS threads (named barrier 2): each loads 8 chunks of 8
// values, and once every chunk is in registers all of them write
__device__ __forceinline__ void widen_stage(uint8_t* sb, int tid) {
  constexpr int PER = BK * BN / 8 / WIDENERS;
  const uint8_t* raw = sb + TILE_B - Ring<int8_t>::RAW;
  uint2 q[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * WIDENERS;
    q[i] = *reinterpret_cast<const uint2*>(raw + 8 * c);
  }
  sm90::named_sync(2, WIDENERS);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * WIDENERS;
    const int k = c / 16, j = c % 16;  // n = 8 j .. 8 j + 7
    *reinterpret_cast<uint4*>(sb + (j / 8) * (BK * 128) +
                              sm90::swizzle128(k, 16 * (j % 8))) =
        widen8(q[i]);
  }
}

// The block's tile: output tile (blockIdx.x, blockIdx.y), K slice of
// `rank`, `slice_steps` K steps of 64 a rank.  epi(gm, gn, v) is called
// once for each element of the tile inside M x N.  For int8 B, TMA's A box
// holds `a_rows` rows (tm_a's box; BM for bf16 B) and the rest of each A
// tile is zeroed once, before the ring starts.  GROUPED tiles read group
// `grp` of stacked operands: TMA through 3-D maps at plane `grp`, the
// masked path through `a` and `b`, which the caller points at the group.
template <typename TB, bool B_KMAJOR, bool GROUPED = false, typename Epilogue>
__device__ __forceinline__ void tile(const CUtensorMap& tm_a,
                                     const CUtensorMap& tm_b,
                                     const __nv_bfloat16* __restrict__ a,
                                     const TB* __restrict__ b, int M, int N,
                                     int K, long long lda, long long sbk,
                                     long long sbn, int slice_steps,
                                     int use_tma, int a_rows, int rank,
                                     int grp, Epilogue epi) {
  using R = Ring<TB>;
  static_assert(!(R::WIDEN && B_KMAJOR), "int8 B is MN-major");
  static_assert(!(R::WIDEN && GROUPED), "int8 B is not grouped");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  uint64_t* wide = empty + R::STAGES;  // int8 B only

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // consumers: 0, 1
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int steps = (K + BK - 1) / BK;
  const int t0 = rank * slice_steps;
  const int nt = max(0, min(steps, t0 + slice_steps) - t0);

  if (R::WIDEN && use_tma && a_rows < BM) {  // A's rows past the box
    for (int s = 0; s < R::STAGES; ++s)
      for (int e = a_rows * 8 + tid; e < BM * 8;
           e += CONSUMERS + R::PRODUCERS)
        reinterpret_cast<uint4*>(smem + s * R::STAGE)[e] =
            make_uint4(0, 0, 0, 0);
    sm90::fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
      if (R::WIDEN) sm90::mbar_init(&wide[s], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: one thread issues the TMA loads (for int8 B, the
    // warps after the first widen each stage), or all copy the stage
    // themselves on the masked path
    const int ptid = tid - CONSUMERS;
    if (R::WIDEN && use_tma && ptid >= 32) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % R::STAGES;
        uint8_t* sb = smem + s * R::STAGE + TILE_A;
        sm90::mbar_wait(&full[s], (t / R::STAGES) & 1);
        widen_stage(sb, ptid - 32);
        sm90::fence_proxy_async();
        sm90::named_sync(2, WIDENERS);
        if (ptid == 32) sm90::mbar_arrive(&wide[s]);
      }
      return;
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % R::STAGES;
      const uint32_t parity = ((t / R::STAGES) & 1) ^ 1;
      uint8_t* sa = smem + s * R::STAGE;
      uint8_t* sb = sa + TILE_A;
      const int k0 = (t0 + t) * BK;
      if (use_tma) {
        if (ptid == 0) {
          sm90::mbar_wait(&empty[s], parity);
          if constexpr (R::WIDEN) {
            sm90::mbar_arrive_expect_tx(&full[s], a_rows * 128 + R::RAW);
            sm90::tma_load_2d(sa, &tm_a, &full[s], k0, m0);
            sm90::tma_load_2d(sb + TILE_B - R::RAW, &tm_b, &full[s], n0, k0);
          } else {
            auto load = [&](void* dst, const CUtensorMap* map, int c0,
                            int c1) {
              if constexpr (GROUPED)
                sm90::tma_load_3d(dst, map, &full[s], c0, c1, grp);
              else
                sm90::tma_load_2d(dst, map, &full[s], c0, c1);
            };
            sm90::mbar_arrive_expect_tx(&full[s], R::STAGE);
            load(sa, &tm_a, k0, m0);
            if (B_KMAJOR) {
              load(sb, &tm_b, k0, n0);
            } else {
              load(sb, &tm_b, n0, k0);
              load(sb + BK * 128, &tm_b, n0 + 64, k0);
            }
          }
        }
      } else {
        sm90::mbar_wait(&empty[s], parity);
        fill_stage_masked<B_KMAJOR, R::PRODUCERS>(sa, sb, a, b, M, N, K, lda,
                                                  sbk, sbn, m0, n0, k0, ptid);
        sm90::fence_proxy_async();
        sm90::named_sync(1, R::PRODUCERS);
        if (ptid == 0) {
          sm90::mbar_arrive(&full[s]);
          if (R::WIDEN) sm90::mbar_arrive(&wide[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64)
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool active = m0 + 64 * wg < M;
  for (int t = 0; t < nt; ++t) {
    const int s = t % R::STAGES;
    sm90::mbar_wait(&full[s], (t / R::STAGES) & 1);
    if (R::WIDEN) sm90::mbar_wait(&wide[s], (t / R::STAGES) & 1);
    if (active) {
      const uint8_t* sa = smem + s * R::STAGE + wg * 64 * 128;
      const uint8_t* sb = smem + s * R::STAGE + TILE_A;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sm90::wgmma_desc(sa + kk * 32, 16, 1024);
        if (B_KMAJOR) {
          sm90::wgmma_m64n128k16<0>(
              acc, da, sm90::wgmma_desc(sb + kk * 32, 16, 1024));
        } else {
          sm90::wgmma_m64n128k16<1>(
              acc, da, sm90::wgmma_desc(sb + kk * 16 * 128, BK * 128, 1024));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_acc(acc);
    }
    if (tid % 32 == 0) sm90::mbar_arrive(&empty[s]);
  }
  if (!active) return;

  // Fragment of m64nNk16: register i of lane l in warp w holds row
  // 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int gm = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int gn = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (gm < M && gn < N) epi(gm, gn, acc[i]);
  }
}

}  // namespace wgmma_tile
