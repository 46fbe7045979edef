// C = A @ B with fp32 accumulation: the port of the TPU kernel
// src/repro/kernels/matmul/matmul.py::matmul_pallas (_matmul_kernel).
//
// What bounds it on the H100.  Serving runs M = 4 at decode and 64..256 at
// prefill, training M = 1024 (and 128 per cross-entropy chunk), with K and
// N in {256, 2048, 16384, 256000}.  At M = 4 every weight byte feeds 4
// operations in bf16, far below the card's ~295 per byte: decode GEMMs are
// bound by reading B once (2048 x 16384 bf16 = 64 MiB -> 20 us at
// 3.35 TB/s), so they need enough loads in flight on enough SMs.  At
// M >= 256 they are bound by the tensor cores (bf16) or the FMA units (the
// fp32 gradient GEMMs of training, which keep full fp32: no TF32).
//
// What this design does about it.
// - bf16: 128 x 128 output tiles, 64-deep K steps through a ring of 6
//   shared-memory stages.  A producer warpgroup fills the ring with TMA
//   (128-byte swizzle, completion on mbarriers); two consumer warpgroups,
//   64 rows each, run wgmma m64n128k16 with fp32 accumulators in
//   registers.  B is read MN-major (weights, sbn == 1) or K-major (the tied
//   head's embed.T, sbk == 1) through wgmma's transpose bit, without a
//   copy.  Rows past M arrive as TMA's zero fill; a warpgroup whose rows
//   all lie past M skips its products.  The tile is matmul_wgmma.cuh's,
//   which B5 (quantized_matmul.cu) runs with int8 B.
// - fp32: 128 x 128 tiles through 3 cp.async stages (16-byte copies along
//   whichever axis of B is contiguous), 256 threads each holding 8 x 8 FMA
//   accumulators fed by float4 shared-memory reads; K steps of 32 for a
//   K-major B, 16 for an MN-major one (the faster of each on the card).
// - Split K: when N has too few tiles for the card, `split` blocks take
//   consecutive K slices of one output tile and write fp32 partial tiles
//   to a scratch tensor; a second kernel sums them in rank order.  No
//   atomics.  The split is chosen by the wrapper from (K, N, dtype) only
//   (grouped: (G, K, N, dtype)).
//   (Blocks of one cluster summing through distributed shared memory were
//   measured slower: clusters of 8 one-block-per-SM blocks did not all
//   run at once.)
// - Grouped: (G, M, K) @ (G, K, N) -> (G, M, N), the MoE experts' form
//   (repro/kernels/matmul/ops.py::_grouped_kernel_lowering, per-expert
//   matmul_pallas calls).  One launch covers every group: blockIdx.z is
//   group x split + rank, each group's tiles are the dense route's tiles
//   over that group's operands.  bf16 reads them through 3-D tensor maps,
//   boxes one group deep, so a tile past a group's M or K rows gets TMA's
//   zeros and never the next group's data; fp32 offsets its pointers.
// - Grouped at a short contraction: the MoE training backward.  Under the
//   bf16 policy the JAX VJP (ops.py:265, _grouped_vjp_bwd, beside the
//   forward's lowering at ops.py:250) upcasts bf16 x, w and g, runs fp32
//   GEMMs and rounds each gradient to bf16 once.  A product of two bf16
//   values is exact in fp32, so bf16 operands with fp32 accumulation give
//   the same function up to the order of the fp32 sums; the wrapper
//   (dispatch.py) passes them as they are.  Both GEMMs are bound by
//   bytes: at C = 88, G = 60, dx = g @ w^T reads w's 346 MB and dw = x^T @
//   g writes as many, 0.1142 ms each against 0.0307 ms of bf16
//   operations.  dw contracts over the capacity (C = 8, 24, 88: one or
//   two K steps), so its epilogue and the tile's fill and drain are the
//   whole kernel; dx contracts over K = 1408 or 2048 into one row tile a
//   group, its tiles' fill and epilogue still a large share.
//   The short tile (matmul_bf16_grouped_short_kernel) takes the two
//   layouts that only the backward sends: both operands MN-major (dw: x^T
//   read M-major, g N-major) or both K-major (dx: g, and w^T read through
//   its strides).  It is one persistent block an SM walking (group, row
//   tile, column tile) triples through a ring of 4 stages, so the next
//   tile's TMA loads are in flight under this tile's products and
//   epilogue; each warp stages its 16 rows of the tile as bf16 in shared
//   memory (two buffers) and stores them with TMA, 128-byte rows in place
//   of 2-byte stores; x^T is read through wgmma's transpose bit, so dw
//   needs no transposed copy of x (21.6 MB at C = 88); TMA's zeros fill K
//   past C (88 is not a multiple of 64).  Its products are the tile
//   route's (m64n128k16 over 64-deep K steps in order), no split, no
//   atomics.  The forward (x K-major, w N-major) stays on the tile route,
//   which serves C = 8 and 24 a little faster.
//
// A row's bits depend on nothing but its own inputs: the tile shape, the
// K order and the split are fixed by (K, N, dtype) (grouped: and the
// operands' layout, which picks the short tile), rows past M are zeros,
// and both bf16 paths (TMA, and the masked path for strides that are not
// 16-byte multiples) write the same swizzled tiles for the same products.
#include <algorithm>

#include "matmul_wgmma.cuh"

namespace {

using sm90::aligned16;
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::encode_map;
using sm90::encode_map_3d;
using sm90::launch;

constexpr int BM = 128, BN = 128;
// the K unit of a split's slice (kernels/matmul/matmul.py's TILE_K)
constexpr int SLICE_K32 = 32;

// the block's output: straight to c, or (wherever there is a scratch) its
// rank's partial to scratch, where a rank's partials span `rank_rows` rows
// (every group's M); a split of 1 with a scratch writes the fp32 sums
// themselves (repro_matmul_f32out)
template <typename TC>
__device__ __forceinline__ void put(TC* __restrict__ c,
                                    float* __restrict__ scratch, int split,
                                    int rank, long long rank_rows, int N,
                                    int gm, int gn, float v) {
  if (scratch == nullptr)
    c[static_cast<long long>(gm) * N + gn] = from_f32<TC>(v);
  else
    scratch[(rank * rank_rows + gm) * N + gn] = v;
}

// the group and the K rank of this block (blockIdx.z = group x split +
// rank), and its output and partials moved to the group's
struct Place {
  int grp, rank;
  long long offset;  // of the group's (M, N) output and partials
};
__device__ __forceinline__ Place place(int M, int N, int split) {
  const int grp = blockIdx.z / split;
  return {grp, static_cast<int>(blockIdx.z % split),
          static_cast<long long>(grp) * M * N};
}

// ------------------------------------------------------------------ bf16
constexpr int BK16 = wgmma_tile::BK;
constexpr int THREADS16 = wgmma_tile::threads<__nv_bfloat16>();
constexpr int SMEM16 = wgmma_tile::smem_bytes<__nv_bfloat16>();

template <bool B_KMAJOR, bool GROUPED>
__global__ void __launch_bounds__(THREADS16, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ c,
                         float* __restrict__ scratch, int G, int M, int N,
                         int K, long long lda, long long sag, long long sbg,
                         long long sbk, long long sbn, int split,
                         int slice_steps, int use_tma) {
  const Place at = place(M, N, split);
  __nv_bfloat16* cg = c + at.offset;
  float* sg = split > 1 ? scratch + at.offset : scratch;
  const long long rank_rows = static_cast<long long>(G) * M;
  wgmma_tile::tile<__nv_bfloat16, B_KMAJOR, GROUPED>(
      tm_a, tm_b, a + at.grp * sag, b + at.grp * sbg, M, N, K, lda, sbk, sbn,
      slice_steps, use_tma, BM, at.rank, at.grp,
      [&](int gm, int gn, float v) {
        put(cg, sg, split, at.rank, rank_rows, N, gm, gn, v);
      });
}

// ------------------------------------------------------- bf16, short K
// The grouped route's short tile: B1's products (wgmma m64n128k16 over
// 64-deep K steps in order, so the tile route's bits in either layout)
// in a persistent block that walks the (group, row tile, column tile)
// triples, its next tiles' TMA loads in flight under this tile's
// products and epilogue.
namespace short_tile {
constexpr int STAGES = 4;  // two tiles of two K steps each
constexpr int STAGE = wgmma_tile::TILE_A + wgmma_tile::TILE_B;  // 32 KiB
constexpr int CONSUMERS = wgmma_tile::CONSUMERS;  // 2 warpgroups
constexpr int PRODUCERS = 128;  // one issues TMA; all fill the masked path
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int HALF = 16 * 128;  // a warp's 16 rows x 64 columns of bf16
constexpr int WARP_OUT = 2 * HALF;  // its 16 x 128 rows, two halves
constexpr int OUT = CONSUMERS / 32 * WARP_OUT;  // one tile's output
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * OUT + 2 * STAGES * 8;
}  // namespace short_tile

// one operand's 64-deep K step, 128 rows (M or N): as TMA writes it from
// the operand's map, K-major (one box of 128 rows of 64 k, each a 128-byte
// swizzled row) or MN-major (MN: two boxes of 64 rows of k, each row 64
// elements of the rows' axis)
template <bool MN>
__device__ __forceinline__ void load_operand(uint8_t* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int r0, int k0,
                                             int grp) {
  if (MN) {
    sm90::tma_load_3d(dst, map, bar, r0, k0, grp);
    sm90::tma_load_3d(dst + BK16 * 128, map, bar, r0 + 64, k0, grp);
  } else {
    sm90::tma_load_3d(dst, map, bar, k0, r0, grp);
  }
}

// the same step written by the 128 producer threads, where an operand's
// base or rows are not 16-byte aligned: element (r, k) is src[r s_row +
// k s_k]; zeros past `rows` and K
template <bool MN>
__device__ void fill_operand_masked(uint8_t* dst,
                                    const __nv_bfloat16* __restrict__ src,
                                    int rows, int K, long long s_row,
                                    long long s_k, int r0, int k0, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < BM * BK16; e += short_tile::PRODUCERS) {
    int r, k;
    uint32_t off;
    if (MN) {
      k = e / BM;
      r = e % BM;
      off = (r / 64) * (BK16 * 128) + sm90::swizzle128(k, 2 * (r % 64));
    } else {
      r = e / BK16;
      k = e % BK16;
      off = sm90::swizzle128(r, 2 * k);
    }
    const int gr = r0 + r, gk = k0 + k;
    *reinterpret_cast<__nv_bfloat16*>(dst + off) =
        (gr < rows && gk < K) ? src[gr * s_row + gk * s_k] : zero;
  }
}

// A (G, M, K) @ B (G, K, N) -> c (G, M, N) in bf16, fp32 accumulation,
// without a split, both operands MN-major (MN: dw = x^T @ g, A's rows of
// K lda apart with a unit M stride, read through wgmma's transpose bit,
// B's rows of K sbk apart) or both K-major (dx = g @ w^T, A's rows lda
// apart, B's sbn apart).  Each consumer warp rounds its 16 rows of the
// tile to bf16 into a swizzled staging buffer (two per warp, alternating
// tiles) and stores them with TMA (store_tma), or, where c's rows are not
// 16-byte multiples, element by element.
template <bool MN>
__global__ void __launch_bounds__(short_tile::THREADS, 1)
matmul_bf16_grouped_short_kernel(const __grid_constant__ CUtensorMap tm_a,
                                 const __grid_constant__ CUtensorMap tm_b,
                                 const __grid_constant__ CUtensorMap tm_c,
                                 const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ b,
                                 __nv_bfloat16* __restrict__ c, int G, int M,
                                 int N, int K, long long lda, long long sag,
                                 long long sbg, long long sbk, long long sbn,
                                 int use_tma, int store_tma) {
  using namespace short_tile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * OUT);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = (M + BM - 1) / BM * tiles_n;
  const int tiles = G * per_group;
  const int steps = (K + BK16 - 1) / BK16;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of each warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: the K steps of this block's tiles, in order, through
    // the ring (one thread issues TMA, or all copy on the masked path)
    const int ptid = tid - CONSUMERS;
    if (use_tma && ptid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int grp = tile / per_group, r = tile % per_group;
      const int m0 = r / tiles_n * BM, n0 = r % tiles_n * BN;
      for (int t = 0; t < steps; ++t, ++it) {
        const int s = it % STAGES;
        uint8_t* sa = smem + s * STAGE;
        uint8_t* sb = sa + wgmma_tile::TILE_A;
        const int k0 = t * BK16;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        if (use_tma) {
          sm90::mbar_arrive_expect_tx(&full[s], STAGE);
          load_operand<MN>(sa, &tm_a, &full[s], m0, k0, grp);
          load_operand<MN>(sb, &tm_b, &full[s], n0, k0, grp);
        } else {
          fill_operand_masked<MN>(sa, a + grp * sag, M, K, MN ? 1 : lda,
                                  MN ? lda : 1, m0, k0, ptid);
          fill_operand_masked<MN>(sb, b + grp * sbg, N, K, sbn, sbk, n0, k0,
                                  ptid);
          sm90::fence_proxy_async();
          sm90::named_sync(1, PRODUCERS);
          if (ptid == 0) sm90::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile,
  // warp w of it rows [16 w, 16 w + 16) of those
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  uint8_t* staged = out + (tid / 32) * WARP_OUT;
  int it = 0, parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int grp = tile / per_group, r = tile % per_group;
    const int m0 = r / tiles_n * BM, n0 = r % tiles_n * BN;
    const bool active = m0 + 64 * wg < M;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < steps; ++t, ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      if (active) {
        const uint8_t* sa = smem + s * STAGE + wg * (BK16 * 128);
        const uint8_t* sb = smem + s * STAGE + wgmma_tile::TILE_A;
        sm90::fence_acc(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK16 / 16; ++kk) {
          const uint64_t da =
              MN ? sm90::wgmma_desc(sa + kk * 16 * 128, BK16 * 128, 1024)
                 : sm90::wgmma_desc(sa + kk * 32, 16, 1024);
          const uint64_t db =
              MN ? sm90::wgmma_desc(sb + kk * 16 * 128, BK16 * 128, 1024)
                 : sm90::wgmma_desc(sb + kk * 32, 16, 1024);
          sm90::wgmma_m64n128k16<MN, MN>(acc, da, db);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_acc(acc);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // Fragment of m64nNk16: register i of lane l holds row l / 4 +
    // 8 ((i / 2) % 2) of the warp's 16, column 8 (i / 4) + 2 (l % 4) +
    // i % 2.  A pair (i, i + 1) is one 4-byte store into the staging
    // buffer; the 8 rows a store instruction reaches sit in 8 distinct
    // 16-byte chunks of the swizzle, so the stores meet no bank conflict.
    const int row0 = m0 + 64 * wg + 16 * warp;
    if (store_tma) {
      uint8_t* st = staged + parity * OUT;
      if (lane == 0) sm90::bulk_wait_read<1>();  // this buffer's last store
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = lane / 4 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(
            st + (col / 64) * HALF + sm90::swizzle128(row, 2 * (col % 64))) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (row0 < M) {
          sm90::tma_store_3d(&tm_c, st, n0, row0, grp);
          if (n0 + 64 < N) sm90::tma_store_3d(&tm_c, st + HALF, n0 + 64, row0,
                                              grp);
        }
        sm90::bulk_commit();  // one group a tile, empty or not
      }
      parity ^= 1;
    } else if (active) {
      __nv_bfloat16* cg = c + static_cast<long long>(grp) * M * N;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int gm = row0 + lane / 4 + 8 * ((i / 2) % 2);
        const int gn = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (gm < M && gn < N)
          cg[static_cast<long long>(gm) * N + gn] =
              from_f32<__nv_bfloat16>(acc[i]);
      }
    }
  }
  if (store_tma && lane == 0) sm90::bulk_wait<0>();  // before smem goes
}

// ------------------------------------------------------------------ fp32
constexpr int STAGES32 = 3;
constexpr int THREADS32 = 256;

// the tile of one B layout: K steps of BK, rows of BK floats padded by 4
// so that float4 reads of neighbouring rows hit distinct banks
template <bool B_KMAJOR>
struct Tile32 {
  static constexpr int BK = B_KMAJOR ? 32 : 16;
  static constexpr int LD = BK + 4;
  static constexpr int A = BM * LD;  // floats: As[m][k]
  static constexpr int B = BN * LD;  // Bs[n][k], or Bs[k][n] in BK * BN
  static constexpr int STAGE = A + B;
  static constexpr int SMEM = STAGES32 * STAGE * 4;
};

// one stage: A as As[m][k], B as Bs[k][n] (MN-major) or Bs[n][k] (K-major);
// 16-byte copies when ALIGNED, else 4-byte ones, zeros past the edges
template <bool B_KMAJOR, bool ALIGNED>
__device__ __forceinline__ void load_stage32(
    float* As, float* Bs, const float* __restrict__ a,
    const float* __restrict__ b, int M, int N, int K, long long lda,
    long long sbk, long long sbn, int m0, int n0, int k0, int tid) {
  using T = Tile32<B_KMAJOR>;
  constexpr int CH = T::BK / 4;  // 16-byte chunks along K in a row
#pragma unroll
  for (int h = 0; h < BM * CH / THREADS32; ++h) {
    const int e = tid + h * THREADS32;
    {  // A: 128 rows of m x CH chunks of k
      const int r = e / CH, k = 4 * (e % CH);
      const int gm = m0 + r, gk = k0 + k;
      float* dst = As + r * T::LD + k;
      const float* src = a + (gm < M ? gm * lda : 0);
      if (ALIGNED) {
        const int n_ok = (gm < M) ? max(0, min(4, K - gk)) : 0;
        cp_async16(dst, n_ok ? src + gk : a, 4 * n_ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = gm < M && gk + q < K;
          cp_async4(dst + q, ok ? src + gk + q : a, ok ? 4 : 0);
        }
      }
    }
    if (B_KMAJOR) {  // 128 rows of n x CH chunks of k
      const int n = e / CH, k = 4 * (e % CH);
      const int gn = n0 + n, gk = k0 + k;
      float* dst = Bs + n * T::LD + k;
      const float* src = b + (gn < N ? gn * sbn : 0);
      if (ALIGNED) {
        const int n_ok = (gn < N) ? max(0, min(4, K - gk)) : 0;
        cp_async16(dst, n_ok ? src + gk : b, 4 * n_ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = gn < N && gk + q < K;
          cp_async4(dst + q, ok ? src + (gk + q) * sbk : b, ok ? 4 : 0);
        }
      }
    } else {  // BK rows of k x 32 chunks of n
      const int k = e / 32, n = 4 * (e % 32);
      const int gk = k0 + k, gn = n0 + n;
      float* dst = Bs + k * BN + n;
      const float* src = b + (gk < K ? gk * sbk : 0);
      if (ALIGNED) {
        const int n_ok = (gk < K) ? max(0, min(4, N - gn)) : 0;
        cp_async16(dst, n_ok ? src + gn : b, 4 * n_ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = gk < K && gn + q < N;
          cp_async4(dst + q, ok ? src + (gn + q) * sbn : b, ok ? 4 : 0);
        }
      }
    }
  }
}

// GROUPED names the grouped route's instantiations apart from the dense
// route's (the arithmetic is the same), so a profile can tell them apart
template <bool GROUPED, bool B_KMAJOR, bool ALIGNED>
__global__ void __launch_bounds__(THREADS32, 1)
matmul_f32_simt_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ c,
                       float* __restrict__ scratch, int G, int M, int N,
                       int K, long long lda, long long sag, long long sbg,
                       long long sbk, long long sbn, int split,
                       int slice_steps) {
  using T = Tile32<B_KMAJOR>;
  extern __shared__ float4 smem32_raw[];
  float* smem = reinterpret_cast<float*>(smem32_raw);
  const int tid = threadIdx.x;
  // rows rbase + rstep i; columns cbase + cstep j (K-major B, a row of
  // Bs per column) or two float4 runs cbase + crun (j / 4) + j % 4
  const int tx = tid % 16, ty = tid / 16;
  const int rbase = ty, rstep = 16;
  const int cbase = B_KMAJOR ? tx : 4 * tx;
  const int cstep = 16, crun = 64;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const Place at = place(M, N, split);
  const int rank = at.rank;
  const long long rank_rows = static_cast<long long>(G) * M;
  a += at.grp * sag;
  b += at.grp * sbg;
  c += at.offset;
  if (split > 1) scratch += at.offset;
  const int kb = rank * slice_steps * SLICE_K32;
  const int ke = min(K, kb + slice_steps * SLICE_K32);
  const int nt = max(0, (ke - kb + T::BK - 1) / T::BK);
  const bool live = m0 + rbase < M;  // else this thread's rows all lie past M

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage_a = [&](int s) { return smem + s * T::STAGE; };
  auto stage_b = [&](int s) { return smem + s * T::STAGE + T::A; };
#pragma unroll
  for (int s = 0; s < STAGES32 - 1; ++s) {
    if (s < nt)
      load_stage32<B_KMAJOR, ALIGNED>(stage_a(s), stage_b(s), a, b, M, N, K,
                                      lda, sbk, sbn, m0, n0, kb + s * T::BK,
                                      tid);
    sm90::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    sm90::cp_async_wait<STAGES32 - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free again
    const int tn = t + STAGES32 - 1;
    if (tn < nt)
      load_stage32<B_KMAJOR, ALIGNED>(
          stage_a(tn % STAGES32), stage_b(tn % STAGES32), a, b, M, N, K, lda,
          sbk, sbn, m0, n0, kb + tn * T::BK, tid);
    sm90::cp_async_commit();
    if (!live) continue;
    const float* As = stage_a(t % STAGES32);
    const float* Bs = stage_b(t % STAGES32);
#pragma unroll
    for (int k4 = 0; k4 < T::BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            As + (rbase + rstep * i) * T::LD + k4);
      if (B_KMAJOR) {
        float4 bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(
              Bs + (cbase + cstep * j) * T::LD + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = reinterpret_cast<const float*>(&av[i])[kk];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(ai, reinterpret_cast<const float*>(&bv[j])[kk],
                               acc[i][j]);
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = Bs + (k4 + kk) * BN + cbase;
          const float4 b0 = *reinterpret_cast<const float4*>(brow);
          const float4 b1 = *reinterpret_cast<const float4*>(brow + crun);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = reinterpret_cast<const float*>(&av[i])[kk];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + rbase + rstep * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (B_KMAJOR ? cbase + cstep * j
                                    : cbase + crun * (j / 4) + j % 4);
      if (gm < M && gn < N)
        put(c, scratch, split, rank, rank_rows, N, gm, gn, acc[i][j]);
    }
  }
}

// c = the sum of the split partial products in scratch, in rank order
template <typename TC>
__global__ void __launch_bounds__(256)
matmul_splitk_reduce_kernel(const float* __restrict__ scratch,
                            TC* __restrict__ c, long long mn, int split) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < mn;
       i += gridDim.x * 256ll) {
    float v = scratch[i];
    for (int q = 1; q < split; ++q) v += scratch[q * mn + i];
    c[i] = from_f32<TC>(v);
  }
}

// ------------------------------------------------------------------ host
// the split's second pass, where it takes one: c's `rows` (every group's)
// rows of N
template <typename TC>
int reduce_splits(const float* scratch, TC* c, long long rows, int N,
                  int split, cudaStream_t stream) {
  if (split == 1) return 0;
  const long long mn = rows * N;
  const long long blocks = std::min<long long>((mn + 255) / 256, 132 * 8);
  matmul_splitk_reduce_kernel<TC><<<static_cast<int>(blocks), 256, 0,
                                    stream>>>(scratch, c, mn, split);
  return static_cast<int>(cudaGetLastError());
}

// G groups of a (M, K) @ b (K, N) -> c (M, N): a's groups `sag` elements
// apart, b's `sbg`, c's M x N (G = 1 and `grouped` false for the dense
// route).  a's rows are lda apart: rows of M with a unit K stride, or
// (a_mn, the short tile only) rows of K with a unit M stride.
struct Problem {
  int G, M, N, K;
  long long lda, sag, sbg, sbk, sbn;
  int split, slice_steps;
  bool grouped, a_mn = false, short_k = false;
};

// one operand's 3-D map, boxes one group deep: K-major rows of `rows` (M
// or N) with K inner, boxes of 64 k x 128 rows; or MN-major rows of K with
// the rows' axis inner, boxes of 64 x 64 k; rows `row` elements apart,
// groups `plane`
bool encode_operand(CUtensorMap* map, const __nv_bfloat16* base, bool kmajor,
                    int rows, int K, long long row, long long plane, int G) {
  const uint64_t inner = kmajor ? K : rows, outer = kmajor ? rows : K;
  // a lone group's plane stride is its own extent (never stepped over)
  if (G == 1) plane = row * outer;
  return encode_map_3d(map, base, inner, outer, G, 2 * row, 2 * plane, BK16,
                       kmajor ? BM : 64);
}

// the tensor maps of the bf16 routes, 2-D (dense) or 3-D, one group deep
// (grouped); false where cuTensorMapEncodeTiled refuses one
bool encode_maps(CUtensorMap* tm_a, CUtensorMap* tm_b,
                 const __nv_bfloat16* a, const __nv_bfloat16* b,
                 const Problem& p) {
  const bool kmajor = p.sbn != 1;
  const long long b_row = kmajor ? p.sbn : p.sbk;
  if (p.grouped)
    return encode_operand(tm_a, a, !p.a_mn, p.M, p.K, p.lda, p.sag, p.G) &&
           encode_operand(tm_b, b, kmajor, p.N, p.K, b_row, p.sbg, p.G);
  // B's map: rows of K (K-major) or of N, 64-wide boxes of N
  const uint64_t b_inner = kmajor ? p.K : p.N, b_outer = kmajor ? p.N : p.K;
  return encode_map(tm_a, a, p.K, p.M, 2 * p.lda, BK16, BM) &&
         encode_map(tm_b, b, b_inner, b_outer, 2 * b_row, kmajor ? BK16 : 64,
                    kmajor ? BN : BK16);
}

template <bool B_KMAJOR, bool GROUPED>
int launch_bf16_as(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                   const __nv_bfloat16* a, const __nv_bfloat16* b,
                   __nv_bfloat16* c, float* scratch, const Problem& p,
                   int use_tma, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.G * p.split);
  return launch(matmul_bf16_wgmma_kernel<B_KMAJOR, GROUPED>, grid, THREADS16,
                SMEM16, stream, tm_a, tm_b, a, b, c, scratch, p.G, p.M, p.N,
                p.K, p.lda, p.sag, p.sbg, p.sbk, p.sbn, p.split,
                p.slice_steps, use_tma);
}

// the short tile, its A and B maps made (use_tma) or not; c's map too
// where c's rows are 16-byte multiples: a warp's 16 rows x 64 columns a
// box.  One block an SM (the grid does not change a tile's bits)
int launch_short(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                 const __nv_bfloat16* a, const __nv_bfloat16* b,
                 __nv_bfloat16* c, const Problem& p, int use_tma,
                 cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(p.G) *
                          ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(std::min<long long>(tiles, sms)));
  CUtensorMap tm_c = {};
  const int store_tma =
      aligned16(c, 2ll * p.N) &&
      encode_map_3d(&tm_c, c, p.N, p.M, p.G, 2ll * p.N, 2ll * p.N * p.M, 64,
                    16);
  return launch(p.a_mn ? matmul_bf16_grouped_short_kernel<true>
                       : matmul_bf16_grouped_short_kernel<false>,
                grid, short_tile::THREADS, short_tile::SMEM, stream, tm_a,
                tm_b, tm_c, a, b, c, p.G, p.M, p.N, p.K, p.lda, p.sag, p.sbg,
                p.sbk, p.sbn, use_tma, store_tma);
}

// the bf16 routes' products: into c, or (with a scratch) their fp32 sums
// into it, a split's partials rank by rank
int launch_bf16_products(const __nv_bfloat16* a, const __nv_bfloat16* b,
                         __nv_bfloat16* c, float* scratch, const Problem& p,
                         cudaStream_t stream) {
  const bool kmajor = p.sbn != 1;  // else sbk == 1 (checked by the caller)
  CUtensorMap tm_a = {}, tm_b = {};
  // TMA wants 16-byte bases and row strides, and so every group's base
  const bool groups16 = p.G == 1 || (2 * p.sag % 16 == 0 &&
                                     2 * p.sbg % 16 == 0);
  int use_tma = p.K > 0 && groups16 && aligned16(a, 2 * p.lda) &&
                aligned16(b, 2 * (kmajor ? p.sbn : p.sbk));
  if (use_tma && !encode_maps(&tm_a, &tm_b, a, b, p)) {
    // the dense route's maps are plain row-major matrices; a grouped
    // operand at strides the encoder refuses takes the masked path
    if (!p.grouped) return static_cast<int>(cudaErrorInvalidValue);
    use_tma = 0;
  }
  if (p.short_k) return launch_short(tm_a, tm_b, a, b, c, p, use_tma, stream);
  if (p.grouped)
    return kmajor ? launch_bf16_as<true, true>(tm_a, tm_b, a, b, c, scratch,
                                               p, use_tma, stream)
                  : launch_bf16_as<false, true>(tm_a, tm_b, a, b, c, scratch,
                                                p, use_tma, stream);
  return kmajor ? launch_bf16_as<true, false>(tm_a, tm_b, a, b, c, scratch, p,
                                              use_tma, stream)
                : launch_bf16_as<false, false>(tm_a, tm_b, a, b, c, scratch,
                                               p, use_tma, stream);
}

int launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                __nv_bfloat16* c, float* scratch, const Problem& p,
                cudaStream_t stream) {
  const int rc = launch_bf16_products(a, b, c, scratch, p, stream);
  return rc ? rc
            : reduce_splits(scratch, c, static_cast<long long>(p.G) * p.M,
                            p.N, p.split, stream);
}

template <bool GROUPED, bool B_KMAJOR>
int launch_f32_as(const float* a, const float* b, float* c, float* scratch,
                  const Problem& p, cudaStream_t stream) {
  const bool groups16 = p.G == 1 || (4 * p.sag % 16 == 0 &&
                                     4 * p.sbg % 16 == 0);
  const bool al = groups16 && aligned16(a, 4 * p.lda) &&
                  aligned16(b, 4 * (B_KMAJOR ? p.sbn : p.sbk));
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.G * p.split);
  const int rc = launch(al ? matmul_f32_simt_kernel<GROUPED, B_KMAJOR, true>
                           : matmul_f32_simt_kernel<GROUPED, B_KMAJOR, false>,
                        grid, THREADS32, Tile32<B_KMAJOR>::SMEM, stream, a, b,
                        c, scratch, p.G, p.M, p.N, p.K, p.lda, p.sag, p.sbg,
                        p.sbk, p.sbn, p.split, p.slice_steps);
  return rc ? rc
            : reduce_splits(scratch, c, static_cast<long long>(p.G) * p.M,
                            p.N, p.split, stream);
}

int run(const void* a, const void* b, void* c, void* scratch,
        const Problem& p, int dtype, cudaStream_t s) {
  float* part = static_cast<float*>(scratch);
  if ((p.sbk != 1 && p.sbn != 1) || p.split < 1 || p.split > 8 ||
      p.slice_steps < 0 || p.G < 1 || p.G * p.split > 65535 ||
      (p.M + BM - 1) / BM > 65535 || (p.split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the short tile: bf16, grouped, no split, both operands MN-major (A
  // read M-major, B N-major) or both K-major; only it reads A MN-major
  if ((p.short_k && (!p.grouped || dtype != DTYPE_BF16 || p.split != 1 ||
                     p.a_mn != (p.sbn == 1))) ||
      (p.a_mn && !p.short_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(a),
                       static_cast<const __nv_bfloat16*>(b),
                       static_cast<__nv_bfloat16*>(c), part, p, s);
  if (dtype == DTYPE_F32) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    const bool kmajor = p.sbn != 1;
    if (p.grouped)
      return kmajor ? launch_f32_as<true, true>(fa, fb, fc, part, p, s)
                    : launch_f32_as<true, false>(fa, fb, fc, part, p, s);
    return kmajor ? launch_f32_as<false, true>(fa, fb, fc, part, p, s)
                  : launch_f32_as<false, false>(fa, fb, fc, part, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (M, K) with row stride lda and unit K stride; b (K, N) at strides
// (sbk, sbn), one of them 1; c (M, N) contiguous, of a's type.  `split`
// blocks share each output tile, rank r taking the K range
// [r slice_steps, (r + 1) slice_steps) in units of 64 (bf16) or 32 (fp32);
// with split > 1, scratch holds split x M x N fp32 partial products.
// Returns a cudaError_t.
extern "C" int repro_matmul(const void* a, const void* b, void* c,
                            void* scratch, int M, int N, int K, int lda,
                            int sbk, int sbn, int split, int slice_steps,
                            int dtype, void* stream) {
  const Problem p{1, M, N, K, lda, 0, 0, sbk, sbn, split, slice_steps, false};
  return run(a, b, c, scratch, p, dtype, static_cast<cudaStream_t>(stream));
}

// As repro_matmul for bf16 a and b, with c (M, N) fp32: the products'
// fp32 sums, not rounded to bf16 (a row-parallel shard's partial sums,
// added over the model axis before the one rounding).  scratch holds the
// split x M x N partials where split > 1 (null otherwise).
extern "C" int repro_matmul_f32out(const void* a, const void* b, void* c,
                                   void* scratch, int M, int N, int K,
                                   int lda, int sbk, int sbn, int split,
                                   int slice_steps, void* stream) {
  const Problem p{1, M, N, K, lda, 0, 0, sbk, sbn, split, slice_steps, false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  float* part = split > 1 ? static_cast<float*>(scratch) : out;
  if ((p.sbk != 1 && p.sbn != 1) || split < 1 || split > 8 ||
      slice_steps < 0 || (M + BM - 1) / BM > 65535 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_bf16_products(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), nullptr, part, p, s);
  return rc ? rc : reduce_splits(part, out, M, N, split, s);
}

// G groups, in one launch: group g computes a_g (M, K) @ b_g (K, N) into
// c_g (M, N), where a_g = a + g sag (rows lda apart, unit K stride; or,
// with a_mn, rows of K lda apart with a unit M stride), b_g = b + g sbg
// (strides sbk, sbn, one of them 1) and c (G, M, N) is contiguous.
// short_k picks the short tile (bf16, split 1, both operands MN-major
// (a_mn, sbn == 1) or both K-major (sbk == 1); the only one that takes
// a_mn), else the tile route: the split is repro_matmul's, applied in
// every group; with split > 1, scratch holds split x G x M x N fp32
// partial products.  Returns a cudaError_t.
extern "C" int repro_grouped_matmul(const void* a, const void* b, void* c,
                                    void* scratch, int G, int M, int N, int K,
                                    int lda, int sag, int sbg, int sbk,
                                    int sbn, int split, int slice_steps,
                                    int a_mn, int short_k, int dtype,
                                    void* stream) {
  Problem p{G, M, N, K, lda, sag, sbg, sbk, sbn, split, slice_steps, true};
  p.a_mn = a_mn != 0;
  p.short_k = short_k != 0;
  return run(a, b, c, scratch, p, dtype, static_cast<cudaStream_t>(stream));
}
