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
//   atomics.  The split is chosen by the wrapper from (K, N, dtype) only.
//   (Blocks of one cluster summing through distributed shared memory were
//   measured slower: clusters of 8 one-block-per-SM blocks did not all
//   run at once.)
//
// A row's bits depend on nothing but its own inputs: the tile shape, the
// K order and the split are fixed by (K, N, dtype), rows past M are zeros,
// and both bf16 paths (TMA, and the masked path for strides that are not
// 16-byte multiples) write the same swizzled tiles for the same products.
#include <algorithm>

#include "matmul_wgmma.cuh"

namespace {

using sm90::aligned16;
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::encode_map;
using sm90::launch;

constexpr int BM = 128, BN = 128;
// the K unit of a split's slice (kernels/matmul/matmul.py's TILE_K)
constexpr int SLICE_K32 = 32;

// the block's output: straight to c, or its rank's partial to scratch
template <typename TC>
__device__ __forceinline__ void put(TC* __restrict__ c,
                                    float* __restrict__ scratch, int split,
                                    int rank, int M, int N, int gm, int gn,
                                    float v) {
  if (split == 1)
    c[static_cast<long long>(gm) * N + gn] = from_f32<TC>(v);
  else
    scratch[(static_cast<long long>(rank) * M + gm) * N + gn] = v;
}

// ------------------------------------------------------------------ bf16
constexpr int BK16 = wgmma_tile::BK;
constexpr int THREADS16 = wgmma_tile::threads<__nv_bfloat16>();
constexpr int SMEM16 = wgmma_tile::smem_bytes<__nv_bfloat16>();

template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS16, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ c,
                         float* __restrict__ scratch, int M, int N, int K,
                         long long lda, long long sbk, long long sbn,
                         int split, int slice_steps, int use_tma) {
  const int rank = blockIdx.z;
  wgmma_tile::tile<__nv_bfloat16, B_KMAJOR>(
      tm_a, tm_b, a, b, M, N, K, lda, sbk, sbn, slice_steps, use_tma, BM,
      [&](int gm, int gn, float v) {
        put(c, scratch, split, rank, M, N, gm, gn, v);
      });
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

template <bool B_KMAJOR, bool ALIGNED>
__global__ void __launch_bounds__(THREADS32, 1)
matmul_f32_simt_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ c,
                       float* __restrict__ scratch, int M, int N, int K,
                       long long lda, long long sbk, long long sbn, int split,
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
  const int rank = blockIdx.z;
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
        put(c, scratch, split, rank, M, N, gm, gn, acc[i][j]);
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
// the split's second pass, where it takes one
template <typename TC>
int reduce_splits(const float* scratch, TC* c, int M, int N, int split,
                  cudaStream_t stream) {
  if (split == 1) return 0;
  const long long mn = static_cast<long long>(M) * N;
  const long long blocks = std::min<long long>((mn + 255) / 256, 132 * 8);
  matmul_splitk_reduce_kernel<TC><<<static_cast<int>(blocks), 256, 0,
                                    stream>>>(scratch, c, mn, split);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                __nv_bfloat16* c, float* scratch, int M, int N, int K,
                long long lda, long long sbk, long long sbn, int split,
                int slice_steps, cudaStream_t stream) {
  const bool kmajor = sbn != 1;  // else sbk == 1 (checked by the caller)
  const long long b_row = kmajor ? sbn : sbk;
  CUtensorMap tm_a = {}, tm_b = {};
  const int use_tma =
      K > 0 && aligned16(a, 2 * lda) && aligned16(b, 2 * b_row);
  if (use_tma &&
      !(encode_map(&tm_a, a, K, M, 2 * lda, BK16, BM) &&
        (kmajor ? encode_map(&tm_b, b, K, N, 2 * b_row, BK16, BN)
                : encode_map(&tm_b, b, N, K, 2 * b_row, 64, BK16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  const int rc =
      kmajor ? launch(matmul_bf16_wgmma_kernel<true>, grid, THREADS16, SMEM16,
                      stream, tm_a, tm_b, a, b, c, scratch, M, N, K, lda, sbk,
                      sbn, split, slice_steps, use_tma)
             : launch(matmul_bf16_wgmma_kernel<false>, grid, THREADS16,
                      SMEM16, stream, tm_a, tm_b, a, b, c, scratch, M, N, K,
                      lda, sbk, sbn, split, slice_steps, use_tma);
  return rc ? rc : reduce_splits(scratch, c, M, N, split, stream);
}

template <bool B_KMAJOR>
int launch_f32(const float* a, const float* b, float* c, float* scratch,
               int M, int N, int K, long long lda, long long sbk,
               long long sbn, int split, int slice_steps,
               cudaStream_t stream) {
  const bool al =
      aligned16(a, 4 * lda) && aligned16(b, 4 * (B_KMAJOR ? sbn : sbk));
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  const int rc = launch(al ? matmul_f32_simt_kernel<B_KMAJOR, true>
                           : matmul_f32_simt_kernel<B_KMAJOR, false>,
                        grid, THREADS32, Tile32<B_KMAJOR>::SMEM, stream, a, b,
                        c, scratch, M, N, K, lda, sbk, sbn, split,
                        slice_steps);
  return rc ? rc : reduce_splits(scratch, c, M, N, split, stream);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if ((sbk != 1 && sbn != 1) || split < 1 || split > 8 || slice_steps < 0 ||
      (M + BM - 1) / BM > 65535 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(a),
                       static_cast<const __nv_bfloat16*>(b),
                       static_cast<__nv_bfloat16*>(c), part, M, N, K, lda,
                       sbk, sbn, split, slice_steps, s);
  if (dtype == DTYPE_F32) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    return sbn != 1 ? launch_f32<true>(fa, fb, fc, part, M, N, K, lda, sbk,
                                       sbn, split, slice_steps, s)
                    : launch_f32<false>(fa, fb, fc, part, M, N, K, lda, sbk,
                                        sbn, split, slice_steps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
