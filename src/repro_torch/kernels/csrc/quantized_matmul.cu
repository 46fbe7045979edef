// C = A @ B_q with per-output-channel scales, fp32 accumulation: the port of
// the TPU kernel src/repro/kernels/matmul/matmul.py::quantized_matmul_pallas
// (_quantized_matmul_kernel), the int8-weight GEMM of type demotion (§4.4).
//
// What bounds it on the H100.  On the serving path A is the activations
// (M = 4 at decode, up to 256 at prefill; bf16 on the card's serving path,
// fp32 in the full-precision checks) and B_q the int8 projection and MLP
// weights (K x N in {2048x2048, 2048x256, 2048x16384, 16384x2048}), scale
// one f32 per column.  At M = 4 every weight byte feeds 8 operations: the
// GEMM is bound by reading B_q once, which int8 halves against bf16
// (2048 x 16384 = 32 MiB -> 10 us at 3.35 TB/s), so it needs enough loads
// in flight on enough SMs.
//
// What this design does about it.
// - bf16 A: B1's tensor-core tile (matmul_wgmma.cuh: 128 x 128 outputs,
//   a TMA ring feeding wgmma m64n128k16 in two consumer warpgroups) with
//   B_q brought in by TMA as int8 and widened to bf16 in shared memory by
//   four producer warps.  Only B is dequantized, and exactly: no int8
//   wgmma, which would need a quantized A (a different function,
//   kernels/matmul/ref.py::quantized_matmul_ref).
// - fp32 A: a 64 x 64 FMA tile, 16-deep K steps staged through shared
//   memory with B_q widened to fp32 as it is staged.
// - Split K: `split` blocks take consecutive K slices of one output tile,
//   chosen by the wrapper from (K, N, dtype) only (matmul.py::
//   quantized_split_plan); their fp32 partial tiles are summed in rank
//   order by a second kernel.  No atomics.
// The column scale multiplies the fp32 sum once, at the flush (the TPU
// kernel's _flush): in the tile's epilogue, or in the split's sum.  A
// row's bits depend on nothing but its own inputs: the tile, the K order
// and the split are fixed by (K, N, dtype), rows past M are zeros, and the
// masked path (strides that are not 16-byte multiples) fills the tiles the
// TMA path fills.
#include <algorithm>

#include "matmul_wgmma.cuh"

namespace {

using sm90::aligned16;
using sm90::launch;

constexpr int MAX_SPLIT = 16;
// the K unit of a split's slice (kernels/matmul/matmul.py's Q_TILE_K)
constexpr int SLICE_K = 64;

// the flush: the scaled sum to c, or the rank's partial to scratch
__device__ __forceinline__ void flush(float* __restrict__ c,
                                      float* __restrict__ scratch,
                                      const float* __restrict__ scale,
                                      int split, int rank, int M, int N,
                                      int gm, int gn, float v) {
  if (split == 1)
    c[static_cast<long long>(gm) * N + gn] = v * scale[gn];
  else
    scratch[(static_cast<long long>(rank) * M + gm) * N + gn] = v;
}

// ------------------------------------------------------------------ bf16
constexpr int BM16 = wgmma_tile::BM, BN16 = wgmma_tile::BN;
constexpr int SMEM16 = wgmma_tile::smem_bytes<int8_t>();

__global__ void __launch_bounds__(wgmma_tile::threads<int8_t>(), 1)
quantized_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __nv_bfloat16* __restrict__ a,
                       const int8_t* __restrict__ b,
                       const float* __restrict__ scale, float* __restrict__ c,
                       float* __restrict__ scratch, int M, int N, int K,
                       long long lda, int split, int slice_steps,
                       int use_tma, int a_rows) {
  const int rank = blockIdx.z;
  wgmma_tile::tile<int8_t, false>(
      tm_a, tm_b, a, b, M, N, K, lda, N, 1, slice_steps, use_tma, a_rows,
      rank, 0, [&](int gm, int gn, float v) {
        flush(c, scratch, scale, split, rank, M, N, gm, gn, v);
      });
}

// ------------------------------------------------------------------ fp32
constexpr int BM32 = 64, BN32 = 64, BK32 = 16;
constexpr int THREADS32 = 256;  // 16 x 16 threads, each a 4 x 4 micro-tile

__global__ void __launch_bounds__(THREADS32)
quantized_f32_kernel(const float* __restrict__ a,
                     const int8_t* __restrict__ b,
                     const float* __restrict__ scale, float* __restrict__ c,
                     float* __restrict__ scratch, int M, int N, int K,
                     long long lda, int split, int slice_steps) {
  // +1 column of padding keeps the transposing stores off one bank
  __shared__ float As[BK32][BM32 + 1];
  __shared__ float Bs[BK32][BN32 + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM32, n0 = blockIdx.x * BN32;
  const int rank = blockIdx.z;
  const int kb = rank * slice_steps * SLICE_K;
  const int ke = min(K, kb + slice_steps * SLICE_K);
  float acc[4][4] = {};

  for (int k0 = kb; k0 < ke; k0 += BK32) {
    for (int i = tid; i < BM32 * BK32; i += THREADS32) {
      const int m = i / BK32, k = i % BK32;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < ke) ? a[gm * lda + gk] : 0.f;
    }
    for (int i = tid; i < BK32 * BN32; i += THREADS32) {
      const int k = i / BN32, n = i % BN32;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < ke && gn < N)
                     ? static_cast<float>(
                           b[static_cast<long long>(gk) * N + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N)
        flush(c, scratch, scale, split, rank, M, N, gm, gn, acc[i][j]);
    }
  }
}

// c = the sum of the split partial products in scratch, in rank order,
// times the column's scale; rows on the grid's y axis
__global__ void __launch_bounds__(256)
quantized_splitk_sum_kernel(const float* __restrict__ scratch,
                            const float* __restrict__ scale,
                            float* __restrict__ c, int M, int N, int split) {
  const long long mn = static_cast<long long>(M) * N;
  for (int r = blockIdx.y; r < M; r += gridDim.y)
    for (int n = blockIdx.x * 256 + threadIdx.x; n < N;
         n += gridDim.x * 256) {
      const long long i = static_cast<long long>(r) * N + n;
      float v = scratch[i];
      for (int q = 1; q < split; ++q) v += scratch[q * mn + i];
      c[i] = v * scale[n];
    }
}

// ------------------------------------------------------------------ host
int sum_splits(const float* scratch, const float* scale, float* c, int M,
               int N, int split, cudaStream_t stream) {
  if (split == 1) return 0;
  // about 8 blocks an SM
  const int bx = std::min((N + 255) / 256, 132 * 8);
  const int by = std::min(M, std::max(1, 132 * 8 / bx));
  quantized_splitk_sum_kernel<<<dim3(bx, by), 256, 0, stream>>>(
      scratch, scale, c, M, N, split);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const __nv_bfloat16* a, const int8_t* b, const float* scale,
                float* c, float* scratch, int M, int N, int K, int lda,
                int split, int slice_steps, cudaStream_t stream) {
  CUtensorMap tm_a = {}, tm_b = {};
  const int use_tma = K > 0 && aligned16(a, 2LL * lda) && aligned16(b, N);
  // A as bf16 boxes of 64 k x a_rows rows (128-byte swizzle): the rows M
  // can fill, the tile's rows past M being zeros either way (at decode a
  // sixteenth of the tile); B_q as int8 boxes of 128 n x 64 k, unswizzled
  // (the widening reads them row by row)
  const int a_rows = std::min(BM16, (M + 7) / 8 * 8);
  if (use_tma &&
      !(sm90::encode_map(&tm_a, a, K, M, 2LL * lda, wgmma_tile::BK, a_rows) &&
        sm90::encode_map_2d(&tm_b, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            CU_TENSOR_MAP_SWIZZLE_NONE, b, N, K, N, BN16,
                            wgmma_tile::BK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN16 - 1) / BN16, (M + BM16 - 1) / BM16, split);
  const int rc = launch(quantized_wgmma_kernel, grid,
                        wgmma_tile::threads<int8_t>(), SMEM16, stream, tm_a,
                        tm_b, a, b, scale, c, scratch, M, N, K, lda, split,
                        slice_steps, use_tma, a_rows);
  return rc ? rc : sum_splits(scratch, scale, c, M, N, split, stream);
}

int launch_f32(const float* a, const int8_t* b, const float* scale, float* c,
               float* scratch, int M, int N, int K, int lda, int split,
               int slice_steps, cudaStream_t stream) {
  const dim3 grid((N + BN32 - 1) / BN32, (M + BM32 - 1) / BM32, split);
  quantized_f32_kernel<<<grid, THREADS32, 0, stream>>>(
      a, b, scale, c, scratch, M, N, K, lda, split, slice_steps);
  const int rc = static_cast<int>(cudaGetLastError());
  return rc ? rc : sum_splits(scratch, scale, c, M, N, split, stream);
}

}  // namespace

// a (M, K) contiguous rows of stride lda, bf16 or fp32 (dtype); b (K, N)
// int8 contiguous; scale (N,) f32; c (M, N) f32 contiguous.  `split`
// blocks share each output tile, rank r taking the K range
// [r slice_steps, (r + 1) slice_steps) in units of 64; with split > 1,
// scratch holds split x M x N fp32 partial products.  Returns a
// cudaError_t.
extern "C" int repro_quantized_matmul(const void* a, const void* b,
                                      const void* scale, void* c,
                                      void* scratch, int M, int N, int K,
                                      int lda, int split, int slice_steps,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bq = static_cast<const int8_t*>(b);
  const float* sc = static_cast<const float*>(scale);
  float* fc = static_cast<float*>(c);
  float* part = static_cast<float*>(scratch);
  const int tile_m = dtype == DTYPE_BF16 ? BM16 : BM32;
  if (split < 1 || split > MAX_SPLIT || slice_steps < 0 ||
      (M + tile_m - 1) / tile_m > 65535 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(a), bq, sc, fc,
                       part, M, N, K, lda, split, slice_steps, s);
  if (dtype == DTYPE_F32)
    return launch_f32(static_cast<const float*>(a), bq, sc, fc, part, M, N,
                      K, lda, split, slice_steps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
