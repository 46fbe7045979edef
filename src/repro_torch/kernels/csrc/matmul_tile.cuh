// The tiled fp32-accumulating GEMM of B5 (quantized_matmul.cu), the int8-
// weight GEMM.  (B1 used it until its Hopper redesign in matmul.cu.)
//
// 64x64 output tiles, 16-deep K steps staged through shared memory as
// fp32, 256 threads each owning a 4x4 micro-tile of fp32 FMA accumulators.
// Each block reads its B columns exactly once for M <= 64, so decode
// moves the minimum number of bytes; it does not yet use the tensor cores
// (wgmma) or TMA, which is the next step for prefill.
//
// Ragged M/N/K edges are masked (the TPU kernels asserted divisibility).
// B is read through its strides, so the tied logits head passes the
// embedding table's transposed view without a copy.  Each output element
// is one thread's sequential K loop, k = 0..K-1, with one fixed tile shape:
// its rounding never depends on M, on its row's neighbours or on the grid.
//
// A and B are widened to fp32 as they are staged (an int8 B never exists
// in device memory as floats).  A non-null `scale` multiplies column n of
// the fp32 sum by scale[n] once, at the flush: the per-output-channel
// dequant of B5, which factors out of the K contraction.
#pragma once

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 micro-tile

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
              const float* __restrict__ scale, TC* __restrict__ c, int M,
              int N, int K, long long lda, long long sbk, long long sbn) {
  // +1 column of padding keeps the transposing stores off one bank
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // neighbouring threads walk whichever B axis is contiguous in memory
  const bool b_k_contiguous = (sbk == 1);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(a[gm * lda + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = b_k_contiguous ? i % BK : i / BN;
      const int n = b_k_contiguous ? i / BK : i % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(b[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
      if (gm < M && gn < N) {
        const float v = scale != nullptr ? acc[i][j] * scale[gn] : acc[i][j];
        c[(long long)gm * N + gn] = from_f32<TC>(v);
      }
    }
  }
}

template <typename TA, typename TB, typename TC>
int launch_matmul(const void* a, const void* b, const float* scale, void* c,
                  int M, int N, int K, int lda, int sbk, int sbn,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<TA, TB, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), scale,
      static_cast<TC*>(c), M, N, K, lda, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
