// C = A @ B with fp32 accumulation: the port of the TPU kernel
// src/repro/kernels/matmul/matmul.py::matmul_pallas (_matmul_kernel).
//
// What bounds it on the H100.  On the serving path M is the slot count at
// decode (4) and batch x page at prefill (64..256), K is 2048 or 16384 and
// N is 256..256000.  At M=4 every weight byte feeds 8 operations, far
// below the card's ~295 operations per byte, so decode GEMMs are bound by
// reading B once (e.g. 2048x16384 bf16 = 64 MiB -> 20 us at 3.35 TB/s).
// At M=256 the intensity reaches ~250 operations per byte, near the ridge:
// those GEMMs want the tensor cores.
//
// What this design does about it.  It is the simple, right first version:
// 64x64 output tiles, 16-deep K steps staged through shared memory as
// fp32, 256 threads each owning a 4x4 micro-tile of fp32 FMA
// accumulators.  Each block reads its B columns exactly once for M <= 64,
// so decode moves the minimum number of bytes; it does not yet use the
// tensor cores (wgmma) or TMA, which is the next step for prefill.
//
// Ragged M/N/K edges are masked (the TPU kernel asserted divisibility).
// B is read through its strides, so the tied logits head passes the
// embedding table's transposed view without a copy.  Each output element
// is one thread's sequential K loop, k = 0..K-1, with one fixed tile shape:
// its rounding never depends on M, on its row's neighbours or on the grid.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 micro-tile

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int M, int N, int K, long long lda,
              long long sbk, long long sbn) {
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
      if (gm < M && gn < N)
        c[(long long)gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int lda, int sbk, int sbn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, lda, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) with row stride lda and unit K stride; b (K, N) at strides
// (sbk, sbn); c (M, N) contiguous, of a's type.  Returns a cudaError_t.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int lda, int sbk, int sbn,
                            int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(a, b, c, M, N, K, lda, sbk, sbn, s);
  if (dtype == DTYPE_F32)
    return launch<float>(a, b, c, M, N, K, lda, sbk, sbn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
