// C = A @ B_q with per-output-channel scales, fp32 accumulation: the port of
// the TPU kernel src/repro/kernels/matmul/matmul.py::quantized_matmul_pallas
// (_quantized_matmul_kernel), the int8-weight GEMM of type demotion (§4.4).
//
// What bounds it on the H100.  On the serving path A is the activations
// (M = 4 at decode, up to 256 at prefill; bf16 or fp32), B_q the int8
// projection and MLP weights (K x N in {2048x2048, 2048x256, 2048x16384,
// 16384x2048}) and scale one f32 per column.  At M=4 every weight byte
// feeds 8 operations: the GEMM is bound by reading B_q once, which int8
// halves against bf16 (2048x16384 = 32 MiB -> 10 us at 3.35 TB/s).
//
// What this design does about it.  It is the tiled kernel of
// matmul_tile.cuh (B1's first design) with B staged from int8: each int8 weight is widened to fp32 as it is
// written to shared memory, so no float copy of B is made in device
// memory, and the column scale multiplies the fp32 sum once at the flush,
// as the TPU kernel does.  One tile shape and one K order per output keep
// a row's rounding independent of M.  At M=4 it is bound by the latency
// of its K steps rather than by bytes; it does not yet use the
// tensor cores (int8 wgmma needs an int8 A) or TMA.
#include "matmul_tile.cuh"

// a (M, K) contiguous rows of stride lda, bf16 or fp32 (dtype); b (K, N)
// int8 contiguous; scale (N,) f32; c (M, N) f32 contiguous.  Returns a
// cudaError_t.
extern "C" int repro_quantized_matmul(const void* a, const void* b,
                                      const void* scale, void* c, int M,
                                      int N, int K, int lda, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == DTYPE_BF16)
    return launch_matmul<__nv_bfloat16, int8_t, float>(a, b, sc, c, M, N, K,
                                                       lda, N, 1, s);
  if (dtype == DTYPE_F32)
    return launch_matmul<float, int8_t, float>(a, b, sc, c, M, N, K, lda, N,
                                               1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
