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
// What this design does about it: the simple, right first version of
// matmul_tile.cuh (64x64 tiles, fp32 FMA, one fixed K order per output).
#include "matmul_tile.cuh"

// a (M, K) with row stride lda and unit K stride; b (K, N) at strides
// (sbk, sbn); c (M, N) contiguous, of a's type.  Returns a cudaError_t.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int lda, int sbk, int sbn,
                            int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_matmul<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        a, b, nullptr, c, M, N, K, lda, sbk, sbn, s);
  if (dtype == DTYPE_F32)
    return launch_matmul<float, float, float>(a, b, nullptr, c, M, N, K, lda,
                                              sbk, sbn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
