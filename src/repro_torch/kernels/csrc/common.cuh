// Shared helpers of the port's hand-written CUDA kernels (sm_90a).
//
// Every kernel reads bf16 or fp32 inputs (and, for int8 weights and KV
// pages, int8 with f32 scales), accumulates in fp32, and is instantiated
// once per input type.  The C entry points take the float element type as
// an int: DTYPE_F32 or DTYPE_BF16 (kernels/cuda.py passes it).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as a cast to bf16 does in PyTorch and XLA
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded through T: the attention kernels cast P to V's dtype before
// the PV product, as the TPU kernels do
template <typename T> __device__ __forceinline__ float round_via(float x) {
  return to_f32(from_f32<T>(x));
}
// int8 pools are widened to f32 at load, so P stays f32 (the TPU kernels
// cast P to the widened V's dtype)
template <> __device__ __forceinline__ float round_via<int8_t>(float x) {
  return x;
}

// One K/V element as f32: float pools widen; int8 pools dequantize by the
// f32 scale of their (page, kv head) cell, `scale[row]`.
template <typename T>
__device__ __forceinline__ float load_kv(const T* pages, long long off,
                                         const float* /*scale*/,
                                         long long /*row*/) {
  return to_f32(pages[off]);
}
template <>
__device__ __forceinline__ float load_kv<int8_t>(const int8_t* pages,
                                                 long long off,
                                                 const float* scale,
                                                 long long row) {
  return static_cast<float>(pages[off]) * scale[row];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The masked-score sentinel of the TPU kernels: exp(NEG_BIG - m) == 0 for
// any real running max m.
constexpr float NEG_BIG = -1e30f;
