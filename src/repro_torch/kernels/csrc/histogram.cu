// Histogram of int32 values into n_bins int32 counts (paper §2.3,
// random-access buffering): the port of the TPU kernel
// src/repro/kernels/histogram/histogram.py::histogram_pallas
// (_hist_kernel).  A value outside [0, n_bins) is dropped, negative ones
// included, as the TPU kernel's one-hot compare drops it.
//
// What bounds it on the H100.  One compare and one add per value against
// 4 bytes read: 2^26 values are 268 MB, 80 us at 3.35 TB/s, bound by
// bytes, as long as the updates keep up.  When many values fall into one
// bin, same-address atomics serialise and bound it instead.
//
// What this design does about it.  The TPU has no scatter, so its kernel
// turns the update into a one-hot compare summed over 8 banks of partial
// bins in VMEM.  Hopper has fast shared-memory atomics, so each block
// builds a private histogram in shared memory from a grid-stride share of
// the values (the on-chip bin buffer of §2.3) and adds it to the output
// once per non-empty bin with a global atomic.  Integer adds commute, so
// the counts are exact and do not depend on the order.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int* __restrict__ values, int* __restrict__ out,
                 int n, int n_bins) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < n_bins; b += THREADS) bins[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int v = values[i];
    if (static_cast<unsigned>(v) < static_cast<unsigned>(n_bins))
      atomicAdd(&bins[v], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += THREADS)
    if (bins[b]) atomicAdd(&out[b], bins[b]);
}

}  // namespace

// values (N,) int32; out (n_bins,) int32, zeroed by the caller; both
// contiguous.  Returns a cudaError_t.
extern "C" int repro_histogram(const void* values, void* out, int n,
                               int n_bins, void* stream) {
  if (n == 0) return 0;
  if (n_bins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a few blocks per SM, and none without values to read
  const long long want = (static_cast<long long>(n) + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4LL * sms ? want : 4LL * sms);
  histogram_kernel<<<blocks, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(values), static_cast<int*>(out), n, n_bins);
  return static_cast<int>(cudaGetLastError());
}
