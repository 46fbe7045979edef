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
// once per non-empty bin with a global atomic.  The bins are cut into
// windows of at most `window` bins that fit one block's shared memory,
// one grid row (blockIdx.y) per window: a block counts only the values
// that fall into its window, so any n_bins is taken, and a histogram of
// one window (256 bins) runs as a single private histogram.  Every window
// reads all the values (19 times the bytes at 2^20 bins), and a window
// of 227 KB leaves one block an SM, so the values come as 16-byte loads,
// several in flight a thread.
// Integer adds commute, so the counts are exact and do not depend on the
// order or on the windows.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

// one value into the window [lo, lo + width); unsigned, so values below
// the window (negative ones too) wrap above it
__device__ __forceinline__ void count(int* bins, int x, unsigned lo,
                                      unsigned width) {
  const unsigned v = static_cast<unsigned>(x) - lo;
  if (v < width) atomicAdd(&bins[v], 1);
}

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int* __restrict__ values, int* __restrict__ out,
                 int n, int n_bins, int window) {
  extern __shared__ int bins[];
  const int lo = blockIdx.y * window;
  const int width = min(window, n_bins - lo);
  for (int b = threadIdx.x; b < width; b += THREADS) bins[b] = 0;
  __syncthreads();
  const long long first = blockIdx.x * static_cast<long long>(THREADS) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // 16-byte loads where the values start on a 16-byte boundary (every
  // allocation does), several in flight a thread; then the tail
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(values) % 16 == 0) {
    const int4* v4 = reinterpret_cast<const int4*>(values);
    const long long n4 = n / 4;
#pragma unroll 4
    for (long long i = first; i < n4; i += stride) {
      const int4 x = v4[i];
      count(bins, x.x, lo, width);
      count(bins, x.y, lo, width);
      count(bins, x.z, lo, width);
      count(bins, x.w, lo, width);
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    count(bins, values[i], lo, width);
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += THREADS)
    if (bins[b]) atomicAdd(&out[lo + b], bins[b]);
}

}  // namespace

// values (N,) int32; out (n_bins,) int32, zeroed by the caller; both
// contiguous.  `window` bins per grid row (at most the bins one block's
// shared memory holds).  Returns a cudaError_t.
extern "C" int repro_histogram(const void* values, void* out, int n,
                               int n_bins, int window, void* stream) {
  if (n == 0) return 0;
  if (n_bins <= 0 || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = (n_bins + window - 1) / window;
  const size_t smem =
      static_cast<size_t>(window < n_bins ? window : n_bins) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a few blocks per SM over all windows, and none without values to read
  // (4 a thread)
  const long long want =
      (static_cast<long long>(n) + 4 * THREADS - 1) / (4 * THREADS);
  long long per_window = 4LL * sms / windows;
  if (per_window < 1) per_window = 1;
  const int blocks = static_cast<int>(want < per_window ? want : per_window);
  histogram_kernel<<<dim3(blocks, windows), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(values), static_cast<int*>(out), n, n_bins,
      window);
  return static_cast<int>(cudaGetLastError());
}
