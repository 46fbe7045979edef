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
// bins in VMEM.  Hopper has fast atomics, and the route is chosen by
// n_bins alone (histogram.py::histogram_route):
// - shared: while the bins fit one block's shared memory (58,112 bins),
//   each block builds a private histogram there from a grid-stride share
//   of the values (the on-chip bin buffer of §2.3) and adds it to the
//   output once per non-empty bin with a global atomic.
// - global: past that, one pass over the values with one
//   `red.global.add` per kept value straight into the output.  2^20 bins
//   are 4 MB, which the 50 MB L2 holds, so the updates stay on chip.
//   Same-address atomics serialise in L2 (2^26 values in one bin took
//   49 ms as one atomic each), so each lane keeps a run of equal values
//   in a register and adds the run once it ends: values that repeat along
//   a lane's share, all in one bin the worst of them, cost one atomic per
//   run.  (Aggregating equal values across a warp with __match_any_sync
//   instead took 1.6 ms on one bin; both read the same on uniform values:
//   PERF.md.)
// Both routes read the values once as 16-byte loads where they start on a
// 16-byte boundary (every allocation does), several in flight a thread.
// Integer adds commute, so the counts are exact and do not depend on the
// order.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int ROUTE_SHARED = 0, ROUTE_GLOBAL = 1;
constexpr unsigned NO_BIN = 0xFFFFFFFFu;  // above any bin: n_bins < 2^31

// one value into the block's private bins; unsigned, so negative values
// wrap above n_bins
__device__ __forceinline__ void count(int* bins, int x, unsigned n_bins) {
  const unsigned v = static_cast<unsigned>(x);
  if (v < n_bins) atomicAdd(&bins[v], 1);
}

__global__ void __launch_bounds__(THREADS)
histogram_shared_kernel(const int* __restrict__ values, int* __restrict__ out,
                        int n, int n_bins) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < n_bins; b += THREADS) bins[b] = 0;
  __syncthreads();
  const long long first = blockIdx.x * static_cast<long long>(THREADS) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(values) % 16 == 0) {
    const int4* v4 = reinterpret_cast<const int4*>(values);
    const long long n4 = n / 4;
#pragma unroll 4
    for (long long i = first; i < n4; i += stride) {
      const int4 x = v4[i];
      count(bins, x.x, n_bins);
      count(bins, x.y, n_bins);
      count(bins, x.z, n_bins);
      count(bins, x.w, n_bins);
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    count(bins, values[i], n_bins);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += THREADS)
    if (bins[b]) atomicAdd(&out[b], bins[b]);
}

__device__ __forceinline__ void red_add(unsigned* p, unsigned v) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// a lane's run of equal in-range values, added to the output when it ends
struct Run {
  unsigned bin = NO_BIN, n = 0;
  __device__ __forceinline__ void push(unsigned* out, int x, unsigned n_bins) {
    const unsigned v = static_cast<unsigned>(x) < n_bins
                           ? static_cast<unsigned>(x) : NO_BIN;
    if (v == bin) {
      ++n;
      return;
    }
    flush(out);
    bin = v;
    n = 1;
  }
  __device__ __forceinline__ void flush(unsigned* out) {
    if (bin != NO_BIN) red_add(out + bin, n);
  }
};

__global__ void __launch_bounds__(THREADS)
histogram_global_kernel(const int* __restrict__ values,
                        unsigned* __restrict__ out, int n, int n_bins) {
  const long long first = blockIdx.x * static_cast<long long>(THREADS) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const unsigned bins = static_cast<unsigned>(n_bins);
  Run run;
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(values) % 16 == 0) {
    const int4* v4 = reinterpret_cast<const int4*>(values);
    const long long n4 = n / 4;
#pragma unroll 4
    for (long long i = first; i < n4; i += stride) {
      const int4 x = v4[i];
      run.push(out, x.x, bins);
      run.push(out, x.y, bins);
      run.push(out, x.z, bins);
      run.push(out, x.w, bins);
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    run.push(out, values[i], bins);
  run.flush(out);
}

}  // namespace

// values (N,) int32; out (n_bins,) int32, zeroed by the caller; both
// contiguous.  `route` is ROUTE_SHARED (n_bins within one block's shared
// memory) or ROUTE_GLOBAL.  Returns a cudaError_t.
extern "C" int repro_histogram(const void* values, void* out, int n,
                               int n_bins, int route, void* stream) {
  if (n == 0) return 0;
  if (n_bins <= 0 || (route != ROUTE_SHARED && route != ROUTE_GLOBAL))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // none without values to read (4 a thread)
  const long long want =
      (static_cast<long long>(n) + 4 * THREADS - 1) / (4 * THREADS);
  if (route == ROUTE_GLOBAL) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, histogram_global_kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long full = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                           sms;
    histogram_global_kernel<<<static_cast<int>(want < full ? want : full),
                              THREADS, 0, s>>>(
        static_cast<const int*>(values), static_cast<unsigned*>(out), n,
        n_bins);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int);
  err = cudaFuncSetAttribute(histogram_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a few blocks per SM
  const long long full = 4LL * sms;
  histogram_shared_kernel<<<static_cast<int>(want < full ? want : full),
                            THREADS, smem, s>>>(
      static_cast<const int*>(values), static_cast<int*>(out), n, n_bins);
  return static_cast<int>(cudaGetLastError());
}
