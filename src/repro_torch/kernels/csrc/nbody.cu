// All-pairs Plummer-softened gravitational acceleration (paper §6.3):
// the port of the TPU kernel src/repro/kernels/nbody/nbody.py::nbody_pallas
// (_nbody_kernel).  For target i,
//   a_i = sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^1.5,
// with positions in SoA layout, pos (3, N), and masses (N,), fp32.
//
// What bounds it on the H100.  N^2 pairs at 19 operations each, an FMA
// counted as 2 (3 differences, the softened squared distance in 3 FMAs, a
// reciprocal square root, 3 multiplies for its cube times the mass, and 3
// accumulating FMAs) against 16 bytes per particle read and 12 written:
// N = 65536 is 82 GFLOP over 1.8 MB, bound by operations (1.22 ms at the
// 67 TFLOP/s fp32 peak).
//
// What this design does about it.  The TPU kernel pins a (3, bt) block of
// target positions in VMEM and streams (3, bs) source blocks past it
// (§3.3), accumulating into a VMEM scratch (§2.1.2).  Here each thread
// keeps one target's position and its three accumulators in registers,
// and its block streams 128-source tiles of positions and masses through
// shared memory, which every thread of the block then reads as a
// broadcast.  The sum over sources runs in ascending order, one FMA chain
// per component.  Ragged N is masked: a source past the end has mass 0 and
// a target past the end writes nothing.  rsqrtf (~2 ulp) takes the place
// of XLA's rsqrt; the cube is inv_r * inv_r * inv_r.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;         // targets per block = sources per tile

__global__ void __launch_bounds__(THREADS)
nbody_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
             float* __restrict__ out, int n, float eps2) {
  __shared__ float sx[THREADS], sy[THREADS], sz[THREADS], sm[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const long long row = n;   // stride of the x, y, z rows
  const bool live = i < n;
  const float xi = live ? pos[i] : 0.f;
  const float yi = live ? pos[row + i] : 0.f;
  const float zi = live ? pos[2 * row + i] : 0.f;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j0 = 0; j0 < n; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    const bool src = j < n;
    sx[threadIdx.x] = src ? pos[j] : 0.f;
    sy[threadIdx.x] = src ? pos[row + j] : 0.f;
    sz[threadIdx.x] = src ? pos[2 * row + j] : 0.f;
    sm[threadIdx.x] = src ? mass[j] : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < THREADS; ++t) {
      const float dx = sx[t] - xi, dy = sy[t] - yi, dz = sz[t] - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv_r = rsqrtf(r2);
      const float w = inv_r * inv_r * inv_r * sm[t];
      ax += dx * w;
      ay += dy * w;
      az += dz * w;
    }
    __syncthreads();
  }
  if (live) {
    out[i] = ax;
    out[row + i] = ay;
    out[2 * row + i] = az;
  }
}

}  // namespace

// pos (3, N) fp32, mass (N,) fp32, out (3, N) fp32, all contiguous;
// eps2 = eps^2.  Returns a cudaError_t.
extern "C" int repro_nbody(const void* pos, const void* mass, void* out,
                           int n, float eps2, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  nbody_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(mass),
      static_cast<float*>(out), n, eps2);
  return static_cast<int>(cudaGetLastError());
}
