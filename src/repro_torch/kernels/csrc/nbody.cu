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
// 67 TFLOP/s fp32 peak).  Counted as instructions, a pair issues 12 on the
// FP32 pipe (3 FADD, 3 FFMA, 3 FMUL, 3 FFMA) and one MUFU.RSQ: 128 FP32
// lanes an SM make that 1.54 ms at N = 65536 and 1.98 GHz, the bound
// this design can reach.
//
// What this design does about it.  The TPU kernel pins a (3, bt) block of
// target positions in VMEM and streams (3, bs) source blocks past it
// (§3.3), accumulating into a VMEM scratch (§2.1.2), over a grid of
// (target blocks, source blocks).  Here:
// - each thread keeps TPT = 2 targets (positions and accumulators) in
//   registers, so every source it reads from shared memory serves two
//   pairs (1, 2 and 4 measured: 2 and 4 within 5%, 1 slower;
//   tools/kernel_variants.py); the sources of a tile are read four at a time as float4s of x,
//   y, z and m (SoA in shared memory, one broadcast 16-byte load per four
//   sources and coordinate), so loads are a small share of the issue;
// - source tiles are double-buffered through cp.async (4-byte copies: the
//   rows of pos are 4-byte aligned for any N), tile t + 1 in flight while
//   tile t is computed;
// - the source range is split across blocks, as the TPU kernel's second
//   grid axis splits it (kernels/nbody/nbody.py::nbody_split_plan, by N
//   alone), so that N = 16128 fills the card; each split writes its
//   partial sums to an fp32 scratch and a second kernel sums them in rank
//   order: no atomics, so reruns are bit-equal;
// - 1/sqrt is rsqrt.approx.ftz.f32 (r^2 >= eps^2 = 1e-6 is never
//   subnormal), one MUFU.RSQ with no fix-up; the cube is inv * inv * inv.
// The tensor cores are no help: the distance would come from
// |ri|^2 + |rj|^2 - 2 ri.rj, which cancels for close pairs at eps = 1e-3.
// Within a split, sources are summed in ascending order, one FMA chain
// per component and target.  Ragged N is masked: a source past the end is
// zero-filled (mass 0) and a target past the end writes nothing.
#include "common.cuh"
#include "matmul_sm90.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TPT = 2;               // targets a thread
constexpr int TILE = 256;            // sources a tile

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(THREADS)
nbody_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
             float* __restrict__ out, int n, int per, float eps2) {
  __shared__ __align__(16) float src[2][4][TILE];   // x, y, z, m
  const long long row = n;                          // stride of x, y, z
  const int j_begin = blockIdx.y * per;
  const int j_end = min(n, j_begin + per);
  const int tiles = j_end > j_begin ? (j_end - j_begin + TILE - 1) / TILE : 0;
  const int i0 = blockIdx.x * THREADS * TPT + threadIdx.x;
  float xi[TPT], yi[TPT], zi[TPT], ax[TPT], ay[TPT], az[TPT];
#pragma unroll
  for (int q = 0; q < TPT; ++q) {
    const int i = i0 + q * THREADS;
    const bool live = i < n;
    xi[q] = live ? pos[i] : 0.f;
    yi[q] = live ? pos[row + i] : 0.f;
    zi[q] = live ? pos[2 * row + i] : 0.f;
    ax[q] = ay[q] = az[q] = 0.f;
  }
  auto stage = [&](int buf, int j0) {
    for (int e = threadIdx.x; e < TILE; e += THREADS) {
      const int j = j0 + e;
      const bool ok = j < j_end;
      const int js = ok ? j : 0;       // a zero-filled copy reads nothing
      sm90::cp_async4(&src[buf][0][e], pos + js, ok ? 4 : 0);
      sm90::cp_async4(&src[buf][1][e], pos + row + js, ok ? 4 : 0);
      sm90::cp_async4(&src[buf][2][e], pos + 2 * row + js, ok ? 4 : 0);
      sm90::cp_async4(&src[buf][3][e], mass + js, ok ? 4 : 0);
    }
    sm90::cp_async_commit();
  };
  if (tiles) stage(0, j_begin);
  for (int tl = 0; tl < tiles; ++tl) {
    const int buf = tl & 1;
    if (tl + 1 < tiles) {
      stage(buf ^ 1, j_begin + (tl + 1) * TILE);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* sx = reinterpret_cast<const float4*>(src[buf][0]);
    const float4* sy = reinterpret_cast<const float4*>(src[buf][1]);
    const float4* sz = reinterpret_cast<const float4*>(src[buf][2]);
    const float4* sm = reinterpret_cast<const float4*>(src[buf][3]);
#pragma unroll 2
    for (int e = 0; e < TILE / 4; ++e) {
      const float4 X = sx[e], Y = sy[e], Z = sz[e], M = sm[e];
      const float xs[4] = {X.x, X.y, X.z, X.w}, ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const float zs[4] = {Z.x, Z.y, Z.z, Z.w}, ms[4] = {M.x, M.y, M.z, M.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int q = 0; q < TPT; ++q) {
          const float dx = xs[s] - xi[q], dy = ys[s] - yi[q];
          const float dz = zs[s] - zi[q];
          const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
          const float inv = rsqrt_approx(r2);
          const float w = ms[s] * inv * (inv * inv);
          ax[q] = fmaf(dx, w, ax[q]);
          ay[q] = fmaf(dy, w, ay[q]);
          az[q] = fmaf(dz, w, az[q]);
        }
      }
    }
    __syncthreads();
  }
  // split s writes rows 3s .. 3s + 2 of out (out itself when unsplit)
  float* o = out + static_cast<long long>(blockIdx.y) * 3 * row;
#pragma unroll
  for (int q = 0; q < TPT; ++q) {
    const int i = i0 + q * THREADS;
    if (i < n) {
      o[i] = ax[q];
      o[row + i] = ay[q];
      o[2 * row + i] = az[q];
    }
  }
}

// out = sum over the splits of part, in rank order
__global__ void nbody_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long n3,
                                 int splits) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n3; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = part[e];
    for (int s = 1; s < splits; ++s) acc += part[s * n3 + e];
    out[e] = acc;
  }
}

}  // namespace

// pos (3, N) fp32, mass (N,) fp32, out (3, N) fp32, all contiguous;
// sources split into `splits` ranges of `per` (splits * per >= N > (splits
// - 1) * per); part a (splits, 3, N) fp32 scratch when splits > 1;
// eps2 = eps^2.  Returns a cudaError_t.
extern "C" int repro_nbody(const void* pos, const void* mass, void* out,
                           void* part, int n, int splits, int per,
                           float eps2, void* stream) {
  if (n == 0) return 0;
  if (splits < 1 || per < 1 ||
      static_cast<long long>(splits) * per < n ||
      static_cast<long long>(splits - 1) * per >= n ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + THREADS * TPT - 1) / (THREADS * TPT), splits);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  nbody_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(pos),
                                        static_cast<const float*>(mass), dst,
                                        n, per, eps2);
  if (splits > 1) {
    const long long n3 = 3LL * n;
    const long long want = (n3 + 255) / 256;
    const int blocks = static_cast<int>(want < 1024 ? want : 1024);
    nbody_sum_kernel<<<blocks, 256, 0, s>>>(dst, static_cast<float*>(out),
                                            n3, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
