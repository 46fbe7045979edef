// RWKV6 chunked WKV recurrence: the port of the TPU kernel
// src/repro/kernels/wkv/wkv.py::wkv_pallas (_wkv_kernel).
//
// For one (batch, head), with per-channel log-decays lw <= 0, the output
// row i of a chunk of c rows is
//   o_i = (r_i * exp(ecum_i)) @ S                       (earlier chunks)
//       + sum_{j<i} (sum_d r_id k_jd exp(ecum_id - cum_jd)) v_j
//       + (r_i . (u * k_i)) v_i                         (the bonus)
// with cum the inclusive and ecum the exclusive cumsum of lw over the
// chunk, and the (hd, hd) state then becomes
//   S <- exp(total) * S + (k * exp(total - cum))^T @ v,  total = cum_{c-1}.
//
// What bounds it on the H100.  At rwkv6-7b's time-mix width (B=4,
// S=4096, H=64, hd=64, c=64) the function reads r, k, v (bf16 or fp32)
// and lw (fp32) once and writes o (fp32) once: 940 MB in bf16.  The work
// is ~32 G operations, 2.1 G of them exponentials (one per (i, j < i,
// channel) of every chunk), ~34 per byte: on fp32 FMA units with an
// accurate expf it is bound by operations, not bytes.
//
// What this design does about it.  The TPU kernel walks the chunks on a
// sequential ('arbitrary') grid axis and carries the state in a VMEM
// scratch.  Blocks on Hopper run in no order, so one block owns one
// (batch, head) and loops over its chunks inside, with the fp32 state in
// shared memory the whole time.  Per chunk it stages r, k, v and the
// cumsum of lw (c x hd fp32 each, rows padded to hd + 1 floats against
// bank conflicts) and the (c, c) attention matrix: 100 KB at c = hd = 64,
// so two blocks share an SM and B x H = 256 blocks fill the card in one
// wave.  Every exponent stays <= 0: the intra-chunk weight is one
// exponential of (ecum_i - cum_j), clamped at -60 as wkv.py:83 does, and
// never exp(ecum_i) * exp(-cum_j), whose second factor overflows under
// strong decay.  The bonus sits on the attention matrix's diagonal.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// floats of shared memory: r, k, v, cum tiles (c x (hd+1)); the attention
// matrix (c x (c+1)); the state (hd x (hd+1)); u (hd)
size_t smem_floats(int c, int hd) {
  const size_t ld = hd + 1;
  return 4 * c * ld + static_cast<size_t>(c) * (c + 1) + hd * ld + hd;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, float* __restrict__ out, int S,
           int H, int hd, int c) {
  extern __shared__ float smem[];
  const int ld = hd + 1, lda = c + 1;
  float* rs = smem;                  // r, then r * exp(ecum)
  float* ks = rs + c * ld;           // k, then k * exp(total - cum)
  float* vs = ks + c * ld;
  float* cum = vs + c * ld;          // lw, then its inclusive cumsum
  float* att = cum + c * ld;         // (c, c+1), lower triangle
  float* st = att + c * lda;         // the state, (hd, hd+1)
  float* us = st + hd * ld;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = static_cast<long long>(H) * hd;  // one time step
  const long long base = (static_cast<long long>(b) * S * H + h) * hd;

  for (int e = tid; e < hd * ld; e += THREADS) st[e] = 0.f;
  for (int d = tid; d < hd; d += THREADS) us[d] = u[h * hd + d];

  for (int s0 = 0; s0 < S; s0 += c) {
    for (int e = tid; e < c * hd; e += THREADS) {
      const int i = e / hd, d = e % hd;
      const long long g = base + (s0 + i) * step + d;
      rs[i * ld + d] = to_f32(r[g]);
      ks[i * ld + d] = to_f32(k[g]);
      vs[i * ld + d] = to_f32(v[g]);
      cum[i * ld + d] = lw[g];
    }
    __syncthreads();
    // inclusive cumsum per channel; the exclusive one is the row above
    for (int d = tid; d < hd; d += THREADS) {
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        run += cum[i * ld + d];
        cum[i * ld + d] = run;
      }
    }
    __syncthreads();
    // attention matrix: j < i decayed, j == i the bonus
    for (int e = tid; e < c * c; e += THREADS) {
      const int i = e / c, j = e % c;
      if (j > i) continue;
      const float* ri = rs + i * ld;
      const float* kj = ks + j * ld;
      float a = 0.f;
      if (j == i) {
        for (int d = 0; d < hd; ++d) a += ri[d] * (us[d] * kj[d]);
      } else {
        const float* ecum_i = cum + (i - 1) * ld;   // i >= 1 here
        const float* cum_j = cum + j * ld;
        for (int d = 0; d < hd; ++d)
          a += ri[d] * kj[d] * expf(fmaxf(ecum_i[d] - cum_j[d], -60.f));
      }
      att[i * lda + j] = a;
    }
    __syncthreads();
    for (int e = tid; e < c * hd; e += THREADS) {
      const int i = e / hd, d = e % hd;
      const float total = cum[(c - 1) * ld + d];
      const float ecum = i > 0 ? cum[(i - 1) * ld + d] : 0.f;
      rs[i * ld + d] *= expf(ecum);
      ks[i * ld + d] *= expf(total - cum[i * ld + d]);
    }
    __syncthreads();
    for (int e = tid; e < c * hd; e += THREADS) {
      const int i = e / hd, d = e % hd;
      float inter = 0.f, intra = 0.f;
      for (int x = 0; x < hd; ++x) inter += rs[i * ld + x] * st[x * ld + d];
      for (int j = 0; j <= i; ++j) intra += att[i * lda + j] * vs[j * ld + d];
      out[base + (s0 + i) * step + d] = inter + intra;
    }
    __syncthreads();
    for (int e = tid; e < hd * hd; e += THREADS) {
      const int x = e / hd, d = e % hd;
      float add = 0.f;
      for (int j = 0; j < c; ++j) add += ks[j * ld + x] * vs[j * ld + d];
      st[x * ld + d] = expf(cum[(c - 1) * ld + x]) * st[x * ld + d] + add;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* out, int B, int S, int H, int hd, int c,
           cudaStream_t stream) {
  const size_t smem = smem_floats(c, hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)        // two 100 KB blocks per SM at c = hd = 64
    err = cudaFuncSetAttribute(wkv_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), S, H, hd, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v (B, S, H, hd) of the float type `dtype`; lw (B, S, H, hd) fp32;
// u (H, hd) fp32; out (B, S, H, hd) fp32; all contiguous.  c divides S.
// Returns a cudaError_t.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, void* out, int B,
                         int S, int H, int hd, int c, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0 || hd == 0) return 0;
  if (c <= 0 || S % c) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, out, B, S, H, hd, c, s);
  if (dtype == DTYPE_F32)
    return launch<float>(r, k, v, lw, u, out, B, S, H, hd, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
