// Dense causal / sliding-window flash attention forward with the per-row
// logsumexp residual: the port of the TPU kernel
// src/repro/kernels/attention/flash.py::flash_attention_pallas
// (_flash_kernel).
//
// What bounds it on the H100.  At the training shape (B=2, H=8, S=512,
// hd=256, causal) the two products do 4 x B x H x S^2/2 x hd = 2.1 GFLOP
// against 4 x B x H x S x hd x 2 bytes = 8.4 MB of bf16 q/k/v in and
// 8.4 MB of fp32 o out: ~130 operations per byte, under the tensor cores'
// ridge (~295) but far above what fp32 FMA units can feed (67 TFLOP/s).
// On this kernel's FMA units it is bound by operations.
//
// What this design does about it.  The TPU kernel carries the running
// max m, denominator l and (bq, hd) accumulator across a sequential
// ('arbitrary') KV grid axis.  Blocks on Hopper run in no order, so one
// block owns a (batch x head, 32-row query tile) and loops over 32-key
// K/V tiles inside, keeping q, the 32 x hd fp32 accumulator, one K and
// one V tile and the scores in shared memory (133 KB at hd = 256).  Tiles
// that no row of the block can see are skipped structurally, as
// flash.py:44-53 does: causal stops at the block's last row, a window
// starts at its first row's oldest visible key.  Ragged edges (S not a
// multiple of 32) are masked instead of asserted.  P is rounded to V's
// type before P @ V and the flush divides by max(l, 1e-30) and writes
// lse = m + log(max(l, 1e-30)), exactly as the TPU kernel's flush.  Both
// products run on fp32 FMA units; wgmma and TMA are later steps.
#include "common.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int TK = 32;        // keys per tile: one softmax lane per key
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int hd, int causal,
                 int window) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, S - q0);
  const long long base = (long long)blockIdx.x * S * hd;
  const int kstride = hd + 1;  // padded K rows: the score loop's lanes
                               // walk keys, so rows must not share banks
  float* q_s = smem;                    // BQ x hd
  float* acc_s = q_s + BQ * hd;         // BQ x hd
  float* k_s = acc_s + BQ * hd;         // TK x kstride
  float* v_s = k_s + TK * kstride;      // TK x hd
  float* p_s = v_s + TK * hd;           // BQ x TK
  float* m_s = p_s + BQ * TK;           // BQ: running max
  float* l_s = m_s + BQ;                // BQ: running denominator
  float* alpha_s = l_s + BQ;            // BQ: this tile's rescale
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd;
    q_s[i] = r < nq ? to_f32(q[base + (long long)q0 * hd + i]) : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // keys some row of this block can see: [k_begin, k_end)
  const int q_hi = q0 + nq - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(S, q_hi + 1) : S;

  for (int k_lo = (k_begin / TK) * TK; k_lo < k_end; k_lo += TK) {
    for (int i = tid; i < TK * hd; i += THREADS) {
      const int t = i / hd, d = i % hd, kpos = k_lo + t;
      float kv = 0.f, vv = 0.f;
      if (kpos < k_end) {
        const long long off = base + (long long)kpos * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[t * kstride + d] = kv;
      v_s[t * hd + d] = vv;
    }
    __syncthreads();
    // scores: one thread per (query row, key)
    for (int i = tid; i < BQ * TK; i += THREADS) {
      const int r = i / TK, t = i % TK;
      const int qpos = q0 + r, kpos = k_lo + t;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(q_s[r * hd + d], k_s[t * kstride + d], s);
      const bool valid = r < nq && kpos < k_end && (!causal || kpos <= qpos) &&
                         (window == 0 || kpos > qpos - window);
      p_s[i] = valid ? s * scale : NEG_BIG;
    }
    __syncthreads();
    // online softmax: one warp per query row, one lane per key
    for (int r = warp; r < BQ; r += THREADS / 32) {
      const float s = p_s[r * TK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = s > NEG_BIG ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[r * TK + lane] = round_via<T>(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < BQ * hd; i += THREADS) {
      const int r = i / hd, d = i % hd;
      float a = acc_s[i] * alpha_s[r];
      for (int t = 0; t < TK; ++t)
        a = fmaf(p_s[r * TK + t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * hd; i += THREADS) {
    const int r = i / hd;
    out[base + (long long)q0 * hd + i] = acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
  for (int r = tid; r < nq; r += THREADS)
    lse[(long long)blockIdx.x * S + q0 + r] =
        m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (2 * BQ * hd + TK * (hd + 1) + TK * hd + BQ * TK + 3 * BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, int hd, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), S, hd, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (BH, S, hd) of the float type `dtype`; out (BH, S, hd) fp32;
// lse (BH, S) fp32; all contiguous.  causal 0/1; window 0 = none.
// Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int S, int hd, int causal,
                                     int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || S == 0) return 0;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, BH, S, hd, causal,
                                 window, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, out, lse, BH, S, hd, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
