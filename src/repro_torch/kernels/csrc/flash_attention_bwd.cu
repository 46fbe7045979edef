// The fused recompute backward of flash attention: the port of the TPU
// kernels src/repro/kernels/attention/backward.py::
// flash_attention_bwd_pallas (_dq_kernel, _dkv_kernel).
//
// What bounds it on the H100.  At the training shape (B=2, H=8, S=512,
// hd=256, causal) the backward recomputes the scores and dP in both
// sweeps and forms dQ, dK and dV: 7 products of B x H x S^2/2 x hd
// multiply-adds each, 3.8 GFLOP, against ~25 MB of q/k/v (bf16), o, dO,
// dQ/dK/dV (fp32) and lse/delta moved once: ~150 operations per byte.  On
// this kernel's fp32 FMA units it is bound by operations.
//
// What this design does about it.  The TPU formulation's two sweeps stay,
// each over its own grid, so every output tile is written by exactly one
// block in a fixed order: no atomics, and two runs give bit-identical
// gradients.
//   dQ:  one block per (batch x head, 32 query rows) keeps q, dO and the
//        32 x hd dQ accumulator, and loops over 32-key K/V tiles.
//   dKV: one block per (batch x head, 32 keys) keeps K, V and the two
//        32 x hd dK / dV accumulators, and loops over 32-row q/dO tiles.
// Each step recomputes P = exp(scale q k^T - lse) under the causal /
// window mask and dS = P (dO V^T - delta) from the forward's lse residual
// (delta = rowsum(dO O) comes precomputed from the wrapper), as
// backward.py:_p_and_ds does; the (S, S) matrix never exists.  At
// hd = 256 the dKV block holds 201 KB of shared memory (of 227 KB); 32-row
// tiles are what make two fp32 accumulators fit.  Dead tiles are skipped
// structurally, as backward.py:_tile_live does.  dS is rounded to q/k's
// type before the products with K and Q, P to dO's (fp32), as in the TPU
// kernels.  All products run on fp32 FMA units; wgmma and TMA are later
// steps.
#include "common.cuh"

namespace {

constexpr int BQ = 32;        // query rows per tile
constexpr int TK = 32;        // keys per tile
constexpr int THREADS = 256;

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || kpos <= qpos) && (window == 0 || kpos > qpos - window);
}

// P and dS of one (query row, key) pair from the staged rows
__device__ __forceinline__ void p_and_ds(const float* q_row,
                                         const float* do_row,
                                         const float* k_row,
                                         const float* v_row, int hd,
                                         float scale, float lse, float delta,
                                         bool valid, float* p, float* ds) {
  float s = 0.f, dp = 0.f;
  for (int d = 0; d < hd; ++d) {
    s = fmaf(q_row[d], k_row[d], s);
    dp = fmaf(do_row[d], v_row[d], dp);
  }
  *p = valid ? expf(s * scale - lse) : 0.f;
  *ds = *p * (dp - delta);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int S, int hd, int causal, int window) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, S - q0);
  const long long base = (long long)blockIdx.x * S * hd;
  const long long row_base = (long long)blockIdx.x * S;
  const int kstride = hd + 1;
  float* q_s = smem;                    // BQ x hd
  float* do_s = q_s + BQ * hd;          // BQ x hd
  float* acc_s = do_s + BQ * hd;        // BQ x hd: dQ / scale
  float* k_s = acc_s + BQ * hd;         // TK x kstride
  float* v_s = k_s + TK * kstride;      // TK x kstride
  float* ds_s = v_s + TK * kstride;     // BQ x TK
  float* lse_s = ds_s + BQ * TK;        // BQ
  float* delta_s = lse_s + BQ;          // BQ
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const bool live = i / hd < nq;
    const long long off = base + (long long)q0 * hd + i;
    q_s[i] = live ? to_f32(q[off]) : 0.f;
    do_s[i] = live ? dout[off] : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    lse_s[r] = r < nq ? lse[row_base + q0 + r] : 0.f;
    delta_s[r] = r < nq ? delta[row_base + q0 + r] : 0.f;
  }
  __syncthreads();

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
      v_s[t * kstride + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < BQ * TK; i += THREADS) {
      const int r = i / TK, t = i % TK;
      const int qpos = q0 + r, kpos = k_lo + t;
      float p, ds;
      p_and_ds(q_s + r * hd, do_s + r * hd, k_s + t * kstride,
               v_s + t * kstride, hd, scale, lse_s[r], delta_s[r],
               r < nq && kpos < k_end && visible(qpos, kpos, causal, window),
               &p, &ds);
      ds_s[i] = round_via<T>(ds);
    }
    __syncthreads();
    // dQ += dS @ K
    for (int i = tid; i < BQ * hd; i += THREADS) {
      const int r = i / hd, d = i % hd;
      float a = acc_s[i];
      for (int t = 0; t < TK; ++t)
        a = fmaf(ds_s[r * TK + t], k_s[t * kstride + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * hd; i += THREADS)
    dq[base + (long long)q0 * hd + i] = acc_s[i] * scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int hd, int causal,
                 int window) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.y * TK;
  const int nk = min(TK, S - k0);
  const long long base = (long long)blockIdx.x * S * hd;
  const long long row_base = (long long)blockIdx.x * S;
  const int kstride = hd + 1;
  float* k_s = smem;                    // TK x kstride
  float* v_s = k_s + TK * kstride;      // TK x kstride
  float* dk_s = v_s + TK * kstride;     // TK x hd: dK / scale
  float* dv_s = dk_s + TK * hd;         // TK x hd
  float* q_s = dv_s + TK * hd;          // BQ x hd
  float* do_s = q_s + BQ * hd;          // BQ x hd
  float* p_s = do_s + BQ * hd;          // BQ x TK
  float* ds_s = p_s + BQ * TK;          // BQ x TK
  float* lse_s = ds_s + BQ * TK;        // BQ
  float* delta_s = lse_s + BQ;          // BQ
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int i = tid; i < TK * hd; i += THREADS) {
    const int t = i / hd, d = i % hd;
    float kv = 0.f, vv = 0.f;
    if (t < nk) {
      const long long off = base + (long long)(k0 + t) * hd + d;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    k_s[t * kstride + d] = kv;
    v_s[t * kstride + d] = vv;
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  __syncthreads();

  // query rows some key of this block is visible to: [q_begin, q_end)
  const int k_hi = k0 + nk - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_hi + window) : S;

  for (int q_lo = (q_begin / BQ) * BQ; q_lo < q_end; q_lo += BQ) {
    for (int i = tid; i < BQ * hd; i += THREADS) {
      const bool live = q_lo + i / hd < q_end;
      const long long off = base + (long long)q_lo * hd + i;
      q_s[i] = live ? to_f32(q[off]) : 0.f;
      do_s[i] = live ? dout[off] : 0.f;
    }
    for (int r = tid; r < BQ; r += THREADS) {
      const bool live = q_lo + r < q_end;
      lse_s[r] = live ? lse[row_base + q_lo + r] : 0.f;
      delta_s[r] = live ? delta[row_base + q_lo + r] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * TK; i += THREADS) {
      const int r = i / TK, t = i % TK;
      const int qpos = q_lo + r, kpos = k0 + t;
      float p, ds;
      p_and_ds(q_s + r * hd, do_s + r * hd, k_s + t * kstride,
               v_s + t * kstride, hd, scale, lse_s[r], delta_s[r],
               qpos < q_end && t < nk && visible(qpos, kpos, causal, window),
               &p, &ds);
      p_s[i] = p;                 // dO is fp32: P is not rounded
      ds_s[i] = round_via<T>(ds);
    }
    __syncthreads();
    // dV += P^T @ dO, dK += dS^T @ Q
    for (int i = tid; i < TK * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      float a = dv_s[i], b = dk_s[i];
      for (int r = 0; r < BQ; ++r) {
        a = fmaf(p_s[r * TK + t], do_s[r * hd + d], a);
        b = fmaf(ds_s[r * TK + t], q_s[r * hd + d], b);
      }
      dv_s[i] = a;
      dk_s[i] = b;
    }
    __syncthreads();
  }

  for (int i = tid; i < nk * hd; i += THREADS) {
    const long long off = base + (long long)k0 * hd + i;
    dk[off] = dk_s[i] * scale;
    dv[off] = dv_s[i];
  }
}

size_t dq_smem_bytes(int hd) {
  return sizeof(float) *
         (3 * BQ * hd + 2 * TK * (hd + 1) + BQ * TK + 2 * BQ);
}

size_t dkv_smem_bytes(int hd) {
  return sizeof(float) * (2 * TK * (hd + 1) + 2 * TK * hd + 2 * BQ * hd +
                          2 * BQ * TK + 2 * BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int BH, int S, int hd, int causal, int window,
           cudaStream_t stream) {
  const size_t smem_q = dq_smem_bytes(hd), smem_kv = dkv_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lset = static_cast<const float*>(lse);
  const float* dlt = static_cast<const float*>(delta);
  flash_dq_kernel<T><<<dim3(BH, (S + BQ - 1) / BQ), THREADS, smem_q,
                       stream>>>(qt, kt, vt, dot, lset, dlt,
                                 static_cast<float*>(dq), S, hd, causal,
                                 window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<T><<<dim3(BH, (S + TK - 1) / TK), THREADS, smem_kv,
                        stream>>>(qt, kt, vt, dot, lset, dlt,
                                  static_cast<float*>(dk),
                                  static_cast<float*>(dv), S, hd, causal,
                                  window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (BH, S, hd) of the float type `dtype`; dout (BH, S, hd) fp32;
// lse, delta (BH, S) fp32; dq, dk, dv (BH, S, hd) fp32; all contiguous.
// Launches the dQ sweep, then the dK/dV sweep.  Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int BH,
                                         int S, int hd, int causal,
                                         int window, int dtype,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || S == 0) return 0;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                 S, hd, causal, window, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, hd,
                         causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
