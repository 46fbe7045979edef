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
// gradients.  Each step recomputes P = exp(scale q k^T - lse) under the
// causal / window mask and dS = P (dO V^T - delta) from the forward's lse
// residual (delta = rowsum(dO O) comes precomputed from the wrapper), as
// backward.py:_p_and_ds does; the (S, S) matrix never exists.  Dead tiles
// are skipped structurally, as backward.py:_tile_live does.  dS is
// rounded to q/k's type before the products with K and Q, P to dO's
// (fp32), as in the TPU kernels.  Two routes, chosen by the wrapper from
// (dtype, hd) alone (kernels/attention/flash.py::flash_route).
//
// wgmma (bf16 at hd 64, 128 and 256).  Two of the products have an fp32
// operand, dO: dP = dO V^T and dV = P^T dO.  A first kernel splits dO
// into bf16 halves, dO = hi + lo (exact to ~2^-16 relative), so both run
// on bf16 wgmma: dP = hi V^T + lo V^T (V is exact in bf16) and dV =
// P_hi^T hi + P_hi^T lo + P_lo^T hi.  (On the training path dO is a bf16
// cotangent cast up, so lo is zero there; the kernels do not assume it.)
//   dQ:  one warpgroup per (batch x head, 64 query rows) keeps Q, hi and
//        lo (TMA, once) and the 64 x hd fp32 dQ accumulator in registers;
//        64-key K/V tiles stream through a two-stage TMA ring (224 KB at
//        hd = 256).  Per tile: S and dP on m64n64k16, P and dS on the
//        fragments, dQ += dS K on m64n{hd}k16 with dS from registers.
//   dKV: one block per (batch x head, 64 keys) keeps K and V (TMA, once);
//        32-row q / hi / lo tiles stream through a two-stage ring (168 KB
//        at hd = 256).  The two 64 x hd accumulators (2 x 128 registers a
//        thread at hd = 256) are too many for one warpgroup, so two
//        share the block: the first forms P^T = exp(K Q^T scale - lse)
//        (m64n32k16), hands it to the second through 8 KB of shared
//        memory and accumulates dV; the second forms dP^T = V dO^T, reads
//        P^T, forms dS^T and accumulates dK = dS^T Q.  One writer per
//        output tile still: each accumulator belongs to one warpgroup.
//
// simt (fp32, and bf16 at other head widths).
//   dQ:  one block per (batch x head, 32 query rows) keeps q, dO and the
//        32 x hd dQ accumulator, and loops over 32-key K/V tiles.
//   dKV: one block per (batch x head, 32 keys) keeps K, V and the two
//        32 x hd dK / dV accumulators, and loops over 32-row q/dO tiles.
//   At hd = 256 the dKV block holds 201 KB of shared memory (of 227 KB);
//   32-row tiles are what make two fp32 accumulators fit.  All products
//   run on fp32 FMA units.
//
// A query block at an offset, as in the forward (flash_attention.cu): q,
// dO, lse and delta have Sq rows at key positions q_off .. q_off + Sq - 1
// of k/v's Sk rows.  dK and dV are then this block's part of the whole
// gradient: the rows of other blocks add theirs (the caller's
// reduce-scatter).  Keys no row of the block sees get zeros.
#include <algorithm>

#include "flash_sm90.cuh"

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
                int Sq, int Sk, int q_off, int hd, int causal, int window) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, Sq - q0);
  const long long base = (long long)blockIdx.x * Sq * hd;
  const long long kbase = (long long)blockIdx.x * Sk * hd;
  const long long row_base = (long long)blockIdx.x * Sq;
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

  const int q_hi = q_off + q0 + nq - 1;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;

  for (int k_lo = (k_begin / TK) * TK; k_lo < k_end; k_lo += TK) {
    for (int i = tid; i < TK * hd; i += THREADS) {
      const int t = i / hd, d = i % hd, kpos = k_lo + t;
      float kv = 0.f, vv = 0.f;
      if (kpos < k_end) {
        const long long off = kbase + (long long)kpos * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[t * kstride + d] = kv;
      v_s[t * kstride + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < BQ * TK; i += THREADS) {
      const int r = i / TK, t = i % TK;
      const int qpos = q_off + q0 + r, kpos = k_lo + t;
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
                 float* __restrict__ dv, int Sq, int Sk, int q_off, int hd,
                 int causal, int window) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.y * TK;
  const int nk = min(TK, Sk - k0);
  const long long base = (long long)blockIdx.x * Sq * hd;
  const long long kbase = (long long)blockIdx.x * Sk * hd;
  const long long row_base = (long long)blockIdx.x * Sq;
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
      const long long off = kbase + (long long)(k0 + t) * hd + d;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    k_s[t * kstride + d] = kv;
    v_s[t * kstride + d] = vv;
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  __syncthreads();

  // q's rows some key of this block is visible to: [q_begin, q_end)
  const int k_hi = k0 + nk - 1;
  const int q_begin = max(0, (causal ? k0 : 0) - q_off);
  const int q_end =
      max(q_begin, window > 0 ? min(Sq, k_hi + window - q_off) : Sq);

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
      const int qpos = q_off + q_lo + r, kpos = k0 + t;
      float p, ds;
      p_and_ds(q_s + r * hd, do_s + r * hd, k_s + t * kstride,
               v_s + t * kstride, hd, scale, lse_s[r], delta_s[r],
               q_lo + r < q_end && t < nk &&
                   visible(qpos, kpos, causal, window),
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
    const long long off = kbase + (long long)k0 * hd + i;
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
           int BH, int Sq, int Sk, int q_off, int hd, int causal, int window,
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
  flash_dq_kernel<T><<<dim3(BH, (Sq + BQ - 1) / BQ), THREADS, smem_q,
                       stream>>>(qt, kt, vt, dot, lset, dlt,
                                 static_cast<float*>(dq), Sq, Sk, q_off, hd,
                                 causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<T><<<dim3(BH, (Sk + TK - 1) / TK), THREADS, smem_kv,
                        stream>>>(qt, kt, vt, dot, lset, dlt,
                                  static_cast<float*>(dk),
                                  static_cast<float*>(dv), Sq, Sk, q_off, hd,
                                  causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ wgmma route
constexpr int WT = 64;       // dQ: query rows per block, keys per tile;
                             // dKV: keys per block
constexpr int WQ2 = 32;      // dKV: query rows per streamed tile
constexpr int WSTAGES = 2;

template <int HD>
struct BwdSmem {
  static constexpr int T64 = WT * HD * 2;   // a 64 x hd bf16 tile
  static constexpr int T32 = WQ2 * HD * 2;  // a 32 x hd bf16 tile
  // dQ: Q, hi, lo; then stage s: K at RING + 2 s T64, V after it
  static constexpr int DQ_RING = 3 * T64;
  static constexpr int DQ_BARS = DQ_RING + WSTAGES * 2 * T64;
  static constexpr int DQ_BYTES = 1024 + DQ_BARS + 8 * (WSTAGES + 1);
  // dKV: K, V; then stage s: Q at RING + 3 s T32, hi, lo after it; then
  // P^T handed between the warpgroups (16 fp32 a thread of 128)
  static constexpr int KV_RING = 2 * T64;
  static constexpr int KV_P = KV_RING + WSTAGES * 3 * T32;
  static constexpr int KV_BARS = KV_P + 16 * 128 * 4;
  static constexpr int KV_BYTES = 1024 + KV_BARS + 8 * (WSTAGES + 1);
};

// fp32 dO -> its bf16 halves hi = bf16(dO), lo = bf16(dO - hi); n4 groups
// of 4 values
__global__ void __launch_bounds__(256)
flash_bwd_split_kernel(const float4* __restrict__ dout, uint2* __restrict__ hi,
                       uint2* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += gridDim.x * 256ll) {
    const float4 x = dout[i];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(
        x.x - __low2float(h01), x.y - __high2float(h01));
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(
        x.z - __low2float(h23), x.w - __high2float(h23));
    hi[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                       *reinterpret_cast<const uint32_t*>(&h23));
    lo[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                       *reinterpret_cast<const uint32_t*>(&l23));
  }
}

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_hi,
                      const __grid_constant__ CUtensorMap tm_lo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int Sq, int Sk, int q_off, int causal, int window) {
  using L = BwdSmem<HD>;
  constexpr int R = HD / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* hi_s = smem + L::T64;
  uint8_t* lo_s = smem + 2 * L::T64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::DQ_BARS);
  uint64_t* qbar = full + WSTAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WT;  // heaviest first
  const int q_hi = q_off + min(Sq, q0 + WT) - 1;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int t0 = k_begin / WT;
  const int nt = (k_end + WT - 1) / WT - t0;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  auto issue_kv = [&](int t) {
    const int s = t % WSTAGES;
    uint8_t* ks = smem + L::DQ_RING + s * 2 * L::T64;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::T64);
    sm90::tma_tile<HD>(ks, &tm_k, &full[s], WT, (t0 + t) * WT, bh);
    sm90::tma_tile<HD>(ks + L::T64, &tm_v, &full[s], WT, (t0 + t) * WT, bh);
  };
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(qbar, 3 * L::T64);
    sm90::tma_tile<HD>(q_s, &tm_q, qbar, WT, q0, bh);
    sm90::tma_tile<HD>(hi_s, &tm_hi, qbar, WT, q0, bh);
    sm90::tma_tile<HD>(lo_s, &tm_lo, qbar, WT, q0, bh);
    for (int t = 0; t < min(nt, WSTAGES); ++t) issue_kv(t);
  }

  const int r0 = q0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const long long rows = static_cast<long long>(bh) * Sq;
  const float lse0 = r0 < Sq ? lse[rows + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[rows + r1] : 0.f;
  const float dl0 = r0 < Sq ? delta[rows + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[rows + r1] : 0.f;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  sm90::mbar_wait(qbar, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % WSTAGES;
    const uint8_t* ks = smem + L::DQ_RING + s * 2 * L::T64;
    const uint8_t* vs = ks + L::T64;
    sm90::mbar_wait(&full[s], (t / WSTAGES) & 1);
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n64(sc, sm90::desc_kmajor(q_s, WT, kk),
                         sm90::desc_kmajor(ks, WT, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n64(dp, sm90::desc_kmajor(hi_s, WT, kk),
                         sm90::desc_kmajor(vs, WT, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n64(dp, sm90::desc_kmajor(lo_s, WT, kk),
                         sm90::desc_kmajor(vs, WT, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // P and dS on the fragments; dS replaces S
    const int kb = (t0 + t) * WT + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = (i & 2) ? r1 : r0;
      const int pos = q_off + row;
      const int col = kb + 8 * (i / 4) + (i & 1);
      const bool ok = row < Sq && col < Sk && (!causal || col <= pos) &&
                      (window == 0 || col > pos - window);
      const float p =
          ok ? __expf(sc[i] * scale - ((i & 2) ? lse1 : lse0)) : 0.f;
      sc[i] = p * (dp[i] - ((i & 2) ? dl1 : dl0));
    }
    // dQ += dS K, dS rounded to bf16 (q/k's type)
    uint32_t a[WT / 16][4];
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk) sm90::a_frag(a[kk], sc, kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk)
      sm90::wgmma_rs<HD>(acc, a[kk], sm90::desc_mnmajor(ks, WT, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && t + WSTAGES < nt) issue_kv(t + WSTAGES);
  }

  float* out = dq + rows * HD;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    if (row < Sq)
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * HD +
                                 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(acc[i] * scale, acc[i + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_hi,
                       const __grid_constant__ CUtensorMap tm_lo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int Sq,
                       int Sk, int q_off, int causal, int window) {
  using L = BwdSmem<HD>;
  constexpr int R = HD / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::T64;
  float* p_s = reinterpret_cast<float*>(smem + L::KV_P);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::KV_BARS);
  uint64_t* kvbar = full + WSTAGES;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * WT;  // heaviest (causal: first) first
  const int k_hi = min(Sk, k0 + WT) - 1;
  // q's rows some key of this block is visible to: [q_begin, q_end)
  const int q_begin = max(0, (causal ? k0 : 0) - q_off);
  const int q_end =
      max(q_begin, window > 0 ? min(Sq, k_hi + window - q_off) : Sq);
  const int t0 = q_begin / WQ2;
  const int nt = (q_end + WQ2 - 1) / WQ2 - t0;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  auto issue_q = [&](int t) {
    const int s = t % WSTAGES;
    uint8_t* qs = smem + L::KV_RING + s * 3 * L::T32;
    const int row0 = (t0 + t) * WQ2;
    sm90::mbar_arrive_expect_tx(&full[s], 3 * L::T32);
    sm90::tma_tile<HD>(qs, &tm_q, &full[s], WQ2, row0, bh);
    sm90::tma_tile<HD>(qs + L::T32, &tm_hi, &full[s], WQ2, row0, bh);
    sm90::tma_tile<HD>(qs + 2 * L::T32, &tm_lo, &full[s], WQ2, row0, bh);
  };
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init(kvbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(kvbar, 2 * L::T64);
    sm90::tma_tile<HD>(k_s, &tm_k, kvbar, WT, k0, bh);
    sm90::tma_tile<HD>(v_s, &tm_v, kvbar, WT, k0, bh);
    for (int t = 0; t < min(nt, WSTAGES); ++t) issue_q(t);
  }

  // this thread's key rows; its query columns of a 64 x 32 fragment are
  // qb + 8 (i / 4) + 2 (lane % 4) + (i & 1)
  const int kr0 = k0 + 16 * warp + lane / 4, kr1 = kr0 + 8;
  const long long rows = static_cast<long long>(bh) * Sq;
  float acc[R];  // warpgroup 0: dV; warpgroup 1: dK / scale
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  sm90::mbar_wait(kvbar, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % WSTAGES;
    const uint8_t* qs = smem + L::KV_RING + s * 3 * L::T32;
    const uint8_t* his = qs + L::T32;
    const uint8_t* los = qs + 2 * L::T32;
    const int qb = (t0 + t) * WQ2 + 2 * (lane % 4);
    sm90::mbar_wait(&full[s], (t / WSTAGES) & 1);
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = 0.f;
    if (wg == 0) {
      // P^T = exp(K Q^T scale - lse) under the mask
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n32(f, sm90::desc_kmajor(k_s, WT, kk),
                           sm90::desc_kmajor(qs, WQ2, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(f);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = (i & 2) ? kr1 : kr0;
        const int qc = qb + 8 * (i / 4) + (i & 1);
        const int pos = q_off + qc;
        const bool ok = key < Sk && qc < Sq && (!causal || key <= pos) &&
                        (window == 0 || key > pos - window);
        f[i] = ok ? __expf(f[i] * scale - lse[rows + qc]) : 0.f;
        p_s[i * 128 + wt] = f[i];
      }
      sm90::named_arrive(1, 256);
      // dV += P^T dO = P_hi^T hi + P_hi^T lo + P_lo^T hi
      uint32_t ah[WQ2 / 16][4], al[WQ2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < WQ2 / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = f[8 * kk + 2 * j], x1 = f[8 * kk + 2 * j + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          ah[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
          al[kk][j] = sm90::pack_bf16(x0 - __low2float(h),
                                      x1 - __high2float(h));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WQ2 / 16; ++kk) {
        sm90::wgmma_rs<HD>(acc, ah[kk], sm90::desc_mnmajor(his, WQ2, kk));
        sm90::wgmma_rs<HD>(acc, ah[kk], sm90::desc_mnmajor(los, WQ2, kk));
        sm90::wgmma_rs<HD>(acc, al[kk], sm90::desc_mnmajor(his, WQ2, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    } else {
      // dP^T = V dO^T = V hi^T + V lo^T
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n32(f, sm90::desc_kmajor(v_s, WT, kk),
                           sm90::desc_kmajor(his, WQ2, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n32(f, sm90::desc_kmajor(v_s, WT, kk),
                           sm90::desc_kmajor(los, WQ2, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(f);
      sm90::named_sync(1, 256);  // P^T is in p_s
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qc = qb + 8 * (i / 4) + (i & 1);
        const float dl = qc < Sq ? delta[rows + qc] : 0.f;
        f[i] = p_s[i * 128 + wt] * (f[i] - dl);
      }
      // dK += dS^T Q, dS rounded to bf16
      uint32_t a[WQ2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < WQ2 / 16; ++kk) sm90::a_frag(a[kk], f, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WQ2 / 16; ++kk)
        sm90::wgmma_rs<HD>(acc, a[kk], sm90::desc_mnmajor(qs, WQ2, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with stage s and p_s
    if (tid == 0 && t + WSTAGES < nt) issue_q(t + WSTAGES);
  }

  float* out = (wg == 0 ? dv : dk) + static_cast<long long>(bh) * Sk * HD;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int key = (i & 2) ? kr1 : kr0;
    if (key < Sk)
      *reinterpret_cast<float2*>(out + static_cast<long long>(key) * HD +
                                 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, int smem,
                  cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, void* dout_split, int BH,
                 int Sq, int Sk, int q_off, int causal, int window,
                 cudaStream_t stream) {
  using L = BwdSmem<HD>;
  const long long n = static_cast<long long>(BH) * Sq * HD;
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(dout_split);
  __nv_bfloat16* lo = hi + n;
  CUtensorMap tq = {}, tk = {}, tv = {}, thi = {}, tlo = {};
  CUtensorMap tq32 = {}, thi32 = {}, tlo32 = {};
  if (!encode_bhsd_map(&tq, q, BH, Sq, HD, WT) ||
      !encode_bhsd_map(&tk, k, BH, Sk, HD, WT) ||
      !encode_bhsd_map(&tv, v, BH, Sk, HD, WT) ||
      !encode_bhsd_map(&thi, hi, BH, Sq, HD, WT) ||
      !encode_bhsd_map(&tlo, lo, BH, Sq, HD, WT) ||
      !encode_bhsd_map(&tq32, q, BH, Sq, HD, WQ2) ||
      !encode_bhsd_map(&thi32, hi, BH, Sq, HD, WQ2) ||
      !encode_bhsd_map(&tlo32, lo, BH, Sq, HD, WQ2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const long long blocks = std::min<long long>((n4 + 255) / 256, 132 * 8);
  flash_bwd_split_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const float4*>(dout), reinterpret_cast<uint2*>(hi),
      reinterpret_cast<uint2*>(lo), n4);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  rc = launch_kernel(flash_dq_wgmma_kernel<HD>,
                     dim3(BH, (Sq + WT - 1) / WT), 128, L::DQ_BYTES, stream,
                     tq, tk, tv, thi, tlo, lse_f, delta_f,
                     static_cast<float*>(dq), Sq, Sk, q_off, causal, window);
  if (rc) return rc;
  return launch_kernel(flash_dkv_wgmma_kernel<HD>,
                       dim3(BH, (Sk + WT - 1) / WT), 256, L::KV_BYTES, stream,
                       tq32, tk, tv, thi32, tlo32, lse_f, delta_f,
                       static_cast<float*>(dk), static_cast<float*>(dv), Sq,
                       Sk, q_off, causal, window);
}

}  // namespace

// The simt route: q (BH, Sq, hd) and k, v (BH, Sk, hd) of the float type
// `dtype`, q's rows at key positions q_off .. q_off + Sq - 1 (q_off + Sq
// <= Sk); dout (BH, Sq, hd) fp32; lse, delta (BH, Sq) fp32; dq (BH, Sq,
// hd), dk, dv (BH, Sk, hd) fp32; all contiguous.  Launches the dQ sweep,
// then the dK/dV sweep.  Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int BH,
                                         int Sq, int Sk, int q_off, int hd,
                                         int causal, int window, int dtype,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Sk == 0) return 0;
  if (q_off < 0 || q_off + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                 Sq, Sk, q_off, hd, causal, window, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk,
                         q_off, hd, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route: q (BH, Sq, hd) and k, v (BH, Sk, hd) bf16, hd 64, 128
// or 256, q's rows at key positions q_off .. q_off + Sq - 1; dout (BH, Sq,
// hd) fp32; lse, delta (BH, Sq) fp32; dq (BH, Sq, hd), dk, dv (BH, Sk, hd)
// fp32; dout_split 2 x BH x Sq x hd bf16 of scratch (dO's halves); all
// contiguous and 16-byte aligned.  Splits dO, then launches the dQ sweep
// and the dK/dV sweep.  Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    void* dout_split, int BH, int Sq, int Sk, int q_off, int hd, int causal,
    int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Sk == 0) return 0;
  if (q_off < 0 || q_off + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                            dout_split, BH, Sq, Sk, q_off, causal, window, s);
  if (hd == 128)
    return launch_wgmma<128>(q, k, v, dout, lse, delta, dq, dk, dv,
                             dout_split, BH, Sq, Sk, q_off, causal, window,
                             s);
  if (hd == 256)
    return launch_wgmma<256>(q, k, v, dout, lse, delta, dq, dk, dv,
                             dout_split, BH, Sq, Sk, q_off, causal, window,
                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}
