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
// What this design does about it.  Two routes, chosen by the wrapper
// (kernels/attention/flash.py::flash_route) from (dtype, hd) alone.
//
// wgmma (bf16 at hd 64, 128 and 256).  One warpgroup owns a (batch x
// head, 64-row query tile).  Its Q tile comes once by TMA (128-byte
// swizzle, hd / 64 atoms a row); K and V tiles of 64 keys stream through
// a two-stage TMA ring tracked by mbarriers (Q 32 KB + 2 x (32 + 32) KB
// at hd = 256: one block per SM).  S = Q K^T runs on wgmma m64n64k16 (K
// K-major) into fp32 registers; the online softmax runs on those
// registers, row max and row sum across the four lanes that share a row
// (quad shuffles); P, rounded to V's type as flash.py:75 does, goes
// straight from the accumulator into the A operand of O += P V (wgmma
// m64n{hd}k16, V MN-major through the transpose bit), whose fp32
// accumulator (64 x 256 at hd = 256: 128 registers a thread) never
// leaves the registers until the flush.  While one K/V stage is being
// used the next one loads.  Query tiles are handed out heaviest first
// (the last ones under a causal mask).
//
// simt (fp32, and bf16 at other head widths).  One block owns a (batch x
// head, 32-row query tile) and loops over 32-key K/V tiles inside,
// keeping q, the 32 x hd fp32 accumulator, one K and one V tile and the
// scores in shared memory (133 KB at hd = 256); both products run on
// fp32 FMA units.
//
// Both: the TPU kernel carries the running max m, denominator l and the
// accumulator across a sequential ('arbitrary') KV grid axis; here a loop
// inside the block does.  Tiles that no row of the block can see are
// skipped structurally, as flash.py:44-53 does: causal stops at the
// block's last row, a window starts at its first row's oldest visible
// key.  Ragged edges (S not a multiple of the tile) are masked, not
// asserted.  The flush divides by max(l, 1e-30) and writes lse = m +
// log(max(l, 1e-30)), exactly as the TPU kernel's flush.
//
// A query block at an offset.  q holds Sq rows at positions q_off ..
// q_off + Sq - 1 of k/v's Sk rows (Sq + q_off <= Sk): the query block of
// one rank of a sequence-striped layer.  The causal and window masks and
// the dead-tile bounds read those positions; o and lse have q's Sq rows.
// The TPU kernel takes Sq == Sk and q_off == 0 only.
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int TK = 32;        // keys per tile: one softmax lane per key
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int q_off, int hd,
                 int causal, int window) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, Sq - q0);
  const long long base = (long long)blockIdx.x * Sq * hd;
  const long long kbase = (long long)blockIdx.x * Sk * hd;
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
      v_s[t * hd + d] = vv;
    }
    __syncthreads();
    // scores: one thread per (query row, key)
    for (int i = tid; i < BQ * TK; i += THREADS) {
      const int r = i / TK, t = i % TK;
      const int qpos = q_off + q0 + r, kpos = k_lo + t;
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
    lse[(long long)blockIdx.x * Sq + q0 + r] =
        m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (2 * BQ * hd + TK * (hd + 1) + TK * hd + BQ * TK + 3 * BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Sq, int Sk, int q_off, int hd, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, q_off, hd, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ wgmma route
constexpr int WQ = 64;  // query rows per block: one warpgroup
constexpr int WK = 64;  // keys per K/V tile
constexpr int WSTAGES = 2;
constexpr int WTHREADS = 128;

template <int HD>
struct FwdSmem {
  static constexpr int TILE = WQ * HD * 2;  // one 64 x hd bf16 tile
  static constexpr int Q = 0;
  static constexpr int KV = TILE;  // stage s: K at KV + 2 s TILE, V after
  static constexpr int BARS = KV + WSTAGES * 2 * TILE;
  static constexpr int BYTES = 1024 + BARS + 8 * (WSTAGES + 1);
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       float* __restrict__ out, float* __restrict__ lse,
                       int Sq, int Sk, int q_off, int causal, int window) {
  using L = FwdSmem<HD>;
  constexpr int R = HD / 2;  // O accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* qbar = full + WSTAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;  // heaviest first
  const int q_hi = q_off + min(Sq, q0 + WQ) - 1;
  // keys some row of this block can see: [k_begin, k_end), in tiles
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int t0 = k_begin / WK;
  const int nt = (k_end + WK - 1) / WK - t0;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  auto issue_kv = [&](int t) {
    const int s = t % WSTAGES;
    uint8_t* ks = smem + L::KV + s * 2 * L::TILE;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
    sm90::tma_tile<HD>(ks, &tm_k, &full[s], WK, (t0 + t) * WK, bh);
    sm90::tma_tile<HD>(ks + L::TILE, &tm_v, &full[s], WK, (t0 + t) * WK, bh);
  };
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(qbar, L::TILE);
    sm90::tma_tile<HD>(smem + L::Q, &tm_q, qbar, WQ, q0, bh);
    for (int t = 0; t < min(nt, WSTAGES); ++t) issue_kv(t);
  }

  // this thread's rows (accumulator registers i with i & 2 are r1's) and
  // their positions among the keys
  const int r0 = q0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const int p0 = q_off + r0, p1 = q_off + r1;
  float o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;  // l: this lane's
  sm90::mbar_wait(qbar, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % WSTAGES;
    const uint8_t* ks = smem + L::KV + s * 2 * L::TILE;
    const uint8_t* vs = ks + L::TILE;
    sm90::mbar_wait(&full[s], (t / WSTAGES) & 1);
    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n64(sc, sm90::desc_kmajor(smem + L::Q, WQ, kk),
                         sm90::desc_kmajor(ks, WK, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    // mask, online softmax on the fragments
    const int kb = (t0 + t) * WK + 2 * (lane % 4);
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = (i & 2) ? p1 : p0;
      const int col = kb + 8 * (i / 4) + (i & 1);
      const bool ok = col < Sk && (!causal || col <= row) &&
                      (window == 0 || col > row - window);
      sc[i] = ok ? sc[i] * scale : NEG_BIG;
      if (i & 2)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p =
          sc[i] > NEG_BIG ? __expf(sc[i] - ((i & 2) ? mn1 : mn0)) : 0.f;
      sc[i] = p;
      if (i & 2)
        ps1 += p;
      else
        ps0 += p;
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] *= (i & 2) ? al1 : al0;

    // O += P V, P rounded to bf16 (V's type)
    uint32_t a[WK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) sm90::a_frag(a[kk], sc, kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      sm90::wgmma_rs<HD>(o, a[kk], sm90::desc_mnmajor(vs, WK, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && t + WSTAGES < nt) issue_kv(t + WSTAGES);
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  float* ob = out + static_cast<long long>(bh) * Sq * HD;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    const float d = (i & 2) ? d1 : d0;
    if (row < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(row) * HD +
                                 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(o[i] / d, o[i + 1] / d);
  }
  if (lane % 4 == 0) {
    float* lb = lse + static_cast<long long>(bh) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(d0);
    if (r1 < Sq) lb[r1] = m1 + logf(d1);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int Sq, int Sk, int q_off, int causal,
                 int window, cudaStream_t stream) {
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (!encode_bhsd_map(&tq, q, BH, Sq, HD, WQ) ||
      !encode_bhsd_map(&tk, k, BH, Sk, HD, WK) ||
      !encode_bhsd_map(&tv, v, BH, Sk, HD, WK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = FwdSmem<HD>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + WQ - 1) / WQ);
  flash_fwd_wgmma_kernel<HD><<<grid, WTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), static_cast<float*>(lse), Sq, Sk,
      q_off, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The simt route: q (BH, Sq, hd) and k, v (BH, Sk, hd) of the float type
// `dtype`, q's rows at key positions q_off .. q_off + Sq - 1 (q_off + Sq
// <= Sk); out (BH, Sq, hd) fp32; lse (BH, Sq) fp32; all contiguous.
// causal 0/1; window 0 = none.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int Sq, int Sk, int q_off, int hd,
                                     int causal, int window, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Sq == 0) return 0;
  if (q_off < 0 || q_off + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, BH, Sq, Sk, q_off, hd,
                                 causal, window, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, out, lse, BH, Sq, Sk, q_off, hd, causal,
                         window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route: q (BH, Sq, hd) and k, v (BH, Sk, hd) bf16, hd 64, 128 or
// 256, each 16-byte aligned, q's rows at key positions q_off .. q_off + Sq
// - 1; out (BH, Sq, hd) fp32; lse (BH, Sq) fp32; all contiguous.  causal
// 0/1; window 0 = none.  Returns a cudaError_t.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int BH, int Sq, int Sk,
                                           int q_off, int hd, int causal,
                                           int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Sq == 0) return 0;
  if (q_off < 0 || q_off + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_wgmma<64>(q, k, v, out, lse, BH, Sq, Sk, q_off, causal,
                            window, s);
  if (hd == 128)
    return launch_wgmma<128>(q, k, v, out, lse, BH, Sq, Sk, q_off, causal,
                             window, s);
  if (hd == 256)
    return launch_wgmma<256>(q, k, v, out, lse, BH, Sq, Sk, q_off, causal,
                             window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
