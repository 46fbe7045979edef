// Ragged multi-token prefill attention over a paged KV cache: the port of
// the TPU kernel src/repro/kernels/attention/prefill.py::
// prefill_attention_pallas (_prefill_kernel).
//
// What bounds it on the H100.  A chunk of C = 64 tokens of one slot attends
// causally over the slot's history plus the chunk.  With gemma-2b's GQA
// group of 8 over one kv head, the C x grp = 512 query rows of a slot share
// each K/V row, so per key the kernel does 4 x 512 x 256 operations for
// 2 x 256 elements read: ~1000 operations per byte in bf16, above the
// card's ~295.  It is bound by operations.
//
// What this design does about it.  The TPU kernel kept all 512 x 256 fp32
// accumulator rows of a (slot, kv head) in VMEM (512 KB, more than twice an
// SM's shared memory).  Here the flattened query rows are split over
// blocks: the grid is (B, Hkv, row tiles of 32), so one slot's chunk spreads
// over 16 SMs, and each block keeps its 32 x hd accumulator, one 32-key K/V
// tile and its scores in shared memory.  Row r of the flattened
// (C x grp) axis is token r / grp, query head h x grp + r % grp; its
// causal mask is kpos <= start + r / grp and its window mask
// kpos > qpos - window.  A block visits only the key tiles its own rows can
// see.  Scores and the P @ V product run on fp32 FMA units; moving both
// products onto the tensor cores (wgmma) is the next step.
//
// int8 pools (the TPU kernel's quantized branch, prefill.py:63-73, B4b)
// run the same kernel instantiated on an int8 pool type, dequantizing each
// K/V element at gather time by its (page, kv head) f32 scale, with P kept
// in fp32 before P @ V, as in decode_attention.cu.
#include "common.cuh"

namespace {

constexpr int TK = 32;        // keys per tile: one softmax lane per key
constexpr int RB = 32;        // query rows per block
constexpr int THREADS = 256;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
               const TKV* __restrict__ v_pages,
               const float* __restrict__ k_scale,
               const float* __restrict__ v_scale, const int* __restrict__ table,
               const int* __restrict__ starts, float* __restrict__ out, int C,
               int H, int Hkv, int hd, int page, int n_pages, int n_pool,
               int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, grp = H / Hkv;
  const int rows = C * grp, r0 = blockIdx.z * RB;
  const int nr = min(RB, rows - r0);
  const int kstride = hd + 1;  // padded K rows, as in the decode kernel
  float* q_s = smem;                    // RB x hd
  float* acc_s = q_s + RB * hd;         // RB x hd
  float* k_s = acc_s + RB * hd;         // TK x kstride
  float* v_s = k_s + TK * kstride;      // TK x hd
  float* p_s = v_s + TK * hd;           // RB x TK
  float* m_s = p_s + RB * TK;           // RB: running max
  float* l_s = m_s + RB;                // RB: running denominator
  float* alpha_s = l_s + RB;            // RB: this tile's rescale
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const int start = starts[b];

  for (int i = tid; i < RB * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    float v = 0.f;
    if (r < nr) {
      const int c = (r0 + r) / grp, head = h * grp + (r0 + r) % grp;
      v = to_f32(q[(((long long)b * C + c) * H + head) * hd + d]);
    }
    q_s[i] = v;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < RB; r += THREADS) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // keys this block's rows can see: [k_begin, k_end); keys past the
  // table's last page do not exist (as in the plain version)
  const int q_lo = start + r0 / grp, q_hi = start + (r0 + nr - 1) / grp;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = min(q_hi + 1, n_pages * page);

  for (int k_lo = (k_begin / TK) * TK; k_lo < k_end; k_lo += TK) {
    for (int i = tid; i < TK * hd; i += THREADS) {
      const int t = i / hd, d = i % hd, kpos = k_lo + t;
      float kv = 0.f, vv = 0.f;
      if (kpos >= k_begin && kpos < k_end) {
        const long long pid = table[(long long)b * n_pages + kpos / page];
        if (pid < 0 || pid >= n_pool) __trap();  // a page id outside the pool
        const long long off =
            ((pid * page + kpos % page) * Hkv + h) * (long long)hd + d;
        kv = load_kv(k_pages, off, k_scale, pid * Hkv + h);
        vv = load_kv(v_pages, off, v_scale, pid * Hkv + h);
      }
      k_s[t * kstride + d] = kv;
      v_s[t * hd + d] = vv;
    }
    __syncthreads();
    // scores: one thread per (query row, key)
    for (int i = tid; i < RB * TK; i += THREADS) {
      const int r = i / TK, t = i % TK, kpos = k_lo + t;
      const int qpos = start + (r0 + r) / grp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(q_s[r * hd + d], k_s[t * kstride + d], s);
      const bool valid = r < nr && kpos <= qpos && kpos < k_end &&
                         (window == 0 || kpos > qpos - window);
      p_s[i] = valid ? s * scale : NEG_BIG;
    }
    __syncthreads();
    // online softmax: one warp per query row, one lane per key
    for (int r = warp; r < RB; r += THREADS / 32) {
      const float s = p_s[r * TK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = s > NEG_BIG ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[r * TK + lane] = round_via<TKV>(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < RB * hd; i += THREADS) {
      const int r = i / hd, d = i % hd;
      float a = acc_s[i] * alpha_s[r];
      for (int t = 0; t < TK; ++t) a = fmaf(p_s[r * TK + t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // every real row sees at least its own position, so l > 0
  for (int i = tid; i < nr * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const int c = (r0 + r) / grp, head = h * grp + (r0 + r) % grp;
    out[(((long long)b * C + c) * H + head) * hd + d] =
        acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* table,
           const void* starts, void* out, int B, int C, int H, int Hkv,
           int hd, int page, int n_pages, int n_pool, int window,
           cudaStream_t stream) {
  const int rows = C * (H / Hkv);
  const size_t smem = sizeof(float) * (2 * RB * hd + TK * (hd + 1) +
                                       TK * hd + RB * TK + 3 * RB);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hkv, (rows + RB - 1) / RB);
  prefill_kernel<TQ, TKV><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<float*>(out), C, H, Hkv,
      hd, page, n_pages, n_pool, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, C, H, hd); k/v_pages (n_pool, page, Hkv, hd) of q's type; table
// (B, n_pages) int32; starts (B,) int32; out (B, C, H, hd) fp32; all
// contiguous.  Returns a cudaError_t.
extern "C" int repro_prefill_attention(const void* q, const void* k_pages,
                                       const void* v_pages, const void* table,
                                       const void* starts, void* out, int B,
                                       int C, int H, int Hkv, int hd,
                                       int page, int n_pages, int n_pool,
                                       int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, table, starts, out, B, C, H,
        Hkv, hd, page, n_pages, n_pool, window, s);
  if (dtype == DTYPE_F32)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr, table,
                                starts, out, B, C, H, Hkv, hd, page, n_pages,
                                n_pool, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 branch: k/v_pages int8, k/v_scale (n_pool, Hkv) f32, q of the
// float type `dtype`; otherwise as repro_prefill_attention.
extern "C" int repro_prefill_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* starts, void* out, int B, int C, int H, int Hkv, int hd,
    int page, int n_pages, int n_pool, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, table, starts, out, B, C, H,
        Hkv, hd, page, n_pages, n_pool, window, s);
  if (dtype == DTYPE_F32)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                 table, starts, out, B, C, H, Hkv, hd, page,
                                 n_pages, n_pool, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
