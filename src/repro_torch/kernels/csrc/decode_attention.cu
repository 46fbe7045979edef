// Ragged one-token decode attention over a paged KV cache: the port of the
// TPU kernel src/repro/kernels/attention/decode.py::decode_attention_pallas
// (_decode_kernel).
//
// What bounds it on the H100.  Each slot's query attends over its own
// history: gemma-2b reads lengths x Hkv x hd x 2 K/V elements per layer
// (a 116-token slot: 116 x 1 x 256 x 2 x 2 bytes = 119 KB in bf16) and does
// 4 x grp x hd operations per key, so it is bound by bytes, like any decode
// attention.  At 4 slots the whole call moves well under a megabyte, so in
// practice it is bound by latency and by how many SMs it occupies.
//
// What this design does about it.  One block per (slot, kv head) walks the
// slot's live key range in 32-key tiles: it gathers each tile's K/V rows
// through the page table into shared memory (the TPU kernel resolved the
// table in its BlockSpec index maps; here each block reads its own
// indices), scores all grp query heads of the GQA group against the tile,
// and folds the tile into an fp32 online softmax.  Dead tiles (beyond the
// length, or wholly behind the window) are never visited, and a slot of
// length 0 writes exact zeros.  The grid is (B, Hkv): for gemma-2b
// (Hkv = 1) that is only B blocks on 132 SMs; splitting the key range
// across blocks (split-KV) is the first redesign.
//
// int8 pools (the TPU kernel's quantized branch, decode.py:62-72, B4a) run
// the same kernel instantiated on an int8 pool type: each K/V element
// dequantizes at gather time by its (page, kv head) f32 scale, looked up
// through the same bounds-checked page id, and P stays fp32 before P @ V
// (V is already fp32).  The int8 pools read a quarter of fp32's bytes.
#include "common.cuh"

namespace {

constexpr int TK = 32;        // keys per tile: one softmax lane per key
constexpr int THREADS = 256;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
              const TKV* __restrict__ v_pages,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ table,
              const int* __restrict__ lengths, float* __restrict__ out, int H,
              int Hkv, int hd, int page, int n_pages, int n_pool,
              int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, grp = H / Hkv;
  const int kstride = hd + 1;  // padded K rows: a warp reading one column
                               // of 32 keys hits 32 banks
  float* q_s = smem;                    // grp x hd
  float* acc_s = q_s + grp * hd;        // grp x hd
  float* k_s = acc_s + grp * hd;        // TK x kstride
  float* v_s = k_s + TK * kstride;      // TK x hd
  float* p_s = v_s + TK * hd;           // grp x TK
  float* m_s = p_s + grp * TK;          // grp: running max
  float* l_s = m_s + grp;               // grp: running denominator
  float* alpha_s = l_s + grp;           // grp: this tile's rescale
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  // live keys: [lo, length); a window keeps only the newest `window`.
  // Keys past the table's last page do not exist (as in the plain version).
  const int len_in = lengths[b];
  const int length = max(0, min(len_in, n_pages * page));
  const int lo = window > 0 ? max(0, len_in - window) : 0;

  for (int i = tid; i < grp * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    q_s[i] = to_f32(q[((long long)b * H + h * grp + g) * hd + d]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < grp; g += THREADS) {
    m_s[g] = NEG_BIG;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int k_lo = (lo / TK) * TK; k_lo < length; k_lo += TK) {
    // gather the tile's K/V rows through the page table (rows outside the
    // live range load as zeros and are masked below)
    for (int i = tid; i < TK * hd; i += THREADS) {
      const int t = i / hd, d = i % hd, kpos = k_lo + t;
      float kv = 0.f, vv = 0.f;
      if (kpos >= lo && kpos < length) {
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
    // scores: one thread per (query head, key)
    for (int i = tid; i < grp * TK; i += THREADS) {
      const int g = i / TK, t = i % TK, kpos = k_lo + t;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(q_s[g * hd + d], k_s[t * kstride + d], s);
      p_s[i] = (kpos >= lo && kpos < length) ? s * scale : NEG_BIG;
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per key
    for (int g = warp; g < grp; g += THREADS / 32) {
      const float s = p_s[g * TK + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = s > NEG_BIG ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[g * TK + lane] = round_via<TKV>(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < grp * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < TK; ++t) a = fmaf(p_s[g * TK + t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < grp * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    out[((long long)b * H + h * grp + g) * hd + d] =
        acc_s[i] / fmaxf(l_s[g], 1e-30f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* table,
           const void* lengths, void* out, int B, int H, int Hkv, int hd,
           int page, int n_pages, int n_pool, int window,
           cudaStream_t stream) {
  const int grp = H / Hkv;
  const size_t smem =
      sizeof(float) * (2 * grp * hd + TK * (hd + 1) + TK * hd + grp * TK +
                       3 * grp);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<TQ, TKV><<<dim3(B, Hkv), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), H, Hkv, hd,
      page, n_pages, n_pool, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, hd); k/v_pages (n_pool, page, Hkv, hd) of q's type; table
// (B, n_pages) int32; lengths (B,) int32; out (B, H, hd) fp32; all
// contiguous.  Returns a cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int hd, int page,
                                      int n_pages, int n_pool, int window,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, B, H, Hkv,
        hd, page, n_pages, n_pool, window, s);
  if (dtype == DTYPE_F32)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr, table,
                                lengths, out, B, H, Hkv, hd, page, n_pages,
                                n_pool, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 branch: k/v_pages int8, k/v_scale (n_pool, Hkv) f32, q of the
// float type `dtype`; otherwise as repro_decode_attention.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, int B, int H, int Hkv, int hd, int page,
    int n_pages, int n_pool, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, table, lengths, out, B, H, Hkv,
        hd, page, n_pages, n_pool, window, s);
  if (dtype == DTYPE_F32)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                 table, lengths, out, B, H, Hkv, hd, page,
                                 n_pages, n_pool, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
