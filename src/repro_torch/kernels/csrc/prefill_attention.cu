// Ragged multi-token prefill attention over a paged KV cache: the port of
// the TPU kernel src/repro/kernels/attention/prefill.py::
// prefill_attention_pallas (_prefill_kernel), float pools (B3) and its
// int8 branch (prefill.py:63-73, B4b).
//
// What bounds it on the H100.  A chunk of C = 64 tokens of one slot attends
// causally over the slot's history plus the chunk.  With gemma-2b's GQA
// group of 8 over one kv head, the C x grp = 512 query rows of a slot share
// each K/V row, so per key the kernel does 4 x 512 x 256 operations for
// 2 x 256 bf16 elements read: ~1000 operations per byte, far above the
// tensor cores' ridge of ~295 and out of reach of the fp32 FMA units
// (67 TFLOP/s against 989).  It is bound by operations.
//
// What this design does about it.  Two routes, chosen by the wrapper
// (kernels/attention/prefill.py::prefill_route) from (dtype, hd, grp).
// Row r of a slot's flattened (C x grp) query axis is token r / grp, query
// head h x grp + r % grp (kv head h); its causal mask is
// kpos <= start + r / grp, its window mask kpos > qpos - window.  Both
// routes visit only the key tiles some row of the block can see
// (prefill.py:83-92).
//
// wgmma (bf16 q at hd 64, 128 and 256 with grp dividing 64; float or
// int8 pools).  B6's wgmma design (flash_attention.cu) over the page
// tables.  A block owns a (slot, kv head, 128-row tile, key split): two
// warpgroups of 64 rows each, sharing every K/V tile it loads (so each
// K/V row is read from L2 by half as many blocks as with one warpgroup a
// block, and one warpgroup's softmax overlaps the other's products).  A
// warpgroup's Q tile comes once by TMA: a 4-D box over q viewed as (hd,
// grp, Hkv, B x C) reads 64 / grp tokens of the kv head's grp query heads
// in row order without a copy.  At block start the threads read the page ids
// (and, for int8 pools, the (page, kv head) scales) of every page the
// block's keys touch into shared memory, trapping on a visible page id
// outside the pool.  K and V tiles of 64 keys then stream through a
// two-stage TMA ring tracked by mbarriers: one box of gcd(page, 64) rows
// per page piece (a 64-key page is one box), at row pid x page of the pool
// viewed as (hd, Hkv, P x page); pieces no row sees are boxes past the
// pool, which arrive as zeros.  S = Q K^T runs on wgmma m64n64k16 into
// fp32 registers, where the masks and the online softmax run (base 2);
// O += P V on wgmma m64n{hd}k16 with P from registers.  A warpgroup none
// of whose rows sees a tile skips its products.
//   - float pools: P is rounded to bf16 before P V, as prefill.py:111
//     casts it to V's dtype.
//   - int8 pools: TMA brings each tile's int8 rows unswizzled into a raw
//     stage, and the warpgroup widens them to bf16 in the swizzled tile
//     (exact, as B5 does in matmul_wgmma.cuh).  k_scale multiplies each
//     key column's fp32 score, v_scale that key's P, once.  The reference
//     keeps P in fp32 for int8 pools (prefill.py:70-72 widens V to f32), so
//     P goes in as two bf16 halves, hi + lo, through two P V products (as
//     B7 does with dO): ~2^-16 of P instead of bf16's 2^-9.
//   - Pages whose size is not a multiple of 8 cannot be boxes on the
//     128-byte swizzle's 1024-byte atoms: there the warpgroup copies (and
//     widens) each tile from the pools itself, with the same layout.
//   - Splits: with few query rows and a long history, the keys of a slot
//     are split by attention/prefill.py::prefill_split_plan (shapes only,
//     never the batch or the starts).  Each split writes fp32 (m, l, acc)
//     partials, and prefill_combine_kernel merges them in rank order (no
//     atomics, so a slot's bits do not depend on its batch); one split
//     writes the output directly.
//
// simt (fp32 q, and every other shape).  The first FMA design: the grid is
// (B, Hkv, row tiles of 32); each block keeps its 32 x hd accumulator, one
// 32-key K/V tile and its scores in shared memory, and both products run
// on fp32 FMA units.  int8 pools dequantize each K/V element at gather
// time by its (page, kv head) f32 scale, with P kept in fp32.
#include <algorithm>
#include <climits>
#include <numeric>

#include "flash_sm90.cuh"
#include "matmul_wgmma.cuh"  // widen8: int8 to bf16, exactly

namespace {

// -------------------------------------------------------------- simt route
constexpr int TK = 32;        // keys per tile: one softmax lane per key
constexpr int RB = 32;        // query rows per block
constexpr int THREADS = 256;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
prefill_simt_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ starts, float* __restrict__ out,
                    int C, int H, int Hkv, int hd, int page, int n_pages,
                    int n_pool, int window) {
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
int launch_simt(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale, const void* table,
                const void* starts, void* out, int B, int C, int H, int Hkv,
                int hd, int page, int n_pages, int n_pool, int window,
                cudaStream_t stream) {
  const int rows = C * (H / Hkv);
  const size_t smem = sizeof(float) * (2 * RB * hd + TK * (hd + 1) +
                                       TK * hd + RB * TK + 3 * RB);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_simt_kernel<TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hkv, (rows + RB - 1) / RB);
  prefill_simt_kernel<TQ, TKV><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<float*>(out), C, H, Hkv,
      hd, page, n_pages, n_pool, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- wgmma route
constexpr int WR = 64;   // query rows a warpgroup
constexpr int WGS = 2;   // warpgroups a block, sharing each K/V tile
constexpr int BR = WGS * WR;  // query rows a block
constexpr int WK = 64;   // keys per K/V tile
constexpr int WSTAGES = 2;
constexpr int WTHREADS = 128 * WGS;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the Q tiles; float pools: two stages of K and V tiles;
// int8 pools: the widened K and V tiles, then two stages of raw int8 K and
// V; the barriers; the per-tile column scales (int8); the page list.
template <int HD, bool INT8>
struct PrefillSmem {
  static constexpr int TILE = WR * HD * 2;  // one 64 x hd bf16 tile
  static constexpr int RAW = INT8 ? WK * HD : 0;  // one 64 x hd int8 tile
  static constexpr int Q = 0;
  static constexpr int KV = WGS * TILE;  // float: stage s's K at KV + s STAGE
  static constexpr int RING = INT8 ? KV + 2 * TILE : KV;
  static constexpr int STAGE = INT8 ? 2 * RAW : 2 * TILE;
  static constexpr int BARS = RING + WSTAGES * STAGE;
  static constexpr int COLS = BARS + 8 * (WSTAGES + 1);  // 2 x 64 floats
  static constexpr int LIST = COLS + (INT8 ? 2 * WK * 4 : 0);
  // page ids, and for int8 pools their k and v scales
  static constexpr int PER_PAGE = INT8 ? 12 : 4;
  static int bytes(int pages) { return 1024 + LIST + pages * PER_PAGE; }
};

struct PArgs {
  const int* table;
  const int* starts;
  const float* k_scale;  // int8 pools: (n_pool, Hkv)
  const float* v_scale;
  const uint8_t* k_pages;  // read directly where pages are not boxes
  const uint8_t* v_pages;
  float* out;
  float* part;  // splits > 1: acc (rows x hd a split), then (m, l)
  int B, C, H, Hkv, page, n_pages, n_pool, window, split_keys, splits;
  int box;   // rows of one K/V box: gcd(page, 64); < 8: copied directly
  int list;  // page-list entries a block has room for
};

// max and sum over the four lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (ex2.approx, flushing denormals):
// within 2 ulp, and 0 for the masked scores' NEG_BIG - m
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 16-byte chunk of a bf16 tile row: 8 bf16 values, or 8 int8 widened
template <bool INT8>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* row, int j) {
  if constexpr (INT8) {
    return wgmma_tile::widen8(*reinterpret_cast<const uint2*>(row + 8 * j));
  } else {
    return *reinterpret_cast<const uint4*>(row + 16 * j);
  }
}

// The 64 x hd bf16 tile at `tile` (hd / 64 atoms of 64 swizzled rows),
// written by the warpgroup: row t from row(t) (nullptr: zeros), 8 values
// (16 bytes bf16, 8 bytes int8) a chunk.
template <int HD, bool INT8, typename RowFn>
__device__ __forceinline__ void write_tile(uint8_t* tile, RowFn row,
                                           int tid) {
  constexpr int CHUNKS = HD / 8;
  for (int c = tid; c < WK * CHUNKS; c += WTHREADS) {
    const int t = c / CHUNKS, j = c % CHUNKS;
    const uint8_t* src = row(t);
    const uint4 v = src ? load_chunk<INT8>(src, j) : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(tile + (j / 8) * (WK * 128) +
                              sm90::swizzle128(t, 16 * (j % 8))) = v;
  }
}

template <int HD, bool INT8>
__global__ void __launch_bounds__(WTHREADS, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const PArgs a) {
  using L = PrefillSmem<HD, INT8>;
  constexpr int R = HD / 2;  // O accumulator registers a thread
  constexpr int ES = INT8 ? 1 : 2;  // bytes of a pool element
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* qbar = full + WSTAGES;
  float* kcol_s = reinterpret_cast<float*>(smem + L::COLS);  // int8 only
  float* vcol_s = kcol_s + WK;
  int* pid_s = reinterpret_cast<int*>(smem + L::LIST);
  float* ks_s = reinterpret_cast<float*>(pid_s + a.list);  // int8 only
  float* vs_s = ks_s + a.list;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = tid / 32 % 4;  // warp of the warpgroup
  const int grp = a.H / a.Hkv, rows = a.C * grp;
  const int row_tiles = (rows + BR - 1) / BR;
  const int rt = blockIdx.x % row_tiles;
  const int split = blockIdx.x / row_tiles % a.splits;
  const int bh = blockIdx.x / row_tiles / a.splits;
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int r0 = rt * BR, nr = min(BR, rows - r0);
  const int start = a.starts[b], n_keys = a.n_pages * a.page;
  // keys some row of this block can see within its split: [kb, ke)
  const int q_lo = start + r0 / grp, q_hi = start + (r0 + nr - 1) / grp;
  const int s_lo = split * a.split_keys;
  const int kb = max(s_lo, a.window > 0 ? max(0, q_lo - a.window + 1) : 0);
  const int ke = min(min(s_lo + a.split_keys, n_keys), q_hi + 1);
  const int t0 = kb / WK;
  const int nt = ke > kb ? (ke + WK - 1) / WK - t0 : 0;
  const int p0 = t0 * WK / a.page;  // first page of the list
  const bool boxes = a.box >= 8;
  const float sl2 = LOG2E / sqrtf(static_cast<float>(HD));
  // this warpgroup's rows [rw0, rw0 + nw) and the keys they see: [kw, kwe)
  const int rw0 = r0 + wg * WR, nw = min(WR, rows - rw0);
  const int kw = nw > 0 && a.window > 0
                     ? max(s_lo, start + rw0 / grp - a.window + 1)
                     : kb;
  const int kwe = nw > 0 ? min(ke, start + (rw0 + nw - 1) / grp + 1) : kb;
  // the first and last query positions of the warpgroup's rows
  const int qw_lo = start + rw0 / grp, qw_hi = start + (rw0 + nw - 1) / grp;

  // this thread's rows (accumulator registers i with i & 2 are rl1's)
  const int rl0 = 16 * warp + lane / 4, rl1 = rl0 + 8;
  const int qp0 = start + (rw0 + rl0) / grp, qp1 = start + (rw0 + rl1) / grp;
  float o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;  // l: this lane's

  if (nt > 0) {
    // the Q tiles first (they need no page id), then the page ids (and
    // int8 scales) of every page the block's tiles touch; -1 for a page no
    // row of the block sees
    if (tid == 0) {
      for (int s = 0; s < WSTAGES; ++s) sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(qbar, 1);
      sm90::mbar_fence_init();
      sm90::mbar_arrive_expect_tx(qbar, WGS * L::TILE);
      for (int w = 0; w < WGS; ++w)
#pragma unroll
        for (int at = 0; at < HD / sm90::ATOM; ++at)
          sm90::tma_load_4d(smem + L::Q + w * L::TILE + at * WR * 128, &tm_q,
                            qbar, at * sm90::ATOM, 0, h,
                            b * a.C + (r0 + w * WR) / grp);
    }
    const int np = ((t0 + nt) * WK - 1) / a.page + 1 - p0;
    for (int e = tid; e < np; e += WTHREADS) {
      const int p = p0 + e;
      int pid = -1;
      if (p * a.page < ke && (p + 1) * a.page > kb) {
        pid = a.table[static_cast<long long>(b) * a.n_pages + p];
        if (pid < 0 || pid >= a.n_pool) __trap();  // outside the pool
      }
      pid_s[e] = pid;
      if constexpr (INT8) {
        const long long cell = static_cast<long long>(pid) * a.Hkv + h;
        ks_s[e] = pid >= 0 ? a.k_scale[cell] : 0.f;
        vs_s[e] = pid >= 0 ? a.v_scale[cell] : 0.f;
      }
    }
    __syncthreads();

    // the pool row (pid x page + offset) of key `key`, or past the pool
    // (a box of zeros) where no row of the block sees its page
    auto pool_row = [&](int key) {
      const int pid = pid_s[key / a.page - p0];
      return pid >= 0 ? pid * a.page + key % a.page : a.n_pool * a.page;
    };
    auto issue_kv = [&](int t) {
      const int s = t % WSTAGES;
      uint8_t* st = smem + L::RING + s * L::STAGE;
      sm90::mbar_arrive_expect_tx(&full[s], L::STAGE);
      for (int j = 0; j < WK / a.box; ++j) {
        const int row = pool_row((t0 + t) * WK + j * a.box);
        if constexpr (INT8) {
          sm90::tma_load_3d(st + j * a.box * HD, &tm_k, &full[s], 0, h, row);
          sm90::tma_load_3d(st + L::RAW + j * a.box * HD, &tm_v, &full[s], 0,
                            h, row);
        } else {
#pragma unroll
          for (int at = 0; at < HD / sm90::ATOM; ++at) {
            uint8_t* dst = st + at * WK * 128 + j * a.box * 128;
            sm90::tma_load_3d(dst, &tm_k, &full[s], at * sm90::ATOM, h, row);
            sm90::tma_load_3d(dst + L::TILE, &tm_v, &full[s],
                              at * sm90::ATOM, h, row);
          }
        }
      }
    };
    if (tid == 0 && boxes)
      for (int t = 0; t < min(nt, WSTAGES); ++t) issue_kv(t);
    sm90::mbar_wait(qbar, 0);

    for (int t = 0; t < nt; ++t) {
      const int s = t % WSTAGES, key0 = (t0 + t) * WK;
      uint8_t* kt = smem + L::KV + (INT8 || !boxes ? 0 : s * L::STAGE);
      uint8_t* vt = kt + L::TILE;
      if (boxes) sm90::mbar_wait(&full[s], (t / WSTAGES) & 1);
      if (INT8 || !boxes) {
        // widen the raw stage, or copy (and widen) from the pools
        const uint8_t* raw = smem + L::RING + s * L::STAGE;
        for (int pass = 0; pass < 2; ++pass) {
          const uint8_t* pages = pass ? a.v_pages : a.k_pages;
          const uint8_t* stage = raw + pass * L::RAW;
          write_tile<HD, INT8>(
              pass ? vt : kt,
              [&](int r) -> const uint8_t* {
                if (boxes) return stage + r * HD;
                const int key = key0 + r;
                const int pid = pid_s[key / a.page - p0];
                if (pid < 0) return nullptr;
                return pages + ((static_cast<long long>(pid) * a.page +
                                 key % a.page) * a.Hkv + h) *
                                   static_cast<long long>(HD) * ES;
              },
              tid);
        }
        if constexpr (INT8) {
          if (tid < WK) {
            const int e = (key0 + tid) / a.page - p0;
            kcol_s[tid] = ks_s[e] * sl2;
            vcol_s[tid] = vs_s[e];
          }
        }
        sm90::fence_proxy_async();
        __syncthreads();
      }

      // a warpgroup none of whose rows sees the tile skips its products
      const bool active = nw > 0 && key0 < kwe && key0 + WK > kw;
      if (active) {
        // S = Q K^T
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const uint8_t* qt = smem + L::Q + wg * L::TILE;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss_n64(sc, sm90::desc_kmajor(qt, WR, kk),
                             sm90::desc_kmajor(kt, WK, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(sc);

        // scale (base 2), mask where the tile is not inside every row's
        // band, online softmax on the fragments
        const int cb = 2 * (lane % 4);  // this lane's first column
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] *= INT8 ? kcol_s[cb + 8 * (i / 4) + (i & 1)] : sl2;
        if (key0 + WK - 1 > qw_lo || key0 + WK > n_keys ||
            (a.window > 0 && key0 <= qw_hi - a.window)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qp = (i & 2) ? qp1 : qp0;
            const int col = key0 + cb + 8 * (i / 4) + (i & 1);
            if (!(col <= qp && col < n_keys &&
                  (a.window == 0 || col > qp - a.window)))
              sc[i] = NEG_BIG;
          }
        }
        float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2)
            mx1 = fmaxf(mx1, sc[i]);
          else
            mx0 = fmaxf(mx0, sc[i]);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = sc[i] > NEG_BIG
                              ? fast_exp2(sc[i] - ((i & 2) ? mn1 : mn0))
                              : 0.f;
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
        if (al0 != 1.f || al1 != 1.f) {  // a row's max moved
#pragma unroll
          for (int i = 0; i < R; ++i) o[i] *= (i & 2) ? al1 : al0;
        }

        // O += P V
        if constexpr (INT8) {
          // P x v_scale in fp32, as two bf16 halves: hi, and lo = the rest
          uint32_t ah[WK / 16][4], alo[WK / 16][4];
#pragma unroll
          for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j;
              const int ci = cb + 8 * (i / 4);
              const float x0 = sc[i] * vcol_s[ci];
              const float x1 = sc[i + 1] * vcol_s[ci + 1];
              const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
              ah[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
              alo[kk][j] = sm90::pack_bf16(x0 - __low2float(hi),
                                           x1 - __high2float(hi));
            }
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WK / 16; ++kk) {
            sm90::wgmma_rs<HD>(o, ah[kk], sm90::desc_mnmajor(vt, WK, kk));
            sm90::wgmma_rs<HD>(o, alo[kk], sm90::desc_mnmajor(vt, WK, kk));
          }
        } else {
          // P rounded to bf16 (V's type)
          uint32_t ap[WK / 16][4];
#pragma unroll
          for (int kk = 0; kk < WK / 16; ++kk) sm90::a_frag(ap[kk], sc, kk);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WK / 16; ++kk)
            sm90::wgmma_rs<HD>(o, ap[kk], sm90::desc_mnmajor(vt, WK, kk));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(o);
      }
      __syncthreads();  // every warp is done with stage s: refill it
      if (tid == 0 && boxes && t + WSTAGES < nt) issue_kv(t + WSTAGES);
    }
  }

  // one split: the output; else this split's partial (acc unnormalised,
  // m in base 2, l), where a row that saw no key writes only l = 0
  const float d0 = quad_sum(l0), d1 = quad_sum(l1);
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = half ? rl1 : rl0;
    if (rl >= nw) continue;
    const int r = rw0 + rl;
    const float d = half ? d1 : d0;
    float* dst;
    float inv = 1.f;
    if (a.splits == 1) {
      const int c = r / grp, head = h * grp + r % grp;
      dst = a.out + ((static_cast<long long>(b) * a.C + c) * a.H + head) * HD;
      inv = 1.f / fmaxf(d, 1e-30f);
    } else {
      const long long pr =
          (static_cast<long long>(bh) * a.splits + split) * rows + r;
      if (lane % 4 == 0) {
        float* ml = a.part +
                    static_cast<long long>(a.B) * a.Hkv * a.splits * rows * HD;
        ml[pr * 2] = half ? m1 : m0;
        ml[pr * 2 + 1] = d;
      }
      if (d == 0.f) continue;
      dst = a.part + pr * HD;
    }
#pragma unroll
    for (int i = 2 * half; i < R; i += 4)
      *reinterpret_cast<float2*>(dst + 8 * (i / 4) + col0) =
          make_float2(o[i] * inv, o[i + 1] * inv);
  }
}

// out[b, c, h grp + g, d]: the splits of each (slot, kv head) row merged
// in rank order; one block a flattened query row, one thread a column
__global__ void __launch_bounds__(256)
prefill_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                       int Hkv, int C, int grp, int hd, int splits) {
  const int rows = C * grp;
  const long long bh = blockIdx.x / rows;
  const int r = blockIdx.x % rows, d = threadIdx.x;
  const long long n_bh = static_cast<long long>(gridDim.x) / rows;
  const float* ml = part + n_bh * splits * rows * hd;
  float mb = NEG_BIG, lsum = 0.f, asum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long pr = (bh * splits + s) * rows + r;
    const float mr = ml[pr * 2], lr = ml[pr * 2 + 1];
    if (lr > 0.f) {  // an empty split wrote no acc
      const float mn = fmaxf(mb, mr);
      const float so = exp2f(mb - mn), sn = exp2f(mr - mn);
      lsum = lsum * so + lr * sn;
      asum = asum * so + part[pr * hd + d] * sn;
      mb = mn;
    }
  }
  const long long b = bh / Hkv, h = bh % Hkv;
  const int c = r / grp, head = static_cast<int>(h) * grp + r % grp;
  out[((b * C + c) * (Hkv * grp) + head) * hd + d] =
      asum * (1.f / fmaxf(lsum, 1e-30f));
}

// q viewed as (hd, grp, Hkv, B x C) bf16, boxes of 64 x grp x 1 x 64 / grp:
// one box is 64 flattened query rows of one kv head, in row order
bool encode_q_map(CUtensorMap* map, const void* q, int B, int C, int H,
                  int Hkv, int hd) {
  const int grp = H / Hkv;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(grp),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(B) * C};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(grp) * hd * 2,
                                 static_cast<cuuint64_t>(H) * hd * 2};
  const cuuint32_t box[4] = {sm90::ATOM, static_cast<cuuint32_t>(grp), 1,
                             static_cast<cuuint32_t>(WR / grp)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(q),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a pool viewed as (hd, Hkv, P x page), boxes of `rows` pool rows of one
// kv head: bf16 in 64-wide swizzled atoms, int8 whole rows unswizzled
bool encode_pool_map(CUtensorMap* map, const void* pages, bool int8,
                     int n_pool, int page, int Hkv, int hd, int rows) {
  const cuuint64_t es = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(n_pool) * page};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * es,
                                 static_cast<cuuint64_t>(Hkv) * hd * es};
  const cuuint32_t box[3] = {
      int8 ? static_cast<cuuint32_t>(hd) : static_cast<cuuint32_t>(sm90::ATOM),
      1, static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map,
             int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(pages), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool INT8>
int launch_wgmma(const void* q, const void* k_pages, const void* v_pages,
                 PArgs a, cudaStream_t stream) {
  using L = PrefillSmem<HD, INT8>;
  const int grp = a.H / a.Hkv;
  if (grp <= 0 || WR % grp || a.split_keys <= 0 || a.split_keys % WK ||
      a.split_keys % a.page)
    return static_cast<int>(cudaErrorInvalidValue);
  a.box = std::gcd(a.page, WK);
  a.list = a.split_keys / a.page + 1;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (!encode_q_map(&tq, q, a.B, a.C, a.H, a.Hkv, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.box >= 8 &&
      (!encode_pool_map(&tk, k_pages, INT8, a.n_pool, a.page, a.Hkv, HD,
                        a.box) ||
       !encode_pool_map(&tv, v_pages, INT8, a.n_pool, a.page, a.Hkv, HD,
                        a.box)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = L::bytes(a.list);
  const int rows = a.C * grp;
  const long long blocks = static_cast<long long>((rows + BR - 1) / BR) *
                           a.splits * a.B * a.Hkv;
  if (smem > 232448 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = sm90::launch(prefill_wgmma_kernel<HD, INT8>,
                              dim3(static_cast<unsigned>(blocks)), WTHREADS,
                              smem, stream, tq, tk, tv, a);
  if (rc != 0 || a.splits == 1) return rc;
  const long long cblocks = static_cast<long long>(a.B) * a.Hkv * rows;
  if (cblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  prefill_combine_kernel<<<dim3(static_cast<unsigned>(cblocks)), HD, 0,
                           stream>>>(a.part, a.out, a.Hkv, a.C, grp, HD,
                                     a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8>
int dispatch_wgmma(const void* q, const void* k_pages, const void* v_pages,
                   const PArgs& a, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_wgmma<64, INT8>(q, k_pages, v_pages, a, stream);
  if (hd == 128)
    return launch_wgmma<128, INT8>(q, k_pages, v_pages, a, stream);
  if (hd == 256)
    return launch_wgmma<256, INT8>(q, k_pages, v_pages, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

enum { ROUTE_SIMT = 0, ROUTE_WGMMA = 1 };

template <typename TKV>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* k_scale, const void* v_scale, const void* table,
        const void* starts, void* out, void* scratch, int B, int C, int H,
        int Hkv, int hd, int page, int n_pages, int n_pool, int window,
        int split_keys, int splits, int route, int dtype,
        cudaStream_t stream) {
  constexpr bool INT8 = std::is_same_v<TKV, int8_t>;
  if (B == 0 || C == 0) return 0;
  if (route == ROUTE_WGMMA) {
    if (dtype != DTYPE_BF16 || splits < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const PArgs a{static_cast<const int*>(table),
                  static_cast<const int*>(starts),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const uint8_t*>(k_pages),
                  static_cast<const uint8_t*>(v_pages),
                  static_cast<float*>(out), static_cast<float*>(scratch),
                  B, C, H, Hkv, page, n_pages, n_pool, window, split_keys,
                  splits, 0, 0};
    return dispatch_wgmma<INT8>(q, k_pages, v_pages, a, hd, stream);
  }
  if (route != ROUTE_SIMT || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (INT8) {
    if (dtype == DTYPE_BF16)
      return launch_simt<__nv_bfloat16, int8_t>(
          q, k_pages, v_pages, k_scale, v_scale, table, starts, out, B, C, H,
          Hkv, hd, page, n_pages, n_pool, window, stream);
    return launch_simt<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                      table, starts, out, B, C, H, Hkv, hd,
                                      page, n_pages, n_pool, window, stream);
  } else {
    return launch_simt<TKV, TKV>(q, k_pages, v_pages, k_scale, v_scale,
                                 table, starts, out, B, C, H, Hkv, hd, page,
                                 n_pages, n_pool, window, stream);
  }
}

}  // namespace

// q (B, C, H, hd); k/v_pages (n_pool, page, Hkv, hd) of q's type; table
// (B, n_pages) int32; starts (B,) int32; out (B, C, H, hd) fp32; all
// contiguous.  route: 0 simt (splits must be 1), 1 wgmma (bf16, hd 64,
// 128 or 256, H / Hkv dividing 64, q and the pools 16-byte aligned).
// split_keys and splits: the plan of attention/prefill.py::
// prefill_split_plan; scratch: with splits > 1 the partials,
// B * Hkv * splits * C * (H / Hkv) * (hd + 2) fp32.  Returns a cudaError_t.
extern "C" int repro_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* starts, void* out, void* scratch, int B,
    int C, int H, int Hkv, int hd, int page, int n_pages, int n_pool,
    int window, int split_keys, int splits, int route, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return run<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table,
                              starts, out, scratch, B, C, H, Hkv, hd, page,
                              n_pages, n_pool, window, split_keys, splits,
                              route, dtype, s);
  if (dtype == DTYPE_F32)
    return run<float>(q, k_pages, v_pages, nullptr, nullptr, table, starts,
                      out, scratch, B, C, H, Hkv, hd, page, n_pages, n_pool,
                      window, split_keys, splits, route, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 branch: k/v_pages int8, k/v_scale (n_pool, Hkv) f32, q of the
// float type `dtype`; otherwise as repro_prefill_attention.
extern "C" int repro_prefill_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* starts, void* out, void* scratch, int B, int C, int H,
    int Hkv, int hd, int page, int n_pages, int n_pool, int window,
    int split_keys, int splits, int route, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table, starts,
                     out, scratch, B, C, H, Hkv, hd, page, n_pages, n_pool,
                     window, split_keys, splits, route, dtype, s);
}
