// The backward of RWKV6's WKV recurrence (kernels/wkv/wkv.py::wkv_bwd_cuda).
//
// It replaces no TPU kernel: the JAX package differentiates its chunked
// WKV (src/repro/models/rwkv.py:171, wkv_chunked) by autodiff, with
// jax.checkpoint around each chunk.  The port's model runs its WKV forward
// on B8 (wkv.cu) and its backward here, so the card never runs the plain
// chunked form.
//
// For one (batch, head), with w_t = exp(lw_t), the forward is
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   S_{-1} = 0,
//   o_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t,
// and its final state is dropped.  With G_t = dL/dS_t (G_{S-1} = 0,
// G_{t-1} = diag(w_t) G_t + r_t do_t^T) the gradients are
//   dr_t  = S_{t-1} do_t + u * k_t (v_t . do_t)
//   dk_t  = G_t v_t + u * r_t (v_t . do_t)
//   dv_t  = G_t^T k_t + (r_t . (u * k_t)) do_t
//   dlw_t = w_t * rowsum(G_t * S_{t-1})
//   du    = sum over (b, t) of r_t * k_t (v_t . do_t).
// This is the exact recurrence's gradient; B8 and the chunked form clamp
// their intra-chunk decay weights at e^-60, which moves it by less than
// e^-60 of a term.
//
// What bounds it on the H100.  The function reads r, k, v, lw, do once
// and writes dr, dk, dv, dlw once (126 MB at rwkv6-7b's training shape,
// B 2, S 512, H 64, hd 64, in bf16: 0.0376 ms at 3.35 TB/s), and needs
// about 10 hd^2 operations a step and (batch, head) (chip_smoke.py's
// wkv_bwd_ops), far below the tensor cores' rate: it is bound by bytes.
// The design below moves more: the chunks' states and state gradients
// pass through the scratch three times (written, scanned in place, read:
// 134 MB at that shape) and kernel 1 reads the inputs a second time.
//
// The design: the chunked form on the tensor cores, in chunks of C = 64
// rows (32 at hd 128, for shared memory) and sub-chunks of 16 rows (one
// mma tile), as kernels/wkv/wkv.py::wkv_bwd_chunked writes it in plain
// tensor code.  With cum, ecum the inclusive and exclusive cumsums of lw
// over a chunk j, total its sum, Sin_j the state before the chunk and
// Gout_j the state gradient after it, four launches:
//   1. wkv_bwd_chunk_kernel, one block per (batch, head, chunk): the
//      chunk's own state (k e^(total - cum))^T v and state gradient
//      (r e^ecum)^T do, two (hd x C)(C x hd) products, into the scratch;
//   2. wkv_bwd_scan_kernel, one thread per state element: the scans
//      Sin_{j+1} = e^total Sin_j + (..) forward and
//      Gout_{j-1} = e^total Gout_j + (..) backward, in place (the chunks
//      run in parallel in 1; only this elementwise pass walks them);
//   3. wkv_bwd_grad_kernel, one block of 16 warps per (batch, head,
//      chunk), all of the chunk's rows and channels in shared memory
//      (205 KB at hd 64: one block an SM): every gradient (below);
//   4. wkv_bwd_du_kernel: du, the chunks' partials summed in order.
// Kernel 3 forms M = do v^T and the forward's attention matrix A (its
// diagonal sub-blocks in the direct form, the others factored through the
// sub-chunk ends m_a, as B8 does), then, as register blocks of 2 x NNU
// 16 x 8 tiles a warp (two row tiles, each A fragment split once for NNU
// column tiles, each B fragment for both row tiles):
//   dv = A^T do + (k e^(total - cum)) Gout,
//   dr = e^ecum (do Sin^T) + sum over earlier sub-chunks b of M_ab-products,
//   dk = e^(total - cum) (v Gout^T) + sum over later sub-chunks a,
// and two threads per (sub-chunk, channel) (the block's two halves split
// the sub-block's pairs) add the diagonal sub-blocks' direct form, the
// bonus, and dlw.  dlw_t sums r_tau k_s e^(ecum_tau -
// cum_s) (v_s . do_tau) over s < t < tau (with Sin or Gout for s or tau
// outside the chunk): every term carries w_t, and the sum is split by
// where s and tau lie into a rowsum of Gout * Sin, whole sub-block sums
// (B_ab, a >= b + 2), column sums of r dr' over later and of k dk' over
// earlier sub-chunks, suffix and prefix sums inside t's sub-chunk, and
// the direct form there.  No term is the difference of two sums that hold
// a weight-1 pair (tau = s + 1), as the reverse running sums of r dr' and
// k dk' would be: under strong decay (w_t ~ e^-20) that form leaves fp32
// rounding noise of O(1) sums.
//
// Precision.  The products run as mma.sync m16n8k16 on bf16 operands,
// each fp32 operand split as x = hi + lo and summed as lo*hi + hi*lo +
// hi*hi in fp32, as B8 does: ~2^-16 of each product, far inside fp32's
// 2e-4 of each gradient's max.  Every exponent is a formed difference
// <= 0 taken by ex2.approx; rows of a product that carry tiny weights are
// scaled after it, so nothing relative is lost.  Every sum has a fixed
// order (warp shuffles in a fixed pattern, the du partials summed by
// chunk), no atomics: a rerun is bit-equal.
//
// The scratch (kernels/wkv/wkv.py::wkv_bwd_scratch_floats) holds both
// states of every chunk, 2 B H (S / C) hd^2 floats (33.6 MB at the
// training shape), each chunk's total and its du partial.
#include "common.cuh"

namespace wkvbwd {

constexpr int THREADS = 256;       // kernels 1, 2 and 4
constexpr int NWARP = THREADS / 32;
constexpr int GRAD_THREADS = 512;  // kernel 3: 16 warps
constexpr int SC = 16;              // rows of a sub-chunk: one mma tile
constexpr size_t MAX_SMEM = 232448; // an H100 block's dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;

// rows of a chunk (kernels/wkv/wkv.py::bwd_chunk)
template <int HD>
__host__ __device__ constexpr int chunk_rows() { return HD <= 64 ? 64 : 32; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// e^x for a formed exponent x <= 0
__device__ __forceinline__ float expn(float x) { return ex2(x * LOG2E); }

// two fp32 values (x at the lower index) as bf16 pairs: hi = bf16(x, y),
// lo = bf16(x - hi_x, y - hi_y); x = hi + lo to ~2^-17 of x
struct Pair {
  uint32_t hi, lo;
};
__device__ __forceinline__ uint32_t pack(float x, float y) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(y), "f"(x));
  return d;
}
__device__ __forceinline__ Pair split(float x, float y) {
  const uint32_t hi = pack(x, y);
  return {hi, pack(x - __uint_as_float(hi << 16),
                   y - __uint_as_float(hi & 0xffff0000u))};
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragments of mma.sync m16n8k16 on split operands.  a(row, col) and
// b(row, col) give the fp32 elements; lane = 4 g + t holds A's rows g,
// g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9, B's rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of column g, and C's rows g, g + 8 of columns 2t, 2t + 1.
struct FragA {
  Pair p[4];
};
struct FragB {
  Pair p[2];
};
template <class FA>
__device__ __forceinline__ FragA frag_a(int g, int t, FA a) {
  return {{split(a(g, 2 * t), a(g, 2 * t + 1)),
           split(a(g + 8, 2 * t), a(g + 8, 2 * t + 1)),
           split(a(g, 2 * t + 8), a(g, 2 * t + 9)),
           split(a(g + 8, 2 * t + 8), a(g + 8, 2 * t + 9))}};
}
template <class FB>
__device__ __forceinline__ FragB frag_b(int g, int t, FB b) {
  return {{split(b(2 * t, g), b(2 * t + 1, g)),
           split(b(2 * t + 8, g), b(2 * t + 9, g))}};
}
// c (16 x 8) += A (16 x 16) B (16 x 8): lo*hi + hi*lo + hi*hi (lo*lo lies
// below 2^-17 of the product)
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.p[0].lo, a.p[1].lo, a.p[2].lo, a.p[3].lo, b.p[0].hi, b.p[1].hi);
  mma(c, a.p[0].hi, a.p[1].hi, a.p[2].hi, a.p[3].hi, b.p[0].lo, b.p[1].lo);
  mma(c, a.p[0].hi, a.p[1].hi, a.p[2].hi, a.p[3].hi, b.p[0].hi, b.p[1].hi);
}
template <class FA, class FB>
__device__ __forceinline__ void mma_step(float (&c)[4], int g, int t, FA a,
                                         FB b) {
  mma3(c, frag_a(g, t, a), frag_b(g, t, b));
}

__device__ __forceinline__ void zero(float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// out[0..8) = the column sums of w(row, col) * C over the tile's 16 rows,
// a fixed shuffle pattern over the 8 lanes of each column pair
template <class FW>
__device__ __forceinline__ void col_sums(const float (&c)[4], int g, int t,
                                         FW w, float* out) {
  float s0 = w(g, 2 * t) * c[0] + w(g + 8, 2 * t) * c[2];
  float s1 = w(g, 2 * t + 1) * c[1] + w(g + 8, 2 * t + 1) * c[3];
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (g == 0) {
    out[2 * t] = s0;
    out[2 * t + 1] = s1;
  }
}

// (batch, head, chunk) of a block of kernels 1 and 3
struct Geometry {
  int bh, t0;
  long long base;   // element (b, 0, h, 0)
  long long step;   // one time step: H * hd
};
__device__ __forceinline__ Geometry geometry(int S, int H, int HD, int C,
                                             int nc) {
  Geometry g;
  g.bh = blockIdx.x / nc;
  g.t0 = blockIdx.x % nc * C;
  g.base = (static_cast<long long>(g.bh / H) * S * H + g.bh % H) * HD;
  g.step = static_cast<long long>(H) * HD;
  return g;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// rows [t0, t0 + C) of r, k, v (T), do and lw (fp32), each (B, S, H, HD),
// into five tiles of C rows of ld floats, rows past S as zeros: every
// load of the thread issued before the first store
template <typename T, int HD, int C, int NTH>
__device__ __forceinline__ void stage(float* rs, float* ks, float* vs,
                                      float* ds, float* cm, int ld,
                                      const T* r, const T* k, const T* v,
                                      const float* dout, const float* lw,
                                      const Geometry& g, int S) {
  constexpr int N = C * HD / 4 / NTH;
  static_assert(N * 4 * NTH == C * HD, "tiles split over the threads");
  float4 x[5][N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * NTH;
    const int i = e / (HD / 4), c = (e % (HD / 4)) * 4;
    const long long at = g.base + (g.t0 + i) * g.step + c;
    const bool in = g.t0 + i < S;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    x[0][n] = in ? load4(r + at) : z;
    x[1][n] = in ? load4(k + at) : z;
    x[2][n] = in ? load4(v + at) : z;
    x[3][n] = in ? load4(dout + at) : z;
    x[4][n] = in ? load4(lw + at) : z;
  }
  float* dst[5] = {rs, ks, vs, ds, cm};
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * NTH;
    const int i = e / (HD / 4), c = (e % (HD / 4)) * 4;
#pragma unroll
    for (int a = 0; a < 5; ++a)
      *reinterpret_cast<float4*>(dst[a] + i * ld + c) = x[a][n];
  }
}

// inclusive cumsum down each column of cm (C rows of ld floats): four
// consecutive lanes a column, a run of C / 4 rows each, then a shuffle
// scan of the runs' sums (the same order in kernels 1 and 3)
template <int HD, int C, int NTH>
__device__ __forceinline__ void cumsum(float* cm, int ld) {
  constexpr int PARTS = 4, ROWS = C / PARTS;
  static_assert(HD * PARTS % 32 == 0, "whole warps a pass");
  for (int p = threadIdx.x; p < HD * PARTS; p += NTH) {
    const int x = p / PARTS, part = p % PARTS;
    float* col = cm + part * ROWS * ld + x;
    float val[ROWS];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) val[i] = run += col[i * ld];
    float incl = run;
#pragma unroll
    for (int off = 1; off < PARTS; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (part >= off) incl += o;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (part == 0) before = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) col[i * ld] = val[i] + before;
  }
}

// scratch: the states, then the state gradients (each B H nc hd^2), each
// chunk's total (B H nc hd) and du partial (B H nc hd)
struct Scratch {
  float *st, *gr, *tot, *dup;
};
__device__ __host__ __forceinline__ Scratch carve(float* p, long long chunks,
                                                  int HD) {
  const long long sq = chunks * HD * HD;
  return {p, p + sq, p + 2 * sq, p + 2 * sq + chunks * HD};
}

// ---------------------------------------------------------------- 1
// The chunk's own state (k e^(total - cum))^T v and state gradient
// (r e^ecum)^T do into the scratch, and its total.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ dout, float* __restrict__ scr,
                     int S, int H, int nc) {
  constexpr int C = chunk_rows<HD>(), LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* KS = smem;                // k, then k e^(total - cum)
  float* VS = KS + C * LD;
  float* RS = VS + C * LD;         // r, then r e^ecum
  float* DS = RS + C * LD;
  float* CM = DS + C * LD;         // lw, then its inclusive cumsum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Geometry geo = geometry(S, H, HD, C, nc);
  const Scratch sp = carve(scr, static_cast<long long>(gridDim.x), HD);

  stage<T, HD, C, THREADS>(RS, KS, VS, DS, CM, LD, r, k, v, dout, lw, geo,
                           S);
  __syncthreads();
  cumsum<HD, C, THREADS>(CM, LD);
  __syncthreads();
  for (int e = tid; e < C * HD; e += THREADS) {
    const int i = e / HD, x = e % HD;
    const float total = CM[(C - 1) * LD + x];
    KS[i * LD + x] *= expn(total - CM[i * LD + x]);
    RS[i * LD + x] *= i ? expn(CM[(i - 1) * LD + x]) : 1.f;
  }
  for (int x = tid; x < HD; x += THREADS)
    sp.tot[static_cast<long long>(blockIdx.x) * HD + x] =
        CM[(C - 1) * LD + x];
  __syncthreads();

  // out[i][jj] = sum over rows s of a[s][i] b[s][jj]; a warp owns 16 rows
  // i of one product and every column jj, so each A fragment is split
  // once for the HD / 8 column tiles
  constexpr int MT = HD / 16, NT = HD / 8;
  for (int u = warp; u < 2 * MT; u += NWARP) {
    const int which = u / MT, m0 = u % MT * 16;
    const float* a = which ? RS : KS;
    const float* b = which ? DS : VS;
    float c[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) zero(c[n]);
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      const FragA fa = frag_a(g, t, [&](int row, int col) {
        return a[(k0 + col) * LD + m0 + row];
      });
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3(c[n], fa, frag_b(g, t, [&](int row, int col) {
               return b[(k0 + row) * LD + n * 8 + col];
             }));
    }
    float* out = (which ? sp.gr : sp.st) +
                 static_cast<long long>(blockIdx.x) * HD * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(out + (m0 + g) * HD + n * 8 + 2 * t) =
          make_float2(c[n][0], c[n][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * HD + n * 8 + 2 * t) =
          make_float2(c[n][2], c[n][3]);
    }
  }
}

// ---------------------------------------------------------------- 2
// The chunks' own states into the state before each chunk (blockIdx.y 0,
// forward) and their state gradients into the gradient after each chunk
// (blockIdx.y 1, backward), one thread per element, in place.
template <int HD>
__global__ void __launch_bounds__(THREADS)
wkv_bwd_scan_kernel(float* __restrict__ scr, int BH, int nc) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(BH) * HD * HD) return;
  const Scratch sp = carve(scr, static_cast<long long>(BH) * nc, HD);
  const int bh = static_cast<int>(e / (HD * HD)), el = e % (HD * HD);
  const int i = el / HD;
  const bool back = blockIdx.y == 1;
  float* buf = back ? sp.gr : sp.st;
  float run = 0.f;
  // batches of chunks: their loads issued before the batch's stores
  constexpr int BATCH = 8;
  for (int q0 = 0; q0 < nc; q0 += BATCH) {
    long long at[BATCH];
    float d[BATCH], w[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (q0 + q >= nc) break;
      const long long ch = static_cast<long long>(bh) * nc +
                           (back ? nc - 1 - q0 - q : q0 + q);
      at[q] = ch * HD * HD + el;
      d[q] = buf[at[q]];
      w[q] = sp.tot[ch * HD + i];
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (q0 + q >= nc) break;
      buf[at[q]] = run;
      run = fmaf(expf(w[q]), run, d[q]);
    }
  }
}

// ---------------------------------------------------------------- 3
// The pairs s < tau, tau in [TLO, THI), of one channel of a diagonal
// sub-block: p = e^(ecum_tau - cum_s) M[tau][s] into dr's (k_s p at tau)
// and dk's (r_tau p at s) direct terms, and r_tau k_s p into q[t] for
// every s < t < tau (pairs with tau = s + 1 into no q).  cc holds the
// sub-block's inclusive cumsum (ecum_tau = cc[tau - 1] for tau >= 1), mm
// M's sub-block with rows ld floats apart.
template <int TLO, int THI>
__device__ __forceinline__ void diag_pairs(const float (&rr)[SC],
                                           const float (&kk)[SC],
                                           const float (&cc)[SC],
                                           const float* mm, int ld,
                                           float (&drd)[SC],
                                           float (&dkd)[SC], float (&q)[SC]) {
#pragma unroll
  for (int s = 0; s < THI - 1; ++s) {
    float run = 0.f;     // r_tau k_s p over tau' >= tau, tau' >= s + 2
#pragma unroll
    for (int tau = THI - 1; tau >= TLO && tau > s; --tau) {
      const float p = expn(cc[tau - 1] - cc[s]) * mm[tau * ld + s];
      drd[tau] = fmaf(kk[s], p, drd[tau]);
      dkd[s] = fmaf(rr[tau], p, dkd[s]);
      if (tau >= s + 2) {
        run = fmaf(rr[tau] * kk[s], p, run);
        q[tau - 1] += run;
      }
    }
    // every tau of the range lies after each t in (s, TLO - 1)
#pragma unroll
    for (int t = s + 1; t < TLO - 1; ++t) q[t] += run;
  }
}

// Shared memory of kernel 3, in floats: nine (C, HD + 4) tiles, two
// (C, C + 4), and the per-channel tables.
template <int HD>
struct Layout {
  static constexpr int C = chunk_rows<HD>(), NSC = C / SC;
  static constexpr int LD = HD + 4, LDM = C + 4;
  static constexpr int RS = 0, KS = RS + C * LD, VS = KS + C * LD,
                       DS = VS + C * LD, CM = DS + C * LD, RA = CM + C * LD,
                       KB = RA + C * LD, ODR = KB + C * LD,
                       ODK = ODR + C * LD, MM = ODK + C * LD,
                       AT = MM + C * LDM, PM = AT + C * LDM,
                       QT = PM + NSC * HD, GP = QT + NSC * HD,
                       BB = GP + NSC * NSC * HD, RI = BB + NSC * NSC * HD,
                       KI = RI + NSC * HD, ER = KI + NSC * HD, US = ER + HD,
                       DUS = US + HD, FLOATS = DUS + NSC * HD;
  static constexpr size_t bytes = sizeof(float) * FLOATS;
};
static_assert(Layout<64>::bytes <= MAX_SMEM, "hd 64 past shared memory");
static_assert(Layout<128>::bytes <= MAX_SMEM, "hd 128 past shared memory");

template <typename T, int HD>
__global__ void __launch_bounds__(GRAD_THREADS, 1)
wkv_bwd_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ dout, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dlw, float* __restrict__ scr, int S,
                    int H, int nc) {
  using L = Layout<HD>;
  constexpr int NTHR = GRAD_THREADS, NW = NTHR / 32;
  constexpr int C = L::C, NSC = L::NSC, LD = L::LD, LDM = L::LDM;
  constexpr int NT = HD / 8;                // 8-column tiles of a channel row
  static_assert(NSC * HD <= NTHR, "one thread a (sub-chunk, channel)");
  extern __shared__ __align__(16) float smem[];
  float* RS = smem + L::RS;      // r
  float* KS = smem + L::KS;      // k
  float* VS = smem + L::VS;      // v
  float* DS = smem + L::DS;      // do
  float* CM = smem + L::CM;      // lw, then its inclusive cumsum
  float* RA = smem + L::RA;      // r e^(ecum - m_{a-1})
  float* KB = smem + L::KB;      // k e^(m_b - cum)
  float* ODR = smem + L::ODR;    // dr's products before e^(ecum - m_{a-1})
  float* ODK = smem + L::ODK;    // dk's products before e^(m_b - cum)
  float* MM = smem + L::MM;      // M[tau][s] = do_tau . v_s
  float* AT = smem + L::AT;      // AT[s][tau] = A[tau][s], u on the diagonal
  float* PM = smem + L::PM;      // [a] e^(m_{a-1})
  float* QT = smem + L::QT;      // [a] e^(total - m_a)
  float* GP = smem + L::GP;      // [a][b] e^(m_{a-1} - m_b), b < a
  float* BB = smem + L::BB;      // [a][b] sum of r dr' over a from b
  float* RI = smem + L::RI;      // [a] sum of r dr' over a from Sin
  float* KI = smem + L::KI;      // [b] sum of k dk' over b from Gout
  float* ER = smem + L::ER;      // e^total rowsum(Gout * Sin)
  float* US = smem + L::US;      // u
  float* DUS = smem + L::DUS;    // [a] du over a
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Geometry geo = geometry(S, H, HD, C, nc);
  const Scratch sp = carve(scr, static_cast<long long>(gridDim.x), HD);
  const float* Sin = sp.st + static_cast<long long>(blockIdx.x) * HD * HD;
  const float* Gout = sp.gr + static_cast<long long>(blockIdx.x) * HD * HD;

  stage<T, HD, C, NTHR>(RS, KS, VS, DS, CM, LD, r, k, v, dout, lw, geo,
                        S);
  for (int x = tid; x < HD; x += NTHR) US[x] = u[(geo.bh % H) * HD + x];
  __syncthreads();
  cumsum<HD, C, NTHR>(CM, LD);
  __syncthreads();

  // the scaled tiles and the tables
  for (int e = tid; e < C * HD; e += NTHR) {
    const int i = e / HD, x = e % HD, a = i / SC;
    const float mp = a ? CM[(a * SC - 1) * LD + x] : 0.f;
    const float ec = i ? CM[(i - 1) * LD + x] : 0.f;
    RA[i * LD + x] = RS[i * LD + x] * expn(ec - mp);
    KB[i * LD + x] = KS[i * LD + x] *
                     expn(CM[(a * SC + SC - 1) * LD + x] - CM[i * LD + x]);
  }
  for (int e = tid; e < NSC * HD; e += NTHR) {
    const int a = e / HD, x = e % HD;
    const float ma = CM[(a * SC + SC - 1) * LD + x];
    const float mp = a ? CM[(a * SC - 1) * LD + x] : 0.f;
    PM[e] = expn(mp);
    QT[e] = expn(CM[(C - 1) * LD + x] - ma);
    for (int b = 0; b < a; ++b)
      GP[(a * NSC + b) * HD + x] = expn(mp - CM[(b * SC + SC - 1) * LD + x]);
  }
  __syncthreads();

  // A's diagonal sub-blocks in the direct form, transposed: the pairs
  // tau > s (one a thread, none idle in a warp), zeros below, u on the
  // diagonal
  constexpr int TRI = SC * (SC - 1) / 2;
  for (int e = tid; e < NSC * TRI; e += NTHR) {
    const int a = e / TRI, l = e % TRI;      // l = tau (tau - 1) / 2 + s
    int tau = static_cast<int>((sqrtf(8.f * l + 1.f) + 1.f) * 0.5f);
    while (tau * (tau - 1) / 2 > l) --tau;
    while ((tau + 1) * tau / 2 <= l) ++tau;
    const int s = a * SC + l - tau * (tau - 1) / 2;
    tau += a * SC;
    const float* rt = RS + tau * LD;
    const float* ks = KS + s * LD;
    const float* et = CM + (tau - 1) * LD;
    const float* cs = CM + s * LD;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int x = 0; x < HD; x += 4) {
      const float4 r4 = load4(rt + x), k4 = load4(ks + x),
                   e4 = load4(et + x), c4 = load4(cs + x);
      acc.x += r4.x * k4.x * expn(e4.x - c4.x);
      acc.y += r4.y * k4.y * expn(e4.y - c4.y);
      acc.z += r4.z * k4.z * expn(e4.z - c4.z);
      acc.w += r4.w * k4.w * expn(e4.w - c4.w);
    }
    AT[s * LDM + tau] = (acc.x + acc.y) + (acc.z + acc.w);
    AT[tau * LDM + s] = 0.f;
  }
  for (int e = tid; e < NSC * SC; e += NTHR) {
    const float* rt = RS + e * LD;
    const float* ks = KS + e * LD;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int x = 0; x < HD; x += 4) {
      const float4 r4 = load4(rt + x), k4 = load4(ks + x),
                   u4 = load4(US + x);
      acc.x += r4.x * (u4.x * k4.x);
      acc.y += r4.y * (u4.y * k4.y);
      acc.z += r4.z * (u4.z * k4.z);
      acc.w += r4.w * (u4.w * k4.w);
    }
    AT[e * LDM + e] = (acc.x + acc.y) + (acc.z + acc.w);
  }
  // e^total rowsum(Gout * Sin): 16 consecutive elements a thread, HD / 16
  // threads a row, every load issued first
  {
    constexpr int TPR = HD / 16;
    for (int e0 = tid * 16; e0 < HD * HD; e0 += NTHR * 16) {
      float4 gq[4], sq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gq[q] = load4(Gout + e0 + 4 * q);
        sq[q] = load4(Sin + e0 + 4 * q);
      }
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        p += gq[q].x * sq[q].x + gq[q].y * sq[q].y + gq[q].z * sq[q].z +
             gq[q].w * sq[q].w;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (tid % TPR == 0) {
        const int x = e0 / HD;
        ER[x] = p * expn(CM[(C - 1) * LD + x]);
      }
    }
  }
  // M = do v^T on the sub-block rows at and below the diagonal, then A's
  // sub-blocks below the diagonal (rows tau of a, columns s of b < a):
  // A = (ra e^(m_{a-1} - m_b)) kb^T
  {
    constexpr int NM = NSC * (NSC + 1);          // 16 x 8 tiles of M
    constexpr int NA = NSC * (NSC - 1);          // 16 x 8 tiles of A
    for (int idx = warp; idx < NM + NA; idx += NW) {
      float c[4];
      zero(c);
      if (idx < NM) {
        int a = 0;                               // row tile a: 2 (a + 1)
        while ((a + 1) * (a + 2) <= idx) ++a;    // column tiles
        const int m0 = a * SC, n0 = (idx - a * (a + 1)) * 8;
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 16)
          mma_step(c, g, t,
                   [&](int row, int col) {
                     return DS[(m0 + row) * LD + k0 + col];
                   },
                   [&](int row, int col) {
                     return VS[(n0 + col) * LD + k0 + row];
                   });
        MM[(m0 + g) * LDM + n0 + 2 * t] = c[0];
        MM[(m0 + g) * LDM + n0 + 2 * t + 1] = c[1];
        MM[(m0 + g + 8) * LDM + n0 + 2 * t] = c[2];
        MM[(m0 + g + 8) * LDM + n0 + 2 * t + 1] = c[3];
      } else {
        const int p = (idx - NM) / 2, half = (idx - NM) % 2;
        int a = 1;                               // pairs (a, b), b < a
        while (a * (a + 1) / 2 <= p) ++a;
        const int b = p - a * (a - 1) / 2;
        const int m0 = a * SC, n0 = b * SC + half * 8;
        const float* gp = GP + (a * NSC + b) * HD;
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 16)
          mma_step(c, g, t,
                   [&](int row, int col) {
                     return RA[(m0 + row) * LD + k0 + col] * gp[k0 + col];
                   },
                   [&](int row, int col) {
                     return KB[(n0 + col) * LD + k0 + row];
                   });
        AT[(n0 + 2 * t) * LDM + m0 + g] = c[0];
        AT[(n0 + 2 * t + 1) * LDM + m0 + g] = c[1];
        AT[(n0 + 2 * t) * LDM + m0 + g + 8] = c[2];
        AT[(n0 + 2 * t + 1) * LDM + m0 + g + 8] = c[3];
      }
    }
  }
  __syncthreads();

  // dv (rows s), dr (rows tau), dk (rows s) as twelve units, a warp each:
  // a unit is two row tiles {mp, NSC - 1 - mp} (the pair that evens out
  // the sub-block products) of one of them over NNU column tiles, so each
  // A fragment is split for NNU tiles and each B fragment (from Sin or
  // Gout in the scratch, or from do) for both row tiles.  dr's and dk's
  // column scales e^(m_{a-1}) and e^(total - m_b) are applied after the
  // products from Sin and Gout.
  {
    constexpr int MP = NSC / 2, NG = 12 / (3 * MP), NNU = NT / NG;
    static_assert(3 * MP * NG <= NW && NNU * NG == NT, "twelve units");
    if (warp < 3 * MP * NG) {
      const int which = warp / (MP * NG), mp = warp / NG % MP,
                c0 = warp % NG * NNU * 8;
      const int ms[2] = {mp, NSC - 1 - mp};
      float c[2][NNU][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NNU; ++n) zero(c[m][n]);
      const float* st = which == 1 ? Sin : Gout;
      const float* xs = which == 1 ? DS : VS;
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 16) {
        // A: dv's kb e^(total - m_b) (rows s, columns i); dr's do and
        // dk's v (rows tau or s, columns j).  B: dv's Gout[i][j]; dr's
        // Sin[i][j] and dk's Gout[i][j] as (j, i)
        FragA fa[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int m0 = ms[m] * SC;
          const float* q = QT + ms[m] * HD;
          fa[m] = which == 0
                      ? frag_a(g, t, [&](int row, int col) {
                          return KB[(m0 + row) * LD + k0 + col] * q[k0 + col];
                        })
                      : frag_a(g, t, [&](int row, int col) {
                          return xs[(m0 + row) * LD + k0 + col];
                        });
        }
#pragma unroll
        for (int n = 0; n < NNU; ++n) {
          const int n0 = c0 + n * 8;
          const FragB fb =
              which == 0 ? frag_b(g, t, [&](int row, int col) {
                return Gout[(k0 + row) * HD + n0 + col];
              })
                         : frag_b(g, t, [&](int row, int col) {
                             return st[(n0 + col) * HD + k0 + row];
                           });
          mma3(c[0][n], fa[0], fb);
          mma3(c[1][n], fa[1], fb);
        }
      }
      if (which == 0) {
        // dv += A^T do: row tile b reads A's column blocks a2 >= b
        for (int a2 = ms[0]; a2 < NSC; ++a2) {
          const bool hi = ms[1] <= a2;
          FragA fa[2];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m == 0 || hi)
              fa[m] = frag_a(g, t, [&](int row, int col) {
                return AT[(ms[m] * SC + row) * LDM + a2 * SC + col];
              });
#pragma unroll
          for (int n = 0; n < NNU; ++n) {
            const int n0 = c0 + n * 8;
            const FragB fb = frag_b(g, t, [&](int row, int col) {
              return DS[(a2 * SC + row) * LD + n0 + col];
            });
            mma3(c[0][n], fa[0], fb);
            if (hi) mma3(c[1][n], fa[1], fb);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NNU; ++n)
#pragma unroll
            for (int h8 = 0; h8 < 2; ++h8) {
              const int row = geo.t0 + ms[m] * SC + g + 8 * h8;
              if (row < S)
                *reinterpret_cast<float2*>(dv + geo.base + row * geo.step +
                                           c0 + n * 8 + 2 * t) =
                    make_float2(c[m][n][2 * h8], c[m][n][2 * h8 + 1]);
            }
      } else {
        const float* scale = which == 1 ? PM : QT;
        const float* wt = which == 1 ? RA : KB;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int a = ms[m], m0 = a * SC;
#pragma unroll
          for (int n = 0; n < NNU; ++n) {
            const int n0 = c0 + n * 8;
            const float2 f = *reinterpret_cast<const float2*>(
                scale + a * HD + n0 + 2 * t);
            c[m][n][0] *= f.x;
            c[m][n][1] *= f.y;
            c[m][n][2] *= f.x;
            c[m][n][3] *= f.y;
            // column sums of r dr' from Sin (ra) or of k dk' from Gout (kb)
            col_sums(c[m][n], g, t,
                     [&](int row, int col) {
                       return wt[(m0 + row) * LD + n0 + col];
                     },
                     (which == 1 ? RI : KI) + a * HD + n0);
          }
          if (which == 1) {
            // dr += M_ab (kb_b e^(m_{a-1} - m_b)) for b < a; the
            // whole-block sums B_ab of r dr' for a >= b + 2
            for (int b = 0; b < a; ++b) {
              const float* gp = GP + (a * NSC + b) * HD;
              const FragA fa = frag_a(g, t, [&](int row, int col) {
                return MM[(m0 + row) * LDM + b * SC + col];
              });
#pragma unroll
              for (int n = 0; n < NNU; ++n) {
                const int n0 = c0 + n * 8;
                float p[4];
                zero(p);
                mma3(p, fa, frag_b(g, t, [&](int row, int col) {
                       return KB[(b * SC + row) * LD + n0 + col] *
                              gp[n0 + col];
                     }));
                if (a >= b + 2)
                  col_sums(p, g, t,
                           [&](int row, int col) {
                             return RA[(m0 + row) * LD + n0 + col];
                           },
                           BB + (a * NSC + b) * HD + n0);
#pragma unroll
                for (int q = 0; q < 4; ++q) c[m][n][q] += p[q];
              }
            }
          } else {
            // dk += M_ab^T (ra_a e^(m_{a-1} - m_b)) for a > b (here b = a)
            for (int a2 = a + 1; a2 < NSC; ++a2) {
              const float* gp = GP + (a2 * NSC + a) * HD;
              const FragA fa = frag_a(g, t, [&](int row, int col) {
                return MM[(a2 * SC + col) * LDM + m0 + row];
              });
#pragma unroll
              for (int n = 0; n < NNU; ++n) {
                const int n0 = c0 + n * 8;
                mma3(c[m][n], fa, frag_b(g, t, [&](int row, int col) {
                       return RA[(a2 * SC + row) * LD + n0 + col] *
                              gp[n0 + col];
                     }));
              }
            }
          }
          float* o = which == 1 ? ODR : ODK;
#pragma unroll
          for (int n = 0; n < NNU; ++n) {
            const int n0 = c0 + n * 8;
            *reinterpret_cast<float2*>(o + (m0 + g) * LD + n0 + 2 * t) =
                make_float2(c[m][n][0], c[m][n][1]);
            *reinterpret_cast<float2*>(o + (m0 + g + 8) * LD + n0 + 2 * t) =
                make_float2(c[m][n][2], c[m][n][3]);
          }
        }
      }
    }
  }
  __syncthreads();

  // The diagonal sub-blocks in the direct form, a (sub-chunk a, channel
  // i) at a time, its pairs s < tau split by tau between two threads in
  // the two halves of the block: half 0 takes tau >= SPLIT (65 pairs),
  // half 1 tau < SPLIT (55) and leaves its sums for the rows below SPLIT
  // over v and do, which no phase reads any more; half 0 adds them, the
  // bonus and the terms from outside the sub-block, and writes the rows'
  // dr, dk, dlw.
  constexpr int SPLIT = 11, NX = 3 * (SPLIT - 1);
  static_assert(2 * NSC * HD <= NTHR, "two threads a (sub-chunk, channel)");
  static_assert(NX * NSC * HD <= 2 * C * LD, "partials fit over v and do");
  const int half = tid / (NSC * HD), p = tid % (NSC * HD);
  const int a = p / HD, i = p % HD, r0 = a * SC;
  float* XB = VS;                // the partials of half 1, NX a thread
  float rr[SC], kk[SC], cc[SC], drd[SC], dkd[SC], q[SC];
  if (half < 2) {
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      rr[e] = RS[(r0 + e) * LD + i];
      kk[e] = KS[(r0 + e) * LD + i];
      cc[e] = CM[(r0 + e) * LD + i];
      drd[e] = dkd[e] = q[e] = 0.f;
    }
    const float* mm = MM + r0 * LDM + r0;
    if (half == 0)
      diag_pairs<SPLIT, SC>(rr, kk, cc, mm, LDM, drd, dkd, q);
    else
      diag_pairs<1, SPLIT>(rr, kk, cc, mm, LDM, drd, dkd, q);
    if (half == 1) {
#pragma unroll
      for (int e = 0; e < SPLIT - 1; ++e) {
        XB[e * NSC * HD + p] = drd[e + 1];
        XB[(SPLIT - 1 + e) * NSC * HD + p] = dkd[e];
        XB[(2 * SPLIT - 2 + e) * NSC * HD + p] = q[e];
      }
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int e = 0; e < SPLIT - 1; ++e) {
      drd[e + 1] += XB[e * NSC * HD + p];
      dkd[e] += XB[(SPLIT - 1 + e) * NSC * HD + p];
      q[e] += XB[(2 * SPLIT - 2 + e) * NSC * HD + p];
    }
    const float ui = US[i];
    float du = 0.f;
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      const float bon = MM[(r0 + e) * LDM + r0 + e];
      drd[e] = fmaf(ui * kk[e], bon, drd[e]);
      dkd[e] = fmaf(ui * rr[e], bon, dkd[e]);
      du = fmaf(rr[e] * kk[e], bon, du);
    }
    DUS[a * HD + i] = du;
    // dlw's terms from outside the sub-block, in a fixed order
    float cross = ER[i];
    for (int a2 = a + 1; a2 < NSC; ++a2) cross += RI[a2 * HD + i];
    for (int b = 0; b < a; ++b) cross += KI[b * HD + i];
    for (int a2 = a + 1; a2 < NSC; ++a2)
      for (int b = 0; b < a; ++b) cross += BB[(a2 * NSC + b) * HD + i];
    const float mp = a ? CM[(r0 - 1) * LD + i] : 0.f;
    float run = 0.f;               // r dr' after t in the sub-block
#pragma unroll
    for (int e = SC - 1; e >= 0; --e) {
      q[e] += cross + run;
      run = fmaf(RA[(r0 + e) * LD + i], ODR[(r0 + e) * LD + i], run);
    }
    run = 0.f;                     // k dk' before t in the sub-block
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      q[e] += run;
      run = fmaf(KB[(r0 + e) * LD + i], ODK[(r0 + e) * LD + i], run);
    }
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      const int row = geo.t0 + r0 + e;
      if (row >= S) break;
      const float ec = e ? cc[e - 1] : mp;
      const long long at = geo.base + row * geo.step + i;
      dr[at] = fmaf(expn(ec - mp), ODR[(r0 + e) * LD + i], drd[e]);
      dk[at] = fmaf(expn(cc[SC - 1] - cc[e]), ODK[(r0 + e) * LD + i],
                    dkd[e]);
      dlw[at] = q[e];
    }
  }
  __syncthreads();
  for (int x = tid; x < HD; x += NTHR) {
    float du = 0.f;
    for (int a = 0; a < NSC; ++a) du += DUS[a * HD + x];
    sp.dup[static_cast<long long>(blockIdx.x) * HD + x] = du;
  }
}

// ---------------------------------------------------------------- 4
// du[h, i] = sum over b, then chunks, in order, of the chunks' partials
__global__ void wkv_bwd_du_kernel(const float* __restrict__ dup,
                                  float* __restrict__ du, int B, int H,
                                  int nc, int HD) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * HD) return;
  const int h = e / HD, x = e % HD;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int j = 0; j < nc; ++j)
      acc += dup[((static_cast<long long>(b) * H + h) * nc + j) * HD + x];
  du[e] = acc;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dout, void* dr, void* dk, void* dv,
           void* dlw, void* du, void* scratch, int B, int S, int H,
           cudaStream_t stream) {
  constexpr int C = chunk_rows<HD>();
  constexpr size_t chunk_smem = sizeof(float) * 5 * C * (HD + 4);
  constexpr size_t grad_smem = Layout<HD>::bytes;
  const int nc = (S + C - 1) / C, blocks = B * H * nc;
  float* scr = static_cast<float*>(scratch);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* lwf = static_cast<const float*>(lw);
  const float* dof = static_cast<const float*>(dout);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_chunk_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(chunk_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_bwd_grad_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(grad_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_chunk_kernel<T, HD><<<blocks, THREADS, chunk_smem, stream>>>(
      rt, kt, vt, lwf, dof, scr, S, H, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(B) * H * HD * HD;
  const dim3 scan_grid(static_cast<unsigned>((elems + THREADS - 1) / THREADS),
                       2);
  wkv_bwd_scan_kernel<HD><<<scan_grid, THREADS, 0, stream>>>(scr, B * H, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_grad_kernel<T, HD><<<blocks, GRAD_THREADS, grad_smem, stream>>>(
      rt, kt, vt, lwf, static_cast<const float*>(u), dof,
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dlw), scr, S, H, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scratch sp = carve(scr, static_cast<long long>(blocks), HD);
  const int n = H * HD;
  wkv_bwd_du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      sp.dup, static_cast<float*>(du), B, H, nc, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* r, const void* k, const void* v, const void* lw,
                const void* u, const void* dout, void* dr, void* dk,
                void* dv, void* dlw, void* du, void* scratch, int B, int S,
                int H, int hd, cudaStream_t s) {
  if (hd == 32)
    return launch<T, 32>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, scratch,
                         B, S, H, s);
  if (hd == 64)
    return launch<T, 64>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du, scratch,
                         B, S, H, s);
  if (hd == 128)
    return launch<T, 128>(r, k, v, lw, u, dout, dr, dk, dv, dlw, du,
                          scratch, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wkvbwd

// r, k, v (B, S, H, hd) of `dtype`; lw, do (B, S, H, hd) and u (H, hd)
// fp32; dr, dk, dv, dlw (B, S, H, hd) and du (H, hd) fp32 outputs;
// scratch of B H ceil(S / C) (2 hd^2 + 2 hd) floats, C = 64 (32 at hd
// 128) (kernels/wkv/wkv.py::wkv_bwd_scratch_floats); hd 32, 64 or 128.
// All contiguous and 16-byte aligned.  Returns a cudaError_t.
extern "C" int repro_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, const void* dout,
                             void* dr, void* dk, void* dv, void* dlw,
                             void* du, void* scratch, int B, int S, int H,
                             int hd, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (dtype == DTYPE_BF16)
    return wkvbwd::dispatch_hd<__nv_bfloat16>(r, k, v, lw, u, dout, dr, dk,
                                              dv, dlw, du, scratch, B, S, H,
                                              hd, s);
  if (dtype == DTYPE_F32)
    return wkvbwd::dispatch_hd<float>(r, k, v, lw, u, dout, dr, dk, dv, dlw,
                                      du, scratch, B, S, H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
