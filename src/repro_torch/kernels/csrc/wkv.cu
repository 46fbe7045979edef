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
// and lw (fp32) once and writes o (fp32) once: 940 MB in bf16, 0.28 ms at
// 3.35 TB/s.  Computed in the direct form (one exponential per (i, j < i,
// channel)) it is ~32 G operations, 2.1 G of them exponentials, and bound
// by operations; in the TPU kernel's sub-chunked form (wkv.py:57-99) most
// of that becomes matrix products.
//
// Two routes, chosen by shape alone (kernels/wkv/wkv.py::wkv_route).
//
// The mma route (wkv_mma_kernel; head width 64 or 128, sub-chunks of 8
// to 64 rows) computes the sub-chunked form on the tensor cores.  One
// block of 8 warps owns one (batch, head) and all of its value columns,
// and walks the sequence in pieces of P = 64 rows (32 or 16 where the
// chunk is shorter), carrying the state.  A piece is a whole number of
// sub-chunks, and every term of the sub-chunked form outside the diagonal
// sub-blocks is exact (only those are clamped at e^-60, wkv.py:83), so a
// piece of several chunks computes what the TPU kernel computes chunk by
// chunk.  Per piece, with a(i) the sub-chunk of row i and m_a the cumsum
// at sub-chunk a's last row:
//   ra_i  = r_i * exp(ecum_i - m_{a(i)-1})       (sc-row boundary scaling)
//   kb_j  = k_j * exp(m_{b(j)} - cum_j)
//   A_ij  = ra_i . (kb_j * exp(m_{a-1} - m_b))   a > b: products
//   A_ij  = sum_d r k exp(max(ecum_i - cum_j, -60)), the bonus on i == j:
//           the diagonal sub-blocks, one exponential per (i, j < i, d)
//   O^T   = T @ (ra * exp(m_{a-1}))^T + V^T @ A^T
//   T     <- T * exp(total) + V^T @ (kb * exp(total - m_b))
// where T = S^T stays in the warps' registers from piece to piece: two of
// its accumulator fragments are one A fragment of the next piece's
// inter-chunk product, so the state never touches shared memory.  Every
// exponent is <= 0; nothing uses exp(-cum).  The exponentials are
// ex2.approx of the difference scaled by log2(e) after it is formed (the
// difference of two large cumsums is exact; their scaled copies are not).
//
// Precision.  The products run as mma.sync m16n8k16 on bf16 operands,
// each fp32 operand split as x = hi + lo (both bf16, x to ~2^-17) and
// summed as lo*hi + hi*lo + hi*hi in fp32, as B7 and B4b split theirs:
// each product carries ~2^-16 of relative error, far inside the fp32
// reference's 1e-4 of max |o| at fp32 and bf16 inputs and under strong
// decay (a copy without the lo terms misses it: tools/kernel_variants.py,
// wkv_mutant_no_lo).  A bf16 v is exact, so its products drop the lo*hi
// term.  mma.sync fits the 16-row sub-blocks and 8-column tiles of this
// form; wgmma's 64-row tiles would fit only the chunk-wide products.
// (3xTF32 on m16n8k8 issues twice the mma instructions a flop and ran
// slower on the H100.)
//
// Work a piece (8 warps): the cumsum (4 threads a channel, a shuffle
// scan); the scaled tiles, the sub-chunk tables and the diagonal
// sub-blocks on the FP32 and SFU pipes; the off-diagonal sub-blocks (16 x 8
// tiles, one warp each); then each warp owns 16 value columns of O^T and
// of T (and a K-split of 8 / (hd / 16) over the state's columns and the
// key rows, its partials summed in order through shared memory), so the
// results do not depend on timing and reruns are bit-equal.  Blocks of A
// above the diagonal ones are zero once and never written.  Loads: r, k
// and lw of the next piece are issued by cp.async into their slots as soon
// as the current piece has turned them into the scaled tiles, before the
// products, and v into a second buffer; at rwkv6-7b (hd 64, bf16) a block
// takes 107 KB of shared memory, two blocks an SM, and the 256 (batch,
// head) walks run in one wave.
//
// The simt route (wkv_kernel; any other head width or sub-chunk) is the
// first design: one block per (batch, head, block of at most 64 value
// columns) loops over the chunks with its columns of the fp32 state in
// shared memory; the key side is staged in pieces of 64 channels and a
// chunk longer than 64 rows is walked in row pieces of 64, the state
// carried between them (so a weight across two row pieces is the exact
// product, not clamped), one accurate expf per (i, j < i, channel), every
// product on the FMA units from padded shared-memory tiles.
#include "common.cuh"
#include "matmul_sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 64;  // channels of r, k and lw staged at a time

// floats of shared memory for pieces of `rows` rows and blocks of `cols`
// value columns: r, k, cum (rows x (piece+1)); v (rows x (cols+1)); the
// attention matrix (rows x (rows+1)); the state's columns (hd x
// (cols+1)); u (hd)
size_t smem_floats(int rows, int cols, int hd) {
  const size_t p = hd < PIECE ? hd : PIECE;
  return 3 * rows * (p + 1) + static_cast<size_t>(rows) * (cols + 1) +
         static_cast<size_t>(rows) * (rows + 1) +
         static_cast<size_t>(hd) * (cols + 1) + hd;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, float* __restrict__ out, int S,
           int H, int hd, int c, int rows, int cols) {
  extern __shared__ float smem[];
  const int P = min(hd, PIECE), ldp = P + 1, ldv = cols + 1;
  const int lda = rows + 1;
  float* rs = smem;                  // r, then r * exp(ecum)
  float* ks = rs + rows * ldp;       // k, then k * exp(total - cum)
  float* cum = ks + rows * ldp;      // lw, then its inclusive cumsum
  float* vs = cum + rows * ldp;      // this block's value columns
  float* att = vs + rows * ldv;      // (rows, rows+1), lower triangle
  float* st = att + rows * lda;      // the state's columns, (hd, cols+1)
  float* us = st + hd * ldv;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int d0 = blockIdx.y * cols, nv = min(cols, hd - d0);
  const long long step = static_cast<long long>(H) * hd;  // one time step
  const long long base = (static_cast<long long>(b) * S * H + h) * hd;

  for (int e = tid; e < hd * ldv; e += THREADS) st[e] = 0.f;
  for (int d = tid; d < hd; d += THREADS) us[d] = u[h * hd + d];

  int n = 0;
  for (int s0 = 0; s0 < S; s0 += n) {
    n = min(rows, c - s0 % c);       // a row piece never crosses a chunk
    for (int e = tid; e < n * nv; e += THREADS) {
      const int i = e / nv, d = e % nv;
      vs[i * ldv + d] = to_f32(v[base + (s0 + i) * step + d0 + d]);
    }
    for (int x0 = 0; x0 < hd; x0 += P) {
      const int np = min(P, hd - x0);
      const bool last = x0 + P >= hd;
      for (int e = tid; e < n * np; e += THREADS) {
        const int i = e / np, x = e % np;
        const long long g = base + (s0 + i) * step + x0 + x;
        rs[i * ldp + x] = to_f32(r[g]);
        ks[i * ldp + x] = to_f32(k[g]);
        cum[i * ldp + x] = lw[g];
      }
      __syncthreads();
      // inclusive cumsum per channel; the exclusive one is the row above
      for (int x = tid; x < np; x += THREADS) {
        float run = 0.f;
        for (int i = 0; i < n; ++i) {
          run += cum[i * ldp + x];
          cum[i * ldp + x] = run;
        }
      }
      __syncthreads();
      // attention matrix, summed over the pieces: j < i decayed, j == i
      // the bonus
      for (int e = tid; e < n * n; e += THREADS) {
        const int i = e / n, j = e % n;
        if (j > i) continue;
        const float* ri = rs + i * ldp;
        const float* kj = ks + j * ldp;
        float a = x0 ? att[i * lda + j] : 0.f;
        if (j == i) {
          for (int x = 0; x < np; ++x) a += ri[x] * (us[x0 + x] * kj[x]);
        } else {
          const float* ecum_i = cum + (i - 1) * ldp;   // i >= 1 here
          const float* cum_j = cum + j * ldp;
          for (int x = 0; x < np; ++x)
            a += ri[x] * kj[x] * expf(fmaxf(ecum_i[x] - cum_j[x], -60.f));
        }
        att[i * lda + j] = a;
      }
      __syncthreads();
      for (int e = tid; e < n * np; e += THREADS) {
        const int i = e / np, x = e % np;
        const float total = cum[(n - 1) * ldp + x];
        const float ecum = i > 0 ? cum[(i - 1) * ldp + x] : 0.f;
        rs[i * ldp + x] *= expf(ecum);
        ks[i * ldp + x] *= expf(total - cum[i * ldp + x]);
      }
      __syncthreads();
      // the inter-chunk term of this piece's channels; after the last
      // piece the intra-chunk term; earlier pieces' sums come back from
      // out, which only this thread wrote
      for (int e = tid; e < n * nv; e += THREADS) {
        const int i = e / nv, d = e % nv;
        float val = 0.f;
        for (int x = 0; x < np; ++x)
          val += rs[i * ldp + x] * st[(x0 + x) * ldv + d];
        if (last) {
          float intra = 0.f;
          for (int j = 0; j <= i; ++j)
            intra += att[i * lda + j] * vs[j * ldv + d];
          val += intra;
        }
        const long long g = base + (s0 + i) * step + d0 + d;
        out[g] = x0 ? out[g] + val : val;
      }
      __syncthreads();
      for (int e = tid; e < np * nv; e += THREADS) {
        const int x = e / nv, d = e % nv;
        float add = 0.f;
        for (int j = 0; j < n; ++j) add += ks[j * ldp + x] * vs[j * ldv + d];
        float* sx = st + (x0 + x) * ldv + d;
        *sx = expf(cum[(n - 1) * ldp + x]) * *sx + add;
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* out, int B, int S, int H, int hd, int c,
           int rows, int cols, cudaStream_t stream) {
  const size_t smem = smem_floats(rows, cols, hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)        // two 100 KB blocks per SM at c = hd = 64
    err = cudaFuncSetAttribute(wkv_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (hd + cols - 1) / cols);
  wkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), S, H, hd, c,
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v (B, S, H, hd) of the float type `dtype`; lw (B, S, H, hd) fp32;
// u (H, hd) fp32; out (B, S, H, hd) fp32; all contiguous.  c divides S;
// row pieces of at most `rows` (<= c) rows, blocks of `cols` value
// columns (kernels/wkv/wkv.py::wkv_tiles).  Returns a cudaError_t.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, void* out, int B,
                         int S, int H, int hd, int c, int rows, int cols,
                         int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0 || hd == 0) return 0;
  if (c <= 0 || S % c || rows <= 0 || rows > c || cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, out, B, S, H, hd, c, rows,
                                 cols, s);
  if (dtype == DTYPE_F32)
    return launch<float>(r, k, v, lw, u, out, B, S, H, hd, c, rows, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ mma route

namespace wkvmma {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int PMAX = 64;            // rows of a piece
constexpr size_t MAX_SMEM = 232448; // an H100 block's dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;

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
__device__ __forceinline__ Pair split(float2 v) { return split(v.x, v.y); }

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// c += a @ b on split operands: lo*hi + hi*lo + hi*hi (lo*lo lies below
// 2^-17 of the product); A_EXACT (a bf16 input, lo = 0) drops the first
template <bool A_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const Pair (&a)[4],
                                     const Pair (&b)[2]) {
  if (!A_EXACT) mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(w.x << 16);
  o[1] = __uint_as_float(w.x & 0xffff0000u);
  o[2] = __uint_as_float(w.y << 16);
  o[3] = __uint_as_float(w.y & 0xffff0000u);
}

// V^T's fragment element pair {V[j][d], V[j + 1][d]} (ld elements a row):
// bf16 v is exact, its bits packed as they are; fp32 v is split
template <typename T>
__device__ __forceinline__ Pair vpair(const T* p, int ld);
template <>
__device__ __forceinline__ Pair vpair<__nv_bfloat16>(const __nv_bfloat16* p,
                                                    int ld) {
  const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
  return {static_cast<uint32_t>(q[0]) | (static_cast<uint32_t>(q[ld]) << 16),
          0u};
}
template <>
__device__ __forceinline__ Pair vpair<float>(const float* p, int ld) {
  return split(p[0], p[ld]);
}

// Shared memory of one block, in floats or T elements; rows padded so
// that the fragment loads of the products are free of bank conflicts.
template <typename T, int HD>
struct Layout {
  static constexpr int LDA = HD + 4;            // ra, kb, cum (fp32)
  static constexpr int LDT = PMAX + 4;          // the (P, P) matrix A
  static constexpr int LDR = HD + 16 / sizeof(T);   // raw r, k (T)
  static constexpr int LDV = HD + (sizeof(T) == 2 ? 8 : 4);   // v (T)
  static constexpr int LDO = HD + 4;            // the K-split partials
  static constexpr size_t RA = 0;
  static constexpr size_t KB = RA + 4 * PMAX * LDA;
  static constexpr size_t ATT = KB + 4 * PMAX * LDA;
  static constexpr size_t CUM = ATT + 4 * PMAX * LDT;
  static constexpr size_t RS = CUM + 4 * PMAX * LDA;
  static constexpr size_t KS = RS + sizeof(T) * PMAX * LDR;
  static constexpr size_t VS = KS + sizeof(T) * PMAX * LDR;
  static constexpr size_t TABLES = VS + 2 * sizeof(T) * PMAX * LDV;
  // per-channel tables: exp(m_{a-1}) and exp(total - m_a) for each of nsc
  // sub-chunks, the gaps exp(m_{a-1} - m_b) for a >= b + 2, exp(total), u
  static constexpr size_t bytes(int nsc) {
    return TABLES +
           4 * static_cast<size_t>(2 * nsc + (nsc - 1) * (nsc - 2) / 2 + 2) *
               HD;
  }
};
// a block's bytes at the most sub-chunks a piece holds (PMAX / 8)
template <typename T, int HD>
constexpr size_t most_bytes() { return Layout<T, HD>::bytes(PMAX / 8); }
// fp32 at hd 128 does not fit (kernels/wkv/wkv.py::wkv_route sends it to
// the simt route, and dispatch_hd builds no such kernel)
static_assert(most_bytes<float, 128>() > MAX_SMEM, "fp32 at hd 128 fits");
// two blocks an SM at rwkv6-7b (hd 64, bf16, sub-chunks of 16): 228 KB
// of shared memory an SM, 1 KB of it reserved a block
static_assert(2 * (Layout<__nv_bfloat16, 64>::bytes(4) + 1024) <= 228 * 1024,
              "two blocks an SM at hd 64 do not fit");

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
wkv_mma_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, float* __restrict__ out, int S,
               int H, int sc, int P) {
  using L = Layout<T, HD>;
  constexpr bool V_EXACT = sizeof(T) == 2;
  constexpr int MT = HD / 16;             // 16-column tiles of d
  constexpr int KSPLIT = NWARP / MT;      // warps per tile of d
  constexpr int XW = HD / KSPLIT;         // state columns x of one warp
  constexpr int NXT = XW / 8;             // even: pairs make a k16 step
  static_assert(NXT % 2 == 0, "state columns in pairs of 8");
  extern __shared__ __align__(16) unsigned char smem[];
  float* RA = reinterpret_cast<float*>(smem + L::RA);
  float* KB = reinterpret_cast<float*>(smem + L::KB);
  float* ATT = reinterpret_cast<float*>(smem + L::ATT);
  float* CUM = reinterpret_cast<float*>(smem + L::CUM);
  T* RS = reinterpret_cast<T*>(smem + L::RS);
  T* KS = reinterpret_cast<T*>(smem + L::KS);
  T* VS = reinterpret_cast<T*>(smem + L::VS);
  const int nsc = P / sc, ng = (nsc - 1) * (nsc - 2) / 2;
  const int lsc = __ffs(sc) - 1;          // sc is a power of two
  float* PM = reinterpret_cast<float*>(smem + L::TABLES);
  float* Q = PM + nsc * HD;
  float* G = Q + nsc * HD;
  float* ETOT = G + ng * HD;
  float* US = ETOT + HD;
  // the K-split partials of O, over ra (and kb) once the products are done
  float* OB = RA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = (warp % MT) * 16, hh = warp / MT, xw0 = hh * XW;
  const int bh = blockIdx.x, h = bh % H;
  const long long step = static_cast<long long>(H) * HD;
  const long long base = (static_cast<long long>(bh / H) * S * H + h) * HD;

  for (int d = tid; d < HD; d += THREADS) US[d] = u[h * HD + d];
  // blocks of A above the diagonal ones, and the upper triangles of the
  // diagonal ones, are read as zeros and never written
  for (int e = tid; e < PMAX * L::LDT; e += THREADS) ATT[e] = 0.f;

  // the piece at row s0: r, k and lw into their slots, v into buffer vb
  auto issue = [&](int s0, int vb) {
    constexpr int CH = HD * sizeof(T) / 16, EL = 16 / sizeof(T);
    T* vs = VS + vb * PMAX * L::LDV;
    for (int e = tid; e < P * CH; e += THREADS) {
      const int i = e / CH, c = (e % CH) * EL;
      const long long gi = base + (s0 + i) * step + c;
      sm90::cp_async16(RS + i * L::LDR + c, r + gi, 16);
      sm90::cp_async16(KS + i * L::LDR + c, k + gi, 16);
      sm90::cp_async16(vs + i * L::LDV + c, v + gi, 16);
    }
    for (int e = tid; e < P * HD / 4; e += THREADS) {
      const int i = e / (HD / 4), c = (e % (HD / 4)) * 4;
      sm90::cp_async16(CUM + i * L::LDA + c, lw + base + (s0 + i) * step + c,
                       16);
    }
    sm90::cp_async_commit();
  };

  float st[NXT][4];                       // T = S^T, rows d0.., cols xw0..
#pragma unroll
  for (int n = 0; n < NXT; ++n)
    st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  issue(0, 0);
  for (int s0 = 0, piece = 0; s0 < S; s0 += P, ++piece) {
    const int vb = piece & 1;
    const T* vs = VS + vb * PMAX * L::LDV;
    sm90::cp_async_wait<0>();
    __syncthreads();

    // 1. inclusive cumsum of lw down each channel: PARTS threads a
    // channel, each a run of rows in registers, then a shuffle scan of
    // the runs' sums
    {
      constexpr int PARTS = THREADS / HD, LPC = 32 / PARTS;
      constexpr int RMAX = PMAX / PARTS;
      const int part = lane / LPC, x = warp * LPC + lane % LPC;
      const int rows = P / PARTS;
      float* col = CUM + part * rows * L::LDA + x;
      float val[RMAX];
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (i < rows) val[i] = col[i * L::LDA];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (i < rows) val[i] = run += val[i];
      float incl = run;
#pragma unroll
      for (int off = 1; off < PARTS; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off * LPC);
        if (part >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, LPC);
      if (part == 0) before = 0.f;
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (i < rows) col[i * L::LDA] = val[i] + before;
    }
    __syncthreads();

    // 2. the diagonal sub-blocks (j <= i, one sub-chunk), the scaled
    // tiles and the tables
    {
      const int tri = sc * (sc - 1) / 2;           // j < i
      for (int e = tid; e < nsc * tri; e += THREADS) {
        const int a = e / tri, l = e % tri;        // l = i (i - 1) / 2 + j
        int i = static_cast<int>((sqrtf(8.f * l + 1.f) + 1.f) * 0.5f);
        while (i * (i - 1) / 2 > l) --i;
        while ((i + 1) * i / 2 <= l) ++i;
        const int I = a * sc + i, J = a * sc + l - i * (i - 1) / 2;
        const T* ri = RS + I * L::LDR;
        const T* kj = KS + J * L::LDR;
        const float* ei = CUM + (I - 1) * L::LDA;   // ecum_i
        const float* cj = CUM + J * L::LDA;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int x = 0; x < HD; x += 4) {
          float r4[4], k4[4], e4[4], c4[4];
          load4(ri + x, r4);
          load4(kj + x, k4);
          load4(ei + x, e4);
          load4(cj + x, c4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[q] += r4[q] * k4[q] * expn(fmaxf(e4[q] - c4[q], -60.f));
        }
        ATT[I * L::LDT + J] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      for (int I = tid; I < P; I += THREADS) {     // the bonus, j == i
        const T* ri = RS + I * L::LDR;
        const T* ki = KS + I * L::LDR;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int x = 0; x < HD; x += 4) {
          float r4[4], k4[4], u4[4];
          load4(ri + x, r4);
          load4(ki + x, k4);
          load4(US + x, u4);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += r4[q] * (u4[q] * k4[q]);
        }
        ATT[I * L::LDT + I] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      for (int e = tid; e < P * HD / 4; e += THREADS) {
        const int i = e / (HD / 4), x = (e % (HD / 4)) * 4, a = i >> lsc;
        float r4[4], k4[4], c4[4], e4[4] = {0.f, 0.f, 0.f, 0.f};
        float mp[4] = {0.f, 0.f, 0.f, 0.f}, me[4];
        load4(RS + i * L::LDR + x, r4);
        load4(KS + i * L::LDR + x, k4);
        load4(CUM + i * L::LDA + x, c4);
        if (i) load4(CUM + (i - 1) * L::LDA + x, e4);
        if (a) load4(CUM + ((a << lsc) - 1) * L::LDA + x, mp);
        load4(CUM + (((a + 1) << lsc) - 1) * L::LDA + x, me);
        float4 ra, kb;
        ra.x = r4[0] * expn(e4[0] - mp[0]);
        ra.y = r4[1] * expn(e4[1] - mp[1]);
        ra.z = r4[2] * expn(e4[2] - mp[2]);
        ra.w = r4[3] * expn(e4[3] - mp[3]);
        kb.x = k4[0] * expn(me[0] - c4[0]);
        kb.y = k4[1] * expn(me[1] - c4[1]);
        kb.z = k4[2] * expn(me[2] - c4[2]);
        kb.w = k4[3] * expn(me[3] - c4[3]);
        *reinterpret_cast<float4*>(RA + i * L::LDA + x) = ra;
        *reinterpret_cast<float4*>(KB + i * L::LDA + x) = kb;
      }
      const float* total = CUM + (P - 1) * L::LDA;
      for (int e = tid; e < nsc * HD; e += THREADS) {
        const int a = e / HD, x = e % HD;
        PM[e] = a ? expn(CUM[((a << lsc) - 1) * L::LDA + x]) : 1.f;
        Q[e] = expn(total[x] - CUM[(((a + 1) << lsc) - 1) * L::LDA + x]);
      }
      for (int x = tid; x < HD; x += THREADS) ETOT[x] = expn(total[x]);
      for (int e = tid; e < ng * HD; e += THREADS) {
        const int pair = e / HD, x = e % HD;
        int a = 2;                        // pairs (a, b), b <= a - 2
        while ((a - 1) * a / 2 <= pair) ++a;
        const int b = pair - (a - 2) * (a - 1) / 2;
        G[e] = expn(CUM[((a << lsc) - 1) * L::LDA + x] -
                    CUM[(((b + 1) << lsc) - 1) * L::LDA + x]);
      }
    }
    __syncthreads();
    // r, k and lw are spent: the next piece's tiles load under the products
    if (s0 + P < S) issue(s0 + P, vb ^ 1);

    // 3. the off-diagonal sub-blocks, 16 x 8 tiles of A below the
    // diagonal ones: A_ij = sum_x (ra_ix gap_x) kb_jx, k16 steps over x
    {
      int idx = 0;
      for (int mi = 0; mi < P / 16; ++mi) {
        const int i0 = mi * 16, a_top = (i0 + 15) >> lsc;
        const int ntiles = min(P / 8, (a_top << lsc) / 8);
        for (int nj = 0; nj < ntiles; ++nj, ++idx) {
          if (idx % NWARP != warp) continue;
          const int j0 = nj * 8, bj = j0 >> lsc;
          const int a_lo = (i0 + g) >> lsc, a_hi = (i0 + g + 8) >> lsc;
          const float* glo = a_lo >= bj + 2
              ? G + ((a_lo - 2) * (a_lo - 1) / 2 + bj) * HD : nullptr;
          const float* ghi = a_hi >= bj + 2
              ? G + ((a_hi - 2) * (a_hi - 1) / 2 + bj) * HD : nullptr;
          const float* ra_lo = RA + (i0 + g) * L::LDA + 2 * t;
          const float* ra_hi = ra_lo + 8 * L::LDA;
          const float* kb = KB + (j0 + g) * L::LDA + 2 * t;
          const float2 one = make_float2(1.f, 1.f);
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int x0 = 0; x0 < HD; x0 += 16) {
            const int x = x0 + 2 * t;
            const Pair a[4] = {
                split(mul2(ld2(ra_lo + x0), glo ? ld2(glo + x) : one)),
                split(mul2(ld2(ra_hi + x0), ghi ? ld2(ghi + x) : one)),
                split(mul2(ld2(ra_lo + x0 + 8), glo ? ld2(glo + x + 8) : one)),
                split(mul2(ld2(ra_hi + x0 + 8), ghi ? ld2(ghi + x + 8) : one))};
            const Pair b[2] = {split(ld2(kb + x0)), split(ld2(kb + x0 + 8))};
            mma3<false>(c, a, b);
          }
          if (a_lo > bj) {
            ATT[(i0 + g) * L::LDT + j0 + 2 * t] = c[0];
            ATT[(i0 + g) * L::LDT + j0 + 2 * t + 1] = c[1];
          }
          if (a_hi > bj) {
            ATT[(i0 + g + 8) * L::LDT + j0 + 2 * t] = c[2];
            ATT[(i0 + g + 8) * L::LDT + j0 + 2 * t + 1] = c[3];
          }
        }
      }
    }
    __syncthreads();

    // 4. O^T = T @ (ra exp(m_{a-1}))^T + V^T @ A^T, then the state
    float oc[PMAX / 8][4];
#pragma unroll
    for (int it = 0; it < PMAX / 8; ++it)
      oc[it][0] = oc[it][1] = oc[it][2] = oc[it][3] = 0.f;
    {
      const int nit = P / 8;
#pragma unroll
      for (int n = 0; n < NXT; n += 2) {
        // two of T's accumulator fragments (columns x0.. and x0 + 8..)
        // are one A fragment of a k16 step over x
        const int x = xw0 + n * 8 + 2 * t;
        const Pair a[4] = {split(st[n][0], st[n][1]),
                           split(st[n][2], st[n][3]),
                           split(st[n + 1][0], st[n + 1][1]),
                           split(st[n + 1][2], st[n + 1][3])};
#pragma unroll
        for (int it = 0; it < PMAX / 8; ++it) {
          if (it >= nit) break;
          const float* pm = PM + ((it * 8) >> lsc) * HD + x;
          const float* ra = RA + (it * 8 + g) * L::LDA + x;
          const Pair b[2] = {split(mul2(ld2(ra), ld2(pm))),
                             split(mul2(ld2(ra + 8), ld2(pm + 8)))};
          mma3<false>(oc[it], a, b);
        }
      }
#pragma unroll
      for (int n = 0; n < NXT; ++n) {
        const float2 e = ld2(ETOT + xw0 + n * 8 + 2 * t);
        st[n][0] *= e.x;
        st[n][1] *= e.y;
        st[n][2] *= e.x;
        st[n][3] *= e.y;
      }
#pragma unroll
      for (int s = 0; s < PMAX / 16; ++s) {
        if (s >= P / 16) break;
        const int j0 = s * 16, bj = j0 >> lsc;
        // A = V^T: rows d, k = j
        const T* vt = vs + (j0 + 2 * t) * L::LDV + d0 + g;
        const Pair a[4] = {vpair(vt, L::LDV), vpair(vt + 8, L::LDV),
                           vpair(vt + 8 * L::LDV, L::LDV),
                           vpair(vt + 8 * L::LDV + 8, L::LDV)};
        const float* q0 = Q + bj * HD;
        const float* q1 = Q + ((j0 + 8) >> lsc) * HD;
        const float* kb = KB + (j0 + 2 * t) * L::LDA;
#pragma unroll
        for (int n = 0; n < NXT; ++n) {
          const int x = xw0 + n * 8 + g;
          const Pair b[2] = {
              split(kb[x] * q0[x], kb[L::LDA + x] * q0[x]),
              split(kb[8 * L::LDA + x] * q1[x], kb[9 * L::LDA + x] * q1[x])};
          mma3<V_EXACT>(st[n], a, b);
        }
        if (s % KSPLIT == hh) {
#pragma unroll
          for (int it = 0; it < PMAX / 8; ++it) {
            if (it >= nit) break;
            if (((it * 8) >> lsc) < bj) continue;   // above the diagonal
            const float* ar = ATT + (it * 8 + g) * L::LDT + j0 + 2 * t;
            const Pair b[2] = {split(ld2(ar)), split(ld2(ar + 8))};
            mma3<V_EXACT>(oc[it], a, b);
          }
        }
      }
    }
    __syncthreads();
    // 5. the K-split partials summed in order, rows of o stored whole
#pragma unroll
    for (int it = 0; it < PMAX / 8; ++it) {
      if (it >= P / 8) break;
      float* o = OB + (hh * PMAX + it * 8 + 2 * t) * L::LDO + d0 + g;
      o[0] = oc[it][0];
      o[L::LDO] = oc[it][1];
      o[8] = oc[it][2];
      o[L::LDO + 8] = oc[it][3];
    }
    __syncthreads();
    for (int e = tid; e < P * HD / 4; e += THREADS) {
      const int i = e / (HD / 4), d = (e % (HD / 4)) * 4;
      float4 acc = *reinterpret_cast<const float4*>(OB + i * L::LDO + d);
#pragma unroll
      for (int p = 1; p < KSPLIT; ++p) {
        const float4 o = *reinterpret_cast<const float4*>(
            OB + (p * PMAX + i) * L::LDO + d);
        acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w;
      }
      *reinterpret_cast<float4*>(out + base + (s0 + i) * step + d) = acc;
    }
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* out, int B, int S, int H, int sc, int P,
           cudaStream_t stream) {
  static_assert(most_bytes<T, HD>() <= MAX_SMEM, "block past shared memory");
  const size_t smem = Layout<T, HD>::bytes(P / sc);
  auto kernel = wkv_mma_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), S, H, sc, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* out, int B, int S, int H, int hd,
                int sc, int P, cudaStream_t s) {
  if (hd == 64) return launch<T, 64>(r, k, v, lw, u, out, B, S, H, sc, P, s);
  if constexpr (sizeof(T) == 2)      // fp32 at hd 128 takes the simt route
    if (hd == 128)
      return launch<T, 128>(r, k, v, lw, u, out, B, S, H, sc, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wkvmma

// The mma route: r, k, v, lw, u, out as for repro_wkv, every pointer
// 16-byte aligned; hd 64 or 128 (64 for fp32); sub-chunks of sc rows (8
// to 64, a multiple of 8) inside pieces of `piece` rows (16, 32 or 64; sc
// divides it, it divides S) (kernels/wkv/wkv.py::wkv_route).  Returns a
// cudaError_t.
extern "C" int repro_wkv_mma(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, void* out, int B,
                             int S, int H, int hd, int sc, int piece,
                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0) return 0;
  if ((piece != 16 && piece != 32 && piece != 64) || S % piece ||
      sc < 8 || sc % 8 || piece % sc)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return wkvmma::dispatch_hd<__nv_bfloat16>(r, k, v, lw, u, out, B, S, H,
                                              hd, sc, piece, s);
  if (dtype == DTYPE_F32)
    return wkvmma::dispatch_hd<float>(r, k, v, lw, u, out, B, S, H, hd, sc,
                                      piece, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
