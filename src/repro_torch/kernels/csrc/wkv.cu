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
// (batch, head, block of at most 64 value columns) and loops over the
// chunks inside, with its columns of the fp32 state in shared memory the
// whole time.  Output column d and state column d depend on no other
// value column, so the column blocks are independent; each recomputes the
// chunk's (c, c) key-side matrix, which repeats work and changes nothing.
// The key side (r, k and the cumsum of lw, c x hd each) is staged in
// pieces of 64 channels: every term sums over channels, so the attention
// matrix and the inter-chunk output accumulate piece by piece, and a
// piece's rows of the state are updated once its inter-chunk term is
// taken.  A chunk longer than 64 rows is walked in pieces of 64 rows, the
// state carried from one piece to the next as from one chunk to the next
// (the same sums; the one difference is that the reference clamps a
// weight below e^-60 to e^-60 within a chunk).  So shared memory is
// bounded whatever the chunk and head width: at rwkv6-7b's c = hd = 64
// one piece of 64 rows, 64 channels and 64 columns, 100 KB, two blocks an
// SM, B x H = 256 blocks in one wave, as before the split.  Tiles are
// rows padded to width + 1 floats against bank conflicts.  Every exponent
// stays <= 0: the intra-chunk weight is one exponential of
// (ecum_i - cum_j), clamped at -60 as wkv.py:83 does, and never
// exp(ecum_i) * exp(-cum_j), whose second factor overflows under strong
// decay.  The bonus sits on the attention matrix's diagonal.
#include "common.cuh"

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
