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
// The design.  Every element (i, j) of S and of G is a scalar recurrence
// of its own: S_t[i, j] reads only w_t[i], k_t[i] and v_t[j].  The sums
// over columns j (dr, dk, dlw) and over rows i (dv) are what couples them.
// So one warp owns one row i of one (batch, head), its 32 lanes the
// columns lane + 32 jj (hd / 32 of them a lane), and a row's sums over j
// are warp shuffles; dv, a sum over rows, is computed by the transposed
// mapping in blocks of their own (one warp a column j, lanes over the rows
// i, G only: dv needs no S).  One launch holds both kinds of block
// (blockIdx.y: 0 rows, 1 columns), 8 warps a block, hd / 8 blocks of each
// kind a (batch, head): 2,048 blocks at rwkv6-7b's training shape (B 2,
// H 64, hd 64).
//
// The row blocks sweep forward, computing dr and storing each row's
// state at every segment start (every SEG = 64 steps) in a scratch, and
// then backward, carrying G: for each segment, last first, they replay
// the state from its stored start, keeping it at each sub-segment start
// (every SUB = 8 steps) in registers, and for each sub-segment, last
// first, replay its 8 states S_{t-1} into registers and walk them
// backward.  Registers a lane: the 8 sub-segment states and the 8 states
// of one sub-segment, hd / 32 columns each (32 floats at hd 64).  Each
// segment's inputs are staged in shared memory as fp32 (w = exp(lw) once
// a step; steps past S staged as w = 1 and zero r, k, v, do, which change
// nothing, so S need not be a multiple of SEG).  du is summed per (batch,
// head) in the row blocks and over the batch in order by a second small
// kernel.  No atomics: every sum has a fixed order and a rerun is
// bit-equal.
//
// What bounds it on the H100.  The function reads r, k, v, lw, do once
// and writes dr, dk, dv, dlw once (120 MB at the training shape in bf16:
// 36 us at 3.35 TB/s) and needs about 10 hd^2 operations a step and
// (batch, head) (2.8 G at that shape; chip_smoke.py's wkv_bwd_ops).  This
// kernel, which also takes the hd^2 rowsum for dlw, is far from both: it
// walks the S steps of every row one after another, two shuffle sums a
// step in each direction, so it is bound by the latency of that chain
// (the 2,048 blocks keep several warps an SM scheduler in flight to hide
// it).  The chunked form on the tensor cores, as B8's forward, is the
// redesign (ROADMAP Queue 2).
#include "common.cuh"

namespace wkvbwd {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SEG = 64;    // steps between stored states
constexpr int SUB = 8;     // steps replayed into registers at a time
constexpr int NSUB = SEG / SUB;

// floats of shared memory: row blocks stage v and do for every column
// (SEG x hd each) and w, k, r, two outputs for their 8 rows, and v . do a
// step; column blocks stage w, r, k for every row, do and dv for their 8
// columns, r . (u * k) a step and u
template <int HD>
constexpr int row_floats() { return 2 * SEG * HD + 5 * SEG * WARPS + SEG; }
template <int HD>
constexpr int col_floats() {
  return 3 * SEG * HD + 2 * SEG * WARPS + SEG + HD;
}
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (row_floats<HD>() > col_floats<HD>() ? row_floats<HD>()
                                              : col_floats<HD>());
}

// one step of the state: w s + k v, written once for the sweep and both
// replays so that all three compute the same bits
__device__ __forceinline__ float advance(float w, float s, float k, float v) {
  return fmaf(w, s, k * v);
}

struct Geometry {
  long long base;   // element (b, 0, h, 0)
  long long step;   // one time step: H * hd
  int S, nseg;
};

__device__ __forceinline__ Geometry geometry(int bh, int S, int H, int hd) {
  Geometry g;
  const int b = bh / H, h = bh % H;
  g.base = (static_cast<long long>(b) * S * H + h) * hd;
  g.step = static_cast<long long>(H) * hd;
  g.S = S;
  g.nseg = (S + SEG - 1) / SEG;
  return g;
}

// out[t, lo + q] = buf[t][q] for the steps of the segment inside S
__device__ __forceinline__ void write_block(float* __restrict__ out,
                                            const float* buf,
                                            const Geometry& g, int t0,
                                            int lo) {
  for (int e = threadIdx.x; e < SEG * WARPS; e += THREADS) {
    const int t = e / WARPS, q = e % WARPS;
    if (t0 + t < g.S) out[g.base + (t0 + t) * g.step + lo + q] = buf[e];
  }
}

// the row blocks: warp w owns row i = row0 + w; lane owns the columns
// lane + 32 jj
template <typename T, int HD>
__device__ void rows(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ dout, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dlw,
                     float* __restrict__ states, float* __restrict__ du_part,
                     int S, int H, int bh, int row0, float* smem) {
  constexpr int JB = HD / 32;
  float* vs = smem;                 // [SEG][HD]
  float* ds = vs + SEG * HD;        // [SEG][HD] do
  float* ws = ds + SEG * HD;        // [SEG][WARPS] exp(lw)
  float* ks = ws + SEG * WARPS;     // [SEG][WARPS]
  float* rs = ks + SEG * WARPS;     // [SEG][WARPS]
  float* o1 = rs + SEG * WARPS;     // [SEG][WARPS] dr, then dk
  float* o2 = o1 + SEG * WARPS;     // [SEG][WARPS] dlw
  float* vdo = o2 + SEG * WARPS;    // [SEG] v_t . do_t
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = row0 + warp;
  const Geometry g = geometry(bh, S, H, HD);
  const float ui = u[(bh % H) * HD + i];
  // this row's stored states, one row of hd floats a segment
  float* mine = states + static_cast<long long>(bh) * g.nseg * HD * HD +
                static_cast<long long>(i) * HD;

  auto stage = [&](int t0) {
    for (int e = tid; e < SEG * HD; e += THREADS) {
      const int t = e / HD, x = e % HD;
      const bool in = t0 + t < S;
      const long long at = g.base + (t0 + t) * g.step + x;
      vs[e] = in ? to_f32(v[at]) : 0.f;
      ds[e] = in ? dout[at] : 0.f;
    }
    for (int e = tid; e < SEG * WARPS; e += THREADS) {
      const int t = e / WARPS, q = e % WARPS;
      const bool in = t0 + t < S;
      const long long at = g.base + (t0 + t) * g.step + row0 + q;
      ws[e] = in ? expf(lw[at]) : 1.f;
      ks[e] = in ? to_f32(k[at]) : 0.f;
      rs[e] = in ? to_f32(r[at]) : 0.f;
    }
    __syncthreads();
    for (int t = warp; t < SEG; t += WARPS) {
      float p = 0.f;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        p = fmaf(vs[t * HD + lane + 32 * jj], ds[t * HD + lane + 32 * jj], p);
      p = warp_sum(p);
      if (lane == 0) vdo[t] = p;
    }
    __syncthreads();
  };

  // forward sweep: dr, and the state at every segment start
  float st[JB];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) st[jj] = 0.f;
  for (int seg = 0; seg < g.nseg; ++seg) {
    const int t0 = seg * SEG;
    stage(t0);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      mine[static_cast<long long>(seg) * HD * HD + lane + 32 * jj] = st[jj];
#pragma unroll 4
    for (int t = 0; t < SEG; ++t) {
      const float w = ws[t * WARPS + warp], kk = ks[t * WARPS + warp];
      float p = 0.f;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int x = t * HD + lane + 32 * jj;
        p = fmaf(st[jj], ds[x], p);
        st[jj] = advance(w, st[jj], kk, vs[x]);
      }
      p = warp_sum(p);
      if (lane == 0) o1[t * WARPS + warp] = fmaf(ui * kk, vdo[t], p);
    }
    __syncthreads();
    write_block(dr, o1, g, t0, row0);
  }

  // backward sweep: G from zero, dk and dlw, du
  float gr[JB];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) gr[jj] = 0.f;
  float du_acc = 0.f;
  for (int seg = g.nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG;
    stage(t0);
    float sub[NSUB][JB];      // the state before each sub-segment
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      st[jj] = mine[static_cast<long long>(seg) * HD * HD + lane + 32 * jj];
#pragma unroll
    for (int q = 0; q < NSUB; ++q) {
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) sub[q][jj] = st[jj];
      if (q + 1 < NSUB) {
#pragma unroll
        for (int e = 0; e < SUB; ++e) {
          const int t = q * SUB + e;
          const float w = ws[t * WARPS + warp], kk = ks[t * WARPS + warp];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
            st[jj] = advance(w, st[jj], kk, vs[t * HD + lane + 32 * jj]);
        }
      }
    }
#pragma unroll
    for (int q = NSUB - 1; q >= 0; --q) {
      float sp[SUB][JB];      // S_{t-1} for the sub-segment's steps
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) sp[0][jj] = sub[q][jj];
#pragma unroll
      for (int e = 0; e + 1 < SUB; ++e) {
        const int t = q * SUB + e;
        const float w = ws[t * WARPS + warp], kk = ks[t * WARPS + warp];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
          sp[e + 1][jj] = advance(w, sp[e][jj], kk,
                                  vs[t * HD + lane + 32 * jj]);
      }
#pragma unroll
      for (int e = SUB - 1; e >= 0; --e) {
        const int t = q * SUB + e;
        const float w = ws[t * WARPS + warp], kk = ks[t * WARPS + warp];
        const float rr = rs[t * WARPS + warp];
        float pk = 0.f, pw = 0.f;
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int x = t * HD + lane + 32 * jj;
          pk = fmaf(gr[jj], vs[x], pk);
          pw = fmaf(gr[jj], sp[e][jj], pw);
          gr[jj] = fmaf(w, gr[jj], rr * ds[x]);
        }
        pk = warp_sum(pk);
        pw = warp_sum(pw);
        const float bonus = vdo[t];
        du_acc = fmaf(rr * kk, bonus, du_acc);
        if (lane == 0) {
          o1[t * WARPS + warp] = fmaf(ui * rr, bonus, pk);
          o2[t * WARPS + warp] = w * pw;
        }
      }
    }
    __syncthreads();
    write_block(dk, o1, g, t0, row0);
    write_block(dlw, o2, g, t0, row0);
  }
  if (lane == 0) du_part[static_cast<long long>(bh) * HD + i] = du_acc;
}

// the column blocks: warp w owns column j = col0 + w; lane owns the rows
// lane + 32 ii; G only, swept backward
template <typename T, int HD>
__device__ void cols(const T* __restrict__ r, const T* __restrict__ k,
                     const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ dout, float* __restrict__ dv,
                     int S, int H, int bh, int col0, float* smem) {
  constexpr int IB = HD / 32;
  float* ws = smem;                 // [SEG][HD] exp(lw)
  float* rs = ws + SEG * HD;        // [SEG][HD]
  float* ks = rs + SEG * HD;        // [SEG][HD]
  float* ds = ks + SEG * HD;        // [SEG][WARPS] do
  float* o1 = ds + SEG * WARPS;     // [SEG][WARPS] dv
  float* rk = o1 + SEG * WARPS;     // [SEG] r_t . (u * k_t)
  float* us = rk + SEG;             // [HD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Geometry g = geometry(bh, S, H, HD);
  for (int x = tid; x < HD; x += THREADS) us[x] = u[(bh % H) * HD + x];

  float gc[IB];
#pragma unroll
  for (int ii = 0; ii < IB; ++ii) gc[ii] = 0.f;
  for (int seg = g.nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG;
    for (int e = tid; e < SEG * HD; e += THREADS) {
      const int t = e / HD, x = e % HD;
      const bool in = t0 + t < S;
      const long long at = g.base + (t0 + t) * g.step + x;
      ws[e] = in ? expf(lw[at]) : 1.f;
      rs[e] = in ? to_f32(r[at]) : 0.f;
      ks[e] = in ? to_f32(k[at]) : 0.f;
    }
    for (int e = tid; e < SEG * WARPS; e += THREADS) {
      const int t = e / WARPS, q = e % WARPS;
      ds[e] = t0 + t < S ? dout[g.base + (t0 + t) * g.step + col0 + q] : 0.f;
    }
    __syncthreads();
    for (int t = warp; t < SEG; t += WARPS) {
      float p = 0.f;
#pragma unroll
      for (int ii = 0; ii < IB; ++ii) {
        const int x = lane + 32 * ii;
        p = fmaf(rs[t * HD + x], us[x] * ks[t * HD + x], p);
      }
      p = warp_sum(p);
      if (lane == 0) rk[t] = p;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = SEG - 1; t >= 0; --t) {
      const float dj = ds[t * WARPS + warp];
      float p = 0.f;
#pragma unroll
      for (int ii = 0; ii < IB; ++ii) {
        const int x = t * HD + lane + 32 * ii;
        p = fmaf(gc[ii], ks[x], p);
        gc[ii] = fmaf(ws[x], gc[ii], rs[x] * dj);
      }
      p = warp_sum(p);
      if (lane == 0) o1[t * WARPS + warp] = fmaf(rk[t], dj, p);
    }
    __syncthreads();
    write_block(dv, o1, g, t0, col0);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ dout,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dlw,
               float* __restrict__ states, float* __restrict__ du_part,
               int S, int H) {
  extern __shared__ float smem[];
  constexpr int PARTS = HD / WARPS;
  const int bh = blockIdx.x / PARTS, lo = (blockIdx.x % PARTS) * WARPS;
  if (blockIdx.y == 0)
    rows<T, HD>(r, k, v, lw, u, dout, dr, dk, dlw, states, du_part, S, H,
                bh, lo, smem);
  else
    cols<T, HD>(r, k, lw, u, dout, dv, S, H, bh, lo, smem);
}

// du[h, i] = sum over b, in order, of the row blocks' per-(b, h) sums
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    acc += du_part[static_cast<long long>(b) * n + e];
  du[e] = acc;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dout, void* dr, void* dk, void* dv,
           void* dlw, void* du, void* scratch, int B, int S, int H,
           cudaStream_t stream) {
  static_assert(HD % 32 == 0 && HD % WARPS == 0, "lanes split hd evenly");
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "block past shared memory");
  auto kernel = wkv_bwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nseg = (S + SEG - 1) / SEG;
  float* states = static_cast<float*>(scratch);
  float* du_part = states + static_cast<long long>(B) * H * nseg * HD * HD;
  const dim3 grid(B * H * (HD / WARPS), 2);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(dout),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dlw), states, du_part, S,
      H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * HD;
  wkv_bwd_du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      du_part, static_cast<float*>(du), B, n);
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
// scratch of B H (ceil(S / 64) hd^2 + hd) floats
// (kernels/wkv/wkv.py::wkv_bwd_scratch_floats); hd 32, 64 or 128.  All
// contiguous.  Returns a cudaError_t.
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
