// Ragged one-token decode attention over a paged KV cache: the port of the
// TPU kernel src/repro/kernels/attention/decode.py::decode_attention_pallas
// (_decode_kernel, B2), and of its quantized branch (decode.py:62-72, B4a)
// as the same kernel instantiated on int8 pools.
//
// What bounds it on the H100.  Each slot's query attends over its own
// history: per live key the kernel reads one K row and one V row of hd
// elements and does 4 x grp x hd operations (grp query heads share a kv
// head).  That is grp operations per byte in bf16 (8 for gemma-2b) and
// 2 x grp in int8 (16), both under the card's fp32 FMA ridge of
// 67e12 / 3.35e12 = 20 operations per byte: the work is bound by bytes, and
// CUDA cores suffice if the loads are wide and enough of them are in
// flight.  At the serving shapes (4 slots, lengths <= 256) the call moves
// well under a megabyte and is bound by latency; at gemma-2b's 8192-token
// context one slot reads 8 MiB of bf16 K/V a layer.
//
// What this design does about it.
// - The key range of each slot is split across blocks: split r covers the
//   positions [r * S, (r + 1) * S) of the table, S a multiple of the page
//   size (attention/decode.py::decode_split_plan, from the shapes alone:
//   about 64 blocks a slot, splits x kv heads: 64 keys on gemma-2b's
//   256-key serving table, 128 at 8192 keys, 1024 there with 8 kv heads
//   or more).  The
//   grid is splits x (B * Hkv), flattened, split fastest.  A split with no
//   live key (past the length, or wholly behind the window) writes an empty
//   partial and exits.
// - A block reads the length, its query rows and its keys' page ids at
//   once, then resolves each live key's row offset into shared memory; a
//   page id outside the pool traps.
// - Each warp takes its own keys, U a step, a lane group of L lanes a key
//   (L = 32 for a row of 32 or more pieces): a lane copies 16-byte pieces
//   of the K and V rows (8 bytes for int8) into its own slots of a
//   shared-memory ring with cp.async, up to 8 steps ahead, and reads back
//   only what it copied.  The grp query rows and the fp32 accumulator stay
//   in registers.  A key's grp scores are shuffle sums over the lane group,
//   reduced transposed: at each of the first log2 G levels a lane keeps
//   half its sums and sends the other half, so the G sums cost G - 1
//   shuffles there and each lane ends with one head's score.  That lane
//   runs the head's fp32 online softmax (base 2, branch-free), and the
//   heads' P and rescale factors reach every lane through shared memory.
//   P is rounded to V's dtype before P @ V, as the TPU kernel casts it.
// - int8 pools: each key's (page, kv head) scales ride in the ring beside
//   its pieces; k_scale multiplies the score and v_scale the key's P (kept
//   in fp32), never an element.
// - The lane groups of a block merge through shared memory once, at the
//   end, in a fixed order, one warp a query head; the splits of a slot and
//   kv head merge in rank order in decode_combine_kernel.  No atomics: a
//   rerun gives the same bits, and a slot's bits do not depend on the other
//   slots of its batch.  A slot with no live key writes exact zeros.
// - Asked for it (lse not null), the combine kernel also writes each row's
//   log-sum-exp from the merged m and l it holds (-inf for no live key):
//   what merges the ranks' blocks of a cache striped over a model axis.
// - Rows whose width is not a multiple of a piece, or pools not aligned to
//   one, load element by element in the same kernel (VEC = 1); wider heads
//   (up to 1024) hold more columns a lane and fewer query heads a pass.
//   The split kernel is built five times a (q, pool) type pair: three
//   head groups G for whole pieces of rows up to 256 wide, and 32 columns
//   by 2 heads for wider rows and for rows loaded element by element.
//
// What holds it back (PERF.md, the B2 row): at gemma-2b's heads the FMAs a
// key needs (2 x grp x hd) and the sums and softmax around them keep the
// walk bound by instruction issue with one block of 8 warps an SM, so the
// 8192-token rows read 4.5x their byte bound (10x with int8 pools, whose
// bytes halve but whose work does not); codeqwen1.5-7b's heads (grp 1)
// read 1.4x.
#include <climits>
#include <type_traits>

#include "matmul_sm90.cuh"

namespace {

constexpr int NW = 8;  // warps a block
constexpr int THREADS = 32 * NW;
// the combine kernel: 32 columns of a query head by 8 ranks of splits
constexpr int COMBINE_COLS = 32, COMBINE_RANKS = 8;
constexpr int COMBINE_THREADS = COMBINE_COLS * COMBINE_RANKS;
// the cp.async ring a block aims for: 2 to 8 steps ahead
constexpr int RING_BYTES = 64 * 1024;
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  float* out;
  // (B, H) fp32 log-sum-exp of each row's scaled scores, or null
  float* lse;
  // acc (B * Hkv, splits, grp, hd), then (m, l) (B * Hkv, splits, grp,
  // 2), fp32; m in base 2
  float* part;
  int B, H, Hkv, hd, page, n_pages, n_pool, window, split_keys, splits;
  int lanes;  // L: lanes a key (a power of two <= 32)
};

// a piece of VEC elements, as a lane copies it: 16 bytes of a float row,
// 8 of an int8 row, or one element
template <typename T, int VEC>
__device__ __forceinline__ void copy_piece(void* dst, const T* src) {
  constexpr int BYTES = VEC * sizeof(T);
  if constexpr (BYTES == 16)
    sm90::cp_async16(dst, src, 16);
  else if constexpr (BYTES == 8)
    sm90::cp_async8(dst, src);
  else
    *static_cast<T*>(dst) = *src;
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const void* src, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(*static_cast<const T*>(src));
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint4 r = *static_cast<const uint4*>(src);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    const float4 r = *static_cast<const float4*>(src);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  } else {
    const uint2 r = *static_cast<const uint2*>(src);
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
}

// bytes of one warp's ring slot: U keys' K and V pieces, and for int8
// pools each key's two scales (a lane copies the ones it needs)
template <typename TKV, int W, int U>
__host__ __device__ constexpr int slot_bytes() {
  return U * 2 * W * 32 * static_cast<int>(sizeof(TKV)) +
         (std::is_same_v<TKV, int8_t> ? U * 2 * 32 * 4 : 0);
}

// G floats from shared memory, 16 bytes at a time where G allows
template <int G>
__device__ __forceinline__ void read_row(const float* src, float (&dst)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int g = 0; g < G; g += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + g);
      dst[g] = v.x;
      dst[g + 1] = v.y;
      dst[g + 2] = v.z;
      dst[g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) dst[g] = src[g];
  }
}

template <typename TKV, int W, int U>
__host__ __device__ constexpr int ring_stages() {
  const int ns = RING_BYTES / (NW * slot_bytes<TKV, W, U>());
  return ns < 2 ? 2 : (ns > 8 ? 8 : ns);
}

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
// shared memory: each key of the split's row offset and scale cell; each
// warp's two buffers of P and the rescale factors, (m, l) of the block's
// lane groups and their merge factors; then the ring, which becomes the
// lane groups' accumulators once the walk is done
__host__ __device__ inline size_t keys_bytes(int split_keys) {
  return round16(12 * static_cast<size_t>(split_keys));
}
__host__ __device__ inline size_t head_bytes(int split_keys, int kw, int G,
                                             int U) {
  const size_t floats = 3 * static_cast<size_t>(NW) * kw * G + 2 * G +
                        2 * static_cast<size_t>(NW) * kw * (U + 1) * G;
  return keys_bytes(split_keys) + round16(sizeof(float) * floats);
}

template <typename TQ, typename TKV, int VEC, int G, int W, int U>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const Args a) {
  constexpr int VB = VEC * sizeof(TKV);  // bytes a piece
  static_assert((G & (G - 1)) == 0, "G is a power of two");
  constexpr int NCV = W / VEC;  // pieces a lane holds of one row
  constexpr int SLOT = slot_bytes<TKV, W, U>();
  constexpr int NS = ring_stages<TKV, W, U>();
  constexpr int PIECES = U * 2 * NCV * 32 * VB;  // scales follow (int8)
  constexpr bool INT8 = std::is_same_v<TKV, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x / a.splits, r = blockIdx.x % a.splits;
  const int b = bh / a.Hkv, h = bh % a.Hkv, grp = a.H / a.Hkv, hd = a.hd;
  const int L = a.lanes, KW = 32 / L, P = NW * KW;  // L >= G
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int jl = lane % L, kk = lane / L;
  const int nvec = hd / VEC;
  const long long row0 = static_cast<long long>(bh) * grp;  // b*H + h*grp
  const long long part0 = (static_cast<long long>(bh) * a.splits + r) * grp;
  const long long ml_off =
      static_cast<long long>(a.B) * a.Hkv * a.splits * grp * hd;
  const TQ* qp = static_cast<const TQ*>(a.q);
  float q[G][W], acc[G][W];
  auto load_q = [&](int g0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < NCV; ++c) {
        const int vi = c * L + jl;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          q[g][c * VEC + e] =
              g0 + g < grp && vi < nvec
                  ? to_f32(qp[(row0 + g0 + g) * hd + vi * VEC + e])
                  : 0.f;
      }
  };
  // the length, the first query heads and the page ids of the split's
  // keys are read together, before anything waits on one of them
  const int sk = a.split_keys;
  const int len_in = a.lengths[b];
  auto page_of = [&](int i) { return (r * sk + i) / a.page; };
  const int pid0 = static_cast<int>(threadIdx.x) < sk &&
                           page_of(threadIdx.x) < a.n_pages
                       ? a.table[static_cast<long long>(b) * a.n_pages +
                                 page_of(threadIdx.x)]
                       : 0;
  load_q(0);
  // live keys [lo, length); a window keeps only the newest `window`; keys
  // past the table's last page do not exist (as in the plain version)
  const int length = max(0, min(len_in, a.n_pages * a.page));
  const int lo = a.window > 0 ? max(0, len_in - a.window) : 0;
  const int base = r * sk;
  const int kb = max(base, lo), ke = min(base + sk, length);
  if (kb >= ke) {
    for (int g = threadIdx.x; g < grp; g += THREADS) {
      a.part[ml_off + (part0 + g) * 2] = NEG_BIG;
      a.part[ml_off + (part0 + g) * 2 + 1] = 0.f;
    }
    return;
  }

  long long* off_s = reinterpret_cast<long long*>(smem);  // split_keys
  int* cell_s = reinterpret_cast<int*>(off_s + sk);       // split_keys
  // NW x 2 x KW x (U + 1) x G
  float* bc_s = reinterpret_cast<float*>(smem + keys_bytes(sk));
  float* ml_s = bc_s + NW * 2 * KW * (U + 1) * G;   // P x G x (m, l)
  float* fl_s = ml_s + 2 * P * G;  // P x G factors, then G maxima, G sums
  unsigned char* ring = smem + head_bytes(sk, KW, G, U);
  // P x G x W x L, at the end: lane jl's W columns of each lane group
  float* acc_s = reinterpret_cast<float*>(ring);

  for (int i = threadIdx.x; i < sk; i += THREADS) {
    const int kpos = base + i;
    if (kpos < kb || kpos >= ke) continue;
    const long long pid =
        i == static_cast<int>(threadIdx.x)
            ? pid0
            : a.table[static_cast<long long>(b) * a.n_pages + page_of(i)];
    if (pid < 0 || pid >= a.n_pool) __trap();  // a page id outside the pool
    off_s[i] = ((pid * a.page + kpos % a.page) * a.Hkv + h) *
               static_cast<long long>(hd);
    cell_s[i] = static_cast<int>(pid * a.Hkv + h);
  }
  __syncthreads();

  const TKV* kp = static_cast<const TKV*>(a.k_pages);
  const TKV* vp = static_cast<const TKV*>(a.v_pages);
  const float scale = LOG2E / sqrtf(static_cast<float>(hd));
  const int per_step = NW * U * KW;
  const int nsteps = (ke - kb + per_step - 1) / per_step;
  // the query head whose score this lane ends up holding after the
  // transposed reduction, and whether it is the first lane holding it
  int g_lane = 0;
#pragma unroll
  for (int n = G; n > 1; n >>= 1)
    if (jl & (L * n / (2 * G))) g_lane += n / 2;
  const bool g_first = (jl & (L / G - 1)) == 0;
  // this lane group's key u of step j
  auto key_of = [&](int j, int u) {
    return kb + ((j * NW + w) * U + u) * KW + kk;
  };
  auto slot_of = [&](int slot) {
    return ring + static_cast<size_t>(w * NS + slot) * SLOT;
  };
  auto piece = [&](int slot, int u, int kv, int c) {
    return slot_of(slot) + (((u * 2 + kv) * NCV + c) * 32 + lane) * VB;
  };
  auto scale_at = [&](int slot, int u, int kv) {
    return reinterpret_cast<float*>(slot_of(slot) + PIECES) +
           (u * 2 + kv) * 32 + lane;
  };
  auto issue = [&](int j) {
    if (j < nsteps) {
      const int slot = j % NS;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kpos = key_of(j, u);
        if (kpos < ke) {
          const long long off = off_s[kpos - base];
#pragma unroll
          for (int c = 0; c < NCV; ++c) {
            const int vi = c * L + jl;
            if (vi < nvec) {
              copy_piece<TKV, VEC>(piece(slot, u, 0, c), kp + off + vi * VEC);
              copy_piece<TKV, VEC>(piece(slot, u, 1, c), vp + off + vi * VEC);
            }
          }
          if constexpr (INT8) {
            const int cell = cell_s[kpos - base];
            sm90::cp_async4(scale_at(slot, u, 0), a.k_scale + cell, 4);
            sm90::cp_async4(scale_at(slot, u, 1), a.v_scale + cell, 4);
          }
        }
      }
    }
    sm90::cp_async_commit();
  };

  for (int g0 = 0; g0 < grp; g0 += G) {
    const int ng = min(G, grp - g0);
    if (g0 > 0) load_q(g0);
    // the lane's softmax state, for query head g0 + g_lane
    float m = NEG_BIG, l = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < W; ++i) acc[g][i] = 0.f;

    for (int j = 0; j < NS - 1; ++j) issue(j);
    for (int j = 0; j < nsteps; ++j) {
      issue(j + NS - 1);
      sm90::cp_async_wait<NS - 1>();
      const int slot = j % NS;
      bool live[U];
      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        live[u] = key_of(j, u) < ke;
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] = 0.f;
      }
      // scores: each lane's pieces, then a sum over the lane group
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NCV; ++c) {
          if (c * L + jl < nvec) {
            float f[VEC];
            unpack<TKV, VEC>(piece(slot, u, 0, c), f);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[u][g] = fmaf(q[g][c * VEC + e], f[e], s[u][g]);
          }
        }
      }
      // transposed reduction: at each of the first log2 G levels a lane
      // keeps half its sums and sends the other half, so the G sums of a
      // key cost G - 1 shuffles there instead of G each; then plain levels.
      // s[u][0] ends as key u's score for query head g_lane.
#pragma unroll
      for (int n = G; n > 1; n >>= 1) {
        const int o = L * n / (2 * G);
        const bool upper = jl & o;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < n / 2; ++i) {
            const float send = upper ? s[u][i] : s[u][i + n / 2];
            const float keep = upper ? s[u][i + n / 2] : s[u][i];
            s[u][i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
      }
      for (int o = L / (2 * G); o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u][0] += __shfl_xor_sync(0xffffffffu, s[u][0], o);
      // online softmax of this lane's query head, in base 2 (the scale
      // carries log2 e); int8 pools fold k_scale into the score and
      // v_scale into the key's P, which stays fp32
      float pv[U], mx = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float ks = 1.f;
        if constexpr (INT8) ks = *scale_at(slot, u, 0);
        s[u][0] *= scale * ks;
        if (live[u]) mx = fmaxf(mx, s[u][0]);
      }
      const float alpha = exp2f(m - mx);  // 1 while the max holds
      m = mx;
      l *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = live[u] ? exp2f(s[u][0] - mx) : 0.f;
        l += p;
        float vs = 1.f;
        if constexpr (INT8) vs = *scale_at(slot, u, 1);
        pv[u] = round_via<TKV>(p) * vs;
      }
      // every lane needs every head's P and rescale: through shared memory
      float pg[U][G], ag[G];
      if constexpr (G == 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) pg[u][0] = pv[u];
        ag[0] = alpha;
      } else {
        float* bc = bc_s + ((w * 2 + (j & 1)) * KW + kk) * (U + 1) * G;
        if (g_first) {
#pragma unroll
          for (int u = 0; u < U; ++u) bc[u * G + g_lane] = pv[u];
          bc[U * G + g_lane] = alpha;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < U; ++u) read_row<G>(bc + u * G, pg[u]);
        read_row<G>(bc + U * G, ag);
      }
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < W; ++i) acc[g][i] *= ag[g];
      }
      // acc += P @ V
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (live[u]) {
#pragma unroll
          for (int c = 0; c < NCV; ++c) {
            if (c * L + jl < nvec) {
              float f[VEC];
              unpack<TKV, VEC>(piece(slot, u, 1, c), f);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc[g][c * VEC + e] =
                      fmaf(pg[u][g], f[e], acc[g][c * VEC + e]);
            }
          }
        }
      }
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // merge the block's lane groups in a fixed order: per query head the
    // block's max, each lane group's factor and the sum of l (fl_s); then
    // every lane group stores its scaled accumulator (acc_s), and one warp
    // a query head adds them, group by group, and writes the result
    const int pi = w * KW + kk;
    if (g_first) {
      ml_s[(pi * G + g_lane) * 2] = m;
      ml_s[(pi * G + g_lane) * 2 + 1] = l;
    }
    __syncthreads();
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      float mb = NEG_BIG, lsum = 0.f;
      for (int p = 0; p < P; ++p) mb = fmaxf(mb, ml_s[(p * G + g) * 2]);
      for (int p = 0; p < P; ++p) {
        const float f = exp2f(ml_s[(p * G + g) * 2] - mb);
        fl_s[p * G + g] = f;
        lsum += ml_s[(p * G + g) * 2 + 1] * f;
      }
      fl_s[P * G + g] = mb;
      fl_s[(P + 1) * G + g] = lsum;
    }
    __syncthreads();
    float fg[G];
    read_row<G>(fl_s + pi * G, fg);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < W; ++i)
        acc_s[((pi * G + g) * W + i) * L + jl] = acc[g][i] * fg[g];
    __syncthreads();
    // query head g is summed and written by warp g % NW, whose first lane
    // group holds the same columns as every lane group
    for (int g = w; g < ng; g += NW) {
      if (kk == 0) {
        float sum[W];
#pragma unroll
        for (int i = 0; i < W; ++i) sum[i] = 0.f;
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < W; ++i)
            sum[i] += acc_s[((p * G + g) * W + i) * L + jl];
        const long long row = part0 + g0 + g;
#pragma unroll
        for (int c = 0; c < NCV; ++c) {
          const int vi = c * L + jl;
          if (vi < nvec) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              a.part[row * hd + vi * VEC + e] = sum[c * VEC + e];
          }
        }
        if (jl == 0) {
          a.part[ml_off + row * 2] = fl_s[P * G + g];
          a.part[ml_off + row * 2 + 1] = fl_s[(P + 1) * G + g];
        }
      }
    }
    __syncthreads();  // the next group of query heads reuses the ring
  }
}

// out[b, h*grp + g, d]: the splits of each (slot, kv head) merged in a
// fixed order.  A block takes COMBINE_COLS columns of one query head; its
// COMBINE_RANKS rows of threads take the splits r = row (mod
// COMBINE_RANKS) in rank order, and their sums are added row by row.
// With lse, column 0's thread also writes the row's natural log-sum-exp,
// m ln 2 + ln l (m in base 2), or -inf for a row with no live key.
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      float* __restrict__ lse, int n_bh, int grp, int hd,
                      int splits) {
  __shared__ float red[3][COMBINE_RANKS][COMBINE_COLS];
  const int chunks = (hd + COMBINE_COLS - 1) / COMBINE_COLS;
  const int bh = blockIdx.x / (grp * chunks);
  const int g = blockIdx.x / chunks % grp;
  const int col = threadIdx.x % COMBINE_COLS, rank = threadIdx.x / COMBINE_COLS;
  const int d = blockIdx.x % chunks * COMBINE_COLS + col;
  const long long row = static_cast<long long>(bh) * splits * grp + g;
  const float* ml = part + static_cast<long long>(n_bh) * splits * grp * hd +
                    row * 2;
  const float* acc = part + row * hd + min(d, hd - 1);
  const long long ml_step = 2LL * grp, acc_step = static_cast<long long>(grp) * hd;
  // (m, l, acc) of splits merged in order: the running max moves up and
  // rescales what came before; an empty split (l == 0) wrote no acc
  auto merge = [](float& mb, float& lsum, float& asum, float mr, float lr,
                  float ar) {
    if (lr > 0.f) {
      const float mn = fmaxf(mb, mr);
      const float so = exp2f(mb - mn), sn = exp2f(mr - mn);
      lsum = lsum * so + lr * sn;
      asum = asum * so + ar * sn;
      mb = mn;
    }
  };
  float mb = NEG_BIG, lsum = 0.f, asum = 0.f;
#pragma unroll 4
  for (int r = rank; r < splits; r += COMBINE_RANKS)
    merge(mb, lsum, asum, ml[r * ml_step], ml[r * ml_step + 1],
          acc[r * acc_step]);
  red[0][rank][col] = mb;
  red[1][rank][col] = lsum;
  red[2][rank][col] = asum;
  __syncthreads();
  if (rank == 0 && d < hd) {
    mb = NEG_BIG;
    lsum = 0.f;
    asum = 0.f;
    for (int k = 0; k < COMBINE_RANKS; ++k)
      merge(mb, lsum, asum, red[0][k][col], red[1][k][col], red[2][k][col]);
    out[(static_cast<long long>(bh) * grp + g) * hd + d] =
        asum * (1.f / fmaxf(lsum, 1e-30f));
    if (lse != nullptr && d == 0)
      lse[static_cast<long long>(bh) * grp + g] =
          lsum > 0.f ? mb * LN2 + logf(lsum) : __int_as_float(0xff800000);
  }
}

template <typename TQ, typename TKV, int VEC, int G, int W, int U>
int run(Args a, cudaStream_t stream) {
  if (a.lanes < G) a.lanes = G;  // the transposed reduction needs L >= G
  const int kw = 32 / a.lanes;
  const size_t ring = static_cast<size_t>(ring_stages<TKV, W, U>()) * NW *
                      slot_bytes<TKV, W, U>();
  const size_t merge = sizeof(float) * static_cast<size_t>(NW) * 32 * G * W;
  const size_t smem =
      head_bytes(a.split_keys, kw, G, U) + (ring > merge ? ring : merge);
  const long long blocks =
      static_cast<long long>(a.splits) * a.B * a.Hkv;
  if (smem > MAX_SMEM || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = sm90::launch(decode_split_kernel<TQ, TKV, VEC, G, W, U>,
                              dim3(static_cast<unsigned>(blocks)), THREADS,
                              static_cast<int>(smem), stream, a);
  if (rc != 0) return rc;
  const int grp = a.H / a.Hkv;
  const long long cblocks = static_cast<long long>(a.B) * a.Hkv * grp *
                            ((a.hd + COMBINE_COLS - 1) / COMBINE_COLS);
  if (cblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  decode_combine_kernel<<<dim3(static_cast<unsigned>(cblocks)),
                          COMBINE_THREADS, 0, stream>>>(
      a.part, a.out, a.lse, a.B * a.Hkv, grp, a.hd, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// the lanes a key and the registers a lane holds follow the row's width:
// up to W columns of G query heads a lane (G x W <= 64).  Whole pieces of a
// row up to 256 wide (the models' heads) take G by the group's size; wider
// rows, and rows loaded element by element, take 32 columns and 2 query
// heads a pass
template <typename TQ, typename TKV, int VEC>
int pick(Args a, cudaStream_t stream) {
  const int nvec = a.hd / VEC, grp = a.H / a.Hkv;
  int L = 1;
  while (L < 32 && L < nvec) L *= 2;
  a.lanes = L;
  const int cols = (nvec + L - 1) / L * VEC;
  if (cols > 32) return static_cast<int>(cudaErrorInvalidValue);  // hd > 1024
  if constexpr (VEC > 1) {
    if (cols <= 8) {
      if (grp == 1) return run<TQ, TKV, VEC, 1, 8, 4>(a, stream);
      if (grp <= 4) return run<TQ, TKV, VEC, 4, 8, 4>(a, stream);
      return run<TQ, TKV, VEC, 8, 8, 4>(a, stream);
    }
  }
  return run<TQ, TKV, VEC, 2, 32, 1>(a, stream);
}

template <typename TQ, typename TKV>
int dispatch(const Args& a, cudaStream_t stream) {
  constexpr int VB = std::is_same_v<TKV, int8_t> ? 8 : 16;
  constexpr int VEC = VB / static_cast<int>(sizeof(TKV));
  const bool wide = a.hd % VEC == 0 &&
                    reinterpret_cast<uintptr_t>(a.k_pages) % VB == 0 &&
                    reinterpret_cast<uintptr_t>(a.v_pages) % VB == 0;
  return wide ? pick<TQ, TKV, VEC>(a, stream) : pick<TQ, TKV, 1>(a, stream);
}

Args make_args(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale, const void* table,
               const void* lengths, void* out, void* lse, void* scratch,
               int B, int H, int Hkv, int hd, int page, int n_pages,
               int n_pool, int window, int split_keys, int splits) {
  return Args{q, k_pages, v_pages, static_cast<const float*>(k_scale),
              static_cast<const float*>(v_scale),
              static_cast<const int*>(table),
              static_cast<const int*>(lengths), static_cast<float*>(out),
              static_cast<float*>(lse), static_cast<float*>(scratch), B, H,
              Hkv, hd, page, n_pages, n_pool, window, split_keys, splits,
              32};
}

}  // namespace

// q (B, H, hd); k/v_pages (n_pool, page, Hkv, hd) of q's type; table
// (B, n_pages) int32; lengths (B,) int32; out (B, H, hd) fp32; lse null
// or (B, H) fp32, each row's log-sum-exp; all contiguous.  split_keys
// and splits: the plan of attention/decode.py::decode_split_plan;
// scratch: the splits' partials, B * Hkv * splits * (H / Hkv) * (hd + 2)
// fp32.  Returns a cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lengths, void* out,
                                      void* lse, void* scratch, int B, int H,
                                      int Hkv, int hd, int page, int n_pages,
                                      int n_pool, int window, int split_keys,
                                      int splits, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(q, k_pages, v_pages, nullptr, nullptr, table,
                           lengths, out, lse, scratch, B, H, Hkv, hd,
                           page, n_pages, n_pool, window, split_keys,
                           splits);
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == DTYPE_F32) return dispatch<float, float>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 branch: k/v_pages int8, k/v_scale (n_pool, Hkv) f32, q of the
// float type `dtype`; otherwise as repro_decode_attention.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, void* lse, void* scratch, int B, int H,
    int Hkv, int hd, int page, int n_pages, int n_pool, int window,
    int split_keys, int splits, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(q, k_pages, v_pages, k_scale, v_scale, table,
                           lengths, out, lse, scratch, B, H, Hkv, hd,
                           page, n_pages, n_pool, window, split_keys,
                           splits);
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16, int8_t>(a, s);
  if (dtype == DTYPE_F32) return dispatch<float, int8_t>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
