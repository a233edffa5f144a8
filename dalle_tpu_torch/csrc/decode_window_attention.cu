// Windowed decode attention with per-row starts, over a dense cache slab (K3)
// or a paged block pool (K5), for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_window_kernel
// (body _decode_window_kernel) and decode_attend_window_paged, which gathers
// the pool into the dense slab and runs the same kernel. q (b, h, w, d): query
// j of row b sits at position starts[b] + j and sees the cache positions
// <= starts[b] + j. The cache row of position p holds K in its first h*d
// lanes and V in the rest, stored as f32, bf16 or int8 (int8 with f32 scales:
// K scale times the score, V scale times the probability). The arithmetic is
// the TPU kernel's, rounding for rounding:
//   for a bf16 or int8 cache, qs = bf16(f32(q) * scale); K and V are exact
//   in bf16 (an int8 value is), so every product is bf16 x bf16 into f32;
//   s = qs.k in f32, times the K scale of the position; m is the max over the
//   query's whole visible row, p = exp(s - m) and l = sum p in f32;
//   p * vscale is rounded to bf16 once the row's final m is known, and the
//   products p16.v are summed in f32; out = o / l, or o / 1 where l = 0.
// An f32 cache stays f32 throughout.
//
// Addressing, the only difference between K3 and K5:
//   dense  row(b, p) = b*S + p                      in kv (b, S, 2hd),
//          scales (b, 2h, S);
//   paged  row(b, p) = pages[b, p/bt]*bt + p%bt      in pool (N, bt, 2hd),
//          scales (N, bt, 2h); an unmapped page (-1) reads as a row of zeros
//          with scale 0, exactly what the JAX gather fills in.
// Everything else is one code path per route, templated on PAGED, so K5
// equals K3 on the gathered slab bit for bit, and no slab is materialised.
//
// Bound: HBM bytes. A launch needs the cache positions each row can see once
// (b * positions * 2hd * itemsize); the flops are 4*d per (query, position)
// pair, below the card's ops/byte balance even at w = 257 for bf16 and int8
// (an f32 cache at w = 257 is bound by the f32 FMA rate).
//
// Three routes; the wrapper (ops/decode_attention.py::window_plan) picks the
// route, the tile height and the split, and passes them in:
//   * tc (w > 1, bf16 or int8 cache): tc_window_kernel, mma.sync m16n8k16 on
//     the tensor cores. A CTA holds 64 queries of one (b, h), one warp per 16
//     rows (64-row tiles beat 32 and 16 at every width timed, down to the
//     paged engine's 16-query chunks: four warps keep four times the copies
//     in flight, and a padding warp's products cost no more time). The
//     scaled queries are rounded to bf16 into a shared tile (row stride
//     D + 8, D = d rounded up to 32, 64, 128 or 256, zero padded) and read
//     once into A fragments, so the tile borrows a ring slot
//     that pass 1 leaves free. K and V stream in 64-position tiles through a
//     two-stage 16-byte cp.async ring addressed by Rows::at (a paged tile's
//     rows are looked up two steps ahead into shared memory, off the copies'
//     path); an int8 stage lands raw and is converted to one padded bf16 tile
//     before ldmatrix; the K and V scales of the tile's positions arrive by
//     4-byte cp.async. Two passes, as K1's forward: pass 1 scores every tile
//     for each row's online (m, l) (quad shuffles); pass 2 scores again,
//     forms p = exp(s - m) with the final m, times the V scale in registers,
//     and accumulates bf16(p).v. A one-pass online rescale would round p
//     against a running max: another function. The tile sees positions
//     < min(S, start + q_last + 1), so a parked row (start = S) reads exactly
//     S positions. The longest q tiles launch first; 69 KB of shared memory
//     at d = 128, three CTAs an SM;
//   * split (w = 1, every dtype): split_window_kernel, a decode step. Grid
//     (nsplit, h, b) with a cluster of nsplit CTAs per (b, h), launched with
//     cudaLaunchKernelEx. Rank r scores its slice of the visible positions into
//     its shared memory (lane groups of 16-byte loads, f32 FMA), takes its
//     local max, reads the other ranks' maxima through distributed shared
//     memory, forms and rounds every p against the row's global m, and keeps
//     its partial o and l; rank 0 adds the partials in rank order and writes
//     the output, and a last cluster barrier keeps the ranks alive until it
//     has read them. (A block-then-combine split, K7's, would round p against
//     each block's own max.) The dots are d-long, so the CUDA cores suffice;
//     the positions' cache rows are kept from pass 1 for pass 2, and eight
//     CTAs an SM (64 registers a thread) run a step of 112 (b, h) in one wave;
//   * fma (w > 1, f32 cache): fma_window_kernel, the first port's f32 FMA
//     kernel (TPU f32 arithmetic): 16-query tiles, scores in a (16, S) shared
//     tile, a warp per query row for the softmax, row groups summed in shared
//     memory.
// No atomics, and every sum in a fixed order: repeated runs give the same
// bits. A route that is refused (a bad plan, too much shared memory, a
// cluster that does not fit) returns its CUDA error, and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // fma route
constexpr int kTileQ = 16;           // fma route: queries per CTA
constexpr int kVU = 4;               // V rows a thread keeps in flight
constexpr int kKeys = 64;            // tc route: positions per K/V tile
constexpr int kTcRows = 64;          // tc route: queries per CTA, one warp per 16
constexpr int kTcThreads = kTcRows * 2;
constexpr int kSplitThreads = 128;   // split route: threads per CTA of a cluster
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxSplit = 8;         // the portable cluster size

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Route { kFma = 0, kTc = 1, kSplit = 2 };

template <typename T> struct Vec;  // elements in one 16-byte load
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// one 32-bit word of the cache as f32 values (4 / sizeof(T) of them),
// element 0 in the low bits
template <typename T> __device__ __forceinline__ void from_word(unsigned int w, float* f);
template <> __device__ __forceinline__ void from_word<float>(unsigned int w, float* f) {
  f[0] = __uint_as_float(w);
}
template <> __device__ __forceinline__ void from_word<bf16>(unsigned int w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void from_word<int8_t>(unsigned int w, float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xff));
}

// N elements of the cache at p (16 or 8 bytes, aligned) as f32 values
template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int kPer = 4 / sizeof(T);
  if constexpr (N * sizeof(T) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
    from_word<T>(r.z, f + 2 * kPer);
    from_word<T>(r.w, f + 3 * kPer);
  } else {
    static_assert(N * sizeof(T) == 8, "loads of 8 or 16 bytes");
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// lanes that share one cache position: the power of two >= chunks, at most 32
__host__ __device__ inline int lanes_per_row(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

// Where the cache row of position p of batch row b lives: its index among the
// (rows, 2hd) rows of kv, or -1 for an unmapped page (a row of zeros).
struct Rows {
  const int* pages;  // (b, max_blocks) or null for the dense slab
  int S, bt, max_blocks;

  template <bool PAGED>
  __device__ __forceinline__ long long at(int b, int p) const {
    if (!PAGED) return (long long)b * S + p;
    const int page = pages[(long long)b * max_blocks + p / bt];
    return page < 0 ? -1 : (long long)page * bt + p % bt;
  }
};

// The f32 scale of head row `hr` (0..2h-1: K scales, then V scales) at
// position p of cache row `row` (>= 0)
template <bool PAGED>
__device__ __forceinline__ const float* scale_ptr(const float* sc, long long row, int b, int p,
                                                  int hr, int heads, int S) {
  if (PAGED) return sc + row * 2 * heads + hr;
  return sc + ((long long)b * 2 * heads + hr) * S + p;
}

// ... as a value: 1 without scales, 0 for an unmapped page
template <bool PAGED>
__device__ __forceinline__ float scale_at(const float* sc, long long row, int b, int p, int hr,
                                          int heads, int S) {
  if (sc == nullptr) return 1.f;
  return row < 0 ? 0.f : *scale_ptr<PAGED>(sc, row, b, p, hr, heads, S);
}

// One launch's operands. q and out are f32 or bf16 (q_bf16); kv holds T.
struct Window {
  const void* q;         // (b, h, w, d)
  const void* kv;        // dense slab (b, S, 2hd) or pool (N, bt, 2hd)
  const float* scale;    // int8: (b, 2h, S) or (N, bt, 2h); else null
  const int* starts;     // (b,)
  void* out;             // like q
  Rows rows;
  int q_bf16, heads, w, d;
  float sm_scale;
};

__device__ __forceinline__ float load_q(const Window& a, long long i) {
  return a.q_bf16 ? __bfloat162float(static_cast<const bf16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}

__device__ __forceinline__ void store_out(const Window& a, long long i, float v) {
  if (a.q_bf16) {
    static_cast<bf16*>(a.out)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(a.out)[i] = v;
  }
}

// ---------------------------------------------------------------------------
// tc route: w > 1, bf16 or int8 cache; grid (ceil(w / 64), h, b), four warps,
// the last q tiles first
// ---------------------------------------------------------------------------

// shared memory: for bf16 two stages of (K, V) tiles; for int8 one converted
// (K, V) pair, two stages of raw (K, V) and of their scales; then the cache
// rows of the next two steps' positions (paged)
template <typename T, int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return (std::is_same<T, int8_t>::value
              ? (size_t)2 * kKeys * (D + 8) * 2 + 4 * kKeys * D + 4 * kKeys * 4
              : (size_t)4 * kKeys * (D + 8) * 2) +
         2 * kKeys * 4;
}

// (three CTAs an SM up to d = 128: at most 170 registers a thread)
template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kTcThreads, D <= 128 ? 3 : 1)
tc_window_kernel(const Window a) {
  constexpr int kThr = kTcThreads;
  constexpr int kLd = D + 8, kEl = kKeys * kLd;
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  constexpr int kCE = 16 / sizeof(T);      // cache elements per 16-byte copy
  constexpr int kChunks = D / kCE;
  extern __shared__ __align__(16) unsigned char smem[];
  // bf16: stage s holds K at sKV + 2s*kEl and V after it; int8: the converted
  // K at sKV, V at sKV + kEl
  bf16* sKV = reinterpret_cast<bf16*>(smem);
  // int8: raw stage s, K at raw + 2s*kKeys*D and V after it
  int8_t* raw = reinterpret_cast<int8_t*>(sKV + (kI8 ? 2 : 4) * kEl);
  // int8: stage s, K scales at sSc + 2s*kKeys and V scales after them
  float* sSc = reinterpret_cast<float*>(raw + (kI8 ? 4 * kKeys * D : 0));
  // paged: step st's cache rows at sRow + (st & 1)*kKeys
  int* sRow = reinterpret_cast<int*>(sSc + (kI8 ? 4 * kKeys : 0));
  // the query tile, read into registers before the loop: V's slot of stage 0
  // (bf16) or the converted V (int8), first written at step 1 or later
  bf16* sQ = sKV + kEl;

  const T* kv = static_cast<const T*>(a.kv);
  const Rows rows = a.rows;
  const int S = rows.S, heads = a.heads, w = a.w, d = a.d;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTcRows;
  const int nq = min(kTcRows, w - q0);
  const int start = a.starts[b];
  const int L = max(0, min(S, start + q0 + nq));    // positions the tile can see
  const int nt = (L + kKeys - 1) / kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int row = warp * 16 + (lane >> 2);          // this lane's tile rows: row, row + 8
  const long long row_stride = 2LL * heads * d;
  const T* kbase = kv + (long long)hh * d;
  const T* vbase = kv + (long long)(heads + hh) * d;

  // the cache row of position k0 + j of step st, -1 past L or unmapped; a
  // paged row comes from sRow, filled two steps ahead by `lookup`
  auto row_of = [&](int st, int k0, int j) -> long long {
    if (PAGED) return sRow[(st & 1) * kKeys + j];
    return k0 + j < L ? (long long)b * S + k0 + j : -1;
  };
  auto lookup = [&](int st) {
    const int k0 = (st >= nt ? st - nt : st) * kKeys;
    for (int j = threadIdx.x; j < kKeys; j += kThr)
      sRow[(st & 1) * kKeys + j] = k0 + j < L ? (int)rows.at<PAGED>(b, k0 + j) : -1;
  };
  // the copies of step st (pass 1: K; pass 2: K and V) into ring stage `stage`
  auto fetch = [&](int st, int stage) {
    const bool two = st >= nt;
    const int k0 = (two ? st - nt : st) * kKeys;
    for (int idx = threadIdx.x; idx < kKeys * kChunks; idx += kThr) {
      const int r = idx / kChunks, c = idx - r * kChunks;
      const long long rr = row_of(st, k0, r);
      const bool ok = rr >= 0 && c * kCE < d;
      const long long off = ok ? rr * row_stride + c * kCE : 0;
      if (kI8) {
        int8_t* dst = raw + 2 * stage * kKeys * D + r * D + c * 16;
        tc::cp_async16(dst, kbase + off, ok);
        if (two) tc::cp_async16(dst + kKeys * D, vbase + off, ok);
      } else {
        bf16* dst = sKV + 2 * stage * kEl + r * kLd + c * 8;
        tc::cp_async16(dst, kbase + off, ok);
        if (two) tc::cp_async16(dst + kEl, vbase + off, ok);
      }
    }
    if (kI8) {
      for (int t = threadIdx.x; t < (two ? 2 : 1) * kKeys; t += kThr) {
        const int which = t / kKeys, j = t - which * kKeys;   // 0: K scale, 1: V scale
        const int p = k0 + j;
        const long long rr = row_of(st, k0, j);
        const bool ok = rr >= 0;
        const float* src =
            ok ? scale_ptr<PAGED>(a.scale, rr, b, p, which * heads + hh, heads, S) : a.scale;
        tc::cp_async4(sSc + (2 * stage + which) * kKeys + j, src, ok);
      }
    }
  };

  // the tile's queries, bf16(f32(q) * scale), zero past w and past d
  const long long qoff = (((long long)b * heads + hh) * w + q0) * d;
  for (int x = threadIdx.x; x < kTcRows * D; x += kThr) {
    const int r = x / D, c = x - r * D;
    const float v = r < nq && c < d ? load_q(a, qoff + (long long)r * d + c) * a.sm_scale : 0.f;
    sQ[r * kLd + c] = __float2bfloat16(v);
  }
  if (PAGED && nt > 0) {
    lookup(0);
    lookup(1);
  }
  __syncthreads();
  uint32_t qf[D / 16][4];              // the A fragments of this warp's 16 query rows
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    tc::ldsm_x4(qf[kd], tc::a_addr(sQ, kLd, warp * 16, kd * 16, lane));
  if (nt > 0) fetch(0, 0);
  tc::cp_async_commit();

  const int qpos = start + q0 + row;   // the position of query row `row`
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // pass 1: this lane's share of the row sums
  float acc[D / 8][4];
  tc::zero(acc);
  for (int st = 0; st < 2 * nt; ++st) {
    const int stage = st & 1;
    const bool two = st >= nt;
    tc::cp_async_wait<0>();
    __syncthreads();   // this step's copies have landed, every warp is done with the last step's
    if (PAGED && st + 2 < 2 * nt) lookup(st + 2);
    if (st + 1 < 2 * nt) fetch(st + 1, stage ^ 1);
    tc::cp_async_commit();
    const bf16* cK = sKV + 2 * stage * kEl;
    const float* ks = sSc + 2 * stage * kKeys;
    if (kI8) {
      // int8 -> bf16 (exact) into the padded tiles ldmatrix reads
      cK = sKV;
      const int8_t* src = raw + 2 * stage * kKeys * D;
      for (int idx = threadIdx.x; idx < (two ? 2 : 1) * kKeys * (D / 16); idx += kThr) {
        const int which = idx / (kKeys * (D / 16));
        const int rem = idx - which * kKeys * (D / 16);
        const int r = rem / (D / 16), c = rem - r * (D / 16);
        const uint4 x = *reinterpret_cast<const uint4*>(src + which * kKeys * D + r * D + c * 16);
        const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float f[4];
          from_word<int8_t>(wd[k], f);
          o[2 * k] = tc::pack_bf16(f[0], f[1]);
          o[2 * k + 1] = tc::pack_bf16(f[2], f[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>(sKV + which * kEl + r * kLd + c * 16);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
    }
    const bf16* cV = cK + kEl;
    const float* vs = ks + kKeys;

    const int k0 = (two ? st - nt : st) * kKeys;
    float s[8][4];
    tc::zero(s);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, tc::b_addr(cK, kLd, np * 16, kd * 16, lane));
        tc::mma16816(s[2 * np], qf[kd], bf[0], bf[1]);
        tc::mma16816(s[2 * np + 1], qf[kd], bf[2], bf[3]);
      }
    // times the K scale; -inf past L and where the position is after the query
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int p = k0 + col;
        const float x = kI8 ? s[j][e] * ks[col] : s[j][e];
        s[j][e] = p < L && p <= qpos + 8 * (e >> 1) ? x : -INFINITY;
      }

    if (!two) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], tc::quad_max(mx));
        // a row with nothing visible yet keeps (m, l) as they are
        if (m_new != -INFINITY) {
          const float corr = expf(m[hr] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum += expf(s[j][2 * hr] - m_new) + expf(s[j][2 * hr + 1] - m_new);
          l[hr] = l[hr] * corr + sum;
          m[hr] = m_new;
        }
      }
      if (st + 1 == nt) {   // pass 1 is done: each row's (m, l)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l[hr] = tc::quad_sum(l[hr]);
          if (m[hr] == -INFINITY) m[hr] = 0.f;
        }
      }
    } else {
      // p = exp(s - m) with the final m, times the V scale; dot_pv rounds it
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);
          s[j][e] = kI8 ? p * vs[8 * j + 2 * t4 + (e & 1)] : p;
        }
      tc::dot_pv<D, 8>(acc, s, cV, 0, lane);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= nq) continue;
    const float den = l[hr] > 0.f ? l[hr] : 1.f;
    const long long o = qoff + (long long)r * d + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      if (dn * 8 + 2 * t4 >= d) continue;
      if (a.q_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o + dn * 8) =
            __floats2bfloat162_rn(acc[dn][2 * hr] / den, acc[dn][2 * hr + 1] / den);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o + dn * 8) =
            make_float2(acc[dn][2 * hr] / den, acc[dn][2 * hr + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split route: w = 1, every dtype; grid (nsplit, h, b), a cluster of nsplit
// CTAs per (b, h); rank r takes the r-th slice of the L = min(S, start + 1)
// visible positions
// ---------------------------------------------------------------------------

// pass 2's loads: at most 8 elements (16 bytes of f32 or bf16, 8 of int8),
// so that a thread's V rows in flight fit the register cap
template <typename T>
__host__ __device__ constexpr int split_pv() { return Vec<T>::N > 8 ? 8 : Vec<T>::N; }

template <typename T>
__host__ __device__ inline size_t split_smem_bytes(int per_max, int d) {
  const int vrows = kSplitThreads / (d / split_pv<T>());
  return sizeof(float) * ((size_t)d + 2 * per_max + (size_t)vrows * d + kSplitWarps + 2);
}

// (eight CTAs an SM: at most 64 registers a thread)
template <typename T, bool PAGED>
__global__ void __launch_bounds__(kSplitThreads, 8)
split_window_kernel(const Window a, int per_max) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PV = split_pv<T>();
  constexpr int KU = VEC > 8 ? 2 : 4;     // positions a lane group keeps in flight
  constexpr bool kRound = !std::is_same<T, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsmem[];
  const T* kv = static_cast<const T*>(a.kv);
  const Rows rows = a.rows;
  const int S = rows.S, heads = a.heads, d = a.d;
  const int chunks = d / VEC;
  const int vchunks = d / PV;
  const int vrows = kSplitThreads / vchunks;
  float* q_s = fsmem;                  // d
  float* p_s = q_s + d;                // per_max: scores, then probabilities
  int* r_s = reinterpret_cast<int*>(p_s + per_max);   // per_max: the positions' cache rows
  float* acc_s = p_s + 2 * per_max;    // vrows * d: pass 2's row groups; then o in the first d
  float* red = acc_s + vrows * d;      // kSplitWarps
  float* stat = red + kSplitWarps;     // [0] local max, [1] local sum (read by rank 0)

  const int nsplit = gridDim.x;        // one cluster spans the grid's x
  const int rank = blockIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = a.starts[b];
  const int L = max(0, min(S, start + 1));
  const int per = (L + nsplit - 1) / nsplit;
  const int p0 = min(L, rank * per);
  const int n = min(L, p0 + per) - p0;
  const long long row_stride = 2LL * heads * d;
  const T* kbase = kv + (long long)hh * d;
  const T* vbase = kv + (long long)(heads + hh) * d;

  const long long qoff = ((long long)b * heads + hh) * d;
  for (int x = tid; x < d; x += kSplitThreads) {
    const float v = load_q(a, qoff + x) * a.sm_scale;
    q_s[x] = kRound ? bf16_round(v) : v;
  }
  __syncthreads();

  // ---- pass 1: the slice's scores and its max ----
  const int G = lanes_per_row(chunks);
  const int rows_per_warp = 32 / G;
  const int gl = lane % G;
  const int my_row = warp * rows_per_warp + lane / G;
  const int rows_per_iter = kSplitWarps * rows_per_warp;
  float mloc = -INFINITY;
  for (int base = 0; base < n; base += rows_per_iter * KU) {
    int j[KU];
    long long r[KU];
    float part[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      j[u] = base + u * rows_per_iter + my_row;
      r[u] = j[u] < n ? rows.at<PAGED>(b, p0 + j[u]) : -1;
      part[u] = 0.f;
    }
    for (int c0 = 0; c0 < chunks; c0 += G) {
      const int c = c0 + gl;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (r[u] >= 0 && c < chunks) {
          float f[VEC];
          load_vec<T>(kbase + r[u] * row_stride + c * VEC, f);
          const float4* qv = reinterpret_cast<const float4*>(q_s + c * VEC);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qq = qv[e];
            s = fmaf(f[4 * e], qq.x, s);
            s = fmaf(f[4 * e + 1], qq.y, s);
            s = fmaf(f[4 * e + 2], qq.z, s);
            s = fmaf(f[4 * e + 3], qq.w, s);
          }
          part[u] += s;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      for (int off = G >> 1; off > 0; off >>= 1)
        part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
      if (gl == 0 && j[u] < n) {
        const int p = p0 + j[u];
        const float s = part[u] * scale_at<PAGED>(a.scale, r[u], b, p, hh, heads, S);
        p_s[j[u]] = s;
        r_s[j[u]] = static_cast<int>(r[u]);
        mloc = fmaxf(mloc, s);
      }
    }
  }
  mloc = warp_max(mloc);
  if (lane == 0) red[warp] = mloc;
  __syncthreads();
  if (tid == 0) {
    float mm = red[0];
    for (int k = 1; k < kSplitWarps; ++k) mm = fmaxf(mm, red[k]);
    stat[0] = mm;
  }
  cluster.sync();   // every rank's local max is in its shared memory

  // ---- the row's max, then p rounded against it ----
  float m = lane < nsplit ? *cluster.map_shared_rank(stat, lane) : -INFINITY;
  m = warp_max(m);
  if (m == -INFINITY) m = 0.f;
  float lsum = 0.f;
  for (int jj = tid; jj < n; jj += kSplitThreads) {
    const int p = p0 + jj;
    const float e = expf(p_s[jj] - m);
    lsum += e;
    float pv = e;
    if (a.scale != nullptr) pv *= scale_at<PAGED>(a.scale, r_s[jj], b, p, heads + hh, heads, S);
    p_s[jj] = kRound ? bf16_round(pv) : pv;
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  if (tid == 0) {
    float ll = 0.f;
    for (int k = 0; k < kSplitWarps; ++k) ll += red[k];
    stat[1] = ll;
  }

  // ---- pass 2: the slice's probabilities times V ----
  const int vr = tid / vchunks;
  const int c = tid - vr * vchunks;
  if (vr < vrows) {
    float acc[PV];
#pragma unroll
    for (int e = 0; e < PV; ++e) acc[e] = 0.f;
    for (int base = vr; base < n; base += vrows * kVU) {
      float f[kVU][PV];
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int jj = base + u * vrows;
        const long long r = jj < n ? r_s[jj] : -1;
        if (r >= 0) {
          load_vec<T, PV>(vbase + r * row_stride + c * PV, f[u]);
        } else {
#pragma unroll
          for (int e = 0; e < PV; ++e) f[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int jj = base + u * vrows;
        if (jj < n) {
          const float pr = p_s[jj];
#pragma unroll
          for (int e = 0; e < PV; ++e) acc[e] = fmaf(pr, f[u][e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < PV; ++e) acc_s[vr * d + c * PV + e] = acc[e];
  }
  __syncthreads();
  for (int x = tid; x < d; x += kSplitThreads) {
    float o = 0.f;
    for (int rr = 0; rr < vrows; ++rr) o += acc_s[rr * d + x];
    acc_s[x] = o;   // each thread reads and writes its own column only
  }
  cluster.sync();   // every rank's (o, l) is in its shared memory

  if (rank == 0) {
    float ll = 0.f;
    for (int r2 = 0; r2 < nsplit; ++r2) ll += cluster.map_shared_rank(stat, r2)[1];
    const float den = ll > 0.f ? ll : 1.f;
    for (int x = tid; x < d; x += kSplitThreads) {
      float o = 0.f;
      for (int r2 = 0; r2 < nsplit; ++r2) o += cluster.map_shared_rank(acc_s, r2)[x];
      store_out(a, qoff + x, o / den);
    }
  }
  cluster.sync();   // the other ranks' shared memory lives until rank 0 has read it
}

// ---------------------------------------------------------------------------
// fma route: w > 1, f32 cache; grid (ceil(w / 16), h, b), 256 threads
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t fma_smem_bytes(int S, int d) {
  const int vrows = kThreads / (d / 4);
  return sizeof(float) * ((size_t)kTileQ * d + (size_t)kTileQ * S + kTileQ +
                          (size_t)vrows * kTileQ * d);
}

template <bool PAGED>
__global__ void __launch_bounds__(kThreads)
fma_window_kernel(const Window a) {
  constexpr int TQ = kTileQ;
  constexpr int VEC = 4;     // f32 elements per 16-byte load; also a thread's output dims
  constexpr int KU = 2;      // positions a lane group keeps in flight
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float fsmem[];
  const float* kv = static_cast<const float*>(a.kv);
  const Rows rows = a.rows;
  const int S = rows.S, heads = a.heads, w = a.w, d = a.d;
  const int chunks = d / VEC;
  const int vrows = kThreads / chunks;
  float* q_s = fsmem;           // TQ * d
  float* s_s = q_s + TQ * d;    // TQ * S: scores, then probabilities
  float* l_s = s_s + TQ * S;    // TQ
  float* acc_s = l_s + TQ;      // vrows * TQ * d

  const int q0 = blockIdx.x * TQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = min(TQ, w - q0);
  const int start = a.starts[b];
  const int L = max(0, min(S, start + q0 + nq));  // positions the tile can see
  const long long row_stride = 2LL * heads * d;
  const float* kbase = kv + (long long)hh * d;
  const float* vbase = kv + (long long)(heads + hh) * d;

  const long long qoff = (((long long)b * heads + hh) * w + q0) * d;
  for (int x = tid; x < TQ * d; x += kThreads) {
    q_s[x] = x < nq * d ? load_q(a, qoff + x) * a.sm_scale : 0.f;
  }
  __syncthreads();

  // ---- pass 1: TQ scores per visible position ----
  const int G = lanes_per_row(chunks);
  const int rows_per_warp = 32 / G;
  const int gl = lane % G;
  const int my_row = warp * rows_per_warp + lane / G;
  const int rows_per_iter = kWarps * rows_per_warp;
  for (int base = 0; base < L; base += rows_per_iter * KU) {
    int j[KU];
    long long r[KU];
    float part[KU][TQ];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      j[u] = base + u * rows_per_iter + my_row;
      r[u] = j[u] < L ? rows.at<PAGED>(b, j[u]) : -1;
#pragma unroll
      for (int i = 0; i < TQ; ++i) part[u][i] = 0.f;
    }
    for (int c0 = 0; c0 < chunks; c0 += G) {
      const int c = c0 + gl;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (r[u] >= 0 && c < chunks) {
          float f[VEC];
          load_vec<float>(kbase + r[u] * row_stride + c * VEC, f);
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            const float4 qq = *reinterpret_cast<const float4*>(q_s + i * d + c * VEC);
            float s = 0.f;
            s = fmaf(f[0], qq.x, s);
            s = fmaf(f[1], qq.y, s);
            s = fmaf(f[2], qq.z, s);
            s = fmaf(f[3], qq.w, s);
            part[u][i] += s;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        for (int off = G >> 1; off > 0; off >>= 1) {
          part[u][i] += __shfl_xor_sync(0xffffffffu, part[u][i], off);
        }
      }
      if (gl == 0 && j[u] < L) {
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          s_s[i * S + j[u]] = j[u] <= start + q0 + i ? part[u][i] : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax, one warp per query row; the probability replaces the score ----
  for (int i = warp; i < TQ; i += kWarps) {
    float* srow = s_s + i * S;
    float m = -INFINITY;
    for (int p = lane; p < L; p += 32) m = fmaxf(m, srow[p]);
    m = warp_max(m);
    float l = 0.f;
    for (int p = lane; p < L; p += 32) {
      const float e = srow[p] == -INFINITY ? 0.f : expf(srow[p] - m);
      l += e;
      srow[p] = e;
    }
    l = warp_sum(l);
    if (lane == 0) l_s[i] = l;
  }
  __syncthreads();

  // ---- pass 2: probabilities times V ----
  const int vr = tid / chunks;
  const int c = tid - vr * chunks;
  if (vr < vrows) {
    float acc[TQ][VEC];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    }
    for (int base = vr; base < L; base += vrows * kVU) {
      float f[kVU][VEC];
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int p = base + u * vrows;
        const long long r = p < L ? rows.at<PAGED>(b, p) : -1;
        if (r >= 0) {
          load_vec<float>(vbase + r * row_stride + c * VEC, f[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int p = base + u * vrows;
        if (p < L) {
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            const float pr = s_s[i * S + p];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(pr, f[u][e], acc[i][e]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[(vr * TQ + i) * d + c * VEC + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int x = tid; x < nq * d; x += kThreads) {
    const int i = x / d;
    const int dd = x - i * d;
    float o = 0.f;
    for (int rr = 0; rr < vrows; ++rr) o += acc_s[(rr * TQ + i) * d + dd];
    const float l = l_s[i];
    store_out(a, qoff + x, o / (l > 0.f ? l : 1.f));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int elems_per_16b(int kv_dtype) { return kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 8 : 16; }

// the tc route's padded head width: d rounded up to 32, 64, 128 or 256
int tc_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

template <typename T>
size_t tc_smem(int tile_rows, int d) {
  if (tile_rows != kTcRows) return 0;
  switch (tc_width(d)) {
    case 32: return tc_smem_bytes<T, 32>();
    case 64: return tc_smem_bytes<T, 64>();
    case 128: return tc_smem_bytes<T, 128>();
    default: return tc_smem_bytes<T, 256>();
  }
}

// shared memory of one CTA of the plan, or 0 if the plan is not one of the
// routes: fma needs an f32 cache, tc a bf16 or int8 cache and 64 rows, split
// w = 1 and 1..8 ranks
size_t plan_smem(int kv_dtype, int route, int tile_rows, int nsplit, int w, int S, int d) {
  if (d <= 0 || d > 256 || d % elems_per_16b(kv_dtype) != 0 || S <= 0) return 0;
  switch (route) {
    case kFma:
      return kv_dtype == kF32 ? fma_smem_bytes(S, d) : 0;
    case kTc:
      if (kv_dtype == kBF16) return tc_smem<bf16>(tile_rows, d);
      if (kv_dtype == kI8) return tc_smem<int8_t>(tile_rows, d);
      return 0;
    case kSplit: {
      if (w != 1 || nsplit < 1 || nsplit > kMaxSplit) return 0;
      const int per_max = (S + nsplit - 1) / nsplit;
      if (kv_dtype == kF32) return split_smem_bytes<float>(per_max, d);
      if (kv_dtype == kBF16) return split_smem_bytes<bf16>(per_max, d);
      return split_smem_bytes<int8_t>(per_max, d);
    }
    default:
      return 0;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool PAGED>
int launch_fma(const Window& a, int b, size_t smem, cudaStream_t stream) {
  auto kern = fma_window_kernel<PAGED>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.w + kTileQ - 1) / kTileQ, a.heads, b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool PAGED>
int launch_tc(const Window& a, int b, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<T, D>();
  auto kern = tc_window_kernel<T, D, PAGED>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.w + kTcRows - 1) / kTcRows, a.heads, b);
  kern<<<grid, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int launch_tc_width(const Window& a, int b, cudaStream_t stream) {
  switch (tc_width(a.d)) {
    case 32: return launch_tc<T, 32, PAGED>(a, b, stream);
    case 64: return launch_tc<T, 64, PAGED>(a, b, stream);
    case 128: return launch_tc<T, 128, PAGED>(a, b, stream);
    default: return launch_tc<T, 256, PAGED>(a, b, stream);
  }
}

template <typename T, bool PAGED>
int launch_split(const Window& a, int b, int nsplit, size_t smem, cudaStream_t stream) {
  auto kern = split_window_kernel<T, PAGED>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_max = (a.rows.S + nsplit - 1) / nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, a.heads, b);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, per_max);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch(const Window& a, int kv_dtype, int b, int route, int nsplit, size_t smem,
           cudaStream_t stream) {
  switch (route) {
    case kFma:
      return launch_fma<PAGED>(a, b, smem, stream);
    case kTc:
      return kv_dtype == kBF16 ? launch_tc_width<bf16, PAGED>(a, b, stream)
                               : launch_tc_width<int8_t, PAGED>(a, b, stream);
    default:
      switch (kv_dtype) {
        case kF32: return launch_split<float, PAGED>(a, b, nsplit, smem, stream);
        case kBF16: return launch_split<bf16, PAGED>(a, b, nsplit, smem, stream);
        default: return launch_split<int8_t, PAGED>(a, b, nsplit, smem, stream);
      }
  }
}

}  // namespace

// Shared memory (bytes) one CTA of the plan needs, for the wrapper's check;
// 0 when the plan is not one the kernels take for this cache dtype and shape.
// route 0 = fma, 1 = tc, 2 = split.
extern "C" long long decode_window_smem_bytes(int kv_dtype, int route, int tile_rows,
                                              int nsplit, int w, int S, int d) {
  return static_cast<long long>(plan_smem(kv_dtype, route, tile_rows, nsplit, w, S, d));
}

// q (b, h, w, d) and out in q_dtype (0 = f32, 1 = bf16); kv_dtype 0 = f32,
// 1 = bf16, 2 = int8 (then kv_scale is required). starts (b,) int32. With
// pages null, kv is the dense slab (b, S, 2hd) and kv_scale (b, 2h, S); with
// pages (b, max_blocks) int32, kv is the pool (N, block_tokens, 2hd) and
// kv_scale (N, block_tokens, 2h), S the logical length. The plan (route,
// tile_rows, nsplit) comes from the wrapper's window_plan. Returns the CUDA
// error of the launch: 0 when it launched.
extern "C" int decode_attend_window(const void* q, int q_dtype, const void* kv, int kv_dtype,
                                    const void* kv_scale, const void* pages, const void* starts,
                                    void* out, int b, int h, int w, int S, int d,
                                    int block_tokens, int max_blocks, float sm_scale, int route,
                                    int tile_rows, int nsplit, void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype != kF32 && q_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || w <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plan_smem(kv_dtype, route, tile_rows, nsplit, w, S, d);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pages != nullptr && (block_tokens <= 0 || (long long)block_tokens * max_blocks < S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Window a{q,
           kv,
           static_cast<const float*>(kv_scale),
           static_cast<const int*>(starts),
           out,
           Rows{static_cast<const int*>(pages), S, block_tokens, max_blocks},
           q_dtype == kBF16,
           h,
           w,
           d,
           sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pages == nullptr) return launch<false>(a, kv_dtype, b, route, nsplit, smem, st);
  return launch<true>(a, kv_dtype, b, route, nsplit, smem, st);
}
