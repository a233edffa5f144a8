// Whole-sequence causal attention with an exact (not online) softmax, forward
// and backward, for Hopper (sm_90a), on the tensor cores.
//
// Replaces dalle_tpu/ops/persistent_attention.py::_persist_fwd (Pallas body
// _fwd_kernel) and ::_persist_bwd (body _bwd_kernel). Operands are (b, h, n, d)
// bf16 with any (b, h, n) strides and a dense head dim (the wrapper casts them
// to bf16 first, as the TPU wrapper does); outputs are (b, h, n, d) contiguous
// in f32 or bf16. The arithmetic is the TPU kernel's, rounding for rounding:
//   qs = bf16(f32(q) * scale); s = qs.k^T in f32; a hidden pair scores -1e9
//   (here -inf: its exp is exactly 0 either way);
//   m = the row max, l = sum exp(s - m), p = exp(s - m) / l, p16 = bf16(p);
//   o = p16.v in f32, written in the output type.
// Backward: dp = dO.v^T, o = p16.v recomputed in f32, delta = rowsum(o * dO),
//   ds = bf16(p * (dp - delta)), dq = ds.k * scale, dk = ds^T.q * scale with
//   the UNSCALED bf16 q, dv = p16^T.dO, all accumulated in f32.
// Every product is bf16 x bf16 into f32: exactly mma.sync.m16n8k16's.
// Visibility is j <= i, or an int8 (n, n) table (causality in it, or not)
// with an int8 (nt, nt) map of the 64x64 tiles that hold a visible pair and,
// optionally, an int8 (nt,) flag per q tile that holds a row seeing nothing.
// Such a row has every score at -1e9 on the TPU, so its softmax is 1/n over
// all n keys, the keys above the diagonal included: its q tile visits every
// k tile, and the row takes m = 0 with hidden scores 0 and l = n. The forward
// writes it as m = -inf, l = n, which is how the backward kernels know it.
//
// Bound on the card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At the
// training main shape (b=8, h=14, n=512, d=128, bf16), with the causal half of
// the pairs (b*h*n*(n+1)/2 = 14.7M):
//   forward  2 products * 2*d flops per pair = 7.5 GFLOP   -> 7.6 us;
//            q, k, v read + o written = 4 * 14.7 MB = 59 MB  -> 17.6 us;
//   backward 6 products (s, o, dp, dq, dk, dv) = 22.6 GFLOP -> 23 us;
//            q, k, v, dO read + dq, dk, dv written = 103 MB  -> 31 us.
// Both are bound by bytes. chip_smoke.py recomputes these from its inputs.
//
// Design: the fused-boundary kernels' (csrc/fused_attention.cu), in a copy of
// their own over K8's layout (helpers in tc_tile.cuh):
//   * 64-row q and k tiles, bf16 in shared memory with a row stride of D + 8,
//     read by ldmatrix; they arrive by 16-byte cp.async, row by row through
//     each operand's strides, into a ring of two stages, so the next tile's
//     copy overlaps this tile's products. Shared memory does not depend on n;
//   * scores, p and dS stay in registers from one product into the next (the
//     C fragments of two n8 tiles are the A fragment of one k16 step);
//   * forward, one CTA of 4 warps per (64-row q tile, head, batch row), each
//     warp 16 rows; 68 KB of shared memory at d = 128, three CTAs an SM.
//     q's A fragments are loaded once and scaled in registers. Pass 1 streams
//     the k tiles for each row's max and sum (online over the tiles, quad
//     shuffles); pass 2 streams k and v, forms p = exp(s - m) / l with the
//     FINAL (m, l), rounds it to bf16 and accumulates p16.v. Two passes,
//     because the TPU kernel rounds p after dividing by the whole row's sum.
//     (m, l) are written, f32 (b, h, n), for the backward; without an output
//     pointer the kernel stops after pass 1 (the backward's own (m, l));
//   * dq, one CTA of 8 warps per q tile: warp w takes the 16 rows 16*(w % 4)
//     against half (w / 4) of each k tile's columns. Sweep 1 recomputes p and
//     o = p16.v in f32, adds o's two halves (fixed order) and forms
//     delta = rowsum(o * dO), written f32 (b, h, n). Sweep 2 forms
//     dp = dO.v^T and ds = bf16(p * (dp - delta)) and accumulates ds.k;
//     dq is scaled once, at the end;
//   * dk/dv, one CTA of 8 warps per k tile with k and v resident; q, dO and
//     the rows' (m, l, delta) stream through the ring. The transposed tile
//     (keys as rows) keeps P^T and dS^T in registers as A operands;
//     s^T = k.qs^T scales q's B fragments in registers, dk = ds^T.q takes the
//     unscaled q; the two column halves are added in a fixed order;
//   * the heaviest tiles launch first: the last q tiles, the first k tiles.
//     Without a table, tiles wholly above the diagonal are never read and the
//     element test runs only on the diagonal tile and the ragged last q tile;
//     with one, a q tile visits the tiles its map row marks (all of them when
//     it holds a row that sees nothing) and reads the table once per element.
// No atomics, and every sum in a fixed order: repeated runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kFwdThreads = 128;     // four warps, 16 rows of the q tile each
constexpr int kBwdThreads = 256;     // eight warps: 4 row blocks x 2 column halves

enum DType { kF32 = 0, kBF16 = 1 };

struct Strides {  // elements between batch rows, heads and positions
  long long b, h, n;
};

template <int D> __host__ __device__ constexpr int tile_elems() { return kTile * (D + 8); }
// two stages of k and of v (q lands in v's first stage, which pass 1 leaves free)
template <int D> constexpr int fwd_smem() { return 4 * tile_elems<D>() * 2; }
// q, dO + two stages of (k, v) + the rows' delta
template <int D> constexpr int dq_smem() { return 6 * tile_elems<D>() * 2 + kTile * 4; }
// k, v + two stages of (q, dO) and of the rows' (m, l, delta)
template <int D> constexpr int dkv_smem() { return 6 * tile_elems<D>() * 2 + 2 * 3 * kTile * 4; }

// rows [0, rows) of a 64-row tile of an operand (row stride ld elements,
// below 2^25: the wrapper copies any other layout, so 32-bit offsets do)
// into a shared bf16 tile of row stride D + 8 by 16-byte cp.async; the rows
// from `rows` on are zero (the caller commits and waits)
template <int D, int kThr>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld, int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThr) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = r < rows;
    tc::cp_async16(dst + r * (D + 8) + c * 8, src + (ok ? r * ld + c * 8 : 0), ok);
  }
}

// the (m, l, delta) rows [row0, row0 + 64) of (b, h, n) f32 into dst[0:64],
// dst[64:128], dst[128:192] by 4-byte cp.async; 0 past n
__device__ __forceinline__ void load_stats(float* dst, const float* m, const float* l,
                                           const float* delta, int row0, int n) {
  const int t = threadIdx.x;
  if (t < 3 * kTile) {
    const float* src = t < kTile ? m : (t < 2 * kTile ? l : delta);
    const int pos = row0 + (t & (kTile - 1));
    const bool ok = pos < n;
    tc::cp_async4(dst + t, src + (ok ? pos : 0), ok);
  }
}

template <typename T> __device__ __forceinline__ void store_pair(T* dst, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// this lane's part of rows `row` and row + 8 of a 16-row accumulator, times
// `mul`, into the contiguous (., D) rows of `dst`; rows at or past n are not
// written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int row, int n, const float (&acc)[D / 8][4],
                                           float mul, int t4) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= n) continue;
    T* out = dst + static_cast<size_t>(r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store_pair<T>(out + dn * 8, acc[dn][2 * hr] * mul, acc[dn][2 * hr + 1] * mul);
  }
}

// a (q tile, k tile) pair that needs no element test: no table, the k tile
// wholly before the q tile, and every query row inside n
__device__ __forceinline__ bool all_visible(const int8_t* table, int n, int q0, int k0) {
  return table == nullptr && k0 + kTile <= q0 && q0 + kTile <= n;
}

__device__ __forceinline__ bool visible(const int8_t* table, int n, int i, int j) {
  if (i >= n || j >= n) return false;
  return table != nullptr ? table[static_cast<size_t>(i) * n + j] != 0 : j <= i;
}

// hide what query `row` (+ 8) may not see of key col0 + 8j + 2*t4 (+ 1) in
// this lane's elements of a 16 x 8*NJ block of scores: a key past n scores
// -inf, a hidden one below n scores its row's fill, fill[0] (fill[8]): -inf,
// or 0 for a row that sees nothing (with m = 0 and l = n its p is 1/n at
// every key). The fills live in shared memory: they are read only where the
// element test runs, and registers are the kernels' scarcest resource
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&s)[NJ][4], const int8_t* table, int n,
                                            int row, int col0, int t4, const float* fill) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + 8 * j + 2 * t4 + c;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (!visible(table, n, row + 8 * hr, col))
          s[j][2 * hr + c] = col < n ? fill[8 * hr] : -INFINITY;
    }
}

// the first k tile at or after kt, up to `last`, that q tile qt visits: each
// one without a map or when the q tile holds a row that sees nothing, else
// those the map marks used; last + 1 when there is none
__device__ __forceinline__ int next_k(const int8_t* tiles, const int8_t* empty, int nt, int qt,
                                      int kt, int last) {
  if (tiles != nullptr && (empty == nullptr || empty[qt] == 0))
    while (kt <= last && tiles[static_cast<size_t>(qt) * nt + kt] == 0) ++kt;
  return kt;
}

// the first q tile at or after qt that visits k tile kt; nt when there is none
__device__ __forceinline__ int next_q(const int8_t* tiles, const int8_t* empty, int nt, int kt,
                                      int qt) {
  if (tiles != nullptr)
    while (qt < nt && tiles[static_cast<size_t>(qt) * nt + kt] == 0 &&
           (empty == nullptr || empty[qt] == 0))
      ++qt;
  return qt;
}

// ---------------------------------------------------------------------------
// forward: grid (h, b, nt), the last q tiles first; 4 warps
// (three CTAs an SM: at most 168 registers a thread)
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kFwdThreads, 3)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           Strides sq, Strides sk, Strides sv, const int8_t* __restrict__ table,
           const int8_t* __restrict__ tiles, const int8_t* __restrict__ empty,
           OutT* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, int n,
           int heads, float scale) {
  constexpr int kLd = D + 8, kEl = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // two stages
  bf16* sV = sK + 2 * kEl;                    // two stages
  // q is read once, at step 0, whose copies go to stage 1; v's stage 0 is
  // first written at step 1, after every warp has passed step 0's barrier
  bf16* sQ = sV;
  __shared__ float sFill[kTile];              // each row's hidden score

  const int nt = gridDim.z;
  const int qt = nt - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const bf16* qb = q + bb * sq.b + hh * sq.h;
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;
  const int q0 = qt * kTile;
  const int last = tiles == nullptr ? qt : nt - 1;   // the last k tile a q tile may visit
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int row = q0 + warp * 16 + (lane >> 2);   // this lane's rows: row and row + 8
  const size_t stat = (static_cast<size_t>(bb) * heads + hh) * n;
  if (threadIdx.x < kTile) sFill[threadIdx.x] = -INFINITY;

  int kt = next_k(tiles, empty, nt, qt, 0, last);
  load_tile<D, kFwdThreads>(sQ, qb + q0 * sq.n, sq.n, min(kTile, n - q0));
  load_tile<D, kFwdThreads>(sK, kb + kt * kTile * sk.n, sk.n, min(kTile, n - kt * kTile));
  tc::cp_async_commit();

  uint32_t qf[D / 16][4];           // bf16(f32(q) * scale), loaded once
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};          // pass 1: this lane's share of the row sums
  float acc[D / 8][4];
  tc::zero(acc);
  bool pass2 = false;
  for (int step = 0;; ++step) {
    const int stage = step & 1;
    // the next step: the next k tile of this pass, or after pass 1's last
    // tile the first of pass 2 (none without an output)
    int nkt = next_k(tiles, empty, nt, qt, kt + 1, last);
    bool npass2 = pass2;
    if (nkt > last && !pass2) {
      npass2 = true;
      nkt = next_k(tiles, empty, nt, qt, 0, last);
    }
    const bool more = nkt <= last && (out != nullptr || !npass2);
    tc::cp_async_wait<0>();
    __syncthreads();    // this step's tiles have landed, every warp is done with the last step's
    if (step == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        tc::ldsm_x4(qf[kd], tc::a_addr(sQ, kLd, warp * 16, kd * 16, lane));
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kd][e] = tc::scale_bf16x2(qf[kd][e], scale);
      }
    }
    if (more) {
      const int k1 = nkt * kTile, rows = min(kTile, n - k1);
      load_tile<D, kFwdThreads>(sK + (stage ^ 1) * kEl, kb + k1 * sk.n, sk.n, rows);
      if (npass2) load_tile<D, kFwdThreads>(sV + (stage ^ 1) * kEl, vb + k1 * sv.n, sv.n, rows);
    }
    tc::cp_async_commit();

    const int k0 = kt * kTile;
    const bf16* cK = sK + stage * kEl;
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
    if (!all_visible(table, n, q0, k0)) mask_scores(s, table, n, row, k0, t4, sFill + row - q0);

    if (!pass2) {
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
          for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * hr] - m_new) + expf(s[j][2 * hr + 1] - m_new);
          l[hr] = l[hr] * corr + sum;
          m[hr] = m_new;
        }
      }
      if (npass2) {       // pass 1 is done: each row's (m, l)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l[hr] = tc::quad_sum(l[hr]);
          const int r = row + 8 * hr;
          const bool seen = m[hr] != -INFINITY;
          if (!seen && r < n) {       // a row that sees nothing: p = 1/n at every key
            l[hr] = static_cast<float>(n);
            // read again after the next step's barrier; every lane of the
            // quad has passed this step's reads (the shuffles above)
            if (t4 == 0) sFill[r - q0] = 0.f;
          }
          if (r < n && t4 == 0) {
            m_out[stat + r] = m[hr];
            l_out[stat + r] = l[hr];
          }
          if (!seen) {
            m[hr] = 0.f;
            if (r >= n) l[hr] = 1.f;  // a row past n
          }
        }
      }
    } else {
      // p = exp(s - m) / l in f32 with the final (m, l); dot_pv rounds it
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
      tc::dot_pv<D, 8>(acc, s, sV + stage * kEl, 0, lane);
    }
    if (!more) break;
    kt = nkt;
    pass2 = npass2;
  }
  if (out != nullptr) store_rows<OutT, D>(out + stat * D, row, n, acc, 1.f, t4);
}

// ---------------------------------------------------------------------------
// backward (a): delta and dq; grid (h, b, nt), the last q tiles first; 8 warps
// (two CTAs an SM: at most 128 registers a thread)
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, Strides sq, Strides sk, Strides sv, Strides sd,
          const int8_t* __restrict__ table, const int8_t* __restrict__ tiles,
          const int8_t* __restrict__ empty, const float* __restrict__ m_in,
          const float* __restrict__ l_in, float* __restrict__ delta_out, OutT* __restrict__ dq,
          int n, int heads, float scale) {
  constexpr int kLd = D + 8, kEl = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kEl;
  bf16* sKV = sdO + kEl;            // two stages of [k, v]
  float* sDelta = reinterpret_cast<float*>(sKV + 4 * kEl);
  __shared__ float sFill[kTile];    // each row's hidden score

  const int nt = gridDim.z;
  const int qt = nt - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;
  const int q0 = qt * kTile;
  const int last = tiles == nullptr ? qt : nt - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // rows, key columns
  const int row = q0 + wr + (lane >> 2);
  const size_t stat = (static_cast<size_t>(bb) * heads + hh) * n;

  int kt = next_k(tiles, empty, nt, qt, 0, last);
  load_tile<D, kBwdThreads>(sQ, q + bb * sq.b + hh * sq.h + q0 * sq.n, sq.n, min(kTile, n - q0));
  load_tile<D, kBwdThreads>(sdO, dout + bb * sd.b + hh * sd.h + q0 * sd.n, sd.n,
                            min(kTile, n - q0));
  load_tile<D, kBwdThreads>(sKV, kb + kt * kTile * sk.n, sk.n, min(kTile, n - kt * kTile));
  load_tile<D, kBwdThreads>(sKV + kEl, vb + kt * kTile * sv.n, sv.n, min(kTile, n - kt * kTile));
  tc::cp_async_commit();

  float m[2], l[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    m[hr] = r < n ? m_in[stat + r] : 0.f;
    l[hr] = r < n ? l_in[stat + r] : 1.f;
    const bool blind = m[hr] == -INFINITY;   // a row that sees nothing (l = n): p = 1/n
    if (blind) m[hr] = 0.f;
    if (warp < 4 && t4 == 0) sFill[r - q0] = blind ? 0.f : -INFINITY;   // read after a barrier
  }
  float acc[D / 8][4];              // sweep 1: o; sweep 2: dq
  tc::zero(acc);
  bool sweep2 = false;
  for (int step = 0;; ++step) {
    const int stage = step & 1;
    int nkt = next_k(tiles, empty, nt, qt, kt + 1, last);
    bool nsweep2 = sweep2;
    if (nkt > last && !sweep2) {
      nsweep2 = true;
      nkt = next_k(tiles, empty, nt, qt, 0, last);
    }
    const bool more = nkt <= last;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (step == 0) {      // qs = bf16(f32(q) * scale), in place
      for (int idx = threadIdx.x; idx < kTile * D / 8; idx += kBwdThreads) {
        uint4* p = reinterpret_cast<uint4*>(sQ + (idx / (D / 8)) * kLd + (idx % (D / 8)) * 8);
        uint4 x = *p;
        x.x = tc::scale_bf16x2(x.x, scale);
        x.y = tc::scale_bf16x2(x.y, scale);
        x.z = tc::scale_bf16x2(x.z, scale);
        x.w = tc::scale_bf16x2(x.w, scale);
        *p = x;
      }
      __syncthreads();
    }
    if (more) {
      const int k1 = nkt * kTile, rows = min(kTile, n - k1);
      bf16* next = sKV + (stage ^ 1) * 2 * kEl;
      load_tile<D, kBwdThreads>(next, kb + k1 * sk.n, sk.n, rows);
      load_tile<D, kBwdThreads>(next + kEl, vb + k1 * sv.n, sv.n, rows);
    }
    tc::cp_async_commit();

    const int k0 = kt * kTile;
    bf16* cK = sKV + stage * 2 * kEl;
    const bf16* cV = cK + kEl;
    float s[4][4];
    tc::zero(s);
    tc::dot_nt<D, 4>(s, sQ, wr, cK, wc, lane);
    if (!all_visible(table, n, q0, k0))
      mask_scores(s, table, n, row, k0 + wc, t4, sFill + row - q0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];   // p

    if (!sweep2) {
      tc::dot_pv<D, 4>(acc, s, cV, wc, lane);      // o += p16 . v
      if (nsweep2) {
        // sweep 1 is done. This stage's k and v are read by every warp:
        // they hold the sum of o's two halves
        __syncthreads();
        tc::reduce_halves<D>(acc, reinterpret_cast<float*>(cK), warp, lane);
        if (warp < 4) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = wr + (lane >> 2) + 8 * hr;
            float d = 0.f;
#pragma unroll
            for (int dn = 0; dn < D / 8; ++dn) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(sdO + r * kLd + dn * 8 + 2 * t4));
              d += acc[dn][2 * hr] * f.x + acc[dn][2 * hr + 1] * f.y;
            }
            d = tc::quad_sum(d);
            if (t4 == 0) {
              sDelta[r] = d;
              if (q0 + r < n) delta_out[stat + q0 + r] = d;
            }
          }
        }
        __syncthreads();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) delta[hr] = sDelta[wr + (lane >> 2) + 8 * hr];
        tc::zero(acc);
      }
    } else {
      float dp[4][4];
      tc::zero(dp);
      tc::dot_nt<D, 4>(dp, sdO, wr, cV, wc, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - delta[e >> 1];   // dS
      tc::dot_pv<D, 4>(acc, s, cK, wc, lane);      // dq += bf16(dS) . k
    }
    if (!more) break;
    kt = nkt;
    sweep2 = nsweep2;
  }
  __syncthreads();                  // the ring is free: it holds the sum of the halves
  tc::reduce_halves<D>(acc, reinterpret_cast<float*>(sKV), warp, lane);
  if (warp < 4) store_rows<OutT, D>(dq + stat * D, row, n, acc, scale, t4);
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv; grid (h, b, nt) over k tiles, the first k tiles
// first (under causality they meet the most q tiles); 8 warps, each 16 key
// rows of the resident tile against half of each streamed q tile
// (at d <= 64, two CTAs an SM: at most 128 registers a thread)
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kBwdThreads, D <= 64 ? 2 : 1)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, Strides sq, Strides sk, Strides sv, Strides sd,
           const int8_t* __restrict__ table, const int8_t* __restrict__ tiles,
           const int8_t* __restrict__ empty, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ delta_in,
           OutT* __restrict__ dk_out, OutT* __restrict__ dv_out, int n, int heads, float scale) {
  constexpr int kEl = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kEl;
  bf16* sQD = sV + kEl;             // two stages of [q, dO]
  float* sStat = reinterpret_cast<float*>(sQD + 4 * kEl);   // two stages of [m, l, delta]

  const int nt = gridDim.z;
  const int kt = blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const bf16* qb = q + bb * sq.b + hh * sq.h;
  const bf16* db = dout + bb * sd.b + hh * sd.h;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // key rows, query columns
  const int key = k0 + wr + (lane >> 2);                   // this lane's keys: key, key + 8
  const size_t stat = (static_cast<size_t>(bb) * heads + hh) * n;

  // without a table the q tiles from the diagonal on; with one, any q tile
  int qt = next_q(tiles, empty, nt, kt, tiles == nullptr ? kt : 0);
  load_tile<D, kBwdThreads>(sK, k + bb * sk.b + hh * sk.h + k0 * sk.n, sk.n, min(kTile, n - k0));
  load_tile<D, kBwdThreads>(sV, v + bb * sv.b + hh * sv.h + k0 * sv.n, sv.n, min(kTile, n - k0));
  if (qt < nt) {
    const int rows = min(kTile, n - qt * kTile);
    load_tile<D, kBwdThreads>(sQD, qb + qt * kTile * sq.n, sq.n, rows);
    load_tile<D, kBwdThreads>(sQD + kEl, db + qt * kTile * sd.n, sd.n, rows);
    load_stats(sStat, m_in + stat, l_in + stat, delta_in + stat, qt * kTile, n);
  }
  tc::cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  tc::zero(dk);
  tc::zero(dv);
  // no q tile sees these keys: their gradients stay 0
  for (int step = 0; qt < nt; ++step) {
    const int stage = step & 1;
    const int nqt = next_q(tiles, empty, nt, kt, qt + 1);
    const bool more = nqt < nt;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (more) {
      const int r1 = nqt * kTile, rows = min(kTile, n - r1);
      bf16* next = sQD + (stage ^ 1) * 2 * kEl;
      load_tile<D, kBwdThreads>(next, qb + r1 * sq.n, sq.n, rows);
      load_tile<D, kBwdThreads>(next + kEl, db + r1 * sd.n, sd.n, rows);
      load_stats(sStat + (stage ^ 1) * 3 * kTile, m_in + stat, l_in + stat, delta_in + stat,
                 r1, n);
    }
    tc::cp_async_commit();

    const int q0 = qt * kTile;
    const bf16* cQ = sQD + stage * 2 * kEl;
    const bf16* cdO = cQ + kEl;
    const float* cSt = sStat + stage * 3 * kTile;
    float s[4][4], dp[4][4];
    tc::zero(s);
    tc::zero(dp);
    tc::dot_nt<D, 4, true>(s, sK, wr, cQ, wc, lane, scale);   // s^T = k . qs^T
    tc::dot_nt<D, 4>(dp, sV, wr, cdO, wc, lane);              // dp^T = v . dO^T
    const bool all = all_visible(table, n, q0, k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = wc + 8 * j + 2 * t4 + c;
        const float mq = cSt[col], lq = cSt[kTile + col], dq = cSt[2 * kTile + col];
        // a query that sees nothing (m = -inf, l = n): p = 1/n at every key below n
        const bool blind = mq == -INFINITY;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + c;
          const bool vis = all || visible(table, n, q0 + col, key + 8 * hr);
          const float p = vis ? expf(s[j][e] - mq) / lq
                              : (blind && key + 8 * hr < n ? 1.f / lq : 0.f);
          s[j][e] = p;                               // P^T
          dp[j][e] = p * (dp[j][e] - dq);            // dS^T
        }
      }
    tc::dot_pv<D, 4>(dv, s, cdO, wc, lane);    // dv += bf16(P^T) . dO
    tc::dot_pv<D, 4>(dk, dp, cQ, wc, lane);    // dk += bf16(dS^T) . q, unscaled
    if (!more) break;
    qt = nqt;
  }
  tc::cp_async_wait<0>();
  __syncthreads();                  // the ring is free: it holds the sums of the halves
  float* red = reinterpret_cast<float*>(sQD);
  tc::reduce_halves<D>(dk, red, warp, lane);
  tc::reduce_halves<D>(dv, red + kTile * D, warp, lane);
  if (warp < 4) {
    store_rows<OutT, D>(dk_out + stat * D, key, n, dk, scale, t4);
    store_rows<OutT, D>(dv_out + stat * D, key, n, dv, 1.f, t4);
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename OutT, int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const long long* st,
               const int8_t* table, const int8_t* tiles, const int8_t* empty, void* out,
               float* m, float* l, int b, int h, int n, float scale, cudaStream_t stream) {
  auto kernel = fwd_kernel<OutT, D>;
  constexpr int kSmem = fwd_smem<D>();
  cudaError_t err = set_smem(kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tile index slowest, so that every (head, batch row) starts its
  // heaviest tiles first
  const dim3 grid(h, b, (n + kTile - 1) / kTile);
  kernel<<<grid, kFwdThreads, kSmem, stream>>>(
      q, k, v, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, table, tiles, empty, static_cast<OutT*>(out), m, l, n, h,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int D>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const long long* st, const int8_t* table, const int8_t* tiles,
               const int8_t* empty, const float* m, const float* l, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int n, float scale, cudaStream_t stream) {
  auto dq_k = dq_kernel<OutT, D>;
  auto dkv_k = dkv_kernel<OutT, D>;
  constexpr int kSmemDq = dq_smem<D>();
  constexpr int kSmemDkv = dkv_smem<D>();
  cudaError_t err = set_smem(dq_k, kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem(dkv_k, kSmemDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sd{st[9], st[10], st[11]};
  const dim3 grid(h, b, (n + kTile - 1) / kTile);
  dq_k<<<grid, kBwdThreads, kSmemDq, stream>>>(q, k, v, dout, sq, sk, sv, sd, table, tiles, empty,
                                               m, l, delta, static_cast<OutT*>(dq), n, h, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_k<<<grid, kBwdThreads, kSmemDkv, stream>>>(q, k, v, dout, sq, sk, sv, sd, table, tiles,
                                                 empty, m, l, delta, static_cast<OutT*>(dk),
                                                 static_cast<OutT*>(dv), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}

#define PA_DISPATCH_D(FN, T, ...)                            \
  switch (d) {                                               \
    case 16: return FN<T, 16>(__VA_ARGS__);                  \
    case 32: return FN<T, 32>(__VA_ARGS__);                  \
    case 48: return FN<T, 48>(__VA_ARGS__);                  \
    case 64: return FN<T, 64>(__VA_ARGS__);                  \
    case 80: return FN<T, 80>(__VA_ARGS__);                  \
    case 96: return FN<T, 96>(__VA_ARGS__);                  \
    case 112: return FN<T, 112>(__VA_ARGS__);                \
    case 128: return FN<T, 128>(__VA_ARGS__);                \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// Forward. q, k, v bf16 (b, h, n, d) with `strides` = 3 (b, h, n) element
// strides per operand, in that order; out (b, h, n, d) contiguous of
// `out_dtype` (0 f32, 1 bf16), or null for the row statistics alone; m, l
// f32 (b, h, n). `table` (n, n) and `tiles` (nt, nt) int8 are both null
// (plain causal) or both set; `empty` (nt,) int8 may be null (no row of the
// table sees nothing). Returns a CUDA error code, 0 when the launch was
// accepted.
extern "C" int persist_fwd(const void* q, const void* k, const void* v, const long long* strides,
                           const int8_t* table, const int8_t* tiles, const int8_t* empty,
                           void* out, float* m, float* l, int out_dtype, int b, int h, int n,
                           int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  if (out_dtype == kF32) {
    PA_DISPATCH_D(launch_fwd, float, qq, kk, vv, strides, table, tiles, empty, out, m, l, b, h,
                  n, scale, s)
  }
  if (out_dtype == kBF16) {
    PA_DISPATCH_D(launch_fwd, bf16, qq, kk, vv, strides, table, tiles, empty, out, m, l, b, h,
                  n, scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward: two kernels on `stream`, dq (which writes delta, f32 (b, h, n)
// scratch) then dk/dv. q, k, v, dO bf16 with 4 x 3 strides; m, l from the
// forward; dq, dk, dv (b, h, n, d) contiguous of `out_dtype`.
extern "C" int persist_bwd(const void* q, const void* k, const void* v, const void* dout,
                           const long long* strides, const int8_t* table, const int8_t* tiles,
                           const int8_t* empty, const float* m, const float* l, float* delta,
                           void* dq, void* dk, void* dv, int out_dtype, int b, int h, int n, int d,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v), *oo = static_cast<const bf16*>(dout);
  if (out_dtype == kF32) {
    PA_DISPATCH_D(launch_bwd, float, qq, kk, vv, oo, strides, table, tiles, empty, m, l, delta,
                  dq, dk, dv, b, h, n, scale, s)
  }
  if (out_dtype == kBF16) {
    PA_DISPATCH_D(launch_bwd, bf16, qq, kk, vv, oo, strides, table, tiles, empty, m, l, delta,
                  dq, dk, dv, b, h, n, scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
