// Flash attention over one (q-chunk, k-chunk) pair at runtime global offsets,
// forward, dq and dk/dv, for Hopper (sm_90a): the inner step of
// sequence-parallel ring attention.
//
// Replaces dalle_tpu/ops/chunk_attention.py's three Pallas calls:
// chunk_flash_fwd (_chunk_fwd_kernel, pallas_call at :232), chunk_flash_dq
// (_chunk_dq_kernel, :264) and chunk_flash_dkv (_chunk_dkv_kernel, :293).
// The arithmetic is the TPU kernel's: q, k, v (and dO) are cast to f32 and q
// is scaled; scores, p and every product are f32; a hidden pair scores -1e9
// and, in the forward, its p is forced to 0 (s <= -5e8); the forward keeps a
// running max m, sum l and accumulator per row over the k tiles in order and
// writes o = acc / l and lse = m + log(l), both f32. A row with no visible
// key gets o = 0 and lse = -1e9, so the caller's logaddexp merge weights it
// 0 (the ring flips the final lse of such a row to +1e9 before the backward).
// Backward: p = exp(s - lse), dS = p * (dP - delta), dq = scale * dS.k;
// dk = dS^T.(scale * q), dv = p^T.dO; all outputs f32.
//
// Positions are global: query row i of the chunk sits at q_off + i, key
// column j at k_off + j. A pair is visible when the key lies inside its
// chunk and before n_valid, not after the query when causal, and passes the
// structured element test (axial row or column: the same image row or
// column, text keys always visible; conv window with dilation) computed on
// the global positions. Query rows past n_valid are computed like any other
// (the ring slices them off), as in the TPU kernel.
//
// Skipping: no host block lists. q_off, k_off and n_valid are runtime
// arguments, so one build serves every ring step; the bounds come from them
// in the kernel. The forward and dq visit k tiles [0, hi) of a q tile, hi
// bounded by n_valid and, causal, by the tile's last row (the TPU's
// _hi_blocks); dk/dv visits q tiles [lo, nq) of a k tile, lo the first q tile
// with a row at or after the tile's first key. Both use floor division: a
// chunk wholly in the future gives a negative operand, where C++'s `/` would
// round toward zero and visit one tile (harmless, masked, but not the TPU's
// zero-trip loop).
//
// Bound on the card (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense). At
// the long-sequence slice's pair (b=2, h=8, c=1088, d=64) on the diagonal,
// 9.5M pairs are visible: the forward's 4*d flops a pair are 2.4 GFLOP ->
// 2.5 us at the bf16 rate, its bytes (q, k, v bf16 in, o f32 and lse out)
// 11.2 MB -> 3.3 us, so a pair is bound by bytes, about evenly with
// operations; a pair wholly before the diagonal has twice the pairs and is
// bound by operations. chip_smoke.py recomputes the bounds from its inputs.
//
// Design (first version, K4's: simple, exact, deterministic, no atomics).
// The TPU kernel computes in f32, so this one does too, with FMA on the CUDA
// cores (67 TFLOP/s f32, ~1/15 of the bf16 tensor rate the bound assumes):
//   * one CTA of 256 threads per (64-row tile, head, batch row); thread
//     (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i and columns
//     tx + 16*j (i, j < 4) of each 64x64 score tile; row reductions are 4
//     shuffles in a half-warp;
//   * tiles live in shared memory as f32, row stride d + 1; the score tile
//     p (or dS) is staged there for the second product;
//   * the tile is 64 rows whatever the ring's `block` (the TPU's tiling
//     rule); the ragged edge of a chunk is masked here;
//   * operands are read through their (b, h, n) strides (the zigzag ring
//     hands sub-chunk views of its rotating k and v); lse and delta through
//     their (b, h) strides; outputs are written contiguous.
// No tensor cores, no TMA or cp.async staging, no pipelining: later work
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // query and key rows per tile
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 16;   // score tile row stride: the two half-warps hit other banks
constexpr float kNegInf = -1e9f;

enum DType { kF32 = 0, kBF16 = 1 };
enum MaskKind { kNone = 0, kAxialRow = 1, kAxialCol = 2, kConv = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Mask {
  int kind, text_len, fmap, span, dil;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long st[4][3];       // (b, h, n) strides in elements of q, k, v, dout
  const float* lse_in;      // (b, h, cq) f32, dense along cq
  const float* delta;
  long long sst[2][2];      // (b, h) strides of lse_in and delta
  float* out0;              // o | dq | dk, (b, h, c, d) f32
  float* out1;              // dv
  float* lse_out;           // (b, h, cq) f32
  Mask mk;
  int q_off, k_off, n_valid, causal;
  int cq, ck, heads;
  float scale;
};

// a global position and, inside the image, its grid row and column
struct Pos {
  int p, r, c;
};

__device__ __forceinline__ Pos pos_info(const Mask& mk, int p) {
  Pos o{p, 0, 0};
  if (mk.kind != kNone && p >= mk.text_len) {
    const int i = p - mk.text_len;
    o.r = i / mk.fmap;
    o.c = i - o.r * mk.fmap;
  }
  return o;
}

// key `kl` (local index) at global position k.p, query at q.p
__device__ __forceinline__ bool visible(const Params& p, const Pos& q, const Pos& k, int kl) {
  if (kl >= p.ck || k.p >= p.n_valid) return false;
  if (p.causal && k.p > q.p) return false;
  const Mask& mk = p.mk;
  if (mk.kind == kNone) return true;
  if (k.p < mk.text_len) return true;
  if (q.p < mk.text_len) return false;
  if (mk.kind == kAxialRow) return q.r == k.r;
  if (mk.kind == kAxialCol) return q.c == k.c;
  const int dr = q.r - k.r, dc = q.c - k.c;
  if (dr < 0 || dr > mk.span || dc < 0 || dc > mk.span) return false;
  return mk.dil == 1 || (dr % mk.dil == 0 && dc % mk.dil == 0);
}

// rows [row0, row0 + 64) of one (b, h) slice (row stride sn, dense along d)
// into an f32 shared tile of row stride D + 1, times `mul`; rows at or past
// n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sn, int row0,
                                          int n, float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int p = row0 + r;
    dst[r * (D + 1) + c] = p < n ? to_f32<T>(src[static_cast<long long>(p) * sn + c]) * mul : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, const long long* st, int bb, int hh) {
  return static_cast<const T*>(base) + bb * st[0] + hh * st[1];
}

__device__ __forceinline__ const float* stat_row(const float* base, const long long* st, int bb,
                                                 int hh) {
  return base + bb * st[0] + hh * st[1];
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = A[ty + 16i] . B[tx + 16j] over D, both f32 tiles of row stride D + 1
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B, int ty,
                                         int tx) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kLd + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// k tiles [0, hi) that q tile `qt` visits (the TPU's _hi_blocks)
__device__ __forceinline__ int hi_tiles(const Params& p, int qt) {
  const int nk = (p.ck + kTile - 1) / kTile;
  int hi = floor_div(p.n_valid - p.k_off + kTile - 1, kTile);
  if (p.causal) hi = min(hi, floor_div(p.q_off + (qt + 1) * kTile - 1 - p.k_off, kTile) + 1);
  return max(0, min(hi, nk));
}

// the first q tile that k tile `kt` visits
__device__ __forceinline__ int lo_tiles(const Params& p, int kt) {
  if (!p.causal) return 0;
  const int nq = (p.cq + kTile - 1) / kTile;
  return max(0, min(floor_div(p.k_off + kt * kTile - p.q_off, kTile), nq));
}

template <int D> __host__ __device__ constexpr int tile_floats() { return kTile * (D + 1); }
constexpr int kScoreFloats = kTile * kLdP;

template <int D> constexpr int fwd_smem() { return (3 * tile_floats<D>() + kScoreFloats) * 4; }
template <int D> constexpr int dq_smem() { return (4 * tile_floats<D>() + kScoreFloats) * 4; }
template <int D> constexpr int dkv_smem() {
  return (4 * tile_floats<D>() + 2 * kScoreFloats + 2 * kTile) * 4;
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, h, b); o and lse
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kC = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sP = sV + tile_floats<D>();

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = slice<T>(p.k, p.st[1], bb, hh);
  const T* v = slice<T>(p.v, p.st[2], bb, hh);

  load_tile<T, D>(sQ, slice<T>(p.q, p.st[0], bb, hh), p.st[0][2], qt * kTile, p.cq, p.scale);
  Pos qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = pos_info(p.mk, p.q_off + qt * kTile + ty + 16 * i);

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int hi = hi_tiles(p, qt);
  for (int t = 0; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, p.st[1][2], k0, p.ck, 1.f);
    load_tile<T, D>(sV, v, p.st[2][2], k0, p.ck, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    Pos kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, p.k_off + k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(p, qp[i], kp[j], k0 + tx + 16 * j)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = e;
        sum += e;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], vv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + r];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = sV[r * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    if (row >= p.cq) continue;
    const size_t at = (static_cast<size_t>(bb) * p.heads + hh) * p.cq + row;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) p.out0[at * D + tx + 16 * c] = acc[i][c] / safe_l;
    if (tx == 0) p.lse_out[at] = l[i] > 0.f ? m[i] + logf(safe_l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// dq: grid (q tiles, h, b)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + tile_floats<D>();
  float* sK = sdO + tile_floats<D>();
  float* sV = sK + tile_floats<D>();
  float* sdS = sV + tile_floats<D>();

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = slice<T>(p.k, p.st[1], bb, hh);
  const T* v = slice<T>(p.v, p.st[2], bb, hh);
  const float* lse_row = stat_row(p.lse_in, p.sst[0], bb, hh);
  const float* delta_row = stat_row(p.delta, p.sst[1], bb, hh);

  load_tile<T, D>(sQ, slice<T>(p.q, p.st[0], bb, hh), p.st[0][2], qt * kTile, p.cq, p.scale);
  load_tile<T, D>(sdO, slice<T>(p.dout, p.st[3], bb, hh), p.st[3][2], qt * kTile, p.cq, 1.f);
  Pos qp[4];
  float lse[4], delta[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    qp[i] = pos_info(p.mk, p.q_off + row);
    lse[i] = row < p.cq ? lse_row[row] : 0.f;
    delta[i] = row < p.cq ? delta_row[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int hi = hi_tiles(p, qt);
  for (int t = 0; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, p.st[1][2], k0, p.ck, 1.f);
    load_tile<T, D>(sV, v, p.st[2][2], k0, p.ck, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    Pos kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, p.k_off + k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = visible(p, qp[i], kp[j], k0 + tx + 16 * j) ? s[i][j] : kNegInf;
        const float pr = expf(sv - lse[i]);
        sdS[(ty + 16 * i) * kLdP + tx + 16 * j] = pr * (dp[i][j] - delta[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float ds[4], kv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty + 16 * i) * kLdP + r];
#pragma unroll
      for (int c = 0; c < kC; ++c) kv[c] = sK[r * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

  const size_t stat0 = (static_cast<size_t>(bb) * p.heads + hh) * p.cq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    if (row >= p.cq) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) p.out0[(stat0 + row) * D + tx + 16 * c] = acc[i][c] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (k tiles, h, b)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + tile_floats<D>();
  float* sQ = sV + tile_floats<D>();
  float* sdO = sQ + tile_floats<D>();
  float* sP = sdO + tile_floats<D>();
  float* sdS = sP + kScoreFloats;
  float* sLse = sdS + kScoreFloats;
  float* sDelta = sLse + kTile;

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;
  const T* q = slice<T>(p.q, p.st[0], bb, hh);
  const T* dout = slice<T>(p.dout, p.st[3], bb, hh);
  const float* lse_row = stat_row(p.lse_in, p.sst[0], bb, hh);
  const float* delta_row = stat_row(p.delta, p.sst[1], bb, hh);

  load_tile<T, D>(sK, slice<T>(p.k, p.st[1], bb, hh), p.st[1][2], k0, p.ck, 1.f);
  load_tile<T, D>(sV, slice<T>(p.v, p.st[2], bb, hh), p.st[2][2], k0, p.ck, 1.f);
  // the score tile's key columns tx + 16j are this CTA's keys
  Pos kp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, p.k_off + k0 + tx + 16 * j);
  // the accumulators' rows ty + 16i are keys, columns tx + 16c
  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (p.cq + kTile - 1) / kTile;
  for (int t = lo_tiles(p, kt); t < nq; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q, p.st[0][2], q0, p.cq, p.scale);
    load_tile<T, D>(sdO, dout, p.st[3][2], q0, p.cq, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.cq ? lse_row[row] : 0.f;
      sDelta[threadIdx.x] = row < p.cq ? delta_row[row] : 0.f;
    }
    __syncthreads();
    // the (query, key) tile: rows ty + 16i are queries, columns tx + 16j keys
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const Pos qp = pos_info(p.mk, p.q_off + q0 + r);
      const bool live = q0 + r < p.cq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = visible(p, qp, kp[j], k0 + tx + 16 * j) ? s[i][j] : kNegInf;
        // a row past the chunk has zero q and dO; keep its p out of dv
        const float pr = live ? expf(sv - sLse[r]) : 0.f;
        sP[r * kLdP + tx + 16 * j] = pr;
        sdS[r * kLdP + tx + 16 * j] = pr * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    // dv[key] += p[query][key] * dO[query]; dk[key] += dS[query][key] * q[query]
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pr[4], ds[4], g[kC], qv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sP[r * kLdP + ty + 16 * i];
        ds[i] = sdS[r * kLdP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        g[c] = sdO[r * kLd + tx + 16 * c];
        qv[c] = sQ[r * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dv[i][c] = fmaf(pr[i], g[c], dv[i][c]);
          dk[i][c] = fmaf(ds[i], qv[c], dk[i][c]);
        }
    }
  }

  const size_t stat0 = (static_cast<size_t>(bb) * p.heads + hh) * p.ck;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.ck) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const size_t at = (stat0 + row) * D + tx + 16 * c;
      p.out0[at] = dk[i][c];
      p.out1[at] = dv[i][c];
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(int which, const Params& p, int b, cudaStream_t stream) {
  void (*kernel)(const Params);
  int smem, rows;
  if (which == kFwd) {
    kernel = fwd_kernel<T, D>;
    smem = fwd_smem<D>();
    rows = p.cq;
  } else if (which == kDq) {
    kernel = dq_kernel<T, D>;
    smem = dq_smem<D>();
    rows = p.cq;
  } else {
    kernel = dkv_kernel<T, D>;
    smem = dkv_smem<D>();
    rows = p.ck;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + kTile - 1) / kTile, p.heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int which, const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(which, p, b, stream);
    case 32: return launch<T, 32>(which, p, b, stream);
    case 64: return launch<T, 64>(which, p, b, stream);
    case 128: return launch<T, 128>(which, p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int which, const void* q, const void* k, const void* v, const void* dout, int dtype,
        const long long* strides, const float* lse_in, const float* delta,
        const long long* stat_strides, int q_off, int k_off, int n_valid, int causal, int kind,
        const int* spec, float* out0, float* out1, float* lse_out, int b, int h, int cq, int ck,
        int d, float scale, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  const int operands = which == kFwd ? 3 : 4;
  for (int o = 0; o < operands; ++o)
    for (int s = 0; s < 3; ++s) p.st[o][s] = strides[3 * o + s];
  p.lse_in = lse_in;
  p.delta = delta;
  if (which != kFwd)
    for (int o = 0; o < 2; ++o)
      for (int s = 0; s < 2; ++s) p.sst[o][s] = stat_strides[2 * o + s];
  p.out0 = out0;
  p.out1 = out1;
  p.lse_out = lse_out;
  // spec: text_len, fmap, kernel, dilation (conv); text_len, fmap (axial)
  p.mk = Mask{kind, spec[0], spec[1] > 0 ? spec[1] : 1, (spec[2] - 1) * spec[3],
              spec[3] > 0 ? spec[3] : 1};
  p.q_off = q_off;
  p.k_off = k_off;
  p.n_valid = n_valid;
  p.causal = causal;
  p.cq = cq;
  p.ck = ck;
  p.heads = h;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(which, p, b, d, s);
  if (dtype == kBF16) return dispatch_d<bf16>(which, p, b, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Forward over one pair. q (b, h, cq, d), k and v (b, h, ck, d) of `dtype`
// (0 f32, 1 bf16), dense along d, with (b, h, n) strides in `strides` (9
// values, host); the chunks' global offsets `q_off`, `k_off`, the true
// sequence length `n_valid`, causality, and the element test `kind` (0 none,
// 1 axial row, 2 axial column, 3 conv) with `spec` (4 values, host). Writes o
// (b, h, cq, d) and lse (b, h, cq), both f32 contiguous. Returns a CUDA error
// code, 0 when the launch was accepted.
extern "C" int chunk_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                                   const long long* strides, int q_off, int k_off, int n_valid,
                                   int causal, int kind, const int* spec, float* o, float* lse,
                                   int b, int h, int cq, int ck, int d, float scale,
                                   void* stream) {
  return run(kFwd, q, k, v, nullptr, dtype, strides, nullptr, nullptr, nullptr, q_off, k_off,
             n_valid, causal, kind, spec, o, nullptr, lse, b, h, cq, ck, d, scale, stream);
}

// The pair's dq (b, h, cq, d) f32 from q, k, v, dout (strides: 12 values),
// lse and delta = rowsum(dout * o), both (b, h, cq) f32 dense along cq with
// (b, h) strides in `stat_strides` (4 values, host). `unused` keeps the
// signature of chunk_attention_dkv.
extern "C" int chunk_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                  int dtype, const long long* strides, const float* lse,
                                  const float* delta, const long long* stat_strides, int q_off,
                                  int k_off, int n_valid, int causal, int kind, const int* spec,
                                  float* dq, float* unused, int b, int h, int cq, int ck, int d,
                                  float scale, void* stream) {
  (void)unused;
  return run(kDq, q, k, v, dout, dtype, strides, lse, delta, stat_strides, q_off, k_off,
             n_valid, causal, kind, spec, dq, nullptr, nullptr, b, h, cq, ck, d, scale, stream);
}

// The held k chunk's dk, dv (b, h, ck, d) f32 from the q chunk, as
// chunk_attention_dq.
extern "C" int chunk_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   int dtype, const long long* strides, const float* lse,
                                   const float* delta, const long long* stat_strides, int q_off,
                                   int k_off, int n_valid, int causal, int kind, const int* spec,
                                   float* dk, float* dv, int b, int h, int cq, int ck, int d,
                                   float scale, void* stream) {
  return run(kDkv, q, k, v, dout, dtype, strides, lse, delta, stat_strides, q_off, k_off,
             n_valid, causal, kind, spec, dk, dv, nullptr, b, h, cq, ck, d, scale, stream);
}
