// Flash attention over one (q-chunk, k-chunk) pair at runtime global offsets,
// forward, dq and dk/dv, for Hopper (sm_90a): the inner step of
// sequence-parallel ring attention.
//
// Replaces dalle_tpu/ops/chunk_attention.py's three Pallas calls:
// chunk_flash_fwd (_chunk_fwd_kernel, pallas_call at :232), chunk_flash_dq
// (_chunk_dq_kernel, :264) and chunk_flash_dkv (_chunk_dkv_kernel, :293).
// The function is the TPU kernel's: a hidden pair scores -1e9 and, in the
// forward, its p is forced to 0 (s <= -5e8); the forward keeps a running
// max m, sum l and accumulator per row over the k tiles in order and writes
// o = acc / l and lse = m + log(l), both f32. A row with no visible key gets
// o = 0 and lse = -1e9, so the caller's logaddexp merge weights it 0 (the
// ring flips the final lse of such a row to +1e9 before the backward).
// Backward: p = exp(s - lse), dS = p * (dP - delta), dq = scale * dS.k;
// dk = scale * dS^T.q, dv = p^T.dO; all outputs f32.
//
// Positions are global: query row i of the chunk sits at q_off + i, key
// column j at k_off + j. A pair is visible when the key lies inside its
// chunk (j < ck) and before n_valid, not after the query when causal, and
// passes the structured element test (axial row or column: the same image
// row or column, text keys always visible; conv window with dilation)
// computed on the global positions. Query rows past n_valid are computed
// like any other (the ring slices them off), as in the TPU kernel; rows
// past cq are not written.
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
// bound by operations (4.9 us forward, 7.4 dq, 9.8 dk/dv). chip_smoke.py
// recomputes the bounds from its inputs. Either way the bound assumes the
// tensor cores: f32 FMA on the CUDA cores (67 TFLOP/s) cannot come within
// 15x of it.
//
// Two routes, chosen by the operands' dtype in run(); both deterministic,
// no atomics; operands read through their (b, h, n) strides (the zigzag
// ring hands sub-chunk views of its rotating k and v), lse and delta
// through their (b, h) strides; outputs written contiguous, f32.
//
// f32 operands: the TPU's arithmetic, on the CUDA cores (fwd_kernel,
// dq_kernel, dkv_kernel): q, k, v (and dO) cast to f32 and q scaled; scores,
// p and every product f32 FMA. One CTA of 256 threads per (64-row tile,
// head, batch row); thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16*i and columns tx + 16*j (i, j < 4) of each 64x64 score tile; row
// reductions are 4 shuffles in a half-warp; tiles live in shared memory as
// f32 (row stride d + 1) and the score tile p (or dS) is staged there for
// the second product. Held to chunk_attention.kernel_tolerance. The ring's
// f32 compute (its parity checks) runs here.
//
// bf16 operands: the tensor-core route (tc_fwd_kernel, tc_dq_kernel,
// tc_dkv_kernel: K4's tc_*_kernel design in flash_attention.cu, over this
// pair's tile ranges), built for this card against what holds the f32
// route back (FMA on the CUDA cores, f32 tiles and score tiles through
// shared memory, no asynchronous copies, the element test on every tile):
//   * one CTA per 64-row tile, grid (h, b, tiles), the tile index slowest
//     and the heaviest tiles first (causal: the last q tiles for the
//     forward and dq, the first k tiles for dk/dv); bf16
//     mma.sync.m16n8k16 with f32 accumulators (tc_tile.cuh). The forward
//     has four warps of 16 rows; dq and dk/dv have eight, two on each 16
//     rows, each over half of every streamed tile's columns, and add their
//     accumulators once at the end (a fixed order, so repeatable);
//   * the resident tile (q; q and dO; k and v for dk/dv) is loaded once by
//     16-byte cp.async, the visited tiles stream through a two-stage
//     shared-memory ring (the copies of tile t+1 issued before tile t is
//     computed); rows at or past cq or ck are zero-filled by the copy
//     itself; lse and delta come in by 4-byte cp.async;
//   * bf16 tiles of row stride d + 8, read by ldmatrix; S's C fragments
//     become the next product's A fragments once rounded, so no score tile
//     goes through shared memory; dk/dv computes the transposed tile, keys
//     as the M dimension;
//   * positions are global, division-free (tc_pos); a key at or past ck
//     gets a position past n_valid, so the element test hides it (a
//     zero-filled key scores 0, not -1e9); the test is skipped for a tile
//     pair with no spec, wholly inside ck and n_valid and at or below the
//     diagonal; the outputs are f32, written as float2 from the fragments.
// Rounding (K4's bf16 route, so the ring rounds where the single-chip
// long-sequence layer does): s = (q*k^T)*scale, the bf16 products exact in
// f32 and the scale on the f32 sum; p (forward: exp(s - m), the running
// max; backward: exp(s - lse)) and dS rounded to bf16 before the second
// product; l the f32 sum of the unrounded p; dq and dk scaled once, at the
// end; exp is __expf. The plain versions with operands="bf16" compute
// exactly this, and the kernels are held to them within
// chunk_attention.tc_kernel_tolerance; against the TPU's f32 arithmetic
// the route costs at most 2^-8 of the absolute products (rounding_bound).
// Operands need 16-byte aligned rows: base and (b, h, n) strides multiples
// of 8 elements (the wrapper checks), and global positions below 2^22
// (run() checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "tc_tile.cuh"

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

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Mask {
  int kind, text_len, fmap, span, dil;
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

// pos_info without the integer division, for the tensor-core kernels: r =
// floor((i + 0.5) / fmap) in f32 is exact while i + 0.5 < 2^22 (the quotient
// lies at least 0.5 / fmap from an integer, and the f32 error stays below
// (i + 0.5) * 2^-23 / fmap); run() keeps positions below that
__device__ __forceinline__ Pos tc_pos(const Mask& mk, float inv_fmap, int p) {
  Pos o{p, 0, 0};
  if (mk.kind != kNone && p >= mk.text_len) {
    const int i = p - mk.text_len;
    o.r = __float2int_rz((static_cast<float>(i) + 0.5f) * inv_fmap);
    o.c = i - o.r * mk.fmap;
  }
  return o;
}

struct ChunkParams {
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

  // k tiles [0, hi) that q tile `qt` visits (the TPU's _hi_blocks)
  __device__ __forceinline__ int hi_tiles(int qt) const {
    const int nk = (ck + kTile - 1) / kTile;
    int hi = floor_div(n_valid - k_off + kTile - 1, kTile);
    if (causal) hi = min(hi, floor_div(q_off + (qt + 1) * kTile - 1 - k_off, kTile) + 1);
    return max(0, min(hi, nk));
  }

  // the first q tile that k tile `kt` visits
  __device__ __forceinline__ int lo_tiles(int kt) const {
    if (!causal) return 0;
    const int nq = (cq + kTile - 1) / kTile;
    return max(0, min(floor_div(k_off + kt * kTile - q_off, kTile), nq));
  }

  // query at global q.p, key at global k.p inside its chunk
  __device__ __forceinline__ bool visible(const Pos& q, const Pos& k) const {
    if (k.p >= n_valid) return false;
    if (causal && k.p > q.p) return false;
    if (mk.kind == kNone) return true;
    if (k.p < mk.text_len) return true;
    if (q.p < mk.text_len) return false;
    if (mk.kind == kAxialRow) return q.r == k.r;
    if (mk.kind == kAxialCol) return q.c == k.c;
    const int dr = q.r - k.r, dc = q.c - k.c;
    if (dr < 0 || dr > mk.span || dc < 0 || dc > mk.span) return false;
    return mk.dil == 1 || (dr % mk.dil == 0 && dc % mk.dil == 0);
  }

  // the tensor-core kernels' positions: query row `row` and key `key` of
  // the chunks, local -> global
  __device__ __forceinline__ Pos qpos(float inv_fmap, int row) const {
    return tc_pos(mk, inv_fmap, q_off + row);
  }
  // a key past the chunk (zero-filled, so it would score 0) lies past
  // n_valid, where visible() hides it
  __device__ __forceinline__ Pos kpos(float inv_fmap, int key) const {
    if (key >= ck) return Pos{INT_MAX, 0, 0};
    return tc_pos(mk, inv_fmap, k_off + key);
  }
  // a tile pair that needs no element test: no spec, the key tile inside
  // the chunk and before n_valid, and (when causal) every key at or before
  // every query
  __device__ __forceinline__ bool all_visible(int q0, int k0) const {
    return mk.kind == kNone && k0 + kTile <= ck && k_off + k0 + kTile <= n_valid &&
           (!causal || k_off + k0 + kTile - 1 <= q_off + q0);
  }
  __device__ __forceinline__ const float* lse_row(int bb, int hh) const {
    return lse_in + bb * sst[0][0] + hh * sst[0][1];
  }
  __device__ __forceinline__ const float* delta_row(int bb, int hh) const {
    return delta + bb * sst[1][0] + hh * sst[1][1];
  }
};

// key `kl` (local index) at global position k.p, query at q.p
__device__ __forceinline__ bool visible(const ChunkParams& p, const Pos& q, const Pos& k, int kl) {
  return kl < p.ck && p.visible(q, k);
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
__global__ void __launch_bounds__(kThreads) fwd_kernel(const ChunkParams p) {
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

  const int hi = p.hi_tiles(qt);
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
__global__ void __launch_bounds__(kThreads) dq_kernel(const ChunkParams p) {
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
  const float* lse_row = p.lse_row(bb, hh);
  const float* delta_row = p.delta_row(bb, hh);

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

  const int hi = p.hi_tiles(qt);
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
__global__ void __launch_bounds__(kThreads) dkv_kernel(const ChunkParams p) {
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
  const float* lse_row = p.lse_row(bb, hh);
  const float* delta_row = p.delta_row(bb, hh);

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
  for (int t = p.lo_tiles(kt); t < nq; ++t) {
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

// ---------------------------------------------------------------------------
// the tensor-core route (bf16 operands): K4's tc_*_kernel design
// (flash_attention.cu) over the pair's tile ranges, global positions and
// two chunk lengths, with f32 outputs
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;    // the forward's four warps, 16 rows of the tile each
// The backward kernels run eight warps: warp w takes the 16 rows
// 16*(w % 4) of the resident tile against half (w / 4) of each streamed
// tile's 64 columns, and the two halves' accumulators are added at the end
// through shared memory (group 0 + group 1, a fixed order).
constexpr int kTcBwdThreads = 256;

template <int D> __host__ __device__ constexpr int tc_ld() { return D + 8; }
template <int D> __host__ __device__ constexpr int tc_tile_elems() { return kTile * tc_ld<D>(); }
// q + two stages of k and v
template <int D> constexpr int tc_fwd_smem() { return 5 * tc_tile_elems<D>() * 2; }
// q, dO + two stages of k and v
template <int D> constexpr int tc_dq_smem() { return 6 * tc_tile_elems<D>() * 2; }
// k, v + two stages of q, dO, lse and delta
template <int D> constexpr int tc_dkv_smem() {
  return 6 * tc_tile_elems<D>() * 2 + 4 * kTile * 4;
}

// rows [row0, row0 + 64) of one (b, h) slice (row stride sn) into a bf16
// shared tile of row stride D + 8, by 16-byte cp.async; rows at or past n
// are zero
template <int D, int kThr>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src, long long sn, int row0,
                                             int n) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThr) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const int pos = row0 + r;
    const bool ok = pos < n;
    tc::cp_async16(dst + r * tc_ld<D>() + c * 8,
                   src + (ok ? static_cast<long long>(pos) * sn + c * 8 : 0), ok);
  }
}

// 64 f32 row statistics at rows [row0, row0 + 64) of a row, 0 past n
__device__ __forceinline__ void tc_load_stats(float* dst, const float* src, int row0, int n) {
  if (threadIdx.x < kTile) {
    const int pos = row0 + threadIdx.x;
    const bool ok = pos < n;
    tc::cp_async4(dst + threadIdx.x, src + (ok ? pos : 0), ok);
  }
}

// this lane's part of rows `row` and row + 8 of a 16-row accumulator, times
// `mul`, as f32 rows of a contiguous (b, h, n, d) output
template <int D>
__device__ __forceinline__ void tc_store_rows(float* out, size_t row_base, int row, int n,
                                              const float (&acc)[D / 8][4], float mul, int t4) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= n) continue;
    float* dst = out + (row_base + r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(acc[dn][2 * hr] * mul, acc[dn][2 * hr + 1] * mul);
  }
}

// forward: grid (h, b, q tiles); o and lse
template <int D>
__global__ void __launch_bounds__(kTcThreads) tc_fwd_kernel(const ChunkParams p) {
  constexpr int kLd = tc_ld<D>();
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + kEl;              // two stages
  bf16* sV = sK + 2 * kEl;          // two stages

  // the last q tiles first: under causality they visit the most k tiles
  const int qt = gridDim.z - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kTile;
  const bf16* k = slice<bf16>(p.k, p.st[1], bb, hh);
  const bf16* v = slice<bf16>(p.v, p.st[2], bb, hh);
  const int hi = p.hi_tiles(qt);    // k tiles [0, hi)

  tc_load_tile<D, kTcThreads>(sQ, slice<bf16>(p.q, p.st[0], bb, hh), p.st[0][2], q0, p.cq);
  if (hi > 0) {
    tc_load_tile<D, kTcThreads>(sK, k, p.st[1][2], 0, p.ck);
    tc_load_tile<D, kTcThreads>(sV, v, p.st[2][2], 0, p.ck);
  }
  tc::cp_async_commit();

  const int row = q0 + warp * 16 + g;   // this lane's rows: row and row + 8
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos qp[2] = {p.qpos(inv_fmap, row), p.qpos(inv_fmap, row + 8)};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[D / 8][4];
  tc::zero(acc);
  uint32_t qf[D / 16][4];               // q's A fragments, loaded once

  for (int t = 0; t < hi; ++t) {
    const int stage = t & 1;
    const int k0 = t * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();    // tile t has landed, and every warp is done with t - 1
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        tc::ldsm_x4(qf[kd], tc::a_addr(sQ, kLd, warp * 16, kd * 16, lane));
    }
    if (t + 1 < hi) {
      tc_load_tile<D, kTcThreads>(sK + (stage ^ 1) * kEl, k, p.st[1][2], k0 + kTile, p.ck);
      tc_load_tile<D, kTcThreads>(sV + (stage ^ 1) * kEl, v, p.st[2][2], k0 + kTile, p.ck);
    }
    tc::cp_async_commit();
    const bf16* cK = sK + stage * kEl;
    const bf16* cV = sV + stage * kEl;

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
    if (p.all_visible(q0, k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const Pos kp = p.kpos(inv_fmap, k0 + j * 8 + 2 * t4 + c);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[j][2 * hr + c];
            x = p.visible(qp[hr], kp) ? x * p.scale : kNegInf;
          }
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], tc::quad_max(mx));
      const float corr = __expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * hr + c];
          x = x > 0.5f * kNegInf ? __expf(x - m_new) : 0.f;
          sum += x;
        }
      l[hr] = l[hr] * corr + sum;
      m[hr] = m_new;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * hr] *= corr;
        acc[dn][2 * hr + 1] *= corr;
      }
    }
    tc::dot_pv<D, 8>(acc, s, cV, 0, lane);
  }
  tc::cp_async_wait<0>();

  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * p.cq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float sum = tc::quad_sum(l[hr]);
    const int r = row + 8 * hr;
    if (r >= p.cq) continue;
    // o = acc / l, divided as the plain version does
    const float safe_l = sum > 0.f ? sum : 1.f;
    float* dst = p.out0 + (row_base + r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(acc[dn][2 * hr] / safe_l, acc[dn][2 * hr + 1] / safe_l);
    if (t4 == 0) p.lse_out[row_base + r] = sum > 0.f ? m[hr] + logf(safe_l) : kNegInf;
  }
}

// dq: grid (h, b, q tiles), the last q tiles first
template <int D>
__global__ void __launch_bounds__(kTcBwdThreads) tc_dq_kernel(const ChunkParams p) {
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sdO = sQ + kEl;
  bf16* sK = sdO + kEl;             // two stages
  bf16* sV = sK + 2 * kEl;          // two stages

  const int qt = gridDim.z - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // rows, key columns
  const int q0 = qt * kTile;
  const bf16* k = slice<bf16>(p.k, p.st[1], bb, hh);
  const bf16* v = slice<bf16>(p.v, p.st[2], bb, hh);
  const int hi = p.hi_tiles(qt);    // k tiles [0, hi)
  const float* lse_row = p.lse_row(bb, hh);
  const float* delta_row = p.delta_row(bb, hh);

  tc_load_tile<D, kTcBwdThreads>(sQ, slice<bf16>(p.q, p.st[0], bb, hh), p.st[0][2], q0, p.cq);
  tc_load_tile<D, kTcBwdThreads>(sdO, slice<bf16>(p.dout, p.st[3], bb, hh), p.st[3][2], q0,
                                 p.cq);
  if (hi > 0) {
    tc_load_tile<D, kTcBwdThreads>(sK, k, p.st[1][2], 0, p.ck);
    tc_load_tile<D, kTcBwdThreads>(sV, v, p.st[2][2], 0, p.ck);
  }
  tc::cp_async_commit();

  const int row = q0 + wr + g;
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos qp[2] = {p.qpos(inv_fmap, row), p.qpos(inv_fmap, row + 8)};
  float lse[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    lse[hr] = r < p.cq ? lse_row[r] : 0.f;
    delta[hr] = r < p.cq ? delta_row[r] : 0.f;
  }
  float acc[D / 8][4];
  tc::zero(acc);

  for (int t = 0; t < hi; ++t) {
    const int stage = t & 1;
    const int k0 = t * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < hi) {
      tc_load_tile<D, kTcBwdThreads>(sK + (stage ^ 1) * kEl, k, p.st[1][2], k0 + kTile, p.ck);
      tc_load_tile<D, kTcBwdThreads>(sV + (stage ^ 1) * kEl, v, p.st[2][2], k0 + kTile, p.ck);
    }
    tc::cp_async_commit();
    const bf16* cK = sK + stage * kEl;
    const bf16* cV = sV + stage * kEl;

    float s[4][4], dp[4][4];
    tc::zero(s);
    tc::zero(dp);
    tc::dot_nt<D, 4>(s, sQ, wr, cK, wc, lane);
    tc::dot_nt<D, 4>(dp, sdO, wr, cV, wc, lane);
    const bool all = p.all_visible(q0, k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Pos kp = p.kpos(inv_fmap, k0 + wc + j * 8 + 2 * t4 + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + c;
          const float x = all || p.visible(qp[hr], kp) ? s[j][e] * p.scale : kNegInf;
          const float pr = __expf(x - lse[hr]);
          s[j][e] = pr * (dp[j][e] - delta[hr]);      // dS
        }
      }
    tc::dot_pv<D, 4>(acc, s, cK, wc, lane);
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free: it holds the reduction
  tc::reduce_halves<D>(acc, reinterpret_cast<float*>(sK), warp, lane);
  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * p.cq;
  if (warp < 4) tc_store_rows<D>(p.out0, row_base, row, p.cq, acc, p.scale, t4);
}

// dk, dv: grid (h, b, k tiles), the first k tiles first (under causality
// they are visited by the most q tiles); the transposed tile, keys as rows
// (at d <= 64, two CTAs an SM: at most 128 registers a thread)
template <int D>
__global__ void __launch_bounds__(kTcBwdThreads, D <= 64 ? 2 : 1)
    tc_dkv_kernel(const ChunkParams p) {
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + kEl;
  bf16* sQ = sV + kEl;              // two stages
  bf16* sdO = sQ + 2 * kEl;         // two stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kEl);   // two stages
  float* sDelta = sLse + 2 * kTile;                        // two stages

  const int kt = blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // key rows, query columns
  const int k0 = kt * kTile;
  const bf16* q = slice<bf16>(p.q, p.st[0], bb, hh);
  const bf16* dout = slice<bf16>(p.dout, p.st[3], bb, hh);
  const int lo = p.lo_tiles(kt), nq = (p.cq + kTile - 1) / kTile;   // q tiles [lo, nq)
  const float* lse_in = p.lse_row(bb, hh);
  const float* delta_in = p.delta_row(bb, hh);

  tc_load_tile<D, kTcBwdThreads>(sK, slice<bf16>(p.k, p.st[1], bb, hh), p.st[1][2], k0, p.ck);
  tc_load_tile<D, kTcBwdThreads>(sV, slice<bf16>(p.v, p.st[2], bb, hh), p.st[2][2], k0, p.ck);
  if (lo < nq) {
    const int r0 = lo * kTile;
    tc_load_tile<D, kTcBwdThreads>(sQ, q, p.st[0][2], r0, p.cq);
    tc_load_tile<D, kTcBwdThreads>(sdO, dout, p.st[3][2], r0, p.cq);
    tc_load_stats(sLse, lse_in, r0, p.cq);
    tc_load_stats(sDelta, delta_in, r0, p.cq);
  }
  tc::cp_async_commit();

  const int key = k0 + wr + g;           // this lane's keys: key and key + 8
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos kp[2] = {p.kpos(inv_fmap, key), p.kpos(inv_fmap, key + 8)};
  float dk[D / 8][4], dv[D / 8][4];
  tc::zero(dk);
  tc::zero(dv);

  for (int t = lo; t < nq; ++t) {
    const int stage = (t - lo) & 1;
    const int q0 = t * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nq) {
      const int r1 = q0 + kTile, o = stage ^ 1;
      tc_load_tile<D, kTcBwdThreads>(sQ + o * kEl, q, p.st[0][2], r1, p.cq);
      tc_load_tile<D, kTcBwdThreads>(sdO + o * kEl, dout, p.st[3][2], r1, p.cq);
      tc_load_stats(sLse + o * kTile, lse_in, r1, p.cq);
      tc_load_stats(sDelta + o * kTile, delta_in, r1, p.cq);
    }
    tc::cp_async_commit();
    const bf16* cQ = sQ + stage * kEl;
    const bf16* cdO = sdO + stage * kEl;
    const float* cLse = sLse + stage * kTile;
    const float* cDelta = sDelta + stage * kTile;
    const bool all = p.all_visible(q0, k0);

    float s[4][4], dp[4][4];
    tc::zero(s);
    tc::zero(dp);
    tc::dot_nt<D, 4>(s, sK, wr, cQ, wc, lane);      // S^T = K*Q^T
    tc::dot_nt<D, 4>(dp, sV, wr, cdO, wc, lane);    // dP^T = V*dO^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = wc + j * 8 + 2 * t4 + c;
        const Pos qpos = p.qpos(inv_fmap, q0 + col);
        const float lse = cLse[col], delta = cDelta[col];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + c;
          const float x = all || p.visible(qpos, kp[hr]) ? s[j][e] * p.scale : kNegInf;
          const float pr = __expf(x - lse);
          s[j][e] = pr;                               // P^T
          dp[j][e] = pr * (dp[j][e] - delta);         // dS^T
        }
      }
    tc::dot_pv<D, 4>(dv, s, cdO, wc, lane);     // dv += bf16(P^T)*dO
    tc::dot_pv<D, 4>(dk, dp, cQ, wc, lane);     // dk += bf16(dS^T)*Q
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free: it holds the reductions
  float* red = reinterpret_cast<float*>(sQ);
  tc::reduce_halves<D>(dk, red, warp, lane);
  tc::reduce_halves<D>(dv, red + 64 * D, warp, lane);
  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * p.ck;
  if (warp < 4) {
    tc_store_rows<D>(p.out0, row_base, key, p.ck, dk, p.scale, t4);
    tc_store_rows<D>(p.out1, row_base, key, p.ck, dv, 1.f, t4);
  }
}

template <int D>
int tc_launch(int which, const ChunkParams& p, int b, cudaStream_t stream) {
  void (*kernel)(const ChunkParams);
  int smem, threads = kTcBwdThreads, rows = p.cq;
  if (which == kFwd) {
    kernel = tc_fwd_kernel<D>;
    smem = tc_fwd_smem<D>();
    threads = kTcThreads;
  } else if (which == kDq) {
    kernel = tc_dq_kernel<D>;
    smem = tc_dq_smem<D>();
  } else {
    kernel = tc_dkv_kernel<D>;
    smem = tc_dkv_smem<D>();
    rows = p.ck;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tile index slowest, so that every (head, batch row) starts its
  // heaviest tiles first
  const dim3 grid(p.heads, b, (rows + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int tc_dispatch_d(int which, const ChunkParams& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return tc_launch<16>(which, p, b, stream);
    case 32: return tc_launch<32>(which, p, b, stream);
    case 64: return tc_launch<64>(which, p, b, stream);
    case 128: return tc_launch<128>(which, p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int launch(int which, const ChunkParams& p, int b, cudaStream_t stream) {
  void (*kernel)(const ChunkParams);
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
int dispatch_d(int which, const ChunkParams& p, int b, int d, cudaStream_t stream) {
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
  ChunkParams p{};
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
  // f32: the TPU's arithmetic on the CUDA cores; bf16: the tensor cores,
  // whose division-free grid positions are exact below 2^22
  if (dtype == kF32) return dispatch_d<float>(which, p, b, d, s);
  const bool placed = q_off >= 0 && k_off >= 0 && q_off + cq < (1 << 22) &&
                      k_off + ck < (1 << 22);
  if (dtype == kBF16 && placed) return tc_dispatch_d(which, p, b, d, s);
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
