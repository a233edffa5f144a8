// Block-sparse flash attention over (b, h, n, d), forward and backward, for
// Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/flash_attention.py::_make_flash_fn's three Pallas
// calls: the forward (_fwd_kernel, pallas_call at :354), dq (_bwd_dq_kernel,
// :404) and dk/dv (_bwd_dkv_kernel, :436). The function is the TPU
// kernel's (the f32 route below also keeps its arithmetic: q, k, v and dO
// cast to f32, q scaled, scores, p and every product f32): a hidden pair
// scores -1e9 and its p is forced to 0 (s <= -5e8); the forward keeps a
// running max m, sum l and accumulator per row (online softmax, k tiles in
// list order) and writes o = acc / l and lse = m + log(l); a row with no
// visible key gets o = 0 and lse = +1e9, so the backward's p = exp(s - lse)
// is 0 there. Backward: dS = p * (dP -
// delta) with delta = rowsum(dO * o) computed by the caller; dq = scale *
// dS.k; dk = dS^T.(scale * q), dv = p^T.dO.
//
// Sparsity: the host lowers the mask to block lists of 64-row tiles; a q tile
// visits only its listed k tiles (forward, dq), a k tile only its listed q
// tiles (dk/dv). Inside a visited tile, visibility is computed per element:
// a structured spec (axial row or column: the same image row or column, text
// keys always visible; conv window with dilation), else an int8 (n, n) table,
// else nothing; `pos < n` and causality are always ANDed in.
//
// Bound on the card (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense). At the
// long-sequence slice's full-causal layer (b=2, h=8, n=4352, d=64), counting
// the 151.6M visible pairs: forward 4*d flops per pair = 38.8 GFLOP -> 39 us,
// backward 10*d = 97 GFLOP -> 98 us; bytes (q, k, v, o, lse; plus dO, dq,
// dk, dv) are smaller. So the function is bound by operations on tensor
// cores. chip_smoke.py recomputes these from its inputs.
//
// Two routes, chosen by the operands' dtype in run():
//
// f32 operands: the TPU's arithmetic, on the CUDA cores (fwd_kernel,
// dq_kernel, dkv_kernel). q is scaled before the product; every product is
// f32 FMA. One CTA of 256 threads per (64-row tile, head, batch row); thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i and columns tx + 16*j
// of each 64x64 score tile; tiles sit in shared memory as f32 (row stride
// d + 1) and the score tile is staged there for the second product. Held to
// flash_attention.kernel_tolerance.
//
// bf16 operands: the tensor-core route (tc_fwd_kernel, tc_dq_kernel,
// tc_dkv_kernel), designed for this card:
//   * one CTA per 64-row tile, its tile index the slowest of the grid and
//     the heaviest tiles first (causality: the last q tiles, the first k
//     tiles); warps run bf16 mma.sync.m16n8k16 with f32 accumulators
//     (tc_tile.cuh). The forward has four warps of 16 rows; dq and dk/dv
//     have eight, two on each 16 rows, each over half of every streamed
//     tile's columns, and add their accumulators once at the end (a fixed
//     order, so the result is repeatable);
//   * the resident tile (q, or q and dO; k and v for dk/dv) is loaded once
//     by 16-byte cp.async; the listed tiles stream through a two-stage
//     shared-memory ring: the copies of tile t+1 are issued before tile t is
//     computed, one __syncthreads a tile; rows at or past n are zero-filled
//     by the copy itself;
//   * tiles are bf16 with a row stride of d + 8 (ldmatrix without bank
//     conflicts); no score tile goes through shared memory: the C fragments
//     of S (or dP) are the A fragments of the next product once rounded;
//   * the online softmax lives in registers, row max and sum over the four
//     lanes of a row; the element test runs on the accumulator fragments
//     from each lane's (row, column), and is skipped for a tile that is
//     wholly visible (kind none, inside n, at or below the diagonal);
//   * dk/dv computes the transposed tile (keys are the M dimension), so P^T
//     and dS^T stay in registers as A operands.
// Rounding: S = (q*k^T)*scale, the bf16 products exact in f32 and the scale
// applied to the f32 sum (1/sqrt(d) is not a power of two at d = 128, so
// q is not rounded after scaling). p (forward: exp(s - m), the running max;
// backward: exp(s - lse)) and dS are rounded to bf16 before the second
// product; the forward's sum l is the f32 sum of the unrounded p, as in the
// TPU kernel; dq and dk are scaled once, at the end; exp is __expf
// (ex2.approx, about 2^-21 relative). The plain versions
// with operands="bf16" compute exactly this, and the kernels are held to
// them within flash_attention.tc_kernel_tolerance (a p or dS on a rounding
// boundary may round the other way); against the TPU's f32 arithmetic the
// route costs at most 2^-8 of the absolute products (rounding_bound).
// Operands need 16-byte aligned rows: base and (b, h, n) strides multiples
// of 8 elements (the wrapper checks).
//
// Both routes: deterministic, no atomics; operands read through their
// (b, h, n) strides; outputs written contiguous (b, h, n, d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // query and key rows per tile
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 16;   // score tile row stride: the two half-warps hit other banks
constexpr float kNegInf = -1e9f;

enum DType { kF32 = 0, kBF16 = 1 };
enum MaskKind { kNone = 0, kAxialRow = 1, kAxialCol = 2, kConv = 3, kTable = 4 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Mask {
  int kind, text_len, fmap, span, dil, n, causal;
  const int8_t* table;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long st[4][3];       // (b, h, n) strides in elements of q, k, v, dout
  const int* ids;           // (nt, max_ids) tile lists
  const int* cnt;           // (nt,)
  int max_ids;
  Mask mk;
  const float* lse_in;      // (b, h, n) f32
  const float* delta;       // (b, h, n) f32
  void* out0;               // o | dq | dk, (b, h, n, d)
  void* out1;               // dv
  float* lse_out;
  int heads;
  float scale;
};

// a position and, inside the image, its grid row and column
struct Pos {
  int p, r, c;
};

__device__ __forceinline__ Pos pos_info(const Mask& mk, int p) {
  Pos o{p, 0, 0};
  if (mk.kind >= kAxialRow && mk.kind <= kConv && p >= mk.text_len) {
    const int i = p - mk.text_len;
    o.r = i / mk.fmap;
    o.c = i - o.r * mk.fmap;
  }
  return o;
}

__device__ __forceinline__ bool visible(const Mask& mk, const Pos& q, const Pos& k) {
  if (q.p >= mk.n || k.p >= mk.n) return false;
  if (mk.causal && k.p > q.p) return false;
  switch (mk.kind) {
    case kAxialRow:
    case kAxialCol:
    case kConv: {
      if (k.p < mk.text_len) return true;
      if (q.p < mk.text_len) return false;
      if (mk.kind == kAxialRow) return q.r == k.r;
      if (mk.kind == kAxialCol) return q.c == k.c;
      const int dr = q.r - k.r, dc = q.c - k.c;
      if (dr < 0 || dr > mk.span || dc < 0 || dc > mk.span) return false;
      return mk.dil == 1 || (dr % mk.dil == 0 && dc % mk.dil == 0);
    }
    case kTable:
      return mk.table[static_cast<size_t>(q.p) * mk.n + k.p] != 0;
    default:
      return true;
  }
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
// forward: grid (nt, h, b); o and lse
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
  const int n = p.mk.n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = slice<T>(p.q, p.st[0], bb, hh);
  const T* k = slice<T>(p.k, p.st[1], bb, hh);
  const T* v = slice<T>(p.v, p.st[2], bb, hh);

  load_tile<T, D>(sQ, q, p.st[0][2], qt * kTile, n, p.scale);
  Pos qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = pos_info(p.mk, qt * kTile + ty + 16 * i);

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int* ids = p.ids + static_cast<size_t>(qt) * p.max_ids;
  const int count = p.cnt[qt];
  for (int t = 0; t < count; ++t) {
    const int k0 = ids[t] * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, p.st[1][2], k0, n, 1.f);
    load_tile<T, D>(sV, v, p.st[2][2], k0, n, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    Pos kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(p.mk, qp[i], kp[j])) s[i][j] = kNegInf;
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

  T* o = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    if (row >= n) continue;
    const size_t at = (static_cast<size_t>(bb) * p.heads + hh) * n + row;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[at * D + tx + 16 * c] = from_f32<T>(acc[i][c] / safe_l);
    if (tx == 0) p.lse_out[at] = l[i] > 0.f ? m[i] + logf(safe_l) : -kNegInf;
  }
}

// ---------------------------------------------------------------------------
// dq: grid (nt, h, b)
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
  const int n = p.mk.n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = slice<T>(p.k, p.st[1], bb, hh);
  const T* v = slice<T>(p.v, p.st[2], bb, hh);
  const size_t stat0 = (static_cast<size_t>(bb) * p.heads + hh) * n;

  load_tile<T, D>(sQ, slice<T>(p.q, p.st[0], bb, hh), p.st[0][2], qt * kTile, n, p.scale);
  load_tile<T, D>(sdO, slice<T>(p.dout, p.st[3], bb, hh), p.st[3][2], qt * kTile, n, 1.f);
  Pos qp[4];
  float lse[4], delta[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    qp[i] = pos_info(p.mk, row);
    lse[i] = row < n ? p.lse_in[stat0 + row] : 0.f;
    delta[i] = row < n ? p.delta[stat0 + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int* ids = p.ids + static_cast<size_t>(qt) * p.max_ids;
  const int count = p.cnt[qt];
  for (int t = 0; t < count; ++t) {
    const int k0 = ids[t] * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, p.st[1][2], k0, n, 1.f);
    load_tile<T, D>(sV, v, p.st[2][2], k0, n, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    Pos kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = visible(p.mk, qp[i], kp[j]) ? s[i][j] : kNegInf;
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

  T* dq = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      dq[(stat0 + row) * D + tx + 16 * c] = from_f32<T>(acc[i][c] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (nt, h, b) over k tiles
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
  const int n = p.mk.n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;
  const T* q = slice<T>(p.q, p.st[0], bb, hh);
  const T* dout = slice<T>(p.dout, p.st[3], bb, hh);
  const size_t stat0 = (static_cast<size_t>(bb) * p.heads + hh) * n;

  load_tile<T, D>(sK, slice<T>(p.k, p.st[1], bb, hh), p.st[1][2], k0, n, 1.f);
  load_tile<T, D>(sV, slice<T>(p.v, p.st[2], bb, hh), p.st[2][2], k0, n, 1.f);
  // the score tile's key columns tx + 16j are this CTA's keys
  Pos kp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kp[j] = pos_info(p.mk, k0 + tx + 16 * j);
  // the accumulators' rows ty + 16i are keys, columns tx + 16c
  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int* ids = p.ids + static_cast<size_t>(kt) * p.max_ids;
  const int count = p.cnt[kt];
  for (int t = 0; t < count; ++t) {
    const int q0 = ids[t] * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q, p.st[0][2], q0, n, p.scale);
    load_tile<T, D>(sdO, dout, p.st[3][2], q0, n, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < n ? p.lse_in[stat0 + row] : 0.f;
      sDelta[threadIdx.x] = row < n ? p.delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    // the (query, key) tile: rows ty + 16i are queries, columns tx + 16j keys
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const Pos qp = pos_info(p.mk, q0 + r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = visible(p.mk, qp, kp[j]) ? s[i][j] : kNegInf;
        const float pr = expf(sv - sLse[r]);
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

  T* dk_out = static_cast<T*>(p.out0);
  T* dv_out = static_cast<T*>(p.out1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const size_t at = (stat0 + row) * D + tx + 16 * c;
      dk_out[at] = from_f32<T>(dk[i][c]);
      dv_out[at] = from_f32<T>(dv[i][c]);
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// ---------------------------------------------------------------------------
// the tensor-core route (bf16 operands)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;    // the forward's four warps, 16 rows of the tile each

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

// 64 f32 row statistics of (b, h, n) at rows [row0, row0 + 64), 0 past n
__device__ __forceinline__ void tc_load_stats(float* dst, const float* src, int row0, int n) {
  if (threadIdx.x < kTile) {
    const int pos = row0 + threadIdx.x;
    const bool ok = pos < n;
    tc::cp_async4(dst + threadIdx.x, src + (ok ? pos : 0), ok);
  }
}

// a tile pair that needs no element test: no spec or table, both tiles
// inside n, and (when causal) every key at or before every query
__device__ __forceinline__ bool tile_all_visible(const Mask& mk, int q0, int k0) {
  return mk.kind == kNone && q0 + kTile <= mk.n && k0 + kTile <= mk.n &&
         (!mk.causal || k0 + kTile - 1 <= q0);
}

// pos_info without the integer division: r = floor((i + 0.5) / fmap) in
// f32 is exact while i + 0.5 < 2^22 (the quotient lies at least 0.5 / fmap
// from an integer, and the f32 error stays below (i + 0.5) * 2^-23 / fmap);
// run() keeps n below that
__device__ __forceinline__ Pos tc_pos(const Mask& mk, float inv_fmap, int p) {
  Pos o{p, 0, 0};
  if (mk.kind >= kAxialRow && mk.kind <= kConv && p >= mk.text_len) {
    const int i = p - mk.text_len;
    o.r = __float2int_rz((static_cast<float>(i) + 0.5f) * inv_fmap);
    o.c = i - o.r * mk.fmap;
  }
  return o;
}

// this lane's part of rows `row` and row + 8 of a 16-row accumulator, times
// `mul`, as bf16 rows of a contiguous (b, h, n, d) output
template <int D>
__device__ __forceinline__ void tc_store_rows(bf16* out, size_t row_base, int row, int n,
                                              const float (&acc)[D / 8][4], float mul, int t4) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= n) continue;
    bf16* dst = out + (row_base + r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(acc[dn][2 * hr] * mul, acc[dn][2 * hr + 1] * mul);
  }
}

// forward: grid (h, b, nt); o and lse
template <int D>
__global__ void __launch_bounds__(kTcThreads) tc_fwd_kernel(const Params p) {
  constexpr int kLd = tc_ld<D>();
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + kEl;              // two stages
  bf16* sV = sK + 2 * kEl;          // two stages

  // the last q tiles first: under causality they visit the most k tiles
  const int qt = gridDim.z - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int n = p.mk.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kTile;
  const bf16* k = slice<bf16>(p.k, p.st[1], bb, hh);
  const bf16* v = slice<bf16>(p.v, p.st[2], bb, hh);
  const int* ids = p.ids + static_cast<size_t>(qt) * p.max_ids;
  const int count = p.cnt[qt];

  tc_load_tile<D, kTcThreads>(sQ, slice<bf16>(p.q, p.st[0], bb, hh), p.st[0][2], q0, n);
  if (count > 0) {
    tc_load_tile<D, kTcThreads>(sK, k, p.st[1][2], ids[0] * kTile, n);
    tc_load_tile<D, kTcThreads>(sV, v, p.st[2][2], ids[0] * kTile, n);
  }
  tc::cp_async_commit();

  const int row = q0 + warp * 16 + g;   // this lane's rows: row and row + 8
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos qp[2] = {tc_pos(p.mk, inv_fmap, row), tc_pos(p.mk, inv_fmap, row + 8)};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[D / 8][4];
  tc::zero(acc);
  uint32_t qf[D / 16][4];               // q's A fragments, loaded once

  for (int t = 0; t < count; ++t) {
    const int stage = t & 1;
    const int k0 = ids[t] * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();    // tile t has landed, and every warp is done with t - 1
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        tc::ldsm_x4(qf[kd], tc::a_addr(sQ, kLd, warp * 16, kd * 16, lane));
    }
    if (t + 1 < count) {
      const int k1 = ids[t + 1] * kTile;
      tc_load_tile<D, kTcThreads>(sK + (stage ^ 1) * kEl, k, p.st[1][2], k1, n);
      tc_load_tile<D, kTcThreads>(sV + (stage ^ 1) * kEl, v, p.st[2][2], k1, n);
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
    if (tile_all_visible(p.mk, q0, k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const Pos kp = tc_pos(p.mk, inv_fmap, k0 + j * 8 + 2 * t4 + c);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[j][2 * hr + c];
            x = visible(p.mk, qp[hr], kp) ? x * p.scale : kNegInf;
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

  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * n;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float sum = tc::quad_sum(l[hr]);
    const int r = row + 8 * hr;
    if (r >= n) continue;
    // o = acc / l, divided as the plain version does
    const float safe_l = sum > 0.f ? sum : 1.f;
    bf16* dst = static_cast<bf16*>(p.out0) + (row_base + r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(acc[dn][2 * hr] / safe_l, acc[dn][2 * hr + 1] / safe_l);
    if (t4 == 0) p.lse_out[row_base + r] = sum > 0.f ? m[hr] + logf(safe_l) : -kNegInf;
  }
}

// The backward kernels run eight warps: warp w takes the 16 rows
// 16*(w % 4) of the resident tile against half (w / 4) of each streamed
// tile's 64 columns, and the two halves' accumulators are added at the end
// through shared memory (group 0 + group 1, a fixed order).
constexpr int kTcBwdThreads = 256;

// dq: grid (h, b, nt), the last q tiles first
template <int D>
__global__ void __launch_bounds__(kTcBwdThreads) tc_dq_kernel(const Params p) {
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sdO = sQ + kEl;
  bf16* sK = sdO + kEl;             // two stages
  bf16* sV = sK + 2 * kEl;          // two stages

  const int qt = gridDim.z - 1 - blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int n = p.mk.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // rows, key columns
  const int q0 = qt * kTile;
  const bf16* k = slice<bf16>(p.k, p.st[1], bb, hh);
  const bf16* v = slice<bf16>(p.v, p.st[2], bb, hh);
  const int* ids = p.ids + static_cast<size_t>(qt) * p.max_ids;
  const int count = p.cnt[qt];
  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * n;

  tc_load_tile<D, kTcBwdThreads>(sQ, slice<bf16>(p.q, p.st[0], bb, hh), p.st[0][2], q0, n);
  tc_load_tile<D, kTcBwdThreads>(sdO, slice<bf16>(p.dout, p.st[3], bb, hh), p.st[3][2], q0, n);
  if (count > 0) {
    tc_load_tile<D, kTcBwdThreads>(sK, k, p.st[1][2], ids[0] * kTile, n);
    tc_load_tile<D, kTcBwdThreads>(sV, v, p.st[2][2], ids[0] * kTile, n);
  }
  tc::cp_async_commit();

  const int row = q0 + wr + g;
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos qp[2] = {tc_pos(p.mk, inv_fmap, row), tc_pos(p.mk, inv_fmap, row + 8)};
  float lse[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    lse[hr] = r < n ? p.lse_in[row_base + r] : 0.f;
    delta[hr] = r < n ? p.delta[row_base + r] : 0.f;
  }
  float acc[D / 8][4];
  tc::zero(acc);

  for (int t = 0; t < count; ++t) {
    const int stage = t & 1;
    const int k0 = ids[t] * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < count) {
      const int k1 = ids[t + 1] * kTile;
      tc_load_tile<D, kTcBwdThreads>(sK + (stage ^ 1) * kEl, k, p.st[1][2], k1, n);
      tc_load_tile<D, kTcBwdThreads>(sV + (stage ^ 1) * kEl, v, p.st[2][2], k1, n);
    }
    tc::cp_async_commit();
    const bf16* cK = sK + stage * kEl;
    const bf16* cV = sV + stage * kEl;

    float s[4][4], dp[4][4];
    tc::zero(s);
    tc::zero(dp);
    tc::dot_nt<D, 4>(s, sQ, wr, cK, wc, lane);
    tc::dot_nt<D, 4>(dp, sdO, wr, cV, wc, lane);
    const bool all = tile_all_visible(p.mk, q0, k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Pos kp = tc_pos(p.mk, inv_fmap, k0 + wc + j * 8 + 2 * t4 + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + c;
          const float x = all || visible(p.mk, qp[hr], kp) ? s[j][e] * p.scale : kNegInf;
          const float pr = __expf(x - lse[hr]);
          s[j][e] = pr * (dp[j][e] - delta[hr]);      // dS
        }
      }
    tc::dot_pv<D, 4>(acc, s, cK, wc, lane);
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free: it holds the reduction
  tc::reduce_halves<D>(acc, reinterpret_cast<float*>(sK), warp, lane);
  if (warp < 4) tc_store_rows<D>(static_cast<bf16*>(p.out0), row_base, row, n, acc, p.scale, t4);
}

// dk, dv: grid (h, b, nt) over k tiles, the first k tiles first (under
// causality they are visited by the most q tiles); the transposed tile, keys
// as rows
// (at d <= 64, two CTAs an SM: at most 128 registers a thread)
template <int D>
__global__ void __launch_bounds__(kTcBwdThreads, D <= 64 ? 2 : 1) tc_dkv_kernel(const Params p) {
  constexpr int kEl = tc_tile_elems<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + kEl;
  bf16* sQ = sV + kEl;              // two stages
  bf16* sdO = sQ + 2 * kEl;         // two stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kEl);   // two stages
  float* sDelta = sLse + 2 * kTile;                        // two stages

  const int kt = blockIdx.z, hh = blockIdx.x, bb = blockIdx.y;
  const int n = p.mk.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // key rows, query columns
  const int k0 = kt * kTile;
  const bf16* q = slice<bf16>(p.q, p.st[0], bb, hh);
  const bf16* dout = slice<bf16>(p.dout, p.st[3], bb, hh);
  const int* ids = p.ids + static_cast<size_t>(kt) * p.max_ids;
  const int count = p.cnt[kt];
  const size_t row_base = (static_cast<size_t>(bb) * p.heads + hh) * n;
  const float* lse_in = p.lse_in + row_base;
  const float* delta_in = p.delta + row_base;

  tc_load_tile<D, kTcBwdThreads>(sK, slice<bf16>(p.k, p.st[1], bb, hh), p.st[1][2], k0, n);
  tc_load_tile<D, kTcBwdThreads>(sV, slice<bf16>(p.v, p.st[2], bb, hh), p.st[2][2], k0, n);
  if (count > 0) {
    const int r0 = ids[0] * kTile;
    tc_load_tile<D, kTcBwdThreads>(sQ, q, p.st[0][2], r0, n);
    tc_load_tile<D, kTcBwdThreads>(sdO, dout, p.st[3][2], r0, n);
    tc_load_stats(sLse, lse_in, r0, n);
    tc_load_stats(sDelta, delta_in, r0, n);
  }
  tc::cp_async_commit();

  const int key = k0 + wr + g;           // this lane's keys: key and key + 8
  const float inv_fmap = 1.f / p.mk.fmap;
  const Pos kp[2] = {tc_pos(p.mk, inv_fmap, key), tc_pos(p.mk, inv_fmap, key + 8)};
  float dk[D / 8][4], dv[D / 8][4];
  tc::zero(dk);
  tc::zero(dv);

  for (int t = 0; t < count; ++t) {
    const int stage = t & 1;
    const int q0 = ids[t] * kTile;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < count) {
      const int r1 = ids[t + 1] * kTile, o = stage ^ 1;
      tc_load_tile<D, kTcBwdThreads>(sQ + o * kEl, q, p.st[0][2], r1, n);
      tc_load_tile<D, kTcBwdThreads>(sdO + o * kEl, dout, p.st[3][2], r1, n);
      tc_load_stats(sLse + o * kTile, lse_in, r1, n);
      tc_load_stats(sDelta + o * kTile, delta_in, r1, n);
    }
    tc::cp_async_commit();
    const bf16* cQ = sQ + stage * kEl;
    const bf16* cdO = sdO + stage * kEl;
    const float* cLse = sLse + stage * kTile;
    const float* cDelta = sDelta + stage * kTile;
    const bool all = tile_all_visible(p.mk, q0, k0);

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
        const Pos qpos = tc_pos(p.mk, inv_fmap, q0 + col);
        const float lse = cLse[col], delta = cDelta[col];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + c;
          const float x = all || visible(p.mk, qpos, kp[hr]) ? s[j][e] * p.scale : kNegInf;
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
  if (warp < 4) {
    tc_store_rows<D>(static_cast<bf16*>(p.out0), row_base, key, n, dk, p.scale, t4);
    tc_store_rows<D>(static_cast<bf16*>(p.out1), row_base, key, n, dv, 1.f, t4);
  }
}

template <int D>
int tc_launch(int which, const Params& p, int b, cudaStream_t stream) {
  void (*kernel)(const Params);
  int smem, threads = kTcBwdThreads;
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
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tile index slowest, so that every (head, batch row) starts its
  // heaviest tiles first
  const dim3 grid(p.heads, b, (p.mk.n + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int tc_dispatch_d(int which, const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return tc_launch<16>(which, p, b, stream);
    case 32: return tc_launch<32>(which, p, b, stream);
    case 64: return tc_launch<64>(which, p, b, stream);
    case 128: return tc_launch<128>(which, p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int launch(int which, const Params& p, int b, cudaStream_t stream) {
  void (*kernel)(const Params);
  int smem;
  if (which == kFwd) {
    kernel = fwd_kernel<T, D>;
    smem = fwd_smem<D>();
  } else if (which == kDq) {
    kernel = dq_kernel<T, D>;
    smem = dq_smem<D>();
  } else {
    kernel = dkv_kernel<T, D>;
    smem = dkv_smem<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.mk.n + kTile - 1) / kTile, p.heads, b);
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
        const long long* strides, const int* ids, const int* cnt, int max_ids, int kind,
        const int* spec, const int8_t* table, const float* lse_in, const float* delta,
        void* out0, void* out1, float* lse_out, int b, int h, int n, int d, int causal,
        float scale, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  const int operands = which == kFwd ? 3 : 4;
  for (int o = 0; o < operands; ++o)
    for (int s = 0; s < 3; ++s) p.st[o][s] = strides[3 * o + s];
  p.ids = ids;
  p.cnt = cnt;
  p.max_ids = max_ids;
  // spec: text_len, fmap, kernel, dilation (conv); text_len, fmap (axial)
  p.mk = Mask{kind, spec[0], spec[1] > 0 ? spec[1] : 1, (spec[2] - 1) * spec[3],
              spec[3] > 0 ? spec[3] : 1, n, causal, table};
  p.lse_in = lse_in;
  p.delta = delta;
  p.out0 = out0;
  p.out1 = out1;
  p.lse_out = lse_out;
  p.heads = h;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32: the TPU's arithmetic on the CUDA cores; bf16: the tensor cores
  if (dtype == kF32) return dispatch_d<float>(which, p, b, d, s);
  if (dtype == kBF16) return n < (1 << 22) ? tc_dispatch_d(which, p, b, d, s)
                                            : static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Forward. q, k, v (b, h, n, d) of `dtype` (0 f32, 1 bf16), dense along d,
// with (b, h, n) strides in `strides` (9 values, host); `ids` (nt, max_ids)
// and `cnt` (nt,) int32 on the card: each q tile's k tiles; `kind` and
// `spec` (4 values, host) the element test, `table` (n, n) int8 for kind 4.
// Writes o (b, h, n, d) of `dtype` and lse (b, h, n) f32. Returns a CUDA
// error code, 0 when the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                                   const long long* strides, const int* ids, const int* cnt,
                                   int max_ids, int kind, const int* spec, const int8_t* table,
                                   void* o, float* lse, int b, int h, int n, int d, int causal,
                                   float scale, void* stream) {
  return run(kFwd, q, k, v, nullptr, dtype, strides, ids, cnt, max_ids, kind, spec, table,
             nullptr, nullptr, o, nullptr, lse, b, h, n, d, causal, scale, stream);
}

// dq from q, k, v, dout (strides: 12 values), the forward's lse and delta =
// rowsum(dout * o), both (b, h, n) f32, over each q tile's k tiles. `unused`
// keeps the signature of flash_attention_bwd_dkv.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, int dtype, const long long* strides,
                                      const int* ids, const int* cnt, int max_ids, int kind,
                                      const int* spec, const int8_t* table, const float* lse,
                                      const float* delta, void* dq, void* unused, int b, int h,
                                      int n, int d, int causal, float scale, void* stream) {
  (void)unused;
  return run(kDq, q, k, v, dout, dtype, strides, ids, cnt, max_ids, kind, spec, table, lse,
             delta, dq, nullptr, nullptr, b, h, n, d, causal, scale, stream);
}

// dk, dv as flash_attention_bwd_dq, over each k tile's q tiles (`ids`, `cnt`
// are the transposed lists).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, int dtype, const long long* strides,
                                       const int* ids, const int* cnt, int max_ids, int kind,
                                       const int* spec, const int8_t* table, const float* lse,
                                       const float* delta, void* dk, void* dv, int b, int h,
                                       int n, int d, int causal, float scale, void* stream) {
  return run(kDkv, q, k, v, dout, dtype, strides, ids, cnt, max_ids, kind, spec, table, lse,
             delta, dk, dv, nullptr, b, h, n, d, causal, scale, stream);
}
