// Block-sparse flash attention over (b, h, n, d), forward and backward, for
// Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/flash_attention.py::_make_flash_fn's three Pallas
// calls: the forward (_fwd_kernel, pallas_call at :354), dq (_bwd_dq_kernel,
// :404) and dk/dv (_bwd_dkv_kernel, :436). The arithmetic is the TPU
// kernel's: q, k, v (and dO) are cast to f32 and q is scaled; scores, p and
// every product are f32; a hidden pair scores -1e9 and its p is forced to 0
// (s <= -5e8); the forward keeps a running max m, sum l and accumulator per
// row (online softmax, k tiles in list order) and writes o = acc / l and
// lse = m + log(l); a row with no visible key gets o = 0 and lse = +1e9, so
// the backward's p = exp(s - lse) is 0 there. Backward: dS = p * (dP -
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
// Design (first version: simple, exact, deterministic; no atomics). The TPU
// kernel computes in f32, so this one does too, with FMA on the CUDA cores
// (67 TFLOP/s f32 is ~1/15 of the bf16 tensor rate the bound assumes):
//   * one CTA of 256 threads per (64-row tile, head, batch row); thread
//     (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i and columns
//     tx + 16*j (i, j < 4) of each 64x64 score tile, so the 16 threads of a
//     row are one half-warp and row reductions are 4 shuffles;
//   * tiles live in shared memory as f32, row stride d + 1 (conflict-free
//     column reads); the score tile p (or dS) is staged there for the
//     second product;
//   * forward and dq: the q tile (and dO) is loaded once, the listed k and v
//     tiles are streamed; dk/dv: the k and v tiles are loaded once, the
//     listed q and dO tiles (and their lse, delta) are streamed;
//   * operands are read through their (b, h, n) strides (the head split of
//     the qkv projection is a strided view), scalar loads along d; outputs
//     are written contiguous (b, h, n, d).
// No tensor cores, no TMA or cp.async staging, no pipelining: those, and
// bf16 wgmma with f32 accumulation, are for a later version (PERF.md).

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
enum MaskKind { kNone = 0, kAxialRow = 1, kAxialCol = 2, kConv = 3, kTable = 4 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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
  if (dtype == kF32) return dispatch_d<float>(which, p, b, d, s);
  if (dtype == kBF16) return dispatch_d<bf16>(which, p, b, d, s);
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
