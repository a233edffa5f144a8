// Whole-sequence causal attention with an exact (not online) softmax, forward
// and backward, for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/persistent_attention.py::_persist_fwd (Pallas body
// _fwd_kernel) and ::_persist_bwd (body _bwd_kernel). Operands are (b, h, n, d)
// bf16 with any (b, h, n) strides and a dense head dim (the wrapper casts them
// to bf16 first, as the TPU wrapper does); outputs are (b, h, n, d) contiguous
// in f32 or bf16. The arithmetic is the TPU kernel's, rounding for rounding:
//   qs = bf16(f32(q) * scale); s = qs.k^T in f32; a hidden pair scores -1e9;
//   m = the row max, l = sum exp(s - m), p = exp(s - m) / l, p16 = bf16(p);
//   o = p16.v in f32, written in the output type.
// Backward: dp = dO.v^T, o = p16.v recomputed in f32, delta = rowsum(o * dO),
//   ds = bf16(p * (dp - delta)), dq = ds.k * scale, dk = ds^T.q * scale with
//   the UNSCALED bf16 q, dv = p16^T.dO, all accumulated in f32.
// Visibility is j <= i, or an int8 (n, n) table (causality included). A row
// that sees nothing has every score at -1e9 on the TPU, so its softmax is
// 1/n over all n keys; here such a row (m = -inf) takes p = 1/n directly.
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
// Design. The TPU kernel keeps one (b, h)'s whole (n, n) score tile in VMEM;
// at n = 512 that is 1 MB of f32, and a Hopper block has 227 KB. So a CTA
// keeps a STRIP of kRows score rows resident in shared memory instead: it
// computes the strip's (kRows, n) scores once, takes each row's exact max and
// sum there, writes bf16(p) back over the scores in place and multiplies by v.
// kRows = 32: the widest n the routing gate admits (persistent_fits: ~800 at
// d = 64, ~770 at d = 128) needs 32 * 836 * 4 = 107 KB of f32 rows, beside the
// q strip and one 64-row k/v tile (another 26 KB at d = 128); 64 rows would
// take 214 KB for the scores alone and leave no room for the dq kernel's
// operands. At n = 512 the forward takes 90 KB, two CTAs an SM.
//   * forward, grid (row strips, h, b), 8 warps: k tiles -> scores, one warp
//     per row for the softmax, v tiles -> o;
//   * backward (a), the same grid: scores -> p in f32 kept in place; v tiles
//     -> o = p16.v, delta; k and v tiles -> dp, ds, dq. Writes each row's
//     (m, l, delta) to a (3, b, h, n) f32 workspace;
//   * backward (b), grid (64-column strips, h, b), 8 warps: walks the 64-row
//     query tiles that can see its columns, recomputes s^T and dp^T against
//     the row statistics; warps 0-3 accumulate dv, warps 4-7 dk (as the
//     fused kernel's dk/dv does). No atomics: the same bits every run.
//   * A strip visits the key columns up to its own extent: the causal edge
//     without a table; with one, the last visible column of its rows, or all
//     n when a row sees nothing. The dk/dv kernel skips a query tile with no
//     visible pair in its columns and no empty row.
// Products are nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators,
// operands staged with plain 16-byte loads. The bound is bytes, and this
// design reads each k/v tile twice per strip in the forward (three times in
// dq), so it is far from the bound; cp.async/TMA staging and wgmma are for a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kRows = 32;      // score rows a CTA keeps resident
constexpr int kTile = 64;      // k/v rows per staged tile; dk/dv column strip
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLdT = kTile + 4;  // f32 (., 64) tile row stride
constexpr int kLdP = kTile + 8;  // bf16 (., 64) tile row stride

enum DType { kF32 = 0, kBF16 = 1 };

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Strides {  // elements between batch rows, heads and positions
  long long b, h, n;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

// shared-memory row strides of the staged operands
template <int D> __host__ __device__ constexpr int ld_op() { return D + 8; }   // bf16 rows
template <int D> __host__ __device__ constexpr int ld_out() { return D + 4; }  // f32 rows

template <int D> __host__ __device__ constexpr int strip_bytes() { return kRows * (D + 8) * 2; }
template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * (D + 8) * 2; }

// the score strip's row stride (f32): the padded width plus 4
__host__ __device__ inline int score_ld(int n) { return (n + kTile - 1) / kTile * kTile + 4; }

template <int D> __host__ __device__ inline int fwd_smem(int n) {
  return strip_bytes<D>() + tile_bytes<D>() + kRows * score_ld(n) * 4;
}
template <int D> __host__ __device__ inline int dq_smem(int n) {
  return 2 * strip_bytes<D>() + 2 * tile_bytes<D>() + kRows * score_ld(n) * 4 +
         kRows * kLdT * 4 + kRows * kLdP * 2;
}
template <int D> __host__ __device__ constexpr int dkv_smem() {
  return 5 * tile_bytes<D>() + 2 * kTile * kLdT * 4 + 2 * kTile * kLdP * 2 + 3 * kTile * 4;
}

// rows [0, rows) of a (., D) bf16 operand at row stride ld into a shared tile
// of `count` rows (row stride D + 8); rows at or past `avail` are zero. With
// `scaled` each value becomes bf16(f32(x) * scale), the query rounding.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int avail,
                                          int count, bool scaled, float scale) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < count * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < avail) {
      raw = *reinterpret_cast<const uint4*>(src + r * ld + c);
      if (scaled) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          p[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld_op<D>() + c) = raw;
  }
}

// S[row0:+16, scol:+16] (f32, row stride ld) = A[row0:+16, :D] . B[brow:+16, :D]^T
template <int D>
__device__ __forceinline__ void warp_abt(float* S, int ld, const bf16* A, const bf16* B,
                                         int row0, int brow, int scol) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    FragA a;
    FragBCol b;
    wmma::load_matrix_sync(a, A + row0 * ld_op<D>() + k, ld_op<D>());
    wmma::load_matrix_sync(b, B + brow * ld_op<D>() + k, ld_op<D>());
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(S + row0 * ld + scol, acc, ld, wmma::mem_row_major);
}

// 16 rows x 64 columns of a bf16 P (row stride ldp, starting at column pcol)
// times the 64 x D tile V: acc[j] += for the output fragments f = f0 + 4j
template <int D, int NF>
__device__ __forceinline__ void warp_pv(FragC* acc, const bf16* P, int ldp, int row0, int pcol,
                                        const bf16* V, int f0) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, P + row0 * ldp + pcol + kk, ldp);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + 4 * j;
      if (f < D / 16) {
        FragBRow b;
        wmma::load_matrix_sync(b, V + kk * ld_op<D>() + 16 * f, ld_op<D>());
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
}

// the strip's output fragments (rows 16*(warp&1), fragments (warp>>1) + 4j)
// into an f32 (kRows, D + 4) staging tile, times mul
template <int D, int NF>
__device__ __forceinline__ void stage_strip(float* dst, FragC* acc, int warp, float mul) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = (warp >> 1) + 4 * j;
    if (f < D / 16) {
      for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] *= mul;
      wmma::store_matrix_sync(dst + 16 * (warp & 1) * ld_out<D>() + 16 * f, acc[j], ld_out<D>(),
                              wmma::mem_row_major);
    }
  }
}

// rows [0, rows) of an f32 (., D + 4) staging tile -> contiguous (., D) output
template <typename OutT, int D>
__device__ __forceinline__ void store_rows(OutT* dst, const float* src, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[static_cast<size_t>(r) * D + c] = from_f32<OutT>(src[r * ld_out<D>() + c]);
  }
}

__device__ __forceinline__ bool visible(const int8_t* table, int n, int i, int j) {
  return table != nullptr ? table[static_cast<size_t>(i) * n + j] != 0 : j <= i;
}

// the key columns the strip of rows [r0, r0 + kRows) needs: the causal edge
// without a table; with one, one past its rows' last visible column, or n
// when a row sees nothing (its p is 1/n over every key). Call from all threads.
__device__ int strip_extent(const int8_t* table, int n, int r0, int* s_ext) {
  if (table == nullptr) return min(n, r0 + kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *s_ext = 0;
  __syncthreads();
  for (int r = warp; r < kRows && r0 + r < n; r += kWarps) {
    const int8_t* row = table + static_cast<size_t>(r0 + r) * n;
    int last = -1;
    for (int c = lane; c < n; c += 32)
      if (row[c] != 0) last = c;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if (lane == 0) atomicMax(s_ext, last < 0 ? n : last + 1);
  }
  __syncthreads();
  return *s_ext;
}

// the scores of the strip's rows against key tiles [0, nkt): S (kRows, ld) f32
template <int D>
__device__ __forceinline__ void strip_scores(float* S, int ld, const bf16* sQ, bf16* sK,
                                             const bf16* kbase, long long kn, int n, int nkt) {
  const int warp = threadIdx.x >> 5;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<D>(sK, kbase + static_cast<long long>(kt) * kTile * kn, kn, n - kt * kTile, kTile,
                 false, 0.f);
    __syncthreads();
    warp_abt<D>(S, ld, sQ, sK, 16 * (warp & 1), 16 * (warp >> 1), kt * kTile + 16 * (warp >> 1));
  }
  __syncthreads();
}

// the softmax of one score row (one warp): row max and sum over the visible
// columns of [0, ext). Returns m (-inf for a row that sees nothing) and l.
__device__ __forceinline__ float2 row_stats(const float* srow, const int8_t* table, int n, int i,
                                            int ext) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int c = lane; c < ext; c += 32)
    if (visible(table, n, i, c)) m = fmaxf(m, srow[c]);
  m = warp_max(m);
  float l = 0.f;
  if (m != -INFINITY) {
    for (int c = lane; c < ext; c += 32)
      if (visible(table, n, i, c)) l += expf(srow[c] - m);
    l = warp_sum(l);
  } else {
    l = static_cast<float>(n);
  }
  return make_float2(m, l);
}

__device__ __forceinline__ float prob(float s, float m, float l, bool vis, int c, int n) {
  if (m == -INFINITY) return c < n ? 1.f / static_cast<float>(n) : 0.f;
  return vis ? expf(s - m) / l : 0.f;
}

// ---------------------------------------------------------------------------
// forward: grid (row strips, h, b), 8 warps
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
persist_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                   const int8_t* __restrict__ table, OutT* __restrict__ out, int heads, int n,
                   float scale) {
  constexpr int NF = (D / 16 + 3) / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + strip_bytes<D>());
  float* sS = reinterpret_cast<float*>(smem + strip_bytes<D>() + tile_bytes<D>());
  float* sO = reinterpret_cast<float*>(sKV);  // after the v sweep
  __shared__ int s_ext;

  const int r0 = blockIdx.x * kRows, hh = blockIdx.y, bb = blockIdx.z;
  const int ld = score_ld(n), ldp = 2 * ld;   // the strip as f32, then as bf16
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + bb * sq.b + hh * sq.h;
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;

  load_rows<D>(sQ, qb + r0 * sq.n, sq.n, n - r0, kRows, true, scale);
  const int ext = strip_extent(table, n, r0, &s_ext);
  const int nkt = (ext + kTile - 1) / kTile;
  strip_scores<D>(sS, ld, sQ, sKV, kb, sk.n, n, nkt);

  // exact softmax per row; bf16(p) overwrites the row's own f32 scores. Each
  // 32-column chunk is read by the whole warp before any lane writes it: the
  // bf16 value of column c lands inside f32 column c / 2 <= c.
  for (int r = warp; r < kRows; r += kWarps) {
    const int i = r0 + r;
    float* srow = sS + r * ld;
    bf16* prow = reinterpret_cast<bf16*>(srow);
    const float2 ml = i < n ? row_stats(srow, table, n, i, ext) : make_float2(0.f, 1.f);
    for (int c0 = 0; c0 < nkt * kTile; c0 += 32) {
      const int c = c0 + lane;
      float p = 0.f;
      if (i < n && c < ext) p = prob(srow[c], ml.x, ml.y, visible(table, n, i, c), c, n);
      __syncwarp();
      prow[c] = __float2bfloat16(p);
    }
  }

  // o = p16 . v
  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
  const bf16* sP = reinterpret_cast<const bf16*>(sS);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<D>(sKV, vb + static_cast<long long>(kt) * kTile * sv.n, sv.n, n - kt * kTile, kTile,
                 false, 0.f);
    __syncthreads();
    warp_pv<D, NF>(acc, sP, ldp, 16 * (warp & 1), kt * kTile, sKV, warp >> 1);
  }
  __syncthreads();
  stage_strip<D, NF>(sO, acc, warp, 1.f);
  __syncthreads();
  store_rows<OutT, D>(out + ((static_cast<size_t>(bb) * heads + hh) * n + r0) * D, sO,
                      min(kRows, n - r0));
}

// ---------------------------------------------------------------------------
// backward (a): row statistics, delta and dq; grid (row strips, h, b), 8 warps
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
persist_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout, Strides sq,
                  Strides sk, Strides sv, Strides sd, const int8_t* __restrict__ table,
                  float* __restrict__ stats, OutT* __restrict__ dq, int batch, int heads, int n,
                  float scale) {
  constexpr int NF = (D / 16 + 3) / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + strip_bytes<D>());
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * strip_bytes<D>());
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * strip_bytes<D>() + tile_bytes<D>());
  const int ld = score_ld(n);
  float* sS = reinterpret_cast<float*>(smem + 2 * strip_bytes<D>() + 2 * tile_bytes<D>());
  float* sT = sS + kRows * ld;                           // (kRows, 64) dp tile
  bf16* sP = reinterpret_cast<bf16*>(sT + kRows * kLdT);  // (kRows, 64) p16 / ds tile
  float* sO = reinterpret_cast<float*>(sK);               // staging, between sweeps
  __shared__ int s_ext;
  __shared__ float s_m[kRows], s_l[kRows], s_delta[kRows];

  const int r0 = blockIdx.x * kRows, hh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(kRows, n - r0);
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;

  load_rows<D>(sQ, q + bb * sq.b + hh * sq.h + r0 * sq.n, sq.n, rows, kRows, true, scale);
  load_rows<D>(sdO, dout + bb * sd.b + hh * sd.h + r0 * sd.n, sd.n, rows, kRows, false, 0.f);
  const int ext = strip_extent(table, n, r0, &s_ext);
  const int nkt = (ext + kTile - 1) / kTile;
  strip_scores<D>(sS, ld, sQ, sK, kb, sk.n, n, nkt);

  // p in f32, in place of the scores
  for (int r = warp; r < kRows; r += kWarps) {
    const int i = r0 + r;
    float* srow = sS + r * ld;
    const float2 ml = i < n ? row_stats(srow, table, n, i, ext) : make_float2(0.f, 1.f);
    for (int c = lane; c < nkt * kTile; c += 32) {
      float p = 0.f;
      if (i < n && c < ext) p = prob(srow[c], ml.x, ml.y, visible(table, n, i, c), c, n);
      srow[c] = p;
    }
    if (lane == 0) {
      s_m[r] = ml.x;
      s_l[r] = ml.y;
    }
  }

  // sweep 1: o = p16 . v in f32, then delta = rowsum(o * dO)
  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<D>(sV, vb + static_cast<long long>(kt) * kTile * sv.n, sv.n, n - kt * kTile, kTile,
                 false, 0.f);
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx - r * kTile;
      sP[r * kLdP + c] = __float2bfloat16(sS[r * ld + kt * kTile + c]);
    }
    __syncthreads();
    warp_pv<D, NF>(acc, sP, kLdP, 16 * (warp & 1), 0, sV, warp >> 1);
  }
  __syncthreads();
  stage_strip<D, NF>(sO, acc, warp, 1.f);
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps) {
    float delta = 0.f;
    for (int c = lane; c < D; c += 32)
      delta += sO[r * ld_out<D>() + c] * __bfloat162float(sdO[r * ld_op<D>() + c]);
    delta = warp_sum(delta);
    if (lane == 0) s_delta[r] = delta;
  }

  // sweep 2: dp = dO . v^T, ds = bf16(p * (dp - delta)), dq += ds . k
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    const long long off = static_cast<long long>(kt) * kTile;
    load_rows<D>(sK, kb + off * sk.n, sk.n, n - kt * kTile, kTile, false, 0.f);
    load_rows<D>(sV, vb + off * sv.n, sv.n, n - kt * kTile, kTile, false, 0.f);
    __syncthreads();
    warp_abt<D>(sT, kLdT, sdO, sV, 16 * (warp & 1), 16 * (warp >> 1), 16 * (warp >> 1));
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx - r * kTile;
      const float p = sS[r * ld + kt * kTile + c];
      sP[r * kLdP + c] = __float2bfloat16(p * (sT[r * kLdT + c] - s_delta[r]));
    }
    __syncthreads();
    warp_pv<D, NF>(acc, sP, kLdP, 16 * (warp & 1), 0, sK, warp >> 1);
  }
  __syncthreads();
  stage_strip<D, NF>(sO, acc, warp, scale);
  __syncthreads();
  const size_t row0 = (static_cast<size_t>(bb) * heads + hh) * n + r0;
  store_rows<OutT, D>(dq + row0 * D, sO, rows);
  const size_t plane = static_cast<size_t>(batch) * heads * n;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    stats[row0 + r] = s_m[r];
    stats[plane + row0 + r] = s_l[r];
    stats[2 * plane + row0 + r] = s_delta[r];
  }
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv; grid (64-column strips, h, b), 8 warps
// ---------------------------------------------------------------------------
template <typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
persist_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout, Strides sq,
                   Strides sk, Strides sv, Strides sd, const int8_t* __restrict__ table,
                   const float* __restrict__ stats, OutT* __restrict__ dk,
                   OutT* __restrict__ dv, int batch, int heads, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + tile_bytes<D>());
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * tile_bytes<D>());
  bf16* sQs = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<D>());
  bf16* sdO = reinterpret_cast<bf16*>(smem + 4 * tile_bytes<D>());
  float* sSt = reinterpret_cast<float*>(smem + 5 * tile_bytes<D>());
  float* sdPt = sSt + kTile * kLdT;
  bf16* sPt = reinterpret_cast<bf16*>(sdPt + kTile * kLdT);
  bf16* sdSt = sPt + kTile * kLdP;
  float* sM = reinterpret_cast<float*>(sdSt + kTile * kLdP);
  float* sL = sM + kTile;
  float* sD = sL + kTile;
  float* sOut = reinterpret_cast<float*>(sQ);  // dv then dk, (64, D + 4) each

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nt = (n + kTile - 1) / kTile;
  const int c0 = kt * kTile;
  const int krows = min(kTile, n - c0);
  const int warp = threadIdx.x >> 5;
  const int rb = warp & 3;       // this warp's 16 key rows
  const bool is_dk = warp >= 4;  // warps 0-3 accumulate dv, 4-7 dk
  const size_t stat0 = (static_cast<size_t>(bb) * heads + hh) * n;
  const size_t plane = static_cast<size_t>(batch) * heads * n;
  const bf16* qb = q + bb * sq.b + hh * sq.h;
  const bf16* db = dout + bb * sd.b + hh * sd.h;

  load_rows<D>(sK, k + bb * sk.b + hh * sk.h + c0 * sk.n, sk.n, krows, kTile, false, 0.f);
  load_rows<D>(sV, v + bb * sv.b + hh * sv.h + c0 * sv.n, sv.n, krows, kTile, false, 0.f);

  FragC acc[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int qt = table == nullptr ? kt : 0; qt < nt; ++qt) {
    const int r0 = qt * kTile;
    const int qrows = min(kTile, n - r0);
    if (table != nullptr) {
      // a query tile matters if one of its rows sees one of these columns,
      // or sees nothing at all (then it sees every column at 1/n)
      bool used = false;
      for (int idx = threadIdx.x; idx < qrows * kTile && !used; idx += kThreads) {
        const int r = idx / kTile, c = idx - r * kTile;
        used = (c < krows && table[static_cast<size_t>(r0 + r) * n + c0 + c] != 0) ||
               (c == 0 && stats[stat0 + r0 + r] == -INFINITY);
      }
      if (!__syncthreads_or(used)) continue;
    }
    __syncthreads();
    const bf16* qsrc = qb + r0 * sq.n;
    load_rows<D>(sQ, qsrc, sq.n, qrows, kTile, false, 0.f);
    load_rows<D>(sQs, qsrc, sq.n, qrows, kTile, true, scale);
    load_rows<D>(sdO, db + r0 * sd.n, sd.n, qrows, kTile, false, 0.f);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool in = r < qrows;
      sM[r] = in ? stats[stat0 + r0 + r] : 0.f;
      sL[r] = in ? stats[plane + stat0 + r0 + r] : 1.f;
      sD[r] = in ? stats[2 * plane + stat0 + r0 + r] : 0.f;
    }
    __syncthreads();
    // s^T (keys x queries) and dp^T: each warp 16 key rows x 32 query columns
    for (int cc = 0; cc < 2; ++cc) {
      const int col = 32 * (warp >> 2) + 16 * cc;
      warp_abt<D>(sSt, kLdT, sK, sQs, 16 * rb, col, col);
      warp_abt<D>(sdPt, kLdT, sV, sdO, 16 * rb, col, col);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx >> 6, c = idx & (kTile - 1);
      const int i = r0 + c, j = c0 + r;
      float p = 0.f;
      if (i < n && j < n) p = prob(sSt[r * kLdT + c], sM[c], sL[c], visible(table, n, i, j), j, n);
      sPt[r * kLdP + c] = __float2bfloat16(p);
      sdSt[r * kLdP + c] = __float2bfloat16(p * (sdPt[r * kLdT + c] - sD[c]));
    }
    __syncthreads();
    // dk += ds^T . q, dv += p16^T . dO
    const bf16* A = is_dk ? sdSt : sPt;
    const bf16* B = is_dk ? sQ : sdO;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, A + 16 * rb * kLdP + kk, kLdP);
#pragma unroll
      for (int f = 0; f < D / 16; ++f) {
        FragBRow b;
        wmma::load_matrix_sync(b, B + kk * ld_op<D>() + 16 * f, ld_op<D>());
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
  __syncthreads();
  float* dst = sOut + (is_dk ? kTile * ld_out<D>() : 0);
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    if (is_dk) {
      for (int t = 0; t < acc[f].num_elements; ++t) acc[f].x[t] *= scale;
    }
    wmma::store_matrix_sync(dst + 16 * rb * ld_out<D>() + 16 * f, acc[f], ld_out<D>(),
                            wmma::mem_row_major);
  }
  __syncthreads();
  const size_t row0 = stat0 + c0;
  store_rows<OutT, D>(dv + row0 * D, sOut, krows);
  store_rows<OutT, D>(dk + row0 * D, sOut + kTile * ld_out<D>(), krows);
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename OutT, int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const long long* st,
               const int8_t* table, void* out, int b, int h, int n, float scale,
               cudaStream_t stream) {
  auto kernel = persist_fwd_kernel<OutT, D>;
  const int smem = fwd_smem<D>(n);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, Strides{st[0], st[1], st[2]},
                                           Strides{st[3], st[4], st[5]},
                                           Strides{st[6], st[7], st[8]}, table,
                                           static_cast<OutT*>(out), h, n, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int D>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const long long* st, const int8_t* table, float* stats, void* dq, void* dk,
               void* dv, int b, int h, int n, float scale, cudaStream_t stream) {
  auto dq_kernel = persist_dq_kernel<OutT, D>;
  auto dkv_kernel = persist_dkv_kernel<OutT, D>;
  const int smem_dq = dq_smem<D>(n);
  constexpr int kSmemDkv = dkv_smem<D>();
  cudaError_t err = set_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem(dkv_kernel, kSmemDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sd{st[9], st[10], st[11]};
  dq_kernel<<<dim3((n + kRows - 1) / kRows, h, b), kThreads, smem_dq, stream>>>(
      q, k, v, dout, sq, sk, sv, sd, table, stats, static_cast<OutT*>(dq), b, h, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((n + kTile - 1) / kTile, h, b), kThreads, kSmemDkv, stream>>>(
      q, k, v, dout, sq, sk, sv, sd, table, stats, static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), b, h, n, scale);
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

template <int D> long long smem_of(int n) {
  const long long a = fwd_smem<D>(n), b = dq_smem<D>(n), c = dkv_smem<D>();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

}  // namespace

// Forward. q, k, v bf16 (b, h, n, d) with `strides` = 3 (b, h, n) element
// strides per operand, in that order; out (b, h, n, d) contiguous of
// `out_dtype` (0 f32, 1 bf16). `table` (n, n) int8 may be null (plain
// causal). Returns a CUDA error code, 0 when the launch was accepted.
extern "C" int persist_fwd(const void* q, const void* k, const void* v, const long long* strides,
                           const int8_t* table, void* out, int out_dtype, int b, int h, int n,
                           int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  if (out_dtype == kF32) {
    PA_DISPATCH_D(launch_fwd, float, qq, kk, vv, strides, table, out, b, h, n, scale, s)
  }
  if (out_dtype == kBF16) {
    PA_DISPATCH_D(launch_fwd, bf16, qq, kk, vv, strides, table, out, b, h, n, scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward: two kernels on `stream`, dq (which writes each row's m, l and
// delta into `stats`, f32 (3, b, h, n) scratch) then dk/dv. q, k, v, dO bf16
// with 4 x 3 strides; dq, dk, dv (b, h, n, d) contiguous of `out_dtype`.
extern "C" int persist_bwd(const void* q, const void* k, const void* v, const void* dout,
                           const long long* strides, const int8_t* table, float* stats, void* dq,
                           void* dk, void* dv, int out_dtype, int b, int h, int n, int d,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v), *oo = static_cast<const bf16*>(dout);
  if (out_dtype == kF32) {
    PA_DISPATCH_D(launch_bwd, float, qq, kk, vv, oo, strides, table, stats, dq, dk, dv, b, h, n,
                  scale, s)
  }
  if (out_dtype == kBF16) {
    PA_DISPATCH_D(launch_bwd, bf16, qq, kk, vv, oo, strides, table, stats, dq, dk, dv, b, h, n,
                  scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most dynamic shared memory any of the three kernels takes at (n, d);
// 0 for a d the kernels are not built for.
extern "C" long long persist_smem_bytes(int n, int d) {
  switch (d) {
    case 16: return smem_of<16>(n);
    case 32: return smem_of<32>(n);
    case 48: return smem_of<48>(n);
    case 64: return smem_of<64>(n);
    case 80: return smem_of<80>(n);
    case 96: return smem_of<96>(n);
    case 112: return smem_of<112>(n);
    case 128: return smem_of<128>(n);
    default: return 0;
  }
}
