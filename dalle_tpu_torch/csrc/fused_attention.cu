// Fused-boundary causal attention straight off the merged qkv layout, forward
// and backward, for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/fused_attention.py::_fused_fwd (Pallas body
// _fwd_kernel) and ::_fused_bwd (body _bwd_kernel). The operand is the qkv
// projection's own (b, n, 3*h*d) layout, [q_0..q_{h-1} | k_0.. | v_0..], in
// f32 or bf16; the output is the merged (b, n, h*d) layout in the same type,
// and the gradient dqkv lands in the (b, n, 3*h*d) layout. The arithmetic is
// the TPU kernel's, rounding for rounding:
//   q, k, v, dO are rounded to bf16; qs = bf16(f32(q) * scale);
//   s = qs.k in f32; a hidden (i, j) pair adds nothing (the TPU kernel's
//   -1e9 fill makes its exp exactly 0);
//   p = exp(s - m) / l in f32 (m the row max, l the row sum), p16 = bf16(p);
//   o = p16.v in f32, written in the operand's type.
// Backward: dp = dO.v, o = p16.v recomputed in f32, delta = rowsum(o * dO),
//   ds = bf16(p * (dp - delta)), dq = ds.k * scale, dk = ds^T.q * scale with
//   the UNSCALED bf16 q, dv = p16^T.dO, all accumulated in f32.
// Visibility is j <= i, or an int8 (n, n) table (causality included) with an
// int8 (nt, nt) map of the 64x64 tiles that hold any visible pair.
//
// Bound on the card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At the
// training main shape (b=8, n=512, h=14, d=128, bf16), counting the causal
// half of the pairs (b*h*n*(n+1)/2 = 14.7M):
//   forward  2 products * 2*d flops per pair = 7.5 GFLOP   -> 7.6 us;
//            qkv read + out write + (m, l) = 44.0 + 14.7 + 0.5 MB = 59 MB -> 17.7 us;
//   backward 6 products (s, o, dp, dq, dk, dv) = 22.6 GFLOP -> 23 us;
//            qkv + dO + (m, l) read, dqkv written = 103 MB -> 31 us.
// Both are bound by bytes. chip_smoke.py recomputes these from its inputs.
//
// Design (first version: simple, exact, deterministic; no atomics):
//   * tiles of 64 query rows and 64 key rows; bf16 tiles in shared memory,
//     products by nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators;
//   * forward, one CTA of 4 warps per (64-row q tile, head, batch row); each
//     warp owns 16 query rows. Pass 1 streams the k tiles at or below the
//     diagonal for each row's max and sum; pass 2 streams k and v again,
//     forms p in f32, rounds it to bf16 and accumulates p16.v. The per-row
//     (m, l) are saved, f32 (b, h, n), for the backward;
//   * backward (a), one CTA of 4 warps per q tile: recompute p from (m, l),
//     o = p16.v, delta (written, f32 (b, h, n)), then a second sweep for dq;
//   * backward (b), one CTA of 8 warps per 64-row k tile: walk the q tiles at
//     or below the diagonal; warps 0-3 accumulate dv, warps 4-7 dk;
//   * tiles wholly above the diagonal, and tiles the map marks empty, are
//     never read. The row max, sum and delta use a fixed order, so repeated
//     runs give the same bits.
// The bound is bytes, and this design reads each k/v tile once per q tile
// (twice in the forward): it is far from the bound. Staging with TMA/cp.async,
// wgmma, and one pass with an online softmax are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kTile = 64;              // query rows and key rows per tile
constexpr int kLdS = kTile + 4;        // f32 score tile row stride
constexpr int kLdP = kTile + 8;        // bf16 probability tile row stride

enum DType { kF32 = 0, kBF16 = 1 };

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// eight consecutive values as f32, each rounded to bf16 (the TPU kernel casts
// its operands to bf16 first)
template <typename T> __device__ __forceinline__ void load8(const T* src, float* f);

template <> __device__ __forceinline__ void load8<float>(const float* src, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  f[0] = round_bf16(a.x); f[1] = round_bf16(a.y); f[2] = round_bf16(a.z); f[3] = round_bf16(a.w);
  f[4] = round_bf16(b.x); f[5] = round_bf16(b.y); f[6] = round_bf16(b.z); f[7] = round_bf16(b.w);
}

template <> __device__ __forceinline__ void load8<bf16>(const bf16* src, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// 64 rows x D columns of the operand (row stride ld elements) into a bf16
// shared tile of row stride D + 8; rows at or past `rows` are zero. With
// `scaled`, each value becomes bf16(f32(bf16(x)) * scale), the query rounding.
template <typename T, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const T* src, size_t ld, int rows,
                                          bool scaled, float scale, int nthreads) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    float f[8];
    if (r < rows) {
      load8<T>(src + static_cast<size_t>(r) * ld + c, f);
      if (scaled) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] *= scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    uint4 packed;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = packed;
  }
}

// f32 (64, D) tile in shared memory (row stride D + 4) -> rows [0, rows) of
// the operand-typed output at row stride ld
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, size_t ld, const float* src, int rows,
                                           int nthreads) {
  constexpr int kLd = D + 4;
  for (int idx = threadIdx.x; idx < rows * D; idx += nthreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[static_cast<size_t>(r) * ld + c] = from_f32<T>(src[r * kLd + c]);
  }
}

__device__ __forceinline__ bool visible(const int8_t* table, int n, int i, int j) {
  if (i >= n || j >= n) return false;
  return table != nullptr ? table[static_cast<size_t>(i) * n + j] != 0 : j <= i;
}

__device__ __forceinline__ bool tile_used(const int8_t* tiles, int nt, int qt, int kt) {
  return tiles == nullptr || tiles[qt * nt + kt] != 0;
}

// S[row0:row0+16, col0:col0+16*NC] = A[row0:+16, :D] . B[col0:+16*NC, :D]^T,
// A and B bf16 tiles of row stride D + 8, S f32 of row stride kLdS
template <int D, int NC>
__device__ __forceinline__ void warp_abt(float* S, const bf16* A, const bf16* B, int row0,
                                         int col0) {
  constexpr int kLd = D + 8;
  FragC acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + row0 * kLd + k, kLd);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      FragBCol b;
      wmma::load_matrix_sync(b, B + (col0 + 16 * c) * kLd + k, kLd);
      wmma::mma_sync(acc[c], a, b, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    wmma::store_matrix_sync(S + row0 * kLdS + col0 + 16 * c, acc[c], kLdS, wmma::mem_row_major);
}

// acc[0:D/16] += P[row0:row0+16, 0:64] . V[0:64, 0:D]; P bf16 of row stride
// kLdP, V bf16 of row stride D + 8
template <int D>
__device__ __forceinline__ void warp_pv(FragC* acc, const bf16* P, const bf16* V, int row0) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, P + row0 * kLdP + kk, kLdP);
#pragma unroll
    for (int f = 0; f < D / 16; ++f) {
      FragBRow b;
      wmma::load_matrix_sync(b, V + kk * kLd + 16 * f, kLd);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

template <int D>
__device__ __forceinline__ void warp_stage(float* dst, FragC* acc, int row0, float mul) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    if (mul != 1.f) {
#pragma unroll
      for (int t = 0; t < acc[f].num_elements; ++t) acc[f].x[t] *= mul;
    }
    wmma::store_matrix_sync(dst + row0 * kLd + 16 * f, acc[f], kLd, wmma::mem_row_major);
  }
}

template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * (D + 8) * 2; }
constexpr int kScoreBytes = kTile * kLdS * 4;
constexpr int kProbBytes = kTile * kLdP * 2;

template <int D> __host__ __device__ constexpr int fwd_smem() { return 3 * tile_bytes<D>() + kScoreBytes + kProbBytes; }
template <int D> __host__ __device__ constexpr int bwd_dq_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + kProbBytes;
}
template <int D> __host__ __device__ constexpr int bwd_dkv_smem() {
  return 5 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kProbBytes + 3 * kTile * 4;
}

// ---------------------------------------------------------------------------
// forward: grid (nt, h, b), 4 warps
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128)
fwd_kernel(const T* __restrict__ qkv, const int8_t* __restrict__ table,
           const int8_t* __restrict__ tiles, T* __restrict__ out, float* __restrict__ m_out,
           float* __restrict__ l_out, int n, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + tile_bytes<D>());
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * tile_bytes<D>());
  float* sS = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<D>() + kScoreBytes);
  float* sO = reinterpret_cast<float*>(sK);     // after the sweeps: K and V are done

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nt = (n + kTile - 1) / kTile;
  const int hd = heads * D;
  const size_t ld = 3 * static_cast<size_t>(hd);
  const T* base = qkv + static_cast<size_t>(bb) * n * ld;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;   // row statistics
  const int i = q0 + row;

  load_tile<T, D>(sQ, base + static_cast<size_t>(q0) * ld + hh * D, ld, min(kTile, n - q0),
                  true, scale, 128);

  // pass 1: row max and sum over the visible pairs (online over k tiles)
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    if (!tile_used(tiles, nt, qt, kt)) continue;
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(sK, base + static_cast<size_t>(k0) * ld + hd + hh * D, ld,
                    min(kTile, n - k0), false, 0.f, 128);
    __syncthreads();
    warp_abt<D, 4>(sS, sQ, sK, 16 * warp, 0);
    __syncwarp();
    float tmax = -INFINITY;
    for (int c = half * 32; c < half * 32 + 32; ++c)
      if (visible(table, n, i, k0 + c)) tmax = fmaxf(tmax, sS[row * kLdS + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // every lane of the warp reaches the shuffles; a row with nothing
    // visible yet (m_new = -inf) keeps (m, l) as they are
    const float m_new = fmaxf(m, tmax);
    float sum = 0.f;
    if (m_new != -INFINITY) {
      for (int c = half * 32; c < half * 32 + 32; ++c)
        if (visible(table, n, i, k0 + c)) sum += expf(sS[row * kLdS + c] - m_new);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (m_new != -INFINITY) {
      l = l * expf(m - m_new) + sum;
      m = m_new;
    }
  }
  if (half == 0 && i < n) {
    const size_t at = (static_cast<size_t>(bb) * heads + hh) * n + i;
    m_out[at] = m;
    l_out[at] = l;
  }

  // pass 2: p = exp(s - m) / l, rounded to bf16, times v
  FragC acc[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int kt = 0; kt <= qt; ++kt) {
    if (!tile_used(tiles, nt, qt, kt)) continue;
    const int k0 = kt * kTile;
    const int rows = min(kTile, n - k0);
    __syncthreads();
    load_tile<T, D>(sK, base + static_cast<size_t>(k0) * ld + hd + hh * D, ld, rows, false,
                    0.f, 128);
    load_tile<T, D>(sV, base + static_cast<size_t>(k0) * ld + 2 * hd + hh * D, ld, rows, false,
                    0.f, 128);
    __syncthreads();
    warp_abt<D, 4>(sS, sQ, sK, 16 * warp, 0);
    __syncwarp();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = visible(table, n, i, k0 + c) ? expf(sS[row * kLdS + c] - m) / l : 0.f;
      sP[row * kLdP + c] = __float2bfloat16(p);
    }
    __syncwarp();
    warp_pv<D>(acc, sP, sV, 16 * warp);
  }
  __syncthreads();
  warp_stage<D>(sO, acc, 16 * warp, 1.f);
  __syncthreads();
  store_tile<T, D>(out + (static_cast<size_t>(bb) * n + q0) * hd + hh * D, hd, sO,
                   min(kTile, n - q0), 128);
}

// ---------------------------------------------------------------------------
// backward (a): delta and dq; grid (nt, h, b), 4 warps
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
              const int8_t* __restrict__ table, const int8_t* __restrict__ tiles,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ delta_out, T* __restrict__ dqkv, int n, int heads,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + tile_bytes<D>());
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * tile_bytes<D>());
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<D>());
  float* sS = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>());
  float* sdP = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>() + kScoreBytes);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * tile_bytes<D>() + 2 * kScoreBytes);
  float* sO = reinterpret_cast<float*>(sK);

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nt = (n + kTile - 1) / kTile;
  const int hd = heads * D;
  const size_t ld = 3 * static_cast<size_t>(hd);
  const T* base = qkv + static_cast<size_t>(bb) * n * ld;
  const int q0 = qt * kTile;
  const int qrows = min(kTile, n - q0);
  const int warp = threadIdx.x >> 5;
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int i = q0 + row;
  const size_t at = (static_cast<size_t>(bb) * heads + hh) * n + i;
  const float m = i < n ? m_in[at] : 0.f;
  const float l = i < n ? l_in[at] : 1.f;

  load_tile<T, D>(sQ, base + static_cast<size_t>(q0) * ld + hh * D, ld, qrows, true, scale, 128);
  load_tile<T, D>(sdO, dout + (static_cast<size_t>(bb) * n + q0) * hd + hh * D, hd, qrows,
                  false, 0.f, 128);

  // sweep 1: o = p16.v in f32, then delta = rowsum(o * dO)
  FragC acc[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int kt = 0; kt <= qt; ++kt) {
    if (!tile_used(tiles, nt, qt, kt)) continue;
    const int k0 = kt * kTile;
    const int rows = min(kTile, n - k0);
    __syncthreads();
    load_tile<T, D>(sK, base + static_cast<size_t>(k0) * ld + hd + hh * D, ld, rows, false,
                    0.f, 128);
    load_tile<T, D>(sV, base + static_cast<size_t>(k0) * ld + 2 * hd + hh * D, ld, rows, false,
                    0.f, 128);
    __syncthreads();
    warp_abt<D, 4>(sS, sQ, sK, 16 * warp, 0);
    __syncwarp();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = visible(table, n, i, k0 + c) ? expf(sS[row * kLdS + c] - m) / l : 0.f;
      sP[row * kLdP + c] = __float2bfloat16(p);
    }
    __syncwarp();
    warp_pv<D>(acc, sP, sV, 16 * warp);
  }
  __syncthreads();
  warp_stage<D>(sO, acc, 16 * warp, 1.f);
  __syncwarp();
  float delta = 0.f;
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
    delta += sO[row * (D + 4) + c] * __bfloat162float(sdO[row * (D + 8) + c]);
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (half == 0 && i < n) delta_out[at] = delta;

  // sweep 2: ds = bf16(p * (dp - delta)), dq += ds.k
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int kt = 0; kt <= qt; ++kt) {
    if (!tile_used(tiles, nt, qt, kt)) continue;
    const int k0 = kt * kTile;
    const int rows = min(kTile, n - k0);
    __syncthreads();
    load_tile<T, D>(sK, base + static_cast<size_t>(k0) * ld + hd + hh * D, ld, rows, false,
                    0.f, 128);
    load_tile<T, D>(sV, base + static_cast<size_t>(k0) * ld + 2 * hd + hh * D, ld, rows, false,
                    0.f, 128);
    __syncthreads();
    warp_abt<D, 4>(sS, sQ, sK, 16 * warp, 0);
    warp_abt<D, 4>(sdP, sdO, sV, 16 * warp, 0);
    __syncwarp();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      float ds = 0.f;
      if (visible(table, n, i, k0 + c)) {
        const float p = expf(sS[row * kLdS + c] - m) / l;
        ds = p * (sdP[row * kLdS + c] - delta);
      }
      sP[row * kLdP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_pv<D>(acc, sP, sK, 16 * warp);
  }
  __syncthreads();
  warp_stage<D>(sO, acc, 16 * warp, scale);
  __syncthreads();
  store_tile<T, D>(dqkv + (static_cast<size_t>(bb) * n + q0) * ld + hh * D, ld, sO, qrows, 128);
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv; grid (nt, h, b), 8 warps
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
               const int8_t* __restrict__ table, const int8_t* __restrict__ tiles,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ delta_in, T* __restrict__ dqkv, int n, int heads,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + tile_bytes<D>());
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * tile_bytes<D>());
  bf16* sQs = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<D>());
  bf16* sdO = reinterpret_cast<bf16*>(smem + 4 * tile_bytes<D>());
  float* sSt = reinterpret_cast<float*>(smem + 5 * tile_bytes<D>());
  float* sdPt = reinterpret_cast<float*>(smem + 5 * tile_bytes<D>() + kScoreBytes);
  bf16* sPt = reinterpret_cast<bf16*>(smem + 5 * tile_bytes<D>() + 2 * kScoreBytes);
  bf16* sdSt = reinterpret_cast<bf16*>(smem + 5 * tile_bytes<D>() + 2 * kScoreBytes +
                                       kProbBytes);
  float* sM = reinterpret_cast<float*>(smem + 5 * tile_bytes<D>() + 2 * kScoreBytes +
                                       2 * kProbBytes);
  float* sL = sM + kTile;
  float* sD = sL + kTile;
  float* sOut = reinterpret_cast<float*>(sQ);    // dv then dk, (64, D + 4) each

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nt = (n + kTile - 1) / kTile;
  const int hd = heads * D;
  const size_t ld = 3 * static_cast<size_t>(hd);
  const T* base = qkv + static_cast<size_t>(bb) * n * ld;
  const int k0 = kt * kTile;
  const int krows = min(kTile, n - k0);
  const int warp = threadIdx.x >> 5;
  const int rb = warp & 3;           // this warp's 16 key rows
  const bool is_dk = warp >= 4;      // warps 0-3 accumulate dv, 4-7 dk
  const size_t stat0 = (static_cast<size_t>(bb) * heads + hh) * n;

  load_tile<T, D>(sK, base + static_cast<size_t>(k0) * ld + hd + hh * D, ld, krows, false, 0.f,
                  256);
  load_tile<T, D>(sV, base + static_cast<size_t>(k0) * ld + 2 * hd + hh * D, ld, krows, false,
                  0.f, 256);

  FragC acc[D / 16];
#pragma unroll
  for (int f = 0; f < D / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int qt = kt; qt < nt; ++qt) {
    if (!tile_used(tiles, nt, qt, kt)) continue;
    const int q0 = qt * kTile;
    const int qrows = min(kTile, n - q0);
    __syncthreads();
    const T* qsrc = base + static_cast<size_t>(q0) * ld + hh * D;
    load_tile<T, D>(sQ, qsrc, ld, qrows, false, 0.f, 256);
    load_tile<T, D>(sQs, qsrc, ld, qrows, true, scale, 256);
    load_tile<T, D>(sdO, dout + (static_cast<size_t>(bb) * n + q0) * hd + hh * D, hd, qrows,
                    false, 0.f, 256);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool in = r < qrows;
      sM[r] = in ? m_in[stat0 + q0 + r] : 0.f;
      sL[r] = in ? l_in[stat0 + q0 + r] : 1.f;
      sD[r] = in ? delta_in[stat0 + q0 + r] : 0.f;
    }
    __syncthreads();
    // s^T (keys x queries) and dp^T: each warp 16 key rows x 32 query columns
    warp_abt<D, 2>(sSt, sK, sQs, 16 * rb, 32 * (warp >> 2));
    warp_abt<D, 2>(sdPt, sV, sdO, 16 * rb, 32 * (warp >> 2));
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += 256) {
      const int r = idx >> 6, c = idx & (kTile - 1);
      float p = 0.f, ds = 0.f;
      if (visible(table, n, q0 + c, k0 + r)) {
        p = expf(sSt[r * kLdS + c] - sM[c]) / sL[c];
        ds = p * (sdPt[r * kLdS + c] - sD[c]);
      }
      sPt[r * kLdP + c] = __float2bfloat16(p);
      sdSt[r * kLdP + c] = __float2bfloat16(ds);
    }
    __syncthreads();
    if (is_dk) warp_pv<D>(acc, sdSt, sQ, 16 * rb);    // dk += ds^T . q
    else       warp_pv<D>(acc, sPt, sdO, 16 * rb);    // dv += p16^T . dO
  }
  __syncthreads();
  warp_stage<D>(sOut + (is_dk ? kTile * (D + 4) : 0), acc, 16 * rb, is_dk ? scale : 1.f);
  __syncthreads();
  T* drow = dqkv + (static_cast<size_t>(bb) * n + k0) * ld + hh * D;
  store_tile<T, D>(drow + hd, ld, sOut + kTile * (D + 4), krows, 256);
  store_tile<T, D>(drow + 2 * hd, ld, sOut, krows, 256);
}

template <typename T, int D>
int launch_fwd(const void* qkv, const int8_t* table, const int8_t* tiles, void* out, float* m,
               float* l, int b, int n, int heads, float scale, cudaStream_t stream) {
  auto kernel = fwd_kernel<T, D>;
  constexpr int kSmem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  kernel<<<grid, 128, kSmem, stream>>>(static_cast<const T*>(qkv), table, tiles,
                                       static_cast<T*>(out), m, l, n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* qkv, const void* dout, const int8_t* table, const int8_t* tiles,
               const float* m, const float* l, float* delta, void* dqkv, int b, int n,
               int heads, float scale, cudaStream_t stream) {
  auto dq = bwd_dq_kernel<T, D>;
  auto dkv = bwd_dkv_kernel<T, D>;
  constexpr int kSmemDq = bwd_dq_smem<D>();
  constexpr int kSmemDkv = bwd_dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, heads, b);
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  dq<<<grid, 128, kSmemDq, stream>>>(q, o, table, tiles, m, l, delta, g, n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<grid, 256, kSmemDkv, stream>>>(q, o, table, tiles, m, l, delta, g, n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

#define FA_DISPATCH_D(FN, T, ...)                          \
  switch (d) {                                             \
    case 16: return FN<T, 16>(__VA_ARGS__);                \
    case 32: return FN<T, 32>(__VA_ARGS__);                \
    case 48: return FN<T, 48>(__VA_ARGS__);                \
    case 64: return FN<T, 64>(__VA_ARGS__);                \
    case 80: return FN<T, 80>(__VA_ARGS__);                \
    case 96: return FN<T, 96>(__VA_ARGS__);                \
    case 112: return FN<T, 112>(__VA_ARGS__);              \
    case 128: return FN<T, 128>(__VA_ARGS__);              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// Forward. qkv (b, n, 3*heads*d) of `dtype` (0 f32, 1 bf16) -> out (b, n,
// heads*d) of the same type, m and l (b, heads, n) f32. `table` (n, n) and
// `tiles` (nt, nt) int8 may both be null (plain causal). Returns a CUDA error
// code, 0 when the launch was accepted.
extern "C" int fused_attention_fwd(const void* qkv, int dtype, const int8_t* table,
                                   const int8_t* tiles, void* out, float* m, float* l, int b,
                                   int n, int heads, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    FA_DISPATCH_D(launch_fwd, float, qkv, table, tiles, out, m, l, b, n, heads, scale, s)
  }
  if (dtype == kBF16) {
    FA_DISPATCH_D(launch_fwd, bf16, qkv, table, tiles, out, m, l, b, n, heads, scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward: two kernels on `stream`, dq (which writes delta) then dk/dv.
// dout (b, n, heads*d) and dqkv (b, n, 3*heads*d) of `dtype`; m, l from the
// forward; delta (b, heads, n) f32 scratch.
extern "C" int fused_attention_bwd(const void* qkv, const void* dout, int dtype,
                                   const int8_t* table, const int8_t* tiles, const float* m,
                                   const float* l, float* delta, void* dqkv, int b, int n,
                                   int heads, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    FA_DISPATCH_D(launch_bwd, float, qkv, dout, table, tiles, m, l, delta, dqkv, b, n, heads,
                  scale, s)
  }
  if (dtype == kBF16) {
    FA_DISPATCH_D(launch_bwd, bf16, qkv, dout, table, tiles, m, l, delta, dqkv, b, n, heads,
                  scale, s)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
