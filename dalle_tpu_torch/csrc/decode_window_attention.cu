// Windowed decode attention with per-row starts, over a dense cache slab (K3)
// or a paged block pool (K5), for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_window_kernel
// (body _decode_window_kernel) and decode_attend_window_paged, which gathers
// the pool into the dense slab and runs the same kernel. q (b, h, w, d): query
// j of row b sits at position starts[b] + j and sees the cache positions
// <= starts[b] + j. The cache row of position p holds K in its first h*d
// lanes and V in the rest, stored as f32, bf16 or int8 (int8 with f32 scales:
// K scale times the score, V scale times the probability). Softmax and every
// sum run in f32. For bf16 and int8 caches the TPU kernel feeds its matrix
// unit bf16 operands, so q*scale and the scaled probabilities are rounded to
// bf16 here too (K and V are exact in bf16); f32 caches stay f32 throughout.
// The output is divided by the softmax sum, or by 1 where it is 0.
//
// Addressing, the only difference between K3 and K5:
//   dense  row(b, p) = b*S + p                      in kv (b, S, 2hd),
//          scales (b, 2h, S);
//   paged  row(b, p) = pages[b, p/bt]*bt + p%bt      in pool (N, bt, 2hd),
//          scales (N, bt, 2h); an unmapped page (-1) is a row of zeros that
//          is never read, exactly what the JAX gather fills in.
// Everything else is one code path, so K5 equals K3 on the gathered slab
// bit for bit, and no slab is materialised per call.
//
// Bound: HBM bytes. A tile of queries streams the cache positions it can see
// once (b * positions * 2hd * itemsize); the flops are 4*d per (query,
// position) pair, far below the card's ops/byte balance even at w = 257.
//
// Design (first version, simple and exact):
//   * grid (ceil(w / TQ), h, b), 256 threads; TQ = 1 for w = 1 (a decode
//     step: K2's layout plus a per-row start) and 16 otherwise, so a refill
//     window of 257 queries is 17 tiles of the same kernel. The TPU's window
//     gate (decode_window_kernel_supported, max_window 64 plus a VMEM budget)
//     has no counterpart: every width runs here;
//   * the tile's scaled queries sit in shared memory; the key loop stops at
//     the tile's last visible position min(S, start + q_last + 1), so a
//     parked row (start = S) reads exactly S positions and nothing past them;
//   * pass 1: a group of lanes owns one position and splits d into 16-byte
//     loads; each lane dots its chunk with every query of the tile, a shuffle
//     reduction forms the TQ scores into a (TQ, S) f32 shared-memory tile;
//   * softmax: the block (one query) or one warp per query row (a tile) takes
//     max, exp and sum; the probability (times the V scale, rounded to bf16
//     when the cache is not f32) replaces the score in place;
//   * pass 2: a thread owns a few output dims of every query of the tile and
//     a strided set of positions, 4 V loads in flight; row groups are summed
//     in shared memory.
// Left for later: cp.async/TMA staging, wgmma for the w > 1 tiles, and
// splitting S across CTAs (b*h = 112 CTAs at w = 1, fewer than 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 16;
constexpr int kVU = 4;   // V rows a thread keeps in flight in pass 2

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> struct Vec;  // elements in one 16-byte load
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename Q> __device__ __forceinline__ Q from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// one 32-bit word of the cache as f32 values (4 / sizeof(T) of them),
// element 0 in the low bits
template <typename T> __device__ __forceinline__ void from_word(unsigned int w, float* f);
template <> __device__ __forceinline__ void from_word<float>(unsigned int w, float* f) {
  f[0] = __uint_as_float(w);
}
template <> __device__ __forceinline__ void from_word<__nv_bfloat16>(unsigned int w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void from_word<int8_t>(unsigned int w, float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xff));
}

// N consecutive elements at p (N * sizeof(T) in {4, 8, 16} bytes, aligned) as f32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int kBytes = N * sizeof(T);
  constexpr int kPer = 4 / sizeof(T);
  if constexpr (kBytes == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
    from_word<T>(r.z, f + 2 * kPer);
    from_word<T>(r.w, f + 3 * kPer);
  } else if constexpr (kBytes == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
  } else {
    static_assert(kBytes == 4, "loads of 4, 8 or 16 bytes");
    from_word<T>(__ldg(reinterpret_cast<const unsigned int*>(p)), f);
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

// lanes that share one cache position in pass 1: the power of two >= chunks, at most 32
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
// position p; 1 without scales, 0 for an unmapped page.
template <bool PAGED>
__device__ __forceinline__ float scale_at(const float* sc, long long row, int b, int p, int hr,
                                          int heads, int S) {
  if (sc == nullptr) return 1.f;
  if (PAGED) return row < 0 ? 0.f : sc[row * 2 * heads + hr];
  return sc[((long long)b * 2 * heads + hr) * S + p];
}

template <typename T, typename Q, int TQ, bool PAGED>
__global__ void __launch_bounds__(kThreads)
window_kernel(const Q* __restrict__ q, const T* __restrict__ kv,
              const float* __restrict__ kv_scale, Rows rows, const int* __restrict__ starts,
              Q* __restrict__ out, int heads, int w, int d, float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int DPT = TQ == 1 ? VEC : 4;  // output dims a thread owns in pass 2
  constexpr int KU = TQ == 1 ? 4 : 2;     // positions a lane group keeps in flight
  constexpr bool kRound = !std::is_same<T, float>::value;
  extern __shared__ float smem[];
  const int S = rows.S;
  const int chunks = d / VEC;
  const int vchunks = d / DPT;
  const int vrows = kThreads / vchunks;
  float* q_s = smem;            // TQ * d
  float* s_s = q_s + TQ * d;    // TQ * S: scores, then probabilities
  float* l_s = s_s + TQ * S;    // TQ
  float* red = l_s + TQ;        // 2 * kWarps
  float* acc_s = red + 2 * kWarps;  // vrows * TQ * d

  const int q0 = blockIdx.x * TQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = min(TQ, w - q0);
  const int start = starts[b];
  const int L = max(0, min(S, start + q0 + nq));  // positions the tile can see
  const long long row_stride = 2LL * heads * d;
  const T* kbase = kv + (long long)hh * d;
  const T* vbase = kv + (long long)(heads + hh) * d;

  const Q* qb = q + (((long long)b * heads + hh) * w + q0) * d;
  for (int x = tid; x < TQ * d; x += kThreads) {
    float v = 0.f;
    if (x < nq * d) {
      v = to_f32(qb[x]) * sm_scale;
      if (kRound) v = bf16_round(v);
    }
    q_s[x] = v;
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
          load_vec<T, VEC>(kbase + r[u] * row_stride + c * VEC, f);
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + i * d + c * VEC);
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
              const float4 qq = qv[e];
              s = fmaf(f[4 * e], qq.x, s);
              s = fmaf(f[4 * e + 1], qq.y, s);
              s = fmaf(f[4 * e + 2], qq.z, s);
              s = fmaf(f[4 * e + 3], qq.w, s);
            }
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
        const float ks = scale_at<PAGED>(kv_scale, r[u], b, j[u], hh, heads, S);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          s_s[i * S + j[u]] = j[u] <= start + q0 + i ? part[u][i] * ks : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax per query row; the probability replaces the score ----
  // (the probability times the V scale, rounded to bf16 when the cache is
  // not f32). One query: the whole block reduces its row, as K2 does; a tile
  // of queries: one warp per row.
  auto prob = [&](float s, float m, int p) {
    const float e = s == -INFINITY ? 0.f : expf(s - m);
    float pv = e;
    if (kv_scale != nullptr) {
      pv *= scale_at<PAGED>(kv_scale, rows.at<PAGED>(b, p), b, p, heads + hh, heads, S);
    }
    return make_float2(e, kRound ? bf16_round(pv) : pv);
  };
  if constexpr (TQ == 1) {
    float m = -INFINITY;
    for (int p = tid; p < L; p += kThreads) m = fmaxf(m, s_s[p]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k]);
    float l = 0.f;
    for (int p = tid; p < L; p += kThreads) {
      const float2 ep = prob(s_s[p], m, p);
      l += ep.x;
      s_s[p] = ep.y;
    }
    l = warp_sum(l);
    if (lane == 0) red[kWarps + warp] = l;
    __syncthreads();
    if (tid == 0) {
      l = 0.f;
      for (int k = 0; k < kWarps; ++k) l += red[kWarps + k];
      l_s[0] = l;
    }
  } else {
    for (int i = warp; i < TQ; i += kWarps) {
      float* srow = s_s + i * S;
      float m = -INFINITY;
      for (int p = lane; p < L; p += 32) m = fmaxf(m, srow[p]);
      m = warp_max(m);
      float l = 0.f;
      for (int p = lane; p < L; p += 32) {
        const float2 ep = prob(srow[p], m, p);
        l += ep.x;
        srow[p] = ep.y;
      }
      l = warp_sum(l);
      if (lane == 0) l_s[i] = l;
    }
  }
  __syncthreads();

  // ---- pass 2: probabilities times V ----
  const int vr = tid / vchunks;
  const int c = tid - vr * vchunks;
  if (vr < vrows) {
    float acc[TQ][DPT];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
    }
    for (int base = vr; base < L; base += vrows * kVU) {
      float f[kVU][DPT];
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int p = base + u * vrows;
        const long long r = p < L ? rows.at<PAGED>(b, p) : -1;
        if (r >= 0) {
          load_vec<T, DPT>(vbase + r * row_stride + c * DPT, f[u]);
        } else {
#pragma unroll
          for (int e = 0; e < DPT; ++e) f[u][e] = 0.f;
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
            for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pr, f[u][e], acc[i][e]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc_s[(vr * TQ + i) * d + c * DPT + e] = acc[i][e];
    }
  }
  __syncthreads();
  Q* ob = out + (((long long)b * heads + hh) * w + q0) * d;
  for (int x = tid; x < nq * d; x += kThreads) {
    const int i = x / d;
    const int dd = x - i * d;
    float o = 0.f;
    for (int rr = 0; rr < vrows; ++rr) o += acc_s[(rr * TQ + i) * d + dd];
    const float l = l_s[i];
    ob[x] = from_f32<Q>(o / (l > 0.f ? l : 1.f));
  }
}

template <int TQ, typename T>
size_t smem_bytes(int S, int d) {
  constexpr int DPT = TQ == 1 ? Vec<T>::N : 4;
  const int vrows = kThreads / (d / DPT);
  return sizeof(float) *
         ((size_t)TQ * d + (size_t)TQ * S + TQ + 2 * kWarps + (size_t)vrows * TQ * d);
}

template <typename T, typename Q, int TQ, bool PAGED>
int launch_tq(const void* q, const void* kv, const void* kv_scale, Rows rows,
              const void* starts, void* out, int b, int h, int w, int d, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<TQ, T>(rows.S, d);
  auto kern = window_kernel<T, Q, TQ, PAGED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((w + TQ - 1) / TQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(kv), static_cast<const float*>(kv_scale),
      rows, static_cast<const int*>(starts), static_cast<Q*>(out), h, w, d, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Q, bool PAGED>
int launch(const void* q, const void* kv, const void* kv_scale, Rows rows, const void* starts,
           void* out, int b, int h, int w, int d, float sm_scale, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (d <= 0 || d > 256 || d % VEC != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (w == 1) {
    return launch_tq<T, Q, 1, PAGED>(q, kv, kv_scale, rows, starts, out, b, h, w, d, sm_scale,
                                     stream);
  }
  return launch_tq<T, Q, kTileQ, PAGED>(q, kv, kv_scale, rows, starts, out, b, h, w, d,
                                        sm_scale, stream);
}

template <typename Q, bool PAGED>
int launch_kv(int kv_dtype, const void* q, const void* kv, const void* kv_scale, Rows rows,
              const void* starts, void* out, int b, int h, int w, int d, float sm_scale,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<float, Q, PAGED>(q, kv, kv_scale, rows, starts, out, b, h, w, d, sm_scale,
                                     stream);
    case kBF16:
      return launch<__nv_bfloat16, Q, PAGED>(q, kv, kv_scale, rows, starts, out, b, h, w, d,
                                             sm_scale, stream);
    case kI8:
      return launch<int8_t, Q, PAGED>(q, kv, kv_scale, rows, starts, out, b, h, w, d, sm_scale,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch_q(int q_dtype, int kv_dtype, const void* q, const void* kv, const void* kv_scale,
             Rows rows, const void* starts, void* out, int b, int h, int w, int d,
             float sm_scale, cudaStream_t stream) {
  switch (q_dtype) {
    case kF32:
      return launch_kv<float, PAGED>(kv_dtype, q, kv, kv_scale, rows, starts, out, b, h, w, d,
                                     sm_scale, stream);
    case kBF16:
      return launch_kv<__nv_bfloat16, PAGED>(kv_dtype, q, kv, kv_scale, rows, starts, out, b,
                                             h, w, d, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one launch needs (bytes), for the wrapper's check.
extern "C" long long decode_window_smem_bytes(int kv_dtype, int w, int S, int d) {
  const bool one = w == 1;
  switch (kv_dtype) {
    case kF32:
      return one ? smem_bytes<1, float>(S, d) : smem_bytes<kTileQ, float>(S, d);
    case kBF16:
      return one ? smem_bytes<1, __nv_bfloat16>(S, d) : smem_bytes<kTileQ, __nv_bfloat16>(S, d);
    case kI8:
      return one ? smem_bytes<1, int8_t>(S, d) : smem_bytes<kTileQ, int8_t>(S, d);
    default:
      return -1;
  }
}

// q (b, h, w, d) and out in q_dtype (0 = f32, 1 = bf16); kv_dtype 0 = f32,
// 1 = bf16, 2 = int8 (then kv_scale is required). starts (b,) int32. With
// pages null, kv is the dense slab (b, S, 2hd) and kv_scale (b, 2h, S); with
// pages (b, max_blocks) int32, kv is the pool (N, block_tokens, 2hd) and
// kv_scale (N, block_tokens, 2h), S the logical length. Returns
// cudaGetLastError() after the launch: 0 when it launched.
extern "C" int decode_attend_window(const void* q, int q_dtype, const void* kv, int kv_dtype,
                                    const void* kv_scale, const void* pages, const void* starts,
                                    void* out, int b, int h, int w, int S, int d,
                                    int block_tokens, int max_blocks, float sm_scale,
                                    void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || w <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Rows rows{static_cast<const int*>(pages), S, block_tokens, max_blocks};
  if (pages == nullptr) {
    return launch_q<false>(q_dtype, kv_dtype, q, kv, kv_scale, rows, starts, out, b, h, w, d,
                           sm_scale, st);
  }
  if (block_tokens <= 0 || (long long)block_tokens * max_blocks < S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_q<true>(q_dtype, kv_dtype, q, kv, kv_scale, rows, starts, out, b, h, w, d,
                        sm_scale, st);
}
