// Single-token decode attention over the merged KV cache, for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_kernel (body
// _decode_kernel): q (b, h, 1, d) against the sequence-major cache
// (b, S, 2*h*d) that holds K in the first h*d lanes of each position and V in
// the rest, stored as f32, bf16 or int8 (int8 with per-position scales
// (b, 2h, S), K scales in rows 0..h-1). A position j is valid when
// j < length and, if a mask row is given, mask_row[j] != 0. The result is
// softmax_j(q.k_j * scale) over the valid j applied to v_j; for int8 the K
// scale multiplies the score and the V scale the probability. Softmax and
// all sums run in f32. With no valid position the output is 0 (divided by 1).
//
// Bound: HBM bytes. Each call streams the valid part of the cache once,
// b * length * 2*h*d * itemsize bytes (+ 2*b*h*length*4 scale bytes for int8),
// against 4*b*h*length*d flops, far below the card's ops/byte balance.
//
// Design (first version, simple and exact):
//   * one CTA per (b, h), 256 threads; q is scaled into shared memory;
//   * pass 1: a group of lanes owns one position and splits d into 16-byte
//     loads (4 f32, 8 bf16 or 16 int8 values per lane); each thread keeps
//     kUnroll positions' loads in flight; a shuffle reduction forms each
//     score into an S-float shared-memory row; positions at or past length
//     and masked positions are never read;
//   * block max, exp and sum; the probability row replaces the score row
//     (times the V scale for int8);
//   * pass 2: a thread owns 16 bytes of output dims, neighbouring threads
//     read neighbouring bytes of a V row, row groups are summed in shared
//     memory at the end.
// Left for later: cp.async/TMA staging of K and V tiles, and splitting S
// across CTAs (b*h CTAs is 112 at the main shape, fewer than the 132 SMs,
// and a long cache serialises in one CTA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> struct Vec;  // elements in one 16-byte load
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[4 * i + k] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * k)) & 0xff));
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Q> __device__ __forceinline__ Q from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// lanes that share one cache position in pass 1: the power of two >= d/VEC, at most 32
__host__ __device__ inline int lanes_per_row(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
decode_attend_kernel(const Q* __restrict__ q, const T* __restrict__ kv,
                     const float* __restrict__ kv_scale, const int* __restrict__ mask_row,
                     Q* __restrict__ out, int heads, int S, int d, int length,
                     float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  const int chunks = d / VEC;           // 16-byte chunks in one head row
  const int vrows = kThreads / chunks;  // row groups of pass 2
  float* q_s = smem;                    // d
  float* p_s = q_s + d;                 // S: scores, then probabilities
  float* red = p_s + S;                 // 2 * kWarps
  float* acc_s = red + 2 * kWarps;      // vrows * d

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_stride = 2LL * heads * d;  // elements per cache position
  const T* kbase = kv + (long long)b * S * row_stride + (long long)h * d;
  const T* vbase = kbase + (long long)heads * d;
  const float* ks = kv_scale ? kv_scale + ((long long)b * 2 * heads + h) * S : nullptr;
  const float* vs = kv_scale ? kv_scale + ((long long)b * 2 * heads + heads + h) * S : nullptr;
  const int L = min(length, S);

  for (int i = tid; i < d; i += kThreads) q_s[i] = to_f32(q[(long long)bh * d + i]) * sm_scale;
  __syncthreads();

  // ---- pass 1: one score per valid position ----
  const int G = lanes_per_row(chunks);
  const int rows_per_warp = 32 / G;
  const int gl = lane % G;
  const int my_row = warp * rows_per_warp + lane / G;
  const int rows_per_iter = kWarps * rows_per_warp;
  for (int base = 0; base < L; base += rows_per_iter * kUnroll) {
    int j[kUnroll];
    bool ok[kUnroll];
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = base + u * rows_per_iter + my_row;
      ok[u] = j[u] < L && (mask_row == nullptr || mask_row[j[u]] != 0);
      part[u] = 0.f;
    }
    for (int c0 = 0; c0 < chunks; c0 += G) {
      const int c = c0 + gl;
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        raw[u] = (ok[u] && c < chunks)
                     ? __ldg(reinterpret_cast<const uint4*>(kbase + j[u] * row_stride) + c)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && c < chunks) {
          float f[VEC];
          unpack<T>(raw[u], f);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(f[e], q_s[c * VEC + e], s);
          part[u] += s;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = G >> 1; off > 0; off >>= 1) {
        part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
      }
      if (gl == 0 && j[u] < L) p_s[j[u]] = ok[u] ? part[u] * (ks ? ks[j[u]] : 1.f) : -INFINITY;
    }
  }
  __syncthreads();

  // ---- softmax over the row: max, exp, sum ----
  float m = -INFINITY;
  for (int i = tid; i < L; i += kThreads) m = fmaxf(m, p_s[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  float l = 0.f;
  for (int i = tid; i < L; i += kThreads) {
    const float s = p_s[i];
    const float p = (s == -INFINITY) ? 0.f : expf(s - m);
    l += p;
    p_s[i] = vs ? p * vs[i] : p;
  }
  l = warp_sum(l);
  if (lane == 0) red[kWarps + warp] = l;
  __syncthreads();
  l = 0.f;
  for (int w = 0; w < kWarps; ++w) l += red[kWarps + w];

  // ---- pass 2: probabilities times V ----
  const int r = tid / chunks;
  const int c = tid - r * chunks;
  if (r < vrows) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int base = r; base < L; base += vrows * kUnroll) {
      float p[kUnroll];
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = base + u * vrows;
        p[u] = jj < L ? p_s[jj] : 0.f;
        raw[u] = p[u] != 0.f
                     ? __ldg(reinterpret_cast<const uint4*>(vbase + jj * row_stride) + c)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p[u] != 0.f) {
          float f[VEC];
          unpack<T>(raw[u], f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p[u], f[e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[r * d + c * VEC + e] = acc[e];
  }
  __syncthreads();
  const float denom = l > 0.f ? l : 1.f;
  for (int i = tid; i < d; i += kThreads) {
    float o = 0.f;
    for (int rr = 0; rr < vrows; ++rr) o += acc_s[rr * d + i];
    out[(long long)bh * d + i] = from_f32<Q>(o / denom);
  }
}

template <typename T, typename Q>
int launch(const void* q, const void* kv, const void* kv_scale, const void* mask_row,
           void* out, int b, int h, int S, int d, int length, float sm_scale,
           cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (d <= 0 || d > 256 || d % VEC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d / VEC;
  const int vrows = kThreads / chunks;
  const size_t smem = sizeof(float) * (size_t)(d + S + 2 * kWarps + vrows * d);
  auto kern = decode_attend_kernel<T, Q>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<b * h, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(kv), static_cast<const float*>(kv_scale),
      static_cast<const int*>(mask_row), static_cast<Q*>(out), h, S, d, length, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int launch_q(int kv_dtype, const void* q, const void* kv, const void* kv_scale,
             const void* mask_row, void* out, int b, int h, int S, int d, int length,
             float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<float, Q>(q, kv, kv_scale, mask_row, out, b, h, S, d, length, sm_scale,
                              stream);
    case kBF16:
      return launch<__nv_bfloat16, Q>(q, kv, kv_scale, mask_row, out, b, h, S, d, length,
                                      sm_scale, stream);
    case kI8:
      return launch<int8_t, Q>(q, kv, kv_scale, mask_row, out, b, h, S, d, length, sm_scale,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype (also the output's) is 0 = f32 or 1 = bf16; kv_dtype is 0 = f32,
// 1 = bf16 or 2 = int8 (then kv_scale is required). kv_scale and mask_row may
// be null. Returns cudaGetLastError() after the launch: 0 when it launched.
extern "C" int decode_attend(const void* q, int q_dtype, const void* kv, int kv_dtype,
                             const void* kv_scale, const void* mask_row, void* out, int b,
                             int h, int S, int d, int length, float sm_scale, void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_q<float>(kv_dtype, q, kv, kv_scale, mask_row, out, b, h, S, d, length,
                             sm_scale, st);
    case kBF16:
      return launch_q<__nv_bfloat16>(kv_dtype, q, kv, kv_scale, mask_row, out, b, h, S, d,
                                     length, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
