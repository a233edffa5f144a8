// Chunked single-token decode attention over a long merged KV cache, for
// Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_kernel_chunked
// (body _decode_kernel_chunked): the contract of decode_attend_kernel (q
// (b, h, 1, d) against the sequence-major cache (b, S, 2*h*d), K in the first
// h*d lanes of a position and V in the rest, f32, bf16 or int8 with
// per-position scales (b, 2h, S)) computed over blk-sized blocks of the cache
// with an online softmax. A position j is valid when j < length and, with a
// mask row, mask_row[j] != 0. As in the TPU kernel, a bf16 or int8 cache
// rounds q * scale and the V-scaled probabilities to bf16 before the products
// (an f32 cache keeps f32); scores, the softmax and every sum are f32; the
// int8 K scale multiplies the score and the V scale the probability. A row
// with no valid position gives 0.
//
// Bound: HBM bytes. A call reads the cache up to length once,
// b * length * 2*h*d * itemsize bytes (+ 2*b*h*length*4 scale bytes for int8),
// against 4*b*h*length*d flops, far below the card's ops/byte balance.
//
// Design. The TPU walks the blocks of one batch row in order on one core,
// carrying (m, l, acc) in VMEM scratch, and elides the DMA of blocks past
// length. Here the blocks spread over CTAs, which is what sets this kernel
// apart from decode_attention.cu (one CTA per (b, h) walking the whole cache):
//   * kernel 1, grid (blocks up to length, h, b), 256 threads: one CTA scores
//     its block (groups of lanes per position, 16-byte loads, as in
//     decode_attention.cu), takes the block's own max m_b, p = exp(s - m_b),
//     l_b = sum p, rounds p * vs to the product type and forms acc_b = p.v;
//     it writes (m_b, l_b, acc_b) to a (b, h, blocks, d + 2) f32 scratch.
//     Blocks past length are not launched, so their bytes are never read;
//   * kernel 2, one CTA per (b, h): merges the blocks in block order,
//     M = max m_b, l = sum exp(m_b - M) l_b, o = sum exp(m_b - M) acc_b / l.
//     A fixed order, so repeated runs give the same bits.
// The TPU rounds p against the running max, this kernel against each block's
// own max: the two differ by the bf16 rounding of each probability
// (decode_attention.chunked_tolerance states the bound).

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
    const float2 t = __bfloat1622float2(p[i]);
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

// the product type's rounding: f32 caches keep f32, bf16 and int8 round to bf16
template <typename T> __device__ __forceinline__ float to_dot(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float to_dot<float>(float x) { return x; }

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

// lanes that share one cache position in the score pass: the power of two
// >= d/VEC, at most 32
__host__ __device__ inline int lanes_per_row(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

template <typename T>
__host__ __device__ inline long long block_smem(int blk, int d) {
  const int vrows = kThreads / (d / Vec<T>::N);
  return sizeof(float) * (long long)(d + blk + 2 * kWarps + vrows * d);
}

// ---------------------------------------------------------------------------
// kernel 1: one cache block of one (b, h); grid (blocks, h, b)
// ---------------------------------------------------------------------------
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
chunk_block_kernel(const Q* __restrict__ q, const T* __restrict__ kv,
                   const float* __restrict__ kv_scale, const int* __restrict__ mask_row,
                   float* __restrict__ part, int S, int d, int length, int blk,
                   float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  const int chunks = d / VEC;           // 16-byte chunks in one head row
  const int vrows = kThreads / chunks;  // row groups of the value pass
  float* q_s = smem;                    // d
  float* p_s = q_s + d;                 // blk: scores, then probabilities
  float* red = p_s + blk;               // 2 * kWarps
  float* acc_s = red + 2 * kWarps;      // vrows * d

  const int ib = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y, nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = ib * blk;
  const int cnt = min(blk, min(length, S) - j0);  // positions below length
  const long long row_stride = 2LL * heads * d;
  const T* kbase = kv + ((long long)b * S + j0) * row_stride + (long long)h * d;
  const T* vbase = kbase + (long long)heads * d;
  const float* ks = kv_scale ? kv_scale + ((long long)b * 2 * heads + h) * S + j0 : nullptr;
  const float* vs = kv_scale ? kv_scale + ((long long)b * 2 * heads + heads + h) * S + j0
                             : nullptr;
  const int* mrow = mask_row ? mask_row + j0 : nullptr;
  const long long bh = (long long)b * heads + h;

  for (int i = tid; i < d; i += kThreads) q_s[i] = to_dot<T>(to_f32(q[bh * d + i]) * sm_scale);
  __syncthreads();

  // ---- scores of the block's positions ----
  const int G = lanes_per_row(chunks);
  const int rows_per_warp = 32 / G;
  const int gl = lane % G;
  const int my_row = warp * rows_per_warp + lane / G;
  const int rows_per_iter = kWarps * rows_per_warp;
  for (int base = 0; base < cnt; base += rows_per_iter * kUnroll) {
    int j[kUnroll];
    bool ok[kUnroll];
    float part_s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = base + u * rows_per_iter + my_row;
      ok[u] = j[u] < cnt && (mrow == nullptr || mrow[j[u]] != 0);
      part_s[u] = 0.f;
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
          part_s[u] += s;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = G >> 1; off > 0; off >>= 1) {
        part_s[u] += __shfl_xor_sync(0xffffffffu, part_s[u], off);
      }
      if (gl == 0 && j[u] < cnt) p_s[j[u]] = ok[u] ? part_s[u] * (ks ? ks[j[u]] : 1.f) : -INFINITY;
    }
  }
  __syncthreads();

  // ---- the block's max, p = exp(s - m_b), its sum ----
  float m = -INFINITY;
  for (int i = tid; i < cnt; i += kThreads) m = fmaxf(m, p_s[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  float l = 0.f;
  for (int i = tid; i < cnt; i += kThreads) {
    const float s = p_s[i];
    const float p = (s == -INFINITY) ? 0.f : expf(s - m);
    l += p;
    p_s[i] = to_dot<T>(vs ? p * vs[i] : p);
  }
  l = warp_sum(l);
  if (lane == 0) red[kWarps + warp] = l;
  __syncthreads();
  l = 0.f;
  for (int w = 0; w < kWarps; ++w) l += red[kWarps + w];

  // ---- acc_b = p . v ----
  const int r = tid / chunks;
  const int c = tid - r * chunks;
  if (r < vrows) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int base = r; base < cnt; base += vrows * kUnroll) {
      float p[kUnroll];
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = base + u * vrows;
        p[u] = jj < cnt ? p_s[jj] : 0.f;
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
  float* dst = part + (bh * nb + ib) * (d + 2);
  for (int i = tid; i < d; i += kThreads) {
    float o = 0.f;
    for (int rr = 0; rr < vrows; ++rr) o += acc_s[rr * d + i];
    dst[2 + i] = o;
  }
  if (tid == 0) {
    dst[0] = m;
    dst[1] = l;
  }
}

// ---------------------------------------------------------------------------
// kernel 2: merge the blocks of one (b, h) in block order; grid b*h
// ---------------------------------------------------------------------------
template <typename Q>
__global__ void __launch_bounds__(kThreads)
chunk_combine_kernel(const float* __restrict__ part, Q* __restrict__ out, int nb, int d) {
  const long long bh = blockIdx.x;
  const float* src = part + bh * nb * (d + 2);
  float M = -INFINITY;
  for (int k = 0; k < nb; ++k) M = fmaxf(M, src[k * (d + 2)]);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float l = 0.f, o = 0.f;
    if (M != -INFINITY) {
      for (int k = 0; k < nb; ++k) {
        const float mk = src[k * (d + 2)];
        if (mk == -INFINITY) continue;
        const float w = expf(mk - M);
        l += w * src[k * (d + 2) + 1];
        o += w * src[k * (d + 2) + 2 + i];
      }
    }
    out[bh * d + i] = from_f32<Q>(l > 0.f ? o / l : 0.f);
  }
}

template <typename T, typename Q>
int launch(const void* q, const void* kv, const void* kv_scale, const void* mask_row,
           float* part, void* out, int b, int h, int S, int d, int length, int blk,
           float sm_scale, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (d <= 0 || d > 256 || d % VEC != 0 || blk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = max(0, min(length, S));
  const int nb = (L + blk - 1) / blk;
  if (nb > 0) {
    const long long smem = block_smem<T>(blk, d);
    auto kern = chunk_block_kernel<T, Q>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<dim3(nb, h, b), kThreads, smem, stream>>>(
        static_cast<const Q*>(q), static_cast<const T*>(kv),
        static_cast<const float*>(kv_scale), static_cast<const int*>(mask_row), part, S, d, L,
        blk, sm_scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk_combine_kernel<Q><<<b * h, kThreads, 0, stream>>>(part, static_cast<Q*>(out), nb, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int launch_q(int kv_dtype, const void* q, const void* kv, const void* kv_scale,
             const void* mask_row, float* part, void* out, int b, int h, int S, int d,
             int length, int blk, float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<float, Q>(q, kv, kv_scale, mask_row, part, out, b, h, S, d, length, blk,
                              sm_scale, stream);
    case kBF16:
      return launch<__nv_bfloat16, Q>(q, kv, kv_scale, mask_row, part, out, b, h, S, d, length,
                                      blk, sm_scale, stream);
    case kI8:
      return launch<int8_t, Q>(q, kv, kv_scale, mask_row, part, out, b, h, S, d, length, blk,
                               sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype (also the output's) is 0 = f32 or 1 = bf16; kv_dtype is 0 = f32,
// 1 = bf16 or 2 = int8 (then kv_scale is required). kv_scale and mask_row may
// be null. `part` is f32 scratch of (b, h, ceil(min(length, S) / blk), d + 2).
// Returns cudaGetLastError() after the launches: 0 when both launched.
extern "C" int decode_attend_chunked(const void* q, int q_dtype, const void* kv, int kv_dtype,
                                     const void* kv_scale, const void* mask_row, float* part,
                                     void* out, int b, int h, int S, int d, int length, int blk,
                                     float sm_scale, void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_q<float>(kv_dtype, q, kv, kv_scale, mask_row, part, out, b, h, S, d, length,
                             blk, sm_scale, st);
    case kBF16:
      return launch_q<__nv_bfloat16>(kv_dtype, q, kv, kv_scale, mask_row, part, out, b, h, S, d,
                                     length, blk, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of one block's CTA; 0 for a d the kernel does not take
extern "C" long long decode_chunked_smem_bytes(int kv_dtype, int blk, int d) {
  if (d <= 0 || d > 256 || blk <= 0) return 0;
  switch (kv_dtype) {
    case kF32: return d % 4 ? 0 : block_smem<float>(blk, d);
    case kBF16: return d % 8 ? 0 : block_smem<__nv_bfloat16>(blk, d);
    case kI8: return d % 16 ? 0 : block_smem<int8_t>(blk, d);
    default: return 0;
  }
}
