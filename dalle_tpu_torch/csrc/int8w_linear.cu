// int8-weight linear layer for decode-sized batches, for Hopper (sm_90a).
//
// Replaces no pallas_call: it is the port's counterpart of QDense's int8
// branch (dalle_tpu/ops/quantize_weights.py:48-58), where XLA fuses the
// int8 -> compute-dtype convert and the per-channel scale into the matmul's
// operand load. It computes
//
//     y[m, n] = sum_k x[m, k] * w[n, k]  (+ b[n]),   w = T(T(q[n, k]) * T(s[n]))
//
// for x (M, K) in T = bf16 or f32, q (N, K) int8, s (N,) f32 and an optional
// bias (N,) in T; y is (M, N) in T. As in the JAX package the dequantized
// weight is rounded to T before the product (for bf16: the exact product of
// the int and bf16(s), rounded to bf16), the sum runs in f32, y is rounded to
// T and the bias is added in T. Only the int8 bytes cross HBM: no
// dequantized weight is ever written.
//
// Bound: HBM bytes. M <= 64 rows (a decode step, a speculative window, the
// engine's steps) against N*K weights: per call M*K*|T| + N*K + 4*N +
// M*N*|T| bytes and 2*M*N*K operations, far below the card's operations per
// byte for bf16 on the tensor cores.
//
// Design: one CTA of 8 warps per 16 output channels (two n8 tiles). The
// contraction runs in steps of 64 bytes of a weight row; warp w takes a
// contiguous run of steps (step count * w / 8 to step count * (w + 1) / 8),
// so the slicing depends on K alone. In a step, lane (g, t) loads 16 bytes
// of each of its two channel rows (n0 + g, n0 + 8 + g), bytes 16t..16t+15
// of the step, streamed past L1 (__ldcs), U steps ahead of their use.
//
// * bf16 x (route "tc"): the mma.sync m16n8k16 contraction order is free, so
//   the 64 bytes of a step are dealt out as four k16 products in which lane
//   (g, t)'s logical columns 2t, 2t+1 are its bytes 4j, 4j+1 and columns
//   2t+8, 2t+9 its bytes 4j+2, 4j+3 (j = 0..3); the A fragment of x takes
//   the same columns of rows g and g+8, read straight from global memory
//   (x is small and shared by every CTA, so it stays in L2). Each byte pair
//   is converted in registers, times bf16(s), rounded to bf16 (RNE) and
//   packed into the B fragment. All ceil(M/16) row tiles of a CTA share a
//   weight load.
// * f32 x (route "fma"): f32 FMA, w = q * s rounded in f32; lane (g, t) sums
//   its 16 columns of each step for the 16 rows of its row tile (grid.y),
//   then the quad's four lanes are summed by shuffles.
//
// The warps' partial sums meet in shared memory and are added in warp order.
// Every output element's order of summation depends on K only, never on M
// or on the row's place in the launch, so a row alone and the same row
// inside 64 give the same bits (the serve engine's tokens rest on this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;        // output channels per CTA
constexpr int kStep = 64;        // weight bytes of a row per step
constexpr int kUnroll = 4;       // steps of weights in flight per warp
constexpr int kMaxRows = 64;
constexpr int kF32 = 0, kBF16 = 1;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void warp_steps(int K, int warp, int& s0, int& s1) {
  const int n = (K + kStep - 1) / kStep;
  s0 = n * warp / kWarps;
  s1 = n * (warp + 1) / kWarps;
}

// weight bytes 16t..16t+15 of step `s` of row `row` (zeros past N or K)
__device__ __forceinline__ uint4 load_w(const int8_t* q, int row, int N, int K, int s, int t) {
  const int k = s * kStep + 16 * t;
  if (row >= N || k >= K) return make_uint4(0, 0, 0, 0);
  return __ldcs(reinterpret_cast<const uint4*>(q + static_cast<size_t>(row) * K + k));
}

__device__ __forceinline__ int8_t byte_of(const uint4& v, int i) {
  const uint32_t w = (&v.x)[i >> 2];
  return static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu);
}

// bytes (i, i+1) of v times sb, each rounded to bf16, packed (i in the low half)
__device__ __forceinline__ uint32_t deq_pair(const uint4& v, int i, float sb) {
  return tc::pack_bf16(static_cast<float>(byte_of(v, i)) * sb,
                       static_cast<float>(byte_of(v, i + 1)) * sb);
}

// 16 bf16 of x row `row` at columns k..k+15 as eight packed pairs (zeros past M or K)
__device__ __forceinline__ void load_x16(uint32_t (&r)[8], const bf16* x, int row, int M, int K,
                                         int k) {
  if (row >= M || k >= K) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = 0u;
    return;
  }
  const uint4* p = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K + k);
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 v) { return __bfloat162float(v); }

// y = T(sum) (+ T(b)), stored if in range
template <typename T>
__device__ __forceinline__ void store_out(T* out, const T* bias, int m, int n, int M, int N,
                                          float sum) {
  if (m >= M || n >= N) return;
  float y = round_to<T>(sum);
  if (bias != nullptr) y = y + to_float<T>(bias[n]);
  out[static_cast<size_t>(m) * N + n] = from_float<T>(y);
}

// ---------------------------------------------------------------------------
// route "tc": bf16 x, MT row tiles of 16 in one CTA
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(kThreads) tc_kernel(const bf16* __restrict__ x,
                                                      const int8_t* __restrict__ q,
                                                      const float* __restrict__ s,
                                                      const bf16* __restrict__ bias,
                                                      bf16* __restrict__ out, int M, int N,
                                                      int K) {
  __shared__ float red[kWarps][MT * 2 * 4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int rows[2] = {n0 + g, n0 + 8 + g};
  float sb[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    sb[nt] = rows[nt] < N ? __bfloat162float(__float2bfloat16_rn(s[rows[nt]])) : 0.f;
  }
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  int s0, s1;
  warp_steps(K, warp, s0, s1);
  for (int sbase = s0; sbase < s1; sbase += kUnroll) {
    uint4 wq[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        wq[u][nt] = sbase + u < s1 ? load_w(q, rows[nt], N, K, sbase + u, t)
                                   : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (sbase + u >= s1) break;
      const int k = (sbase + u) * kStep + 16 * t;
      uint32_t bq[2][4][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[nt][j][0] = deq_pair(wq[u][nt], 4 * j, sb[nt]);
          bq[nt][j][1] = deq_pair(wq[u][nt], 4 * j + 2, sb[nt]);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t xa[8], xb[8];
        load_x16(xa, x, mt * 16 + g, M, K, k);
        load_x16(xb, x, mt * 16 + g + 8, M, K, k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {xa[2 * j], xb[2 * j], xa[2 * j + 1], xb[2 * j + 1]};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) tc::mma16816(acc[mt][nt], a, bq[nt][j][0], bq[nt][j][1]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][(mt * 2 + nt) * 4 + e][lane] = acc[mt][nt][e];
  __syncthreads();
  // C fragment element (mt, nt, e) of lane (g, t): row mt*16 + g (+8 for e >= 2),
  // column n0 + nt*8 + 2t + (e & 1)
  for (int i = threadIdx.x; i < MT * 2 * 4 * 32; i += kThreads) {
    const int ln = i & 31, f = i >> 5;
    const int mt = f >> 3, nt = (f >> 2) & 1, e = f & 3;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][f][ln];
    const int m = mt * 16 + (ln >> 2) + (e >= 2 ? 8 : 0);
    const int n = n0 + nt * 8 + 2 * (ln & 3) + (e & 1);
    store_out<bf16>(out, bias, m, n, M, N, sum);
  }
}

// ---------------------------------------------------------------------------
// route "fma": f32 x, one row tile of 16 per CTA (blockIdx.y)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) fma_kernel(const float* __restrict__ x,
                                                       const int8_t* __restrict__ q,
                                                       const float* __restrict__ s,
                                                       const float* __restrict__ bias,
                                                       float* __restrict__ out, int M, int N,
                                                       int K) {
  __shared__ float red[kWarps][16 * 2][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * 16;
  const int rows[2] = {n0 + g, n0 + 8 + g};
  float sc[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) sc[nt] = rows[nt] < N ? s[rows[nt]] : 0.f;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;

  int s0, s1;
  warp_steps(K, warp, s0, s1);
  for (int sbase = s0; sbase < s1; sbase += kUnroll) {
    uint4 wq[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        wq[u][nt] = sbase + u < s1 ? load_w(q, rows[nt], N, K, sbase + u, t)
                                   : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (sbase + u >= s1) break;
      const int k = (sbase + u) * kStep + 16 * t;
      if (k >= K) continue;
      float w[2][16];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[nt][i] = __fmul_rn(static_cast<float>(byte_of(wq[u][nt], i)), sc[nt]);
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        if (m0 + r >= M) break;
        const float4* p =
            reinterpret_cast<const float4*>(x + static_cast<size_t>(m0 + r) * K + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = __ldg(p + c);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float a = acc[r][nt];
            a = fmaf(v.x, w[nt][4 * c], a);
            a = fmaf(v.y, w[nt][4 * c + 1], a);
            a = fmaf(v.z, w[nt][4 * c + 2], a);
            a = fmaf(v.w, w[nt][4 * c + 3], a);
            acc[r][nt] = a;
          }
        }
      }
    }
  }
  // the quad's four lanes (t = 0..3) hold one channel pair's partial sums
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float v = acc[r][nt];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[warp][r * 2 + nt][g] = v;
    }
  __syncthreads();
  // element (r, nt, g): row m0 + r, column n0 + nt*8 + g
  for (int i = threadIdx.x; i < 16 * 2 * 8; i += kThreads) {
    const int gg = i & 7, f = i >> 3;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][f][gg];
    store_out<float>(out, bias, m0 + (f >> 1), n0 + (f & 1) * 8 + gg, M, N, sum);
  }
}

}  // namespace

// x_dtype (also the output's and the bias's) is 0 = f32 or 1 = bf16. bias may
// be null. M in 1..64, K a multiple of 16, every pointer 16-byte aligned
// (the wrapper checks). Returns the CUDA error of the launch: 0 when it launched.
extern "C" int int8w_linear(const void* x, int x_dtype, const void* q, const void* s,
                            const void* bias, void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || M > kMaxRows || N <= 0 || K <= 0 || K % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kCols - 1) / kCols);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  if (x_dtype == kBF16) {
    const bf16* xx = static_cast<const bf16*>(x);
    const bf16* bb = static_cast<const bf16*>(bias);
    bf16* oo = static_cast<bf16*>(out);
    switch ((M + 15) / 16) {
      case 1: tc_kernel<1><<<grid, kThreads, 0, st>>>(xx, qq, ss, bb, oo, M, N, K); break;
      case 2: tc_kernel<2><<<grid, kThreads, 0, st>>>(xx, qq, ss, bb, oo, M, N, K); break;
      case 3: tc_kernel<3><<<grid, kThreads, 0, st>>>(xx, qq, ss, bb, oo, M, N, K); break;
      default: tc_kernel<4><<<grid, kThreads, 0, st>>>(xx, qq, ss, bb, oo, M, N, K); break;
    }
  } else if (x_dtype == kF32) {
    const dim3 g2(grid.x, (M + 15) / 16);
    fma_kernel<<<g2, kThreads, 0, st>>>(static_cast<const float*>(x), qq, ss,
                                        static_cast<const float*>(bias),
                                        static_cast<float*>(out), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
