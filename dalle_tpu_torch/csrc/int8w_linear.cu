// int8-weight linear layer (W8) for Hopper (sm_90a).
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
// Bound. A decode step (M <= 64 rows) reads N*K weight bytes for 2*M*N*K
// operations, far below the card's operations per byte in bf16: HBM bytes
// bound it. A prefill (M = 257 a prompt, slots * 257 a refill) does 2*M
// operations per weight byte, above that line: the tensor cores bound it.
// The first design (PR 16: mma.sync, 16 channels a CTA, x read from L2 into
// fragments by every CTA) grew with M from 24 rows on and had no prefill
// route; where this one's time goes is measured by chip_w8_anatomy.py.
//
// Route "wg" (bf16 x, any M): warpgroup MMA with the operands swapped. The
// output channels are wgmma's 64-row side, the x rows its N side (NT = 8,
// 16, 32 or 64 rows for M <= 64 with one consumer warpgroup, 64 channels a
// CTA; tiles of 128 rows above with two, 128 channels) beside one producer
// warp, over a ring of stages of kUnit = 128 contraction elements: the
// producer's lane 0 initialises the ring's barriers and issues its first
// round of loads before the block meets, then waits for a free stage and
// loads by TMA (2-D tensor maps, 128-byte swizzle) the stage's weight rows
// (128 bytes each) and the x tile (two 64-element atoms of NT rows, the
// canonical K-major SW128 layout that the wgmma B descriptor reads), all on
// the stage's mbarrier. Each consumer
// warp converts its 16 channel rows into the register-sourced A fragments
// of the stage's eight k16 products: lane (g, t) reads the 32-bit words
// that hold its columns 2t, 2t+1 and 2t+8, 2t+9 (bank-conflict free under
// the swizzle), and turns each byte into bf16(q * bf16(s)) with one PRMT
// (the byte, offset by 128, into the low bits of 2^23), one FFMA against
// -(2^23 + 128) * bf16(s) (both products exact, so the sum is q * bf16(s)
// exactly) and half a packing convert (RNE). The warpgroup then issues the
// eight wgmma m64nNTk16 in k order as one group and, while they run,
// converts the next stage into a second register set; a stage is freed
// once its group has completed.
//
// Split. The contraction's kUnit-element units are cut into `split`
// contiguous ranges; the host picks split from (N, K) alone, to fill the
// card's SMs. Decode tiles put one range on each CTA of a cluster of
// `split` CTAs along z: each rank pushes its range's sum into rank 0's
// shared memory (one cluster barrier, after one arrival at the start), and
// rank 0 adds them to its own in rank order. The 128-row tiles of a grid
// that fills the card alone walk every range in one CTA instead, adding each
// range's sum, as it completes, into a running sum in shared memory; in a
// smaller grid they take the cluster too, rank 0 reading each rank's sum
// from that rank's shared memory. Either way an output element is ((p_0 + p_1) + ...)
// + p_{split-1}, each p_r its range's products in k order, with no atomics:
// the same sum in the same order at every M, in every tile of rows and on
// every run. A row alone and the same row among 2,056 give the same bits
// (the serve engine's tokens rest on this).
//
// Route "fma" (f32 x, M <= 64), PR 16's: one CTA of 8 warps per 16 output
// channels; warp w takes a contiguous run of 64-byte steps of the
// contraction, lane (g, t) loads 16 bytes of each of its two channel rows a
// step and sums its 16 columns for the 16 rows of its row tile (grid.y) in
// f32 FMA (w = q * s rounded in f32); the quad's four lanes are summed by
// shuffles and the warps' sums in warp order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <initializer_list>
#include <mutex>
#include <unordered_map>

#include "tc_tile.cuh"

namespace {

// route "fma"
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

// y = sum (+ b), stored if in range
__device__ __forceinline__ void store_out(float* out, const float* bias, int m, int n, int M,
                                          int N, float sum) {
  if (m >= M || n >= N) return;
  out[static_cast<size_t>(m) * N + n] = bias != nullptr ? sum + bias[n] : sum;
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
    store_out(out, bias, m0 + (f >> 1), n0 + (f & 1) * 8 + gg, M, N, sum);
  }
}

// ---------------------------------------------------------------------------
// route "wg": bf16 x, the warpgroup MMA over a TMA ring
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kUnit = 128;       // contraction elements (weight bytes of a row) a stage
constexpr int kMaxSplit = 8;     // the portable cluster size

// 64-channel groups a CTA: one for the decode tiles, two for the 128-row
// tiles (the x tile, the larger operand there, then serves 128 channels)
__host__ __device__ constexpr int groups_of(int NT) { return NT == 128 ? 2 : 1; }
__host__ __device__ constexpr int stage_bytes(int NT) {
  return 64 * groups_of(NT) * kUnit + 2 * NT * 128;
}
// ring stages: four for a decode tile, three for a 128-row tile, beside
// the running sum of its contraction ranges
__host__ __device__ constexpr int ring_of(int NT) { return NT == 128 ? 3 : 4; }
__host__ __device__ constexpr int total_bytes(int NT) {
  return NT == 128 ? groups_of(NT) * NT * 256 : 0;
}
// the ring (1024-aligned for the swizzle), the running sum, the barriers,
// then in a decode tile's rank 0 the other ranks' sums
__host__ __device__ constexpr int wg_smem(int NT, int ranks) {
  return 1024 + ring_of(NT) * stage_bytes(NT) + total_bytes(NT) + 2 * ring_of(NT) * 8 +
         (NT < 128 ? (ranks - 1) * NT * 256 : 0);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_u32(b)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_u32(b)) : "memory");
}
// a wait that cannot end (a refused copy never completes its barrier) traps
// after ~10 s of the SM clock instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(tc::smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// a 2-D TMA box into shared memory at coordinates (c0 innermost, c1), on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(tc::smem_u32(bar))
      : "memory");
}

// the wgmma descriptor of a K-major, 128-byte-swizzled bf16 tile at `p` (8-row
// groups 1024 bytes apart; a k16 step is p advanced by 32 bytes in the atom)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = tc::smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int NT>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// the accumulators stay in place across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bytes sel0, sel1 of the int8 word v (offset by 128 in u), each dequantized
// exactly (q * sb, with cm = -(2^23 + 128) * sb) and rounded to bf16, packed
__device__ __forceinline__ uint32_t deq2(uint32_t u, uint32_t sel0, uint32_t sel1, float sb,
                                         float cm) {
  const float lo = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, sel0)), sb, cm);
  const float hi = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, sel1)), sb, cm);
  return tc::pack_bf16(lo, hi);
}

// A lane's dequantization state: its two channel rows' bf16 scales, the
// FFMA constants, the PRMT selectors and the word of its columns
struct Lane {
  float sb[2], cm[2];
  uint32_t sel0, sel1;
  int g, wo;
};

// the A fragments of a stage's eight k16 products from the warp's 16 weight
// rows at r0 (row0 of the tile; row0 + 8 eight rows on)
__device__ __forceinline__ void convert_stage(uint32_t (&a)[8][4], const uint8_t* r0,
                                              const Lane& L) {
  const uint8_t* r1 = r0 + 8 * kUnit;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // logical chunk j of a row sits at chunk j ^ (row % 8) = j ^ g
    const int c = 16 * (j ^ L.g) + L.wo;
    const uint32_t v00 = *reinterpret_cast<const uint32_t*>(r0 + c) ^ 0x80808080u;
    const uint32_t v01 = *reinterpret_cast<const uint32_t*>(r0 + c + 8) ^ 0x80808080u;
    const uint32_t v10 = *reinterpret_cast<const uint32_t*>(r1 + c) ^ 0x80808080u;
    const uint32_t v11 = *reinterpret_cast<const uint32_t*>(r1 + c + 8) ^ 0x80808080u;
    a[j][0] = deq2(v00, L.sel0, L.sel1, L.sb[0], L.cm[0]);
    a[j][1] = deq2(v10, L.sel0, L.sel1, L.sb[1], L.cm[1]);
    a[j][2] = deq2(v01, L.sel0, L.sel1, L.sb[0], L.cm[0]);
    a[j][3] = deq2(v11, L.sel0, L.sel1, L.sb[1], L.cm[1]);
  }
}

// the stage's eight products in k order into acc, as one wgmma group
template <int NT, int R>
__device__ __forceinline__ void issue_stage(float (&acc)[R], const uint32_t (&a)[8][4],
                                            const uint8_t* xs) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    Wgmma<NT>::mma(acc, a[j], sw128_desc(xs + (j >> 2) * NT * 128 + (j & 3) * 32));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Grid (channel tiles, row tiles, ranks). The contraction's kUnit-element
// units are cut into `split` ranges (from N and K alone). With ranks ==
// split each CTA of a cluster takes one range and rank 0 adds the others'
// sums to its own in rank order; with ranks == 1 (128-row tiles whose grid
// fills the card) one CTA walks every range, adding each range's sum, as
// it completes, to a running sum in shared memory in the same order.
// Either way an output element is ((s_0 + s_1) + ...) + s_{split-1}, each
// s_r its range's products in k order.
template <int NT>
__global__ void __launch_bounds__(128 * groups_of(NT) + 32, 1)
    wg_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
              const float* __restrict__ s, const bf16* __restrict__ bias,
              bf16* __restrict__ out, int M, int N, int K, int split) {
  constexpr int C = groups_of(NT);       // 64-channel warpgroups
  constexpr int kRing = ring_of(NT);
  constexpr int kStage = stage_bytes(NT);
  constexpr int kW = 64 * C * kUnit;     // the stage's weight rows
  constexpr int R = NT / 2;              // accumulators a thread
  constexpr int kConsumers = 128 * C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* total = reinterpret_cast<float*>(smem + kRing * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * kStage + total_bytes(NT));
  uint64_t* empty = full + kRing;
  float* parts = reinterpret_cast<float*>(empty + kRing);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * 64 * C, m0 = blockIdx.y * NT;
  const int units = (K + kUnit - 1) / kUnit;
  const int ranks = gridDim.z, rank = blockIdx.z;
  // this CTA's units [u0, u0 + n_units): one range, or all of them
  const int u0 = ranks == 1 ? 0 : units * rank / split;
  const int n_units = ranks == 1 ? units : units * (rank + 1) / split - u0;
  const bool consumer = warp < 4 * C;
  // a decode tile's rank may write into rank 0's shared memory once every
  // CTA of the cluster has started: each arrives here and waits at the end
  if (NT < 128 && ranks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // stage i's loads: its weight rows and x's two atoms, on full[i % kRing]
  auto load = [&](int i) {
    const int st = i % kRing;
    uint8_t* w = smem + st * kStage;
    mbar_expect_tx(&full[st], kStage);
    const int k0 = (u0 + i) * kUnit;
    tma_2d(w, &tq, k0, n0, &full[st]);
    tma_2d(w + kW, &tx, k0, m0, &full[st]);
    tma_2d(w + kW + NT * 128, &tx, k0 + 64, m0, &full[st]);
  };
  if (threadIdx.x == kConsumers) {
    // the producer's lane 0: the barriers, then the first round of loads
    // before the block meets
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kRing && i < n_units; ++i) load(i);
  }
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * wq + g;   // the lane's rows in the tile: row0, row0 + 8

  if (!consumer) {
    // the producer: each later stage once its slot is free
    if (lane == 0) {
      for (int i = kRing; i < n_units; ++i) {
        mbar_wait(&empty[i % kRing], ((i / kRing) & 1) ^ 1);
        load(i);
      }
    }
  } else {
    Lane L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row0 + 8 * h;
      L.sb[h] = n < N ? __bfloat162float(__float2bfloat16_rn(s[n])) : 0.f;
      L.cm[h] = -8388736.0f * L.sb[h];   // -(2^23 + 128) * sb, exact
    }
    L.sel0 = 0x7540u | (2u * (t & 1));
    L.sel1 = L.sel0 + 1;
    L.g = g;
    L.wo = 4 * (t >> 1);     // the word of columns 2t, 2t+1 in a 16-byte chunk
    // the next range boundary of a CTA that walks every range
    int r_next = 1, u_next = ranks == 1 && split > 1 ? units / split : n_units;
    auto ready = [&](int i) -> const uint8_t* {
      mbar_wait(&full[i % kRing], (i / kRing) & 1);
      return smem + (i % kRing) * kStage + row0 * kUnit;
    };
    auto xs = [&](int i) -> const uint8_t* { return smem + (i % kRing) * kStage + kW; };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % kRing]);
    };
    // a range ends before unit i: its sum goes into the running sum
    auto boundary = [&](int i) {
      if (i != u_next) return;
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        float* p = &total[e * kConsumers + threadIdx.x];
        *p = r_next == 1 ? acc[e] : *p + acc[e];
        acc[e] = 0.f;
      }
      ++r_next;
      u_next = units * r_next / split;
    };
    // two register sets of A fragments: stage i + 1 converts while the
    // products of stage i run
    uint32_t a0[8][4], a1[8][4];
    if (n_units > 0) convert_stage(a0, ready(0), L);
    for (int i = 0; i < n_units; i += 2) {
      issue_stage<NT>(acc, a0, xs(i));
      wgmma_wait<1>();
      if (i > 0) release(i - 1);
      if (i + 1 >= n_units) break;
      convert_stage(a1, ready(i + 1), L);
      boundary(i + 1);
      issue_stage<NT>(acc, a1, xs(i + 1));
      wgmma_wait<1>();
      release(i);
      if (i + 2 < n_units) {
        convert_stage(a0, ready(i + 2), L);
        boundary(i + 2);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (n_units > 0) release(n_units - 1);
    if (ranks == 1 && split > 1) {
      // the last range's sum after the others
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = total[e * kConsumers + threadIdx.x] + acc[e];
    }
  }
  __syncthreads();   // the ring is free

  if (ranks > 1) {
    // rank 0 adds the other ranks' sums in rank order
    cg::cluster_group cluster = cg::this_cluster();
    if constexpr (NT < 128) {
      // each rank pushes its sums into rank 0's shared memory: one barrier
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every CTA started
      if (rank > 0 && consumer) {
        float* dst = cluster.map_shared_rank(parts, 0) + (rank - 1) * R * kConsumers;
#pragma unroll
        for (int i = 0; i < R; ++i) dst[i * kConsumers + threadIdx.x] = acc[i];
      }
      cluster.sync();
      if (rank != 0) return;
      if (consumer) {
        for (int r = 1; r < ranks; ++r) {
          const float* part = parts + (r - 1) * R * kConsumers;
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] += part[i * kConsumers + threadIdx.x];
        }
      }
    } else {
      // a 128-row tile's sums are too large to gather: rank 0 reads each
      // rank's shared memory, which stays alive until it is done
      float* red = reinterpret_cast<float*>(smem);
      if (consumer) {
#pragma unroll
        for (int i = 0; i < R; ++i) red[i * kConsumers + threadIdx.x] = acc[i];
      }
      cluster.sync();
      if (rank == 0 && consumer) {
        for (int r = 1; r < ranks; ++r) {
          const float* part = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] += part[i * kConsumers + threadIdx.x];
        }
      }
      cluster.sync();
      if (rank != 0) return;
    }
  }
  if (!consumer) return;
  // accumulator (j8, e): channel row0 + 8 (e >= 2), x row 8 j8 + 2t + (e & 1)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + row0 + 8 * ((i & 3) >> 1);
    const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (m < M && n < N) {
      float y = __bfloat162float(__float2bfloat16_rn(acc[i]));
      if (bias != nullptr) y = y + __bfloat162float(bias[n]);
      out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(y);
    }
  }
}

// ---------------------------------------------------------------------------
// the host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map depends on nothing but the arguments of its encoding, so
// maps are kept by those arguments: the weights keep their addresses, and
// PyTorch's allocator hands a decode step's activations the blocks the step
// before freed, while each encoding is a driver call on the host (bounded:
// the cache starts over at 4,096 maps).
struct MapKey {
  const void* base;
  int dt, inner, rows, box_inner, box_rows;
  bool operator==(const MapKey& o) const { return std::memcmp(this, &o, sizeof(MapKey)) == 0; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.base);
    for (int v : {k.dt, k.inner, k.rows, k.box_inner, k.box_rows}) h = h * 1000003u ^ v;
    return h;
  }
};

// a row-major (rows, inner) tensor of `row_bytes` a row, boxes of
// (box_inner, box_rows), 128-byte swizzle; zeros outside the tensor
bool encode(CUtensorMap* map, CUtensorMapDataType dt, const void* base, int inner, int rows,
            size_t row_bytes, int box_inner, int box_rows) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key;
  std::memset(&key, 0, sizeof(key));   // the padding takes part in ==
  key.base = base;
  key.dt = static_cast<int>(dt);
  key.inner = inner;
  key.rows = rows;
  key.box_inner = box_inner;
  key.box_rows = box_rows;
  std::lock_guard<std::mutex> guard(lock);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// raise the kernel's dynamic shared memory cap once per device
template <typename Kern>
cudaError_t allow_smem(Kern kern, int smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int NT>
int launch_wg(const void* x, const void* q, const float* s, const void* bias, void* out, int M,
              int N, int K, int split, int ranks, cudaStream_t stream) {
  // a CTA walks every range only in the 128-row tiles (their running sum)
  if (!(ranks == split || (ranks == 1 && NT == 128))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned> smem_done{0};
  CUtensorMap tx, tq;
  if (!encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, static_cast<size_t>(K) * 2, 64,
              NT) ||
      !encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, static_cast<size_t>(K), kUnit,
              64 * groups_of(NT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int C = groups_of(NT);
  auto kern = wg_kernel<NT>;
  const int smem = wg_smem(NT, ranks);
  cudaError_t e = allow_smem(kern, wg_smem(NT, kMaxSplit), smem_done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 64 * C - 1) / (64 * C), (M + NT - 1) / NT, ranks);
  cfg.blockDim = dim3(128 * C + 32);   // C consumer warpgroups and the producer warp
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ranks;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, tx, tq, s, static_cast<const bf16*>(bias),
                         static_cast<bf16*>(out), M, N, K, split);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves its error for the next caller
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype (also the output's and the bias's) is 0 = f32 or 1 = bf16. bias may
// be null. K a multiple of 16, every pointer 16-byte aligned (the wrapper
// checks). f32: M in 1..64 (route "fma"; nt, split and ranks are not
// read). bf16: any M >= 1 (route "wg") in tiles of nt rows (8, 16, 32 or 64
// with 64 channels a CTA, or 128 with 128 channels) and `split` contraction
// ranges (1..8, chosen by the caller from N and K alone), over `ranks` CTAs
// of a cluster (split), or one CTA per tile (1, 128-row tiles only).
// Returns the CUDA error of the launch: 0 when it launched.
extern "C" int int8w_linear(const void* x, int x_dtype, const void* q, const void* s,
                            const void* bias, void* out, int M, int N, int K, int nt,
                            int split, int ranks, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  if (x_dtype == kF32) {
    if (M > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kCols - 1) / kCols, (M + 15) / 16);
    fma_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), qq, ss,
                                          static_cast<const float*>(bias),
                                          static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype != kBF16 || split < 1 || split > kMaxSplit || split > (K + kUnit - 1) / kUnit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
switch (nt) {
    case 8: return launch_wg<8>(x, q, ss, bias, out, M, N, K, split, ranks, st);
    case 16: return launch_wg<16>(x, q, ss, bias, out, M, N, K, split, ranks, st);
    case 32: return launch_wg<32>(x, q, ss, bias, out, M, N, K, split, ranks, st);
    case 64: return launch_wg<64>(x, q, ss, bias, out, M, N, K, split, ranks, st);
    case 128: return launch_wg<128>(x, q, ss, bias, out, M, N, K, split, ranks, st);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
