// Tensor-core tile helpers for Hopper (sm_90a): 16-byte asynchronous copies
// into shared memory, ldmatrix, and the bf16 mma.sync.m16n8k16 product with
// f32 accumulators, as hand-written PTX.
//
// Fragment map of mma.m16n8k16 (lane = 4*g + t, g = lane / 4, t = lane % 4):
//   A (16x16, row-major), 4 registers of two bf16:
//     a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B (16x8, k x n), 2 registers:  b0 (k 2t, 2t+1; col g)  b1 (k 2t+8, +9; col g)
//   C (16x8 f32):  c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, cols 2t, 2t+1)
// So the C fragments of two neighbouring n8 tiles, rounded to bf16, are the A
// fragment of one k16 step: a0 = (c0, c1) and a1 = (c2, c3) of the first, a2
// and a3 of the second. A score tile goes from one product into the next in
// registers.
//
// Shared tiles are row-major bf16 with a row stride of D + 8 elements
// (2*D + 16 bytes): the eight 16-byte rows one ldmatrix phase reads fall in
// eight different bank groups, for every D that is a multiple of 16.
//
// Below the PTX wrappers: warp-level products on such tiles (a 16-row block
// of scores against 8*NJ columns, and bf16(scores) times a tile), the quad
// reductions over a C fragment's row, and the fixed-order sum of two warp
// groups' accumulators, shared by the tensor-core kernels of K1 and K4.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `valid` false
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise (the per-row f32 statistics)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a * b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of a C tile pair: (c of n8 tile 2j, c of n8 tile 2j+1)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane addresses inside a shared tile of row stride ld (elements):
// the A fragment of the 16x16 block at (row0, col0)
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* tile, int ld,
                                                       int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// the B fragments of two n8 tiles (rows n0 .. n0+15 of an [n][k] tile) at
// k16 step col0: registers (b0, b1) of rows n0.., then of rows n0+8..
__device__ __forceinline__ const __nv_bfloat16* b_addr(const __nv_bfloat16* tile, int ld,
                                                       int n0, int col0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 + ((lane >> 3) & 1) * 8;
}

// the B fragments, through ldsm_x4_t, of a [k][n] tile: k16 step at row k0,
// two n8 tiles at columns n0 and n0+8
__device__ __forceinline__ const __nv_bfloat16* bt_addr(const __nv_bfloat16* tile, int ld,
                                                        int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// (lo, hi) of a packed bf16 pair times s in f32, rounded to bf16 again: the
// TPU kernels' query scaling, bf16(f32(q) * scale), on a fragment register
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// max and sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&x)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// s (NJ n8 tiles: 16 rows x 8*NJ columns) += A * B^T over D; A is the 16 rows
// at arow0 of shared tile `a`, B the 8*NJ rows at brow0 of tile `b`, both
// [row][d] of row stride D + 8. With kScaleB, each B value is first
// replaced by bf16(f32(b) * bscale).
template <int D, int NJ, bool kScaleB = false>
__device__ __forceinline__ void dot_nt(float (&s)[NJ][4], const __nv_bfloat16* a, int arow0,
                                       const __nv_bfloat16* b, int brow0, int lane,
                                       float bscale = 1.f) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    ldsm_x4(af, a_addr(a, kLd, arow0, kd * 16, lane));
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b_addr(b, kLd, brow0 + np * 16, kd * 16, lane));
      if (kScaleB) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bf[e] = scale_bf16x2(bf[e], bscale);
      }
      mma16816(s[2 * np], af, bf[0], bf[1]);
      mma16816(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (D/8 n8 tiles) += bf16(p) * B: p the 16 x 8*NJ fragments of a score
// tile, B the 8*NJ rows at brow0 of shared tile `b` ([row][d] of row stride
// D + 8, read transposed by ldmatrix)
template <int D, int NJ>
__device__ __forceinline__ void dot_pv(float (&acc)[D / 8][4], const float (&p)[NJ][4],
                                       const __nv_bfloat16* b, int brow0, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t af[4];
    c_to_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, bt_addr(b, kLd, brow0 + kk * 16, dp * 16, lane));
      mma16816(acc[2 * dp], af, bf[0], bf[1]);
      mma16816(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// Eight warps where warp w takes the 16 rows 16*(w % 4) of a tile against
// half (w / 4) of the other operand's 64 columns: acc of group 1 (warps
// 4..7) into group 0's, through `red`, a free shared buffer of 64*D floats;
// lane-major, so the 32 lanes hit 32 banks. Group 0 + group 1 in that fixed
// order, so repeated runs give the same bits.
template <int D>
__device__ __forceinline__ void reduce_halves(float (&acc)[D / 8][4], float* red, int warp,
                                              int lane) {
  float* mine = red + (warp & 3) * (D / 2) * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(dn * 4 + e) * 32] = acc[dn][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += mine[(dn * 4 + e) * 32];
  }
}

}  // namespace tc
