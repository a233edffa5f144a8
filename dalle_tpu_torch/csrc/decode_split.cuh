// The skeleton shared by the single-query decode kernels K2
// (decode_attention.cu) and K7 (decode_chunked_attention.cu), for Hopper
// (sm_90a).
//
// One query per (b, h) row against the merged cache (b, S, 2*h*d): position p
// holds K in its first h*d lanes and V in the rest, f32, bf16 or int8 (int8
// with per-position scales (b, 2h, S), K scales in rows 0..h-1). A row is
// split over a thread-block cluster of nsplit CTAs along the grid's x; rank r
// streams its slice of the cache once and keeps a local softmax (m, l, o);
// rank 0 merges the ranks through distributed shared memory in rank order.
//
// The ring. A rank's slice goes through shared memory in stages of `rows`
// positions (at most kStage = 64; the plan keeps a slot within 16 KB where d
// allows). A stage slot holds `rows` K head rows and `rows` V head rows (d *
// itemsize contiguous bytes each, strided by 2hd elements in the cache) and,
// for int8, their f32 scales; nst slots form a ring. Every row is
// copied by 16-byte cp.async.cg (the scales by 4-byte cp.async.ca), K and V of
// a slot in one commit group, nst - 1 stages ahead of the one being computed,
// before the kernel touches q. A position at or past length, or masked, is
// not copied: each warp forms the slot's validity bits by two ballots, and
// the bits gate the copies, the scores and the products.
//
// Why cp.async and not cp.async.bulk row copies on an mbarrier: a head row is
// 128-512 bytes, one 16-byte copy per thread per row chunk keeps the whole
// CTA issuing (a 16 KB slot is 8 copies a thread), the masking is a
// per-thread predicate, and the ring needs no barrier objects or
// transaction counts; the bulk form would put a stage's row copies on a
// single thread's issue slot or on one barrier arrival per row for no fewer
// bytes.
//
// The plan (ops/decode_attention.decode_plan) fixes rows, nsplit and the
// ring's depth from the shapes alone. Measured on the card (PERF.md, PR 12):
// what costs time is CTAs that do not fit one wave and CTAs an SM lost to
// shared memory, so a slot stays within 16 KB, the ring has two slots, and
// nsplit is the largest whose grid runs in one wave.
//
// Threads: kThreads = 128 (four warps). Scores: a group of G lanes per
// position (16-byte chunks of the K row, f32 FMA, a shuffle sum). Products:
// thread (vr, c) owns PV output columns c*PV.. and the positions
// j = vr (mod vrows) of a stage; at the end the vrows row groups are summed
// in shared memory (the ring's bytes, free by then) into o[d].
//
// The merge (finish_rank). Each rank writes (m_r, l_r, o_r[d]) into its slot
// of rank 0's shared memory through cluster.map_shared_rank; one
// cluster.sync(); rank 0 merges the slots in rank order: M = max m_r,
// w_r = exp(m_r - M) (0 for an empty rank, m_r = -inf), out = sum w_r o_r /
// sum w_r l_r, or 0 when that sum is 0. Pushing the partials to rank 0
// instead of having it read each rank's shared memory saves the remote loads
// and the last barrier that would keep the ranks alive for them.
// nsplit = 1 takes no cluster call. No atomics, and every sum runs in a fixed
// order: repeated runs give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace dsplit {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 64;       // cache positions per ring stage at most (the validity bits)
constexpr int kMaxSplit = 8;     // the portable cluster size
constexpr int kMaxStages = 8;    // ring slots
constexpr int kCtasPerSm = 8;    // the launch bounds' residency (64 registers a thread)

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> struct Vec;  // elements in one 16-byte chunk
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

// V elements a thread takes of one position (16 bytes, 8 for int8, so a
// thread's accumulators stay within the register cap)
template <typename T>
__host__ __device__ constexpr int pv() { return Vec<T>::N > 8 ? 8 : Vec<T>::N; }

// lanes that share one position in the score pass: the power of two >= the
// row's 16-byte chunks, at most 32
__host__ __device__ inline int lanes_per_row(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

// row groups of the products: threads / (d / PV), at most a stage's positions
template <typename T>
__host__ __device__ inline int vrows_of(int d, int rows) {
  const int r = kThreads / (d / pv<T>());
  return r < rows ? r : rows;
}

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared memory of one CTA, byte offsets, for a ring of nst slots of `rows`
// positions (rows <= kStage) in a cluster of nsplit. `sbuf` is the score buffer in floats: rows
// for K2, 2 * blk for K7; `pbuf` the probability buffer in floats: one row
// of `rows` per warp for K2, exp(s - m_b) of a block for K7. The ring's bytes also hold the row
// groups' sums at the end (red).
struct Layout {
  int slot, ring, scales, q, s, p, bits, stat, parts, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int d, int rows, int nst, int sbuf, int pbuf,
                                         int nsplit) {
  Layout L;
  L.slot = 2 * rows * d * static_cast<int>(sizeof(T));
  const int red = vrows_of<T>(d, rows) * d * 4;
  L.ring = 0;
  int at = round16(nst * L.slot > red ? nst * L.slot : red);
  L.scales = at;
  at += sizeof(T) == 1 ? nst * 2 * rows * 4 : 0;
  L.q = at;
  at += round16(d * 4);
  L.s = at;
  at += round16(sbuf * 4);
  L.p = at;
  at += round16(pbuf * 4);
  L.bits = at;
  at += nst * 2 * 8;
  L.stat = at;   // a sum per warp
  at += 16;
  L.parts = at;  // rank 0: every rank's (m, l, o[d])
  at += nsplit > 1 ? round16(nsplit * (d + 2) * 4) : 0;
  L.total = at;
  return L;
}

// ---------------------------------------------------------------------------
// values
// ---------------------------------------------------------------------------

// one 32-bit word of the cache as f32 values (4 / sizeof(T) of them),
// element 0 in the low bits
template <typename T> __device__ __forceinline__ void from_word(uint32_t w, float* f);
template <> __device__ __forceinline__ void from_word<float>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w);
}
template <> __device__ __forceinline__ void from_word<bf16>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void from_word<int8_t>(uint32_t w, float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xff));
}

// N elements of a row in shared memory at p (16 or 8 bytes, aligned) as f32
template <typename T, int N>
__device__ __forceinline__ void load_smem(const unsigned char* p, float* f) {
  constexpr int kPer = 4 / sizeof(T);
  if constexpr (N * sizeof(T) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
    from_word<T>(r.z, f + 2 * kPer);
    from_word<T>(r.w, f + 3 * kPer);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    from_word<T>(r.x, f);
    from_word<T>(r.y, f + kPer);
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename Q> __device__ __forceinline__ Q from_f32(float x);
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

// ---------------------------------------------------------------------------
// the ring's copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (< kMaxStages) committed groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// bit j set when position p + j is below end and unmasked (j < 64; the caller
// bounds end by the stage); every lane of the warp gets the same bits
__device__ __forceinline__ uint64_t stage_bits(const int* __restrict__ mask, int p, int end) {
  const int lane = threadIdx.x & 31;
  const int a = p + lane, b = p + 32 + lane;
  const bool va = a < end && (mask == nullptr || __ldg(mask + a) != 0);
  const bool vb = b < end && (mask == nullptr || __ldg(mask + b) != 0);
  const uint32_t lo = __ballot_sync(0xffffffffu, va);
  const uint32_t hi = __ballot_sync(0xffffffffu, vb);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// A thread's share of a stage's copies: the 16-byte chunks x = tid + 128 i
// of the stage's rows (row x / chunks, chunk x % chunks). Where chunks
// divides the 128 threads, every x of the thread falls in one chunk column c,
// in rows j0, j0 + step, ...; set once per launch, so a copy costs no division.
struct CopyLanes {
  int chunks, j0, step, c;
  __device__ __forceinline__ explicit CopyLanes(int chunks_) : chunks(chunks_) {
    step = kThreads % chunks == 0 ? kThreads / chunks : 0;
    j0 = threadIdx.x / chunks;
    c = threadIdx.x - j0 * chunks;
  }
};

// the 16-byte chunks of the stage's rows whose bits are set (rows < 64 of
// them): row j is src + (p + j) * stride elements, d * sizeof(T) bytes, to
// dst + j * d * sizeof(T)
template <typename T>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const T* __restrict__ src,
                                          long long stride, int p, uint64_t bits, int rows,
                                          const CopyLanes& ln) {
  if (bits == 0) return;
  if (ln.step) {
    const T* s = src + (p + ln.j0) * stride + ln.c * Vec<T>::N;
    unsigned char* d = dst + 16 * threadIdx.x;
    for (int j = ln.j0; j < rows; j += ln.step, s += ln.step * stride, d += 16 * kThreads) {
      if ((bits >> j) & 1) cp_async16(d, s);
    }
    return;
  }
  for (int x = threadIdx.x; x < rows * ln.chunks; x += kThreads) {
    const int j = x / ln.chunks;
    const int c = x - j * ln.chunks;
    if ((bits >> j) & 1) cp_async16(dst + 16 * x, src + (p + j) * stride + c * Vec<T>::N);
  }
}

// the f32 scales of the set positions, by threads [first, first + rows)
__device__ __forceinline__ void copy_scales(float* dst, const float* __restrict__ src, int p,
                                            uint64_t bits, int rows, int first) {
  const int j = static_cast<int>(threadIdx.x) - first;
  if (j >= 0 && j < rows && ((bits >> j) & 1)) cp_async4(dst + j, src + p + j);
}

// ---------------------------------------------------------------------------
// the arithmetic of a stage
// ---------------------------------------------------------------------------

// s_out[j] = (q . k_j) * kscale_j for the set bits j < n, -inf for the others
// (n <= kStage). q_s holds d f32 values; kscale is null or the slot's K
// scales. A lane group takes two positions at a time, so their loads, FMA
// chains and shuffle sums overlap.
template <typename T>
__device__ __forceinline__ void score_rows(const unsigned char* krows, const float* kscale,
                                           const float* q_s, uint64_t bits, int n, int d,
                                           float* s_out) {
  constexpr int VEC = Vec<T>::N;
  const int chunks = d / VEC;
  const int G = lanes_per_row(chunks);
  const int rpw = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % G;
  const int half = kWarps * rpw;    // positions one pass of the CTA covers
  for (int base = warp * rpw; base < n; base += 2 * half) {
    int j[2];
    bool ok[2];
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      j[u] = base + u * half + lane / G;
      ok[u] = j[u] < n && ((bits >> j[u]) & 1);
    }
    for (int c = gl; c < chunks; c += G) {
      const float4* qv = reinterpret_cast<const float4*>(q_s + c * VEC);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!ok[u]) continue;
        float f[VEC];
        load_smem<T, VEC>(krows + 16 * (j[u] * chunks + c), f);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qq = qv[e];
          part[u] = fmaf(f[4 * e], qq.x, part[u]);
          part[u] = fmaf(f[4 * e + 1], qq.y, part[u]);
          part[u] = fmaf(f[4 * e + 2], qq.z, part[u]);
          part[u] = fmaf(f[4 * e + 3], qq.w, part[u]);
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
      part[1] += __shfl_xor_sync(0xffffffffu, part[1], off);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (gl == 0 && j[u] < n) {
        s_out[j[u]] = ok[u] ? part[u] * (kscale ? kscale[j[u]] : 1.f) : -INFINITY;
      }
    }
  }
}

// acc[e] += p(j) * v_j[c*PV + e] over this thread's positions j = vr (mod
// vrows), j < n, whose bits are set; p(j) is read only for those
template <typename T, typename P>
__device__ __forceinline__ void pv_rows(const unsigned char* vrows_smem, uint64_t bits, int n,
                                        int d, int vr, int c, int vrows, P p_of, float* acc) {
  constexpr int PV = pv<T>();
  if (vr >= vrows) return;
#pragma unroll 4
  for (int j = vr; j < n; j += vrows) {
    const bool ok = (bits >> j) & 1;
    float f[PV];
    if (ok) {
      load_smem<T, PV>(vrows_smem + (j * d + c * PV) * static_cast<int>(sizeof(T)), f);
    } else {
#pragma unroll
      for (int e = 0; e < PV; ++e) f[e] = 0.f;
    }
    const float p = ok ? p_of(j) : 0.f;
#pragma unroll
    for (int e = 0; e < PV; ++e) acc[e] = fmaf(p, f[e], acc[e]);
  }
}

// ---------------------------------------------------------------------------
// the end of a rank: row groups summed, then the cluster's rank-order merge
// ---------------------------------------------------------------------------

// A rank may write into rank 0's shared memory only once every CTA of the
// cluster has started: each arrives (relaxed, no wait) at its start and
// waits for that phase before its first remote write (finish_rank).
__device__ __forceinline__ void cluster_arrive_started() {
  if (gridDim.x > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The end of a rank: its row groups' sums per column, then the cluster's
// merge. red holds vrows * d floats (the ring's bytes, free by now); parts
// nsplit * (d + 2) floats, read in rank 0 only. Rank r writes (m_r, l_r,
// o_r[d]) into slot r of rank 0's parts through distributed shared memory;
// one cluster barrier (release, acquire) makes them visible; rank 0 merges
// them in rank order, M = max m_r, w_r = exp(m_r - M) (0 for an empty rank),
// out = sum w_r o_r / sum w_r l_r, or 0 where that sum is 0. The other
// ranks may then exit: nothing reads their shared memory.
template <typename T, typename Q>
__device__ __forceinline__ void finish_rank(float* red, float* parts, const float* acc, float m,
                                            float l, int d, int vr, int c, int vrows,
                                            Q* __restrict__ out) {
  constexpr int PV = pv<T>();
  if (vr < vrows) {
#pragma unroll
    for (int e = 0; e < PV; ++e) red[vr * d + c * PV + e] = acc[e];
  }
  __syncthreads();
  const int nsplit = gridDim.x;
  if (nsplit == 1) {
    for (int x = threadIdx.x; x < d; x += kThreads) {
      float o = 0.f;
      for (int r = 0; r < vrows; ++r) o += red[r * d + x];
      out[x] = from_f32<Q>(l > 0.f ? o / l : 0.f);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every CTA has started
  float* dst = cluster.map_shared_rank(parts, 0) + blockIdx.x * (d + 2);
  for (int x = threadIdx.x; x < d; x += kThreads) {
    float o = 0.f;
    for (int r = 0; r < vrows; ++r) o += red[r * d + x];
    dst[2 + x] = o;
  }
  if (threadIdx.x == 0) {
    dst[0] = m;
    dst[1] = l;
  }
  cluster.sync();   // every rank's (m, l, o) is in rank 0's shared memory
  if (blockIdx.x != 0) return;
  float w[kMaxSplit];
  float M = -INFINITY;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r) {
    w[r] = r < nsplit ? parts[r * (d + 2)] : -INFINITY;
    M = fmaxf(M, w[r]);
  }
  float lt = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r) {
    w[r] = w[r] == -INFINITY ? 0.f : expf(w[r] - M);
    if (r < nsplit) lt += w[r] * parts[r * (d + 2) + 1];
  }
  for (int x = threadIdx.x; x < d; x += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < nsplit) o += w[r] * parts[r * (d + 2) + 2 + x];
    }
    out[x] = from_f32<Q>(lt > 0.f ? o / lt : 0.f);
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// Raise the kernel's dynamic shared memory cap to the card's opt-in maximum
// once per device (a driver call per launch would cost the host on every
// decode step); below 48 KB nothing is needed.
template <typename K>
inline cudaError_t allow_smem(K kern, int smem, std::atomic<unsigned>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// grid (nsplit, h, b), kThreads a CTA, a cluster of nsplit CTAs along x
// (none for nsplit = 1); returns the launch's CUDA error
template <typename K, typename A>
inline int launch_split(K kern, const A& args, int nsplit, int h, int b, int smem,
                        std::atomic<unsigned>& smem_done, cudaStream_t stream) {
  cudaError_t e = allow_smem(kern, smem, smem_done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, h, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves its error for the next caller
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsplit
