// Chunked single-token decode attention over a long merged KV cache, for
// Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_kernel_chunked
// (body _decode_kernel_chunked): the contract of decode_attend_kernel (q
// (b, h, 1, d) against the sequence-major cache (b, S, 2*h*d), K in the first
// h*d lanes of a position and V in the rest, f32, bf16 or int8 with
// per-position scales (b, 2h, S)) computed over blk-sized blocks of the cache.
// A position j is valid when j < length and, with a mask row,
// mask_row[j] != 0. As in the TPU kernel, a bf16 or int8 cache rounds
// q * scale and the V-scaled probabilities to bf16 before the products (an
// f32 cache keeps f32); scores, the softmax and every sum are f32; the int8 K
// scale multiplies the score and the V scale the probability. A row with no
// valid position gives 0.
//
// Bound: HBM bytes. A call reads the cache up to length once,
// b * length * 2*h*d * itemsize bytes (+ 2*b*h*length*4 scale bytes for int8),
// against 4*b*h*length*d flops, far below the card's ops/byte balance.
//
// Design: K2's skeleton (decode_split.cuh), one kernel per call. Grid
// (nsplit, h, b), a cluster of nsplit CTAs per (b, h) launched with
// cudaLaunchKernelEx; ops/decode_attention.decode_plan picks nsplit and the
// ring's depth from the shapes, never from length. Rank r takes a contiguous
// run of whole blocks below length (ceil(ceil(L / blk) / nsplit) blocks a
// rank, derived on the device), a block being ceil(blk / rows) ring stages.
// The arithmetic is the block's: each block takes its probabilities against
// its own max m_b, so its V rows are needed only once all its K rows are
// scored. The ring therefore pairs, in one slot and one commit group, the K
// rows of stage k of block i with the V rows of stage k of block i - 1 (K of
// the first block comes alone, V of the last alone): K and V copies are in
// flight together, every position is read once, and a slot is no larger than
// K2's. Stage (i, k) scores block i's stage into a (2, blk) f32 score buffer
// and adds p16 . v of block i - 1's stage, with p16 = bf16(e * vs) formed as
// the stage's V rows land; when block i - 1's scores are complete, each warp
// takes the block's max m_b and the CTA writes e = exp(s - m_b) once per
// position and sums it (l_b) in warp order. The blocks of a rank merge
// online (M = max, weights exp(m - M)); the ranks merge in rank order in rank
// 0 through distributed shared memory. The TPU rounds p against the running
// max, this kernel against each block's own max: the two differ by the bf16
// rounding of each probability, and the online merge from the merge over
// every block at once by f32 rounding (decode_attention.chunked_tolerance
// states the bound). No scratch tensor, no second kernel.

#include "decode_split.cuh"

namespace {

using namespace dsplit;

struct Args {
  const void* q;          // (b, h, 1, d), Q
  const void* kv;         // (b, S, 2hd), T
  const float* scale;     // int8: (b, 2h, S); else null
  const int* mask;        // (S,) or null
  void* out;              // like q
  int heads, S, d, length, blk, rows, nst;
  float sm_scale;
};

// the product type's rounding: f32 caches keep f32, bf16 and int8 round to bf16
template <typename T> __device__ __forceinline__ float to_dot(float x) { return bf16_round(x); }
template <> __device__ __forceinline__ float to_dot<float>(float x) { return x; }

// (m, l, o) <- (m, l, o) merged with a block's (mb, lb, acc)
template <int PV>
__device__ __forceinline__ void merge_block(float& m, float& l, float* o, float mb, float lb,
                                            const float* acc) {
  const float M = fmaxf(m, mb);
  if (M == -INFINITY) return;
  const float w = m == -INFINITY ? 0.f : expf(m - M);
  const float wb = mb == -INFINITY ? 0.f : expf(mb - M);
  l = w * l + wb * lb;
#pragma unroll
  for (int e = 0; e < PV; ++e) o[e] = w * o[e] + wb * acc[e];
  m = M;
}

template <typename T>
__host__ __device__ inline Layout k7_layout(int d, int rows, int nst, int blk, int nsplit) {
  return layout<T>(d, rows, nst, 2 * blk, blk, nsplit);
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
chunked_split_kernel(const Args a) {
  constexpr int PV = pv<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, rows = a.rows, nst = a.nst, heads = a.heads, S = a.S, blk = a.blk;
  const Layout lay = k7_layout<T>(d, rows, nst, blk, gridDim.x);
  unsigned char* ring = smem + lay.ring;
  float* scl = reinterpret_cast<float*>(smem + lay.scales);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* s_blk = reinterpret_cast<float*>(smem + lay.s);   // (2, blk) scores
  float* e_blk = reinterpret_cast<float*>(smem + lay.p);   // (blk,) exp(s - m_b)
  uint64_t* bit_s = reinterpret_cast<uint64_t*>(smem + lay.bits);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);

  const int nsplit = gridDim.x, rank = blockIdx.x;
  cluster_arrive_started();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int L = max(0, min(a.length, S));
  const int nblk = (L + blk - 1) / blk;
  const int bpr = (nblk + nsplit - 1) / nsplit;
  const int ib0 = min(nblk, rank * bpr);
  const int nb = min(nblk, ib0 + bpr) - ib0;
  const int spb = (blk + rows - 1) / rows;
  const int steps = nb > 0 ? (nb + 1) * spb : 0;
  const CopyLanes lanes(d / Vec<T>::N);
  const int half = lay.slot / 2;
  const long long stride = 2LL * heads * d;
  const T* kb = static_cast<const T*>(a.kv) + (long long)b * S * stride + (long long)h * d;
  const T* vb = kb + (long long)heads * d;
  const float* ks = a.scale ? a.scale + ((long long)b * 2 * heads + h) * S : nullptr;
  const float* vs = a.scale ? ks + (long long)heads * S : nullptr;

  // the positions [p, e) of stage k of the rank's block i (e <= p: none)
  auto stage_at = [&](int i, int k, int& p, int& e) {
    const int j0 = (ib0 + i) * blk;
    p = j0 + k * rows;
    e = min(min(p + rows, j0 + blk), L);
  };
  // step t = (i, k): K of block i's stage k (i < nb), V of block i - 1's (i >= 1)
  auto issue = [&](int t) {
    if (t < steps) {
      const int i = t / spb, k = t - (t / spb) * spb;
      const int slot = t % nst;
      unsigned char* dst = ring + slot * lay.slot;
      int p, e;
      uint64_t kbits = 0, vbits = 0;
      if (i < nb) {
        stage_at(i, k, p, e);
        kbits = stage_bits(a.mask, p, e);
        copy_rows<T>(dst, kb, stride, p, kbits, rows, lanes);
        if (ks) copy_scales(scl + slot * 2 * rows, ks, p, kbits, rows, 0);
      }
      if (i >= 1) {
        stage_at(i - 1, k, p, e);
        vbits = stage_bits(a.mask, p, e);
        copy_rows<T>(dst + half, vb, stride, p, vbits, rows, lanes);
        if (vs) copy_scales(scl + slot * 2 * rows + rows, vs, p, vbits, rows, rows);
      }
      if (tid == 0) {
        bit_s[2 * slot] = kbits;
        bit_s[2 * slot + 1] = vbits;
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < nst - 1; ++t) issue(t);

  const long long bh = (long long)b * heads + h;
  const Q* q = static_cast<const Q*>(a.q) + bh * d;
  for (int x = tid; x < d; x += kThreads) q_s[x] = to_dot<T>(to_f32(q[x]) * a.sm_scale);

  const int vchunks = d / PV;
  const int vrows = vrows_of<T>(d, rows);
  const int vr = tid / vchunks, c = tid - vr * vchunks;
  float m = -INFINITY, l = 0.f, o[PV], acc[PV];   // the rank's (m, l, o); a block's acc
  float mb = -INFINITY, lb = 0.f;                 // the block whose V is streaming
#pragma unroll
  for (int e = 0; e < PV; ++e) o[e] = acc[e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    issue(t + nst - 1);
    cp_async_wait(nst - 1);
    __syncthreads();   // step t has landed; the scores of earlier steps are written
    const int i = t / spb, k = t - (t / spb) * spb;
    const int slot = t % nst;
    if (k == 0 && i >= 1) {
      // block i - 2 is summed: merge it; block i - 1 is scored: its max (each
      // warp alike), exp(s - m_b) into e_blk and their sum in warp order
      if (i >= 2) {
        merge_block<PV>(m, l, o, mb, lb, acc);
#pragma unroll
        for (int e = 0; e < PV; ++e) acc[e] = 0.f;
      }
      const float* s = s_blk + ((i - 1) & 1) * blk;
      const int len = min(blk, L - (ib0 + i - 1) * blk);
      float mx = -INFINITY;
      for (int j = lane; j < len; j += 32) mx = fmaxf(mx, s[j]);
      mb = warp_max(mx);
      float sum = 0.f;
      for (int j = tid; j < len; j += kThreads) {
        const float ej = s[j] == -INFINITY ? 0.f : expf(s[j] - mb);
        e_blk[j] = ej;
        sum += ej;
      }
      sum = warp_sum(sum);
      if (lane == 0) stat[tid >> 5] = sum;
      __syncthreads();   // e_blk and the warps' sums are written
      lb = 0.f;
      for (int w = 0; w < kWarps; ++w) lb += stat[w];
    }
    int p, e;
    if (i < nb) {
      stage_at(i, k, p, e);
      score_rows<T>(ring + slot * lay.slot, ks ? scl + slot * 2 * rows : nullptr, q_s,
                    bit_s[2 * slot], e - p, d, s_blk + (i & 1) * blk + k * rows);
    }
    if (i >= 1 && mb != -INFINITY) {
      stage_at(i - 1, k, p, e);
      const float* ek = e_blk + k * rows;
      const float* vscl = vs ? scl + slot * 2 * rows + rows : nullptr;
      pv_rows<T>(ring + slot * lay.slot + half, bit_s[2 * slot + 1], e - p, d, vr, c, vrows,
                 [&](int j) { return to_dot<T>(vscl ? ek[j] * vscl[j] : ek[j]); }, acc);
    }
    __syncthreads();   // slot t % nst is free for step t + nst
  }
  cp_async_wait(0);
  if (nb > 0) merge_block<PV>(m, l, o, mb, lb, acc);   // the rank's last block

  finish_rank<T, Q>(reinterpret_cast<float*>(ring), reinterpret_cast<float*>(smem + lay.parts),
                    o, m, l, d, vr, c, vrows, static_cast<Q*>(a.out) + bh * d);
}

template <typename T, typename Q>
int launch(const Args& a, int b, int nsplit, cudaStream_t stream) {
  static std::atomic<unsigned> smem_done{0};
  return launch_split(chunked_split_kernel<T, Q>, a, nsplit, a.heads, b,
                      k7_layout<T>(a.d, a.rows, a.nst, a.blk, nsplit).total, smem_done, stream);
}

template <typename Q>
int launch_q(const Args& a, int kv_dtype, int b, int nsplit, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch<float, Q>(a, b, nsplit, stream);
    case kBF16: return launch<bf16, Q>(a, b, nsplit, stream);
    default: return launch<int8_t, Q>(a, b, nsplit, stream);
  }
}

template <typename T>
long long smem_bytes(int d, int rows, int nst, int blk, int nsplit) {
  if (d <= 0 || d > 256 || d % Vec<T>::N || nst < 1 || nst > kMaxStages) return 0;
  if (rows < 1 || rows > kStage || blk <= 0 || blk > 1 << 20) return 0;
  if (nsplit < 1 || nsplit > kMaxSplit) return 0;
  return k7_layout<T>(d, rows, nst, blk, nsplit).total;
}

long long smem_for(int kv_dtype, int d, int rows, int nst, int blk, int nsplit) {
  switch (kv_dtype) {
    case kF32: return smem_bytes<float>(d, rows, nst, blk, nsplit);
    case kBF16: return smem_bytes<bf16>(d, rows, nst, blk, nsplit);
    case kI8: return smem_bytes<int8_t>(d, rows, nst, blk, nsplit);
    default: return 0;
  }
}

}  // namespace

// Shared memory (bytes) of one CTA for a cache dtype (0 = f32, 1 = bf16,
// 2 = int8), head dim d, stage rows, ring depth, block and ranks; 0 for what
// the kernel does not take.
extern "C" long long decode_chunked_smem_bytes(int kv_dtype, int d, int rows, int stages,
                                               int blk, int nsplit) {
  return smem_for(kv_dtype, d, rows, stages, blk, nsplit);
}

// q_dtype (also the output's) is 0 = f32 or 1 = bf16; kv_dtype is 0 = f32,
// 1 = bf16 or 2 = int8 (then kv_scale is required). kv_scale and mask_row may
// be null. nsplit (1..8), rows (1..64) and stages (1..8) come from the
// wrapper's decode_plan. Returns the CUDA error of the launch: 0 when it
// launched.
extern "C" int decode_attend_chunked(const void* q, int q_dtype, const void* kv, int kv_dtype,
                                     const void* kv_scale, const void* mask_row, void* out,
                                     int b, int h, int S, int d, int length, int blk,
                                     float sm_scale, int nsplit, int rows, int stages,
                                     void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype != kF32 && q_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || S <= 0 || b > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_for(kv_dtype, d, rows, stages, blk, nsplit);
  if (smem == 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, kv, static_cast<const float*>(kv_scale), static_cast<const int*>(mask_row), out,
         h, S, d, length, blk, rows, stages, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_dtype == kF32 ? launch_q<float>(a, kv_dtype, b, nsplit, st)
                         : launch_q<bf16>(a, kv_dtype, b, nsplit, st);
}
