// Single-token decode attention over the merged KV cache, for Hopper (sm_90a).
//
// Replaces dalle_tpu/ops/decode_attention.py::decode_attend_kernel (body
// _decode_kernel): q (b, h, 1, d) against the sequence-major cache
// (b, S, 2*h*d) that holds K in the first h*d lanes of each position and V in
// the rest, stored as f32, bf16 or int8 (int8 with per-position scales
// (b, 2h, S), K scales in rows 0..h-1). A position j is valid when
// j < length and, if a mask row is given, mask_row[j] != 0. The result is
// softmax_j(q.k_j * scale) over the valid j applied to v_j; for int8 the K
// scale multiplies the score and the V scale the probability. q * scale, the
// scores, the probabilities and every sum stay in f32 for every cache dtype
// (the port's arithmetic; the TPU kernel rounds q * scale and p * vscale to
// bf16 before its MXU dots). With no valid position the output is 0.
//
// Bound: HBM bytes. Each call streams the valid part of the cache once,
// b * length * 2*h*d * itemsize bytes (+ 2*b*h*length*4 scale bytes for int8),
// against 4*b*h*length*d flops, far below the card's ops/byte balance.
//
// Design (decode_split.cuh): grid (nsplit, h, b), a cluster of nsplit CTAs per
// (b, h), launched with cudaLaunchKernelEx; ops/decode_attention.decode_plan
// picks nsplit, the stage height and the ring's depth from (b, h, S, d,
// dtype, SMs), never from length, so the grid and the shared memory do not
// depend on it. Each rank
// derives its slice on the device: the valid range [0, L = min(length, S)) in
// runs of ceil(L / nsplit) positions, so every rank of a row holds about the
// same bytes at every length. The rank's stages stream through the ring, K and V of
// a stage in flight together; a stage is scored into shared memory, each warp
// takes the stage's max m' = max(m, max s), rescales its (l, o) by exp(m - m')
// and, with p = exp(s - m') written once per position into the warp's p row
// (times the V scale), adds p times V. Nothing is rounded against a maximum,
// so each rank keeps its own running max and the ranks' partials merge by
// exp(m_r - M) exactly up to f32 rounding (flash-decoding): no barrier
// between reading K and reading V. At DALL·E-1.4B's cache (b=8, h=14, S=512,
// d=128) the plan is 4 ranks over two slots of 32 positions in bf16 (16 in
// f32; 448 CTAs of 34 KB, one wave) and 8 ranks of one 64-position stage in
// int8, so a rank has its first two stages in flight before it touches q.

#include "decode_split.cuh"

namespace {

using namespace dsplit;

struct Args {
  const void* q;          // (b, h, 1, d), Q
  const void* kv;         // (b, S, 2hd), T
  const float* scale;     // int8: (b, 2h, S); else null
  const int* mask;        // (S,) or null
  void* out;              // like q
  int heads, S, d, length, rows, nst;
  float sm_scale;
};

template <typename T>
__host__ __device__ inline Layout k2_layout(int d, int rows, int nst, int nsplit) {
  return layout<T>(d, rows, nst, rows, kWarps * rows, nsplit);
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
decode_split_kernel(const Args a) {
  constexpr int PV = pv<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, rows = a.rows, nst = a.nst, heads = a.heads, S = a.S;
  const Layout lay = k2_layout<T>(d, rows, nst, gridDim.x);
  unsigned char* ring = smem + lay.ring;
  float* scl = reinterpret_cast<float*>(smem + lay.scales);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* s_buf = reinterpret_cast<float*>(smem + lay.s);
  uint64_t* bit_s = reinterpret_cast<uint64_t*>(smem + lay.bits);

  const int nsplit = gridDim.x, rank = blockIdx.x;
  cluster_arrive_started();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* p_w = reinterpret_cast<float*>(smem + lay.p) + warp * rows;   // this warp's p row
  const int L = max(0, min(a.length, S));
  const int per = (L + nsplit - 1) / nsplit;
  const int p0 = min(L, rank * per);
  const int end = min(L, p0 + per);
  const int nstage = (end - p0 + rows - 1) / rows;
  const CopyLanes lanes(d / Vec<T>::N);
  const int half = lay.slot / 2;
  const long long stride = 2LL * heads * d;
  const T* kb = static_cast<const T*>(a.kv) + (long long)b * S * stride + (long long)h * d;
  const T* vb = kb + (long long)heads * d;
  const float* ks = a.scale ? a.scale + ((long long)b * 2 * heads + h) * S : nullptr;
  const float* vs = a.scale ? ks + (long long)heads * S : nullptr;

  // stage t of the rank: positions [p0 + t*rows, min(p0 + (t+1)*rows, end)) into slot t % nst
  auto issue = [&](int t) {
    if (t < nstage) {
      const int slot = t % nst;
      const int p = p0 + t * rows;
      const uint64_t bits = stage_bits(a.mask, p, min(end, p + rows));
      unsigned char* dst = ring + slot * lay.slot;
      copy_rows<T>(dst, kb, stride, p, bits, rows, lanes);
      copy_rows<T>(dst + half, vb, stride, p, bits, rows, lanes);
      if (ks) {
        copy_scales(scl + slot * 2 * rows, ks, p, bits, rows, 0);
        copy_scales(scl + slot * 2 * rows + rows, vs, p, bits, rows, rows);
      }
      if (tid == 0) bit_s[slot] = bits;
    }
    cp_async_commit();
  };
  for (int t = 0; t < nst - 1; ++t) issue(t);

  const long long bh = (long long)b * heads + h;
  const Q* q = static_cast<const Q*>(a.q) + bh * d;
  for (int x = tid; x < d; x += kThreads) q_s[x] = to_f32(q[x]) * a.sm_scale;

  const int vchunks = d / PV;
  const int vrows = vrows_of<T>(d, rows);
  const int vr = tid / vchunks, c = tid - vr * vchunks;
  float m = -INFINITY, l = 0.f;
  float acc[PV];
#pragma unroll
  for (int e = 0; e < PV; ++e) acc[e] = 0.f;

  for (int t = 0; t < nstage; ++t) {
    issue(t + nst - 1);
    cp_async_wait(nst - 1);
    __syncthreads();   // stage t has landed in every thread's view; q_s is written
    const int slot = t % nst;
    const uint64_t bits = bit_s[slot];
    const int n = min(rows, end - (p0 + t * rows));
    const unsigned char* krows = ring + slot * lay.slot;
    const float* kscl = ks ? scl + slot * 2 * rows : nullptr;
    score_rows<T>(krows, kscl, q_s, bits, n, d, s_buf);
    __syncthreads();
    // the stage's max, sum and p (times the V scale) into this warp's p row,
    // each warp alike
    const float s0 = lane < n ? s_buf[lane] : -INFINITY;
    const float s1 = lane + 32 < n ? s_buf[lane + 32] : -INFINITY;
    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    if (m_new != -INFINITY) {
      const float corr = expf(m - m_new);
      const float e0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float e1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      l = l * corr + warp_sum(e0 + e1);
      const float* vscl = kscl ? kscl + rows : nullptr;
      if (lane < n) p_w[lane] = vscl ? e0 * vscl[lane] : e0;
      if (lane + 32 < n) p_w[lane + 32] = vscl ? e1 * vscl[lane + 32] : e1;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < PV; ++e) acc[e] *= corr;
      pv_rows<T>(krows + half, bits, n, d, vr, c, vrows, [&](int j) { return p_w[j]; }, acc);
      m = m_new;
    }
    __syncthreads();   // slot t % nst is free for stage t + nst
  }
  cp_async_wait(0);

  finish_rank<T, Q>(reinterpret_cast<float*>(ring), reinterpret_cast<float*>(smem + lay.parts),
                    acc, m, l, d, vr, c, vrows, static_cast<Q*>(a.out) + bh * d);
}

template <typename T, typename Q>
int launch(const Args& a, int b, int nsplit, cudaStream_t stream) {
  static std::atomic<unsigned> smem_done{0};
  return launch_split(decode_split_kernel<T, Q>, a, nsplit, a.heads, b,
                      k2_layout<T>(a.d, a.rows, a.nst, nsplit).total, smem_done, stream);
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
int smem_bytes(int d, int rows, int nst, int nsplit) {
  if (d <= 0 || d > 256 || d % Vec<T>::N || nst < 1 || nst > kMaxStages) return 0;
  if (rows < 1 || rows > kStage || nsplit < 1 || nsplit > kMaxSplit) return 0;
  return k2_layout<T>(d, rows, nst, nsplit).total;
}

int smem_for(int kv_dtype, int d, int rows, int nst, int nsplit) {
  switch (kv_dtype) {
    case kF32: return smem_bytes<float>(d, rows, nst, nsplit);
    case kBF16: return smem_bytes<bf16>(d, rows, nst, nsplit);
    case kI8: return smem_bytes<int8_t>(d, rows, nst, nsplit);
    default: return 0;
  }
}

}  // namespace

// Shared memory (bytes) of one CTA for a cache dtype (0 = f32, 1 = bf16,
// 2 = int8), head dim d, stage rows, ring depth and ranks; 0 for what the
// kernel does not take.
extern "C" long long decode_attend_smem_bytes(int kv_dtype, int d, int rows, int stages,
                                              int nsplit) {
  return smem_for(kv_dtype, d, rows, stages, nsplit);
}

// q_dtype (also the output's) is 0 = f32 or 1 = bf16; kv_dtype is 0 = f32,
// 1 = bf16 or 2 = int8 (then kv_scale is required). kv_scale and mask_row may
// be null. nsplit (1..8), rows (1..64) and stages (1..8) come from the
// wrapper's decode_plan. Returns the CUDA error of the launch: 0 when it
// launched.
extern "C" int decode_attend(const void* q, int q_dtype, const void* kv, int kv_dtype,
                             const void* kv_scale, const void* mask_row, void* out, int b,
                             int h, int S, int d, int length, float sm_scale, int nsplit,
                             int rows, int stages, void* stream) {
  if ((kv_dtype == kI8) != (kv_scale != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype != kF32 && q_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || S <= 0 || b > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_for(kv_dtype, d, rows, stages, nsplit) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, kv, static_cast<const float*>(kv_scale), static_cast<const int*>(mask_row), out,
         h, S, d, length, rows, stages, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_dtype == kF32 ? launch_q<float>(a, kv_dtype, b, nsplit, st)
                         : launch_q<bf16>(a, kv_dtype, b, nsplit, st);
}
