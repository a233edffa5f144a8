"""Decode attention: the CUDA kernels, their wrappers and plain versions.

``decode_attend`` (K2) is the port of the JAX package's Pallas kernel
``dalle_tpu/ops/decode_attention.py::decode_attend_kernel``. On a CUDA tensor
it launches ``csrc/decode_attention.cu`` (built at first use, see
``_build.py``) or raises; on a CPU tensor it runs ``decode_attend_plain``,
the same function in plain tensor code. ``launches`` counts kernel launches.
The kernel splits each (b, h) row over a thread-block cluster of ``nsplit``
CTAs that stream their slices of the cache through a two-slot ring of
stages of up to 64 positions (``csrc/decode_split.cuh``); ``decode_plan``
picks the split, the stage height and the ring's depth from the shapes
alone, never from ``length``.

``decode_attend_window`` (K3) and ``decode_attend_window_paged`` (K5) port
``decode_attend_window_kernel`` and ``decode_attend_window_paged``: w
queries per row at per-row starts, over the dense slab or the paged block
pool, both launched from ``csrc/decode_window_attention.cu`` along the route
``window_plan`` picks (tensor-core tiles for refill windows, a cluster split
for decode steps, f32 FMA for an f32 cache at w > 1). Their plain versions
are ``decode_attend_window_plain`` and ``decode_attend_window_paged_plain``;
``window_launches`` and ``paged_launches`` count their launches, and
``window_tc_launches``, ``window_split_launches`` and
``window_fma_launches`` the launches of each route.

``decode_attend_chunked`` (K7) ports ``decode_attend_kernel_chunked``: K2's
contract over ``blk``-sized cache blocks with an online softmax, blocks past
``length`` never read. It is launched from
``csrc/decode_chunked_attention.cu``, one kernel on K2's cluster skeleton
whose ranks take runs of whole blocks; its plain version is
``decode_attend_chunked_plain`` and ``chunked_launches`` counts its launches.
No path of either package selects it (it is kept for explicit use, as the
JAX package keeps it).

The function: q (b, h, 1, d) against the merged cache (b, S, 2·h·d) of
``ops/attention.KVCache`` (f32, bf16, or int8 with per-position scales
(b, 2h, S)). Position j is valid when j < length and mask_row[j] != 0; the
output is softmax over the valid j of q·k_j·scale, applied to v_j, divided
by the softmax sum (by 1 when nothing is valid). The int8 scales fold in
after the score dot (K) and into the probabilities (V), as in the Pallas
kernel. The softmax and every sum run in f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e9
MAX_DIM_HEAD = 256

# kernel launches since the last reset (the chip smoke test zeroes it around
# the main path to show the path went through the kernel)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEMS_PER_16B = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16}
# shared memory a block may take on Hopper
_MAX_SMEM = 227 * 1024
_fn = None
_sm_counts = {}
_plans = {}

# K2's and K7's launch plan (csrc/decode_split.cuh)
STAGE = 64                  # cache positions per ring stage at most
SPLIT_THREADS = 128         # threads per CTA
DECODE_CTAS_PER_SM = 8      # their residency by registers (the launch bounds)
SLOT_BYTES = 16 * 1024      # a slot's K and V rows at most, where d allows
_SM_SMEM = 228 * 1024       # shared memory of an SM, 1 KB of it reserved per CTA


class DecodePlan(NamedTuple):
    nsplit: int     # CTAs (a thread-block cluster) per (b, h) row
    rows: int       # cache positions per ring stage
    stages: int     # ring slots, K and V rows of one stage each
    smem: int       # bytes of shared memory per CTA


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _r16(x: int) -> int:
    return (x + 15) & ~15


def decode_smem_bytes(kv_dtype, d: int, rows: int, stages: int,
                      blk: Optional[int] = None, nsplit: int = 1) -> int:
    """Shared memory of one CTA of K2 (``blk`` None) or K7, as
    ``decode_split.cuh``'s ``layout`` lays it out: the ring (``stages`` slots
    of ``rows`` K rows and ``rows`` V rows; it also holds the row groups'
    sums at the end), int8 scales, q, the score buffer (a stage's for K2,
    two blocks' for K7), the probabilities (a row per warp for K2, a
    block's exp(s - m_b) for K7), the slots' validity bits, the warps' sums
    and, in a cluster, every rank's (m, l, o[d]) for rank 0's merge."""
    item = kv_dtype.itemsize
    pv = min(16 // item, 8)                       # V elements a thread takes
    vrows = min(SPLIT_THREADS // (d // pv), rows)
    at = _r16(max(stages * 2 * rows * d * item, vrows * d * 4))
    if kv_dtype == torch.int8:
        at += stages * 2 * rows * 4
    sbuf, pbuf = (rows, SPLIT_THREADS // 32 * rows) if blk is None else (2 * blk, blk)
    parts = _r16(4 * nsplit * (d + 2)) if nsplit > 1 else 0
    return at + _r16(4 * d) + _r16(4 * sbuf) + _r16(4 * pbuf) + 16 * stages + 16 + parts


def decode_plan(b: int, h: int, S: int, d: int, kv_dtype, sm_count: int,
                blk: Optional[int] = None) -> DecodePlan:
    """K2's (``blk`` None) or K7's launch plan for q (b, h, 1, d) over a
    cache of S positions. It reads the shapes only, never ``length``: each
    rank derives its slice from ``length`` on the card.

    * ``rows``: a stage's positions, 64 or fewer so that a slot's K and V
      rows stay within 16 KB (32 at d = 128 in bf16, 16 in f32), at least 16.
    * ``nsplit``: the largest of 1, 2, 4 and 8 (the portable cluster size)
      whose grid runs in one wave at the CTAs an SM that its shared memory
      and registers allow, with each rank of a full cache keeping at least
      one granule (a stage for K2, a ``blk`` block for K7).
    * ``stages``: the ring's depth, two slots (one stage in flight while
      the other is computed) or one where a rank never needs a second.
      Deeper rings and larger stages cost CTAs an SM; on the card this plan
      was the fastest of every (nsplit, rows, stages) at the 1.4B cache or
      within a few percent of it (``PERF.md`` §6, PR 12).
    * ``smem``: ``decode_smem_bytes`` of that ring."""
    slot = 2 * d * kv_dtype.itemsize            # bytes of one position's K and V rows
    rows = max(16, min(STAGE, SLOT_BYTES // slot))

    def ring(nsplit):
        """(stages, smem, fits in one wave) of a split."""
        if blk is None:
            need = -(-(-(-S // nsplit)) // rows)
        else:
            need = (-(-(-(-S // blk)) // nsplit) + 1) * -(-blk // rows)
        stages = min(need, 2)
        smem = decode_smem_bytes(kv_dtype, d, rows, stages, blk, nsplit)
        per_sm = min(DECODE_CTAS_PER_SM, _SM_SMEM // (smem + 1024))
        return stages, smem, nsplit * b * h <= per_sm * sm_count

    gran = rows if blk is None else blk
    nsplit = 1
    for cand in (2, 4, 8):
        if S >= cand * gran and ring(cand)[2]:
            nsplit = cand
    stages, smem, _ = ring(nsplit)
    return DecodePlan(nsplit, rows, stages, smem)


def _plan(q, kv, blk=None) -> DecodePlan:
    """``decode_plan`` for a launch, cached per (device, shapes, dtype, blk)."""
    b, h, _, d = q.shape
    key = (q.device.index, b, h, kv.shape[1], d, kv.dtype, blk)
    plan = _plans.get(key)
    if plan is None:
        plan = decode_plan(b, h, kv.shape[1], d, kv.dtype, _sm_count(q.device), blk=blk)
        if plan.smem > _MAX_SMEM:
            raise ValueError(f"the decode plan {plan} (block {blk}) exceeds a block's "
                             "shared memory")
        _plans[key] = plan
    return plan


def decode_attend_plain(q, kv, kv_scale, length, *,
                        mask_row: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain tensor code, f32 throughout."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    if scale is None:
        scale = d ** -0.5
    k = kv[:, :, :h * d].reshape(b, S, h, d).float()
    v = kv[:, :, h * d:].reshape(b, S, h, d).float()
    s = torch.einsum("bhd,bshd->bhs", q[:, :, 0].float() * scale, k)
    if kv_scale is not None:
        s = s * kv_scale[:, :h]
    valid = torch.arange(S, device=q.device) < length
    if mask_row is not None:
        valid = valid & (mask_row[:S] != 0)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    if kv_scale is not None:
        p = p * kv_scale[:, h:]
    o = torch.einsum("bhs,bshd->bhd", p, v)
    o = o / torch.where(den > 0, den, 1.0)
    return o.to(q.dtype)[:, :, None, :]


def _kernel():
    global _fn
    if _fn is None:
        from ._build import library
        fn = library("decode_attention").decode_attend
        # q, q dtype, kv, kv dtype, scales, mask row, out, b h S d length,
        # scale, nsplit rows stages, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda(q, kv, kv_scale, mask_row):
    b, h, i, d = q.shape
    S = kv.shape[1]
    if i != 1:
        raise ValueError(f"decode_attend takes one query per row, got {q.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv.dtype not in _DTYPE_CODE:
        raise TypeError(f"cache must be float32, bfloat16 or int8, got {kv.dtype}")
    if kv.dim() != 3 or kv.shape[0] != b or kv.shape[2] != 2 * h * d:
        raise ValueError(f"cache {tuple(kv.shape)} does not match q {tuple(q.shape)}")
    if d > MAX_DIM_HEAD or d % _ELEMS_PER_16B[kv.dtype]:
        raise ValueError(f"dim_head {d} must be <= {MAX_DIM_HEAD} and a multiple "
                         f"of {_ELEMS_PER_16B[kv.dtype]} for a {kv.dtype} cache")
    tensors = [q, kv] + [t for t in (kv_scale, mask_row) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("decode_attend operands must share one device")
        if not t.is_contiguous():
            raise ValueError("decode_attend operands must be contiguous")
    if kv.data_ptr() % 16:
        raise ValueError("cache must be 16-byte aligned")
    if (kv.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError("an int8 cache needs its scales, other caches none")
    if kv_scale is not None and (kv_scale.dtype != torch.float32
                                 or tuple(kv_scale.shape) != (b, 2 * h, S)):
        raise ValueError(f"scales must be float32 {(b, 2 * h, S)}")
    if mask_row is not None and (mask_row.dtype != torch.int32
                                 or mask_row.shape[0] < S):
        raise ValueError("mask_row must be int32 and cover the cache length")


def decode_attend(q: torch.Tensor, cache, length: int, *,
                  mask_row: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (b,h,1,d) × ``cache`` (an ``ops/attention.KVCache``) → (b,h,1,d) in
    q's dtype. ``length`` is a Python int; ``mask_row`` an optional (S,)
    validity row (int32 on CUDA)."""
    global launches
    kv, kv_scale = cache.kv, cache.scale
    if q.device.type == "cpu":
        return decode_attend_plain(q, kv, kv_scale, length, mask_row=mask_row,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attend runs on cuda or cpu, not {q.device}")
    _check_cuda(q, kv, kv_scale, mask_row)
    b, h, _, d = q.shape
    S = kv.shape[1]
    if scale is None:
        scale = d ** -0.5
    if mask_row is not None:
        mask_row = mask_row[:S]
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    plan = _plan(q, kv)
    rc = _kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], kv.data_ptr(), _DTYPE_CODE[kv.dtype],
        None if kv_scale is None else kv_scale.data_ptr(),
        None if mask_row is None else mask_row.data_ptr(),
        out.data_ptr(), b, h, S, d, int(length), float(scale), plan.nsplit, plan.rows,
        plan.stages, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attend kernel failed to launch: CUDA error {rc}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# K3 / K5: windowed decode attention with per-row starts
# ---------------------------------------------------------------------------

# launches of the windowed kernel over a dense slab (K3) and over a paged pool
# (K5) since the last reset, and of each route of either (``window_plan``)
window_launches = 0
paged_launches = 0
window_tc_launches = 0
window_split_launches = 0
window_fma_launches = 0
_window_fn = None
_window_smem_fn = None

# the routes of csrc/decode_window_attention.cu, by the code its entry point takes
WINDOW_ROUTES = {"fma": 0, "tc": 1, "split": 2}
WINDOW_KEYS = 64        # cache positions per K/V tile of the tc route
TC_ROWS = 64            # queries per CTA of the tc route
MAX_SPLIT = 8           # the portable thread-block cluster size
SPLIT_CTAS_PER_SM = 8   # the split kernel's residency (its launch bounds)


def window_plan(b: int, h: int, w: int, S: int, kv_dtype, sm_count: int):
    """K3/K5's launch plan for q (b, h, w, d) over a cache of S positions →
    (route, tile_rows, nsplit).

    * w = 1 (a decode step), every cache dtype: ``"split"``. The visible
      positions of each (row, head) are split across a cluster of
      ``nsplit`` CTAs: 2, doubled up to 8 (the portable cluster limit)
      while the doubled grid still runs in one wave (8 CTAs an SM) and each
      rank of a full cache keeps at least 64 positions.
    * w > 1, bf16 or int8 cache: ``"tc"``, tensor-core tiles of 64 query
      rows whatever the width and grid: 32- and 16-row tiles lost every
      timed case, the engine's 16-query prefill chunks and 14-CTA grids
      included, as a CTA of fewer warps keeps fewer copies in flight
      (``PERF.md`` §6).
    * w > 1, f32 cache: ``"fma"``, the f32 FMA kernel (the TPU's f32
      arithmetic) on tiles of 16 queries."""
    if w == 1:
        nsplit = 2
        while (nsplit < MAX_SPLIT and 2 * nsplit * b * h <= SPLIT_CTAS_PER_SM * sm_count
               and S >= 2 * nsplit * WINDOW_KEYS):
            nsplit *= 2
        return "split", 1, nsplit
    if kv_dtype == torch.float32:
        return "fma", 16, 1
    return "tc", TC_ROWS, 1


def decode_attend_window_plain(q, kv, kv_scale, starts, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """K3's function in plain tensor code: q (b, h, w, d) against the merged
    cache (b, S, 2hd) (+ (b, 2h, S) f32 scales for int8); query j of row b
    sees the positions <= starts[b] + j. As in the Pallas kernel, a bf16 or
    int8 cache rounds q·scale and the (V-scaled) probabilities to bf16
    before the products, which sum in f32; an f32 cache stays f32. Output in
    q's dtype."""
    b, h, w, d = q.shape
    S = kv.shape[1]
    if scale is None:
        scale = d ** -0.5
    dot_dt = torch.float32 if kv.dtype == torch.float32 else torch.bfloat16
    qs = (q.float() * scale).to(dot_dt).float()
    k = kv[:, :, :h * d].reshape(b, S, h, d).to(dot_dt).float()
    v = kv[:, :, h * d:].reshape(b, S, h, d).to(dot_dt).float()
    s = torch.einsum("bhwd,bshd->bhws", qs, k)
    if kv_scale is not None:
        s = s * kv_scale[:, :h, None, :]
    starts = torch.as_tensor(starts, device=q.device).long()
    qpos = starts[:, None] + torch.arange(w, device=q.device)[None, :]   # (b, w)
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= qpos[:, :, None])[:, None]                              # (b,1,w,S)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    if kv_scale is not None:
        p = p * kv_scale[:, h:, None, :]
    p = p.to(dot_dt).float()
    o = torch.einsum("bhws,bshd->bhwd", p, v)
    o = o / torch.where(den > 0, den, 1.0)
    return o.to(q.dtype)


def window_tolerance(want: torch.Tensor, kv_dtype) -> torch.Tensor:
    """Per-element bound of K3/K5 against their plain version on the same
    inputs. An f32 cache: the two differ in summation order only, 2e-5 of
    the largest output (at least 1). A bf16 or int8 cache: both round
    q·scale and the probabilities to bf16 at the same points, and a
    probability on a rounding boundary may round the other way when its
    score was summed in another order (2^-8 of the largest output of the
    same (row, head, query), a convex combination of the V rows it sees);
    the bf16 output adds its own rounding (2^-7 of the element, one ulp
    either side)."""
    want = want.float()
    if kv_dtype == torch.float32:
        return torch.full_like(want, 2e-5) * want.abs().max().clamp_min(1.0)
    return 2.0 ** -7 * want.abs() + 2.0 ** -8 * want.abs().amax(-1, keepdim=True)


def window_share(got: torch.Tensor, want: torch.Tensor, kv_dtype) -> float:
    """The worst element's share of its ``window_tolerance`` bound (NaN if
    any element is NaN). An exact match counts 0: a query that sees only
    unmapped pages outputs exact zeros, and its bound is 0."""
    diff = (got.float() - want.float()).abs()
    share = diff / window_tolerance(want, kv_dtype)
    return torch.where(diff == 0, 0.0, share).max().item()


def decode_attend_window_paged_plain(q, cache, starts, *,
                                     scale: Optional[float] = None) -> torch.Tensor:
    """K5's function in plain tensor code: the paged cache gathered into its
    dense slab (``cache.gather_dense()``), then K3's plain version."""
    dense = cache.gather_dense()
    return decode_attend_window_plain(q, dense.kv, dense.scale, starts, scale=scale)


def _window_kernel():
    global _window_fn, _window_smem_fn
    if _window_fn is None:
        from ._build import library
        lib = library("decode_window_attention")
        fn = lib.decode_attend_window
        # q, q dtype, kv, kv dtype, scales, pages, starts, out, b h w S d
        # block_tokens max_blocks, scale, route tile_rows nsplit, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # kv dtype, route, tile_rows, nsplit, w, S, d
        smem = lib.decode_window_smem_bytes
        smem.argtypes = [ctypes.c_int] * 7
        smem.restype = ctypes.c_longlong
        _window_fn, _window_smem_fn = fn, smem
    return _window_fn


def _check_window(q, kv, kv_scale, starts, scale_shape, S, plan):
    """What the windowed kernel takes; raises on anything else. ``kv`` is the
    dense slab or the pool, ``S`` the logical cache length, ``plan`` the
    launch plan (``window_plan``)."""
    b, h, w, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv.dtype not in _DTYPE_CODE:
        raise TypeError(f"cache must be float32, bfloat16 or int8, got {kv.dtype}")
    if kv.dim() != 3 or kv.shape[2] != 2 * h * d:
        raise ValueError(f"cache {tuple(kv.shape)} does not match q {tuple(q.shape)}")
    if d > MAX_DIM_HEAD or d % _ELEMS_PER_16B[kv.dtype]:
        raise ValueError(f"dim_head {d} must be <= {MAX_DIM_HEAD} and a multiple "
                         f"of {_ELEMS_PER_16B[kv.dtype]} for a {kv.dtype} cache")
    if (kv.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError("an int8 cache needs its scales, other caches none")
    if kv_scale is not None and (kv_scale.dtype != torch.float32
                                 or tuple(kv_scale.shape) != scale_shape):
        raise ValueError(f"scales must be float32 {scale_shape}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (b,):
        raise ValueError(f"starts must be int32 ({b},)")
    for t in [q, kv, starts] + ([] if kv_scale is None else [kv_scale]):
        if t.device != q.device:
            raise ValueError("decode_attend_window operands must share one device")
        if not t.is_contiguous():
            raise ValueError("decode_attend_window operands must be contiguous")
    if kv.data_ptr() % 16:
        raise ValueError("cache must be 16-byte aligned")
    _window_kernel()
    route, rows, nsplit = plan
    smem = _window_smem_fn(_DTYPE_CODE[kv.dtype], WINDOW_ROUTES[route], rows, nsplit,
                           w, S, d)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"the windowed kernel's plan {plan} does not fit a {kv.dtype} "
                         f"cache of {S} positions at w={w}, d={d} ({smem} bytes of "
                         "shared memory)")


def _launch_window(q, kv, kv_scale, pages, starts, S, bt, max_blocks, scale, plan):
    b, h, w, d = q.shape
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if b * h * w == 0:
        return out
    route, rows, nsplit = plan
    rc = _window_kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], kv.data_ptr(), _DTYPE_CODE[kv.dtype],
        None if kv_scale is None else kv_scale.data_ptr(),
        None if pages is None else pages.data_ptr(), starts.data_ptr(),
        out.data_ptr(), b, h, w, S, d, bt, max_blocks, float(scale),
        WINDOW_ROUTES[route], rows, nsplit,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attend_window kernel ({route} route) failed to "
                           f"launch: CUDA error {rc}")
    globals()[f"window_{route}_launches"] += 1
    return out


def _cuda_starts(q, starts):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attend_window runs on cuda or cpu, not {q.device}")
    return torch.as_tensor(starts, dtype=torch.int32, device=q.device)


def decode_attend_window(q: torch.Tensor, cache, starts, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K3: q (b,h,w,d) × ``cache`` (an ``ops/attention.KVCache``) → (b,h,w,d)
    in q's dtype, query j of row b at position ``starts[b] + j`` ((b,) int,
    int32 on the card)."""
    global window_launches
    kv, kv_scale = cache.kv, cache.scale
    if q.device.type == "cpu":
        return decode_attend_window_plain(q, kv, kv_scale, starts, scale=scale)
    starts = _cuda_starts(q, starts)
    b, h, w, _ = q.shape
    S = kv.shape[1]
    plan = window_plan(b, h, w, S, kv.dtype, _sm_count(q.device))
    _check_window(q, kv, kv_scale, starts, (b, 2 * h, S), S, plan)
    if kv.shape[0] != b:
        raise ValueError(f"cache batch {kv.shape[0]} != q batch {b}")
    out = _launch_window(q, kv, kv_scale, None, starts, S, 0, 0, scale, plan)
    window_launches += 1
    return out


def decode_attend_window_paged(q: torch.Tensor, cache, starts, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """K5: K3 over a paged cache (an ``ops/paged_kv.PagedKVCache`` with its
    page table bound), read through the page table in the kernel."""
    global paged_launches
    if q.device.type == "cpu":
        return decode_attend_window_paged_plain(q, cache, starts, scale=scale)
    starts = _cuda_starts(q, starts)
    b, h, w, _ = q.shape
    pool, pool_scale, pages = cache.pool, cache.scale, cache.pages
    bt, S = cache.block_tokens, cache.max_seq
    plan = window_plan(b, h, w, S, pool.dtype, _sm_count(q.device))
    _check_window(q, pool, pool_scale, starts, (pool.shape[0], bt, 2 * h), S, plan)
    if pool.shape[1] != bt:
        raise ValueError(f"pool {tuple(pool.shape)} does not hold blocks of {bt}")
    if (pages is None or pages.dtype != torch.int32 or pages.dim() != 2
            or pages.shape[0] != b or pages.device != q.device
            or not pages.is_contiguous() or pages.shape[1] * bt < S):
        raise ValueError(f"pages must be a contiguous int32 ({b}, >= {-(-S // bt)}) "
                         "page table on the query's device")
    out = _launch_window(q, pool, pool_scale, pages, starts, S, bt, pages.shape[1], scale,
                         plan)
    paged_launches += 1
    return out


# ---------------------------------------------------------------------------
# K7: chunked long-cache decode attention
# ---------------------------------------------------------------------------

# launches of the chunked kernel since the last reset (one kernel a call)
chunked_launches = 0
_chunked_fn = None
# the TPU's per-program VMEM budget for the cache blocks (for the copied gate)
_VMEM_BUDGET = 6 * 1024 * 1024


def decode_attend_chunked_plain(q, kv, kv_scale, length: int, *, blk: int = 256,
                                mask_row: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None) -> torch.Tensor:
    """K7's function in plain tensor code, in the TPU kernel's block order:
    an online softmax over ``blk``-sized blocks of the cache up to
    ``length``. A bf16 or int8 cache rounds q·scale and the (V-scaled)
    probabilities, taken against the running max, to bf16 before the
    products, which sum in f32; an f32 cache stays f32. The blocks past
    ``length`` are skipped: on the TPU they re-read the last needed block
    and mask it whole, which changes nothing. An empty row gives 0."""
    b, h, _, d = q.shape
    S = kv.shape[1]
    if scale is None:
        scale = d ** -0.5
    dot_dt = torch.float32 if kv.dtype == torch.float32 else torch.bfloat16
    qs = (q[:, :, 0].float() * scale).to(dot_dt).float()                # (b, h, d)
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    l = torch.zeros(b, h, 1, device=q.device)
    acc = torch.zeros(b, h, d, device=q.device)
    for j0 in range(0, min(int(length), S), blk):
        sl = slice(j0, j0 + blk)
        k = kv[:, sl, :h * d].reshape(b, -1, h, d).to(dot_dt).float()
        s = torch.einsum("bhd,bshd->bhs", qs, k)
        if kv_scale is not None:
            s = s * kv_scale[:, :h, sl]
        valid = torch.arange(j0, j0 + k.shape[1], device=q.device) < length
        if mask_row is not None:
            valid = valid & (mask_row[sl] != 0)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if kv_scale is not None:
            p = p * kv_scale[:, h:, sl]
        v = kv[:, sl, h * d:].reshape(b, -1, h, d).to(dot_dt).float()
        acc = acc * corr + torch.einsum("bhs,bshd->bhd", p.to(dot_dt).float(), v)
        m = m_new
    o = acc / torch.where(l > 0, l, 1.0)
    return o.to(q.dtype)[:, :, None, :]


def chunked_tolerance(q, kv, kv_scale, length: int, want: torch.Tensor, *,
                      mask_row: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Per-element bound of K7 against its plain version on the same inputs.
    The kernel takes each block's probabilities against that block's own max
    and rescales the block's sums when it merges them; the plain version, as
    the TPU, takes them against the running max. An f32 cache: the two
    differ in rounding and summation order only, 2e-5 of the largest output
    (at least 1). A bf16 or int8 cache: each side rounds every V-scaled
    probability to bf16 (within 2^-8 of it, relative) against its own
    reference, so an element differs by at most 2^-7 of
    Σ_j p_j·|vs_j·v_j| / Σ_j p_j, the softmax mean of the |values| the row
    sees (K2's plain version on |v|); plus 1e-5 of the largest output for
    the f32 sums, and for a bf16 output its own rounding, within 2^-8 of
    each side (2^-7 of the element)."""
    want = want.float()
    margin = 1e-5 * max(1.0, want.abs().max().item()) if want.numel() else 0.0
    if kv.dtype == torch.float32:
        return torch.full_like(want, 2e-5 * max(1.0, want.abs().max().item()))
    b, S, hd2 = kv.shape
    hd = hd2 // 2
    kv_abs = torch.cat([kv[:, :, :hd].float(), kv[:, :, hd:].float().abs()], dim=-1)
    vscale = None if kv_scale is None else torch.cat(
        [kv_scale[:, :q.shape[1]], kv_scale[:, q.shape[1]:].abs()], dim=1)
    mean_abs = decode_attend_plain(q.float(), kv_abs, vscale, length, mask_row=mask_row,
                                   scale=scale).float()
    bound = 2.0 ** -7 * mean_abs + margin
    if q.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.abs()
    return bound


def decode_kernel_chunk_supported(q, cache, *, stable: bool, blk: int = 256) -> bool:
    """The JAX package's gate for its chunked variant, verbatim: engages where
    the single-block kernel's VMEM budget is exceeded but per-block tiles
    still tile the lanes. No path of either package calls it to route; it
    is kept beside the kernel as the JAX package keeps it."""
    b, h, i, d = q.shape
    S, hd2 = cache.kv.shape[1], cache.kv.shape[2]
    itemsize = cache.kv.element_size()
    vmem = blk * hd2 * itemsize + blk * 4 + (2 * h * blk * 4
                                             if cache.kv.dtype == torch.int8 else 0)
    return (i == 1 and not stable and S % blk == 0 and S // blk >= 2
            and (hd2 // 2) % 128 == 0 and d % 8 == 0
            and vmem <= _VMEM_BUDGET)


def _chunked_kernel():
    global _chunked_fn
    if _chunked_fn is None:
        from ._build import library
        fn = library("decode_chunked_attention").decode_attend_chunked
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, q dtype, kv, kv dtype, scales, mask row, out, b h S d length blk,
        # scale, nsplit rows stages, stream
        fn.argtypes = [p, i, p, i, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        _chunked_fn = fn
    return _chunked_fn


def decode_attend_chunked(q: torch.Tensor, cache, length: int, *, blk: int = 256,
                          mask_row: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """K7: K2's contract (q (b,h,1,d) × ``cache`` → (b,h,1,d) in q's dtype,
    positions j < ``length`` with mask_row[j] != 0) over ``blk``-sized
    blocks of the cache; S must be a multiple of ``blk``."""
    global chunked_launches
    kv, kv_scale = cache.kv, cache.scale
    S = kv.shape[1]
    if blk <= 0 or S % blk:
        raise ValueError(f"cache length {S} is not a multiple of the block {blk}")
    if q.device.type == "cpu":
        return decode_attend_chunked_plain(q, kv, kv_scale, length, blk=blk,
                                           mask_row=mask_row, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attend_chunked runs on cuda or cpu, not {q.device}")
    _check_cuda(q, kv, kv_scale, mask_row)
    b, h, _, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if mask_row is not None:
        mask_row = mask_row[:S]
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    plan = _plan(q, kv, blk)
    rc = _chunked_kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], kv.data_ptr(), _DTYPE_CODE[kv.dtype],
        None if kv_scale is None else kv_scale.data_ptr(),
        None if mask_row is None else mask_row.data_ptr(),
        out.data_ptr(), b, h, S, d, int(length), blk, float(scale), plan.nsplit,
        plan.rows, plan.stages, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attend_chunked kernel failed to launch: CUDA error {rc}")
    chunked_launches += 1
    return out
