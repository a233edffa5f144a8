"""Ring attention: sequence parallelism over P ranks.

Port of ``dalle_tpu/parallel/ring_attention.py``. The sequence is cut into
P chunks, one per rank; each rank keeps its q chunk, and the k/v chunks
travel round the ring, one hop a step, while an online softmax gathers the
rank's output. Causality and the structured masks (axial, conv) are tested
on global positions, so the result is exact for any P.

The JAX package runs one program per device under ``shard_map`` and moves
k/v with ``lax.ppermute``. Here the per-rank program is written once
against an exchange that stands for ``ppermute``: every value of it is a
list over the ranks this process holds, and ``shift`` hands each rank's
value to the next rank.

* ``LocalRing(P)``: all P ranks in this process; ``shift`` rotates the
  list. This computes what P devices compute, on one card, and launches
  the chunk kernels on every (q-chunk, k-chunk) pair at the same global
  offsets; it saves no memory (the whole sequence lives on the one card).
* ``GroupRing(group)``: one rank per process of a ``torch.distributed``
  group; ``shift`` sends to rank + 1 and receives from rank - 1
  (``batch_isend_irecv``). It is a ``torch.autograd.Function`` whose
  backward shifts the gradient the other way (the transpose JAX applies to
  ``ppermute``), so the dense body differentiates under a group too.

Two bodies share the schedule:

* the dense body (``kernel=False``): the score tile of each step in tensor
  code, f32, with autograd through the unrolled loop; k/v rotate in f32.
  With ``zigzag`` a quadrant whose k chunk lies wholly in its q chunk's
  future is skipped.
* the kernel body (``kernel=True``): each pair runs the chunk kernels K6
  (``ops/chunk_attention.py``), merged with ``merge_chunk``; one
  ``torch.autograd.Function`` over the whole ring saves only (q, k, v, o,
  lse), and its backward is a second ring pass of K6's dq and dk/dv, with
  dk/dv riding the ring home (P hops, the last included). k/v rotate in
  their input dtype. Wholly-future quadrants still launch and visit no
  tile, as the TPU kernels do. f32 inputs keep the TPU kernels' f32
  arithmetic on the card; bf16 inputs (bf16 compute) take K6's
  tensor-core route, which rounds p and dS to bf16 before the second
  product as K4's bf16 route does, so the ring rounds where the
  single-chip long-sequence layer rounds: within
  ``chunk_attention.rounding_tolerance`` (2^-8 of the absolute products)
  of the f32 arithmetic a pair. On the CPU every pair runs the f32
  arithmetic.

``zigzag`` (causal only) places sub-chunks (i, 2P-1-i) on rank i, so every
rank holds one early and one late sub-chunk and the causal work is even.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.chunk_attention import (chunk_flash_dkv, chunk_flash_dq, chunk_flash_fwd,
                                   merge_chunk, pick_block)
from ..ops.flash_attention import elem_fn_from_spec

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

class LocalRing:
    """All ``nper`` ranks in this process: a value is a list over ranks
    0..P-1, and ``shift`` gives rank i what rank i-1 held."""

    def __init__(self, nper: int):
        if nper < 1:
            raise ValueError(f"a ring needs at least one rank, got {nper}")
        self.nper = nper
        self.ranks = tuple(range(nper))

    def shift(self, xs: Sequence[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        return [xs[(i - 1) % self.nper] for i in range(self.nper)]


class GroupRing:
    """One rank per process of a ``torch.distributed`` group (None: the
    default group): a value is a one-element list, and ``shift`` sends it to
    rank + 1 and receives rank - 1's, differentiably."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.nper = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def _peer(self, rank: int) -> int:
        import torch.distributed as dist
        rank %= self.nper
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def exchange(self, tensors: Sequence[torch.Tensor], step: int) -> Tuple[torch.Tensor, ...]:
        """Send each tensor to rank + step, receive as many from rank - step."""
        import torch.distributed as dist
        me = self.ranks[0]
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in tensors)
        ops = []
        for t, buf in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._peer(me + step), self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(me - step), self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def shift(self, xs: Sequence[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        (x,) = xs
        return [_Shift.apply(self, *x)]


class _Shift(torch.autograd.Function):
    """``GroupRing``'s hop: forward to rank + 1; the gradient goes back to
    rank - 1."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return ring.exchange(xs, +1)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.ring.exchange(gs, -1))


# ---------------------------------------------------------------------------
# the dense bodies (autograd through the unrolled loop)
# ---------------------------------------------------------------------------

def _online_step(acc, m, l, q, qpos, k, v, kpos, n_valid, causal, elem_fn):
    """One online-softmax step of a (q, k/v) block in f32 (q already
    scaled): the dense body's arithmetic."""
    s = torch.einsum("bhid,bhjd->bhij", q, k)
    vis = (kpos[None, :] < n_valid).expand(qpos.shape[0], -1)
    if causal:
        vis = vis & (kpos[None, :] <= qpos[:, None])
    if elem_fn is not None:
        vis = vis & elem_fn(qpos[:, None], kpos[None, :])
    s = torch.where(vis, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum("bhij,bhjd->bhid", p, v)
    return acc, m_new, l


def _finish(acc, l, dtype):
    return (acc / torch.where(l > 0, l, 1.0)).to(dtype)


def _shift_kv(ring, k_cur, v_cur):
    moved = ring.shift(list(zip(k_cur, v_cur)))
    return [kv[0] for kv in moved], [kv[1] for kv in moved]


def _ring_body(ring, qs, ks, vs, *, causal: bool, scale: float, n_valid: int, elem_fn=None):
    """Per-rank program, plain layout: q stays, k/v rotate (in f32). Keys
    at padded positions ≥ n_valid are masked."""
    P = ring.nper
    n_local = qs[0].shape[2]
    dev = qs[0].device
    ar = torch.arange(n_local, device=dev)
    qf = [q.float() * scale for q in qs]
    state = [(torch.zeros(q.shape, device=dev),
              torch.full((*q.shape[:3], 1), NEG_INF, device=dev),
              torch.zeros((*q.shape[:3], 1), device=dev)) for q in qs]
    k_cur, v_cur = [k.float() for k in ks], [v.float() for v in vs]
    for t in range(P):
        for i, idx in enumerate(ring.ranks):
            src = (idx - t) % P              # ring origin of the held chunk
            state[i] = _online_step(*state[i], qf[i], idx * n_local + ar, k_cur[i], v_cur[i],
                                    src * n_local + ar, n_valid, causal, elem_fn)
        if t + 1 < P:
            k_cur, v_cur = _shift_kv(ring, k_cur, v_cur)
    return [_finish(acc, l, q.dtype) for (acc, _, l), q in zip(state, qs)]


def _ring_body_zigzag(ring, qs, ks, vs, *, scale: float, n_valid: int, elem_fn=None):
    """Causal per-rank program, zigzag layout: rank i holds sub-chunks
    (i, 2P-1-i) of m rows. A (q-sub, k-sub) quadrant whose k origin lies
    after the q origin has no visible pair and is skipped."""
    P = ring.nper
    m = qs[0].shape[2] // 2
    dev = qs[0].device
    ar = torch.arange(m, device=dev)
    qf = [q.float() * scale for q in qs]
    state = []
    for q in qs:
        shape = (*q.shape[:2], m)
        state.append([(torch.zeros(*shape, q.shape[3], device=dev),
                       torch.full((*shape, 1), NEG_INF, device=dev),
                       torch.zeros((*shape, 1), device=dev)) for _ in range(2)])
    k_cur, v_cur = [k.float() for k in ks], [v.float() for v in vs]
    for t in range(P):
        for i, idx in enumerate(ring.ranks):
            src = (idx - t) % P
            q_origins, k_origins = (idx, 2 * P - 1 - idx), (src, 2 * P - 1 - src)
            for s_i in range(2):
                o_k = k_origins[s_i]
                k_sub = k_cur[i][:, :, s_i * m:(s_i + 1) * m]
                v_sub = v_cur[i][:, :, s_i * m:(s_i + 1) * m]
                for r in range(2):
                    o_q = q_origins[r]
                    if o_k > o_q:                # wholly in the q sub's future
                        continue
                    state[i][r] = _online_step(*state[i][r], qf[i][:, :, r * m:(r + 1) * m],
                                               o_q * m + ar, k_sub, v_sub, o_k * m + ar,
                                               n_valid, True, elem_fn)
        if t + 1 < P:
            k_cur, v_cur = _shift_kv(ring, k_cur, v_cur)
    return [torch.cat([_finish(acc, l, q.dtype) for acc, _, l in st], dim=2)
            for st, q in zip(state, qs)]


# ---------------------------------------------------------------------------
# the kernel body: K6 inside the ring, one autograd.Function over the ring
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _RingSpec:
    causal: bool
    scale: float
    n_valid: int
    zigzag: bool
    mask_spec: Optional[tuple]

    def kw(self):
        return dict(scale=self.scale, n_valid=self.n_valid, causal=self.causal,
                    mask_spec=self.mask_spec)


def _pairs(ring, spec: _RingSpec, t: int, i: int, n_local: int):
    """The (q rows, k rows, q offset, k offset) of each pair rank
    ``ring.ranks[i]`` runs at step t, in the TPU kernels' order."""
    P, idx = ring.nper, ring.ranks[i]
    src = (idx - t) % P
    if not spec.zigzag:
        return [(slice(None), slice(None), idx * n_local, src * n_local)]
    m = n_local // 2
    q_origins, k_origins = (idx, 2 * P - 1 - idx), (src, 2 * P - 1 - src)
    return [(slice(r * m, (r + 1) * m), slice(s_i * m, (s_i + 1) * m),
             q_origins[r] * m, k_origins[s_i] * m)
            for s_i in range(2) for r in range(2)]


def _rows(x, sl):
    """Rows ``sl`` of the sequence dim (dim 2) of (b, h, n, ...)."""
    return x if sl == slice(None) else x[:, :, sl]


def _kernel_fwd(ring, spec: _RingSpec, qs, ks, vs):
    """The ring's forward through K6 → per rank (o f32, lse f32 with empty
    rows at -1e9)."""
    n_local = qs[0].shape[2]
    dev = qs[0].device
    o = [torch.zeros(q.shape, device=dev) for q in qs]
    lse = [torch.full(q.shape[:3], NEG_INF, device=dev) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(ring.nper):
        for i in range(len(qs)):
            for qr, kr, q_off, k_off in _pairs(ring, spec, t, i, n_local):
                o_t, lse_t = chunk_flash_fwd(_rows(qs[i], qr), _rows(k_cur[i], kr),
                                             _rows(v_cur[i], kr), q_off, k_off, **spec.kw())
                o_r, lse_r = merge_chunk(_rows(o[i], qr), _rows(lse[i], qr), o_t, lse_t)
                if qr == slice(None):
                    o[i], lse[i] = o_r, lse_r
                else:
                    o[i][:, :, qr], lse[i][:, :, qr] = o_r, lse_r
        if t + 1 < ring.nper:
            k_cur, v_cur = _shift_kv(ring, k_cur, v_cur)
    return o, lse


class _KernelRing(torch.autograd.Function):
    """The whole ring through K6: forward merges K6 forward results and
    saves (q, k, v, o, lse); backward is a second ring pass of K6 dq and
    dk/dv. Inputs: the ring, its spec, then q, k, v of every held rank."""

    @staticmethod
    def forward(ctx, ring, spec, *qkv):
        h = len(ring.ranks)
        qs, ks, vs = qkv[:h], qkv[h:2 * h], qkv[2 * h:]
        o, lse = _kernel_fwd(ring, spec, qs, ks, vs)
        o = [oi.to(q.dtype) for oi, q in zip(o, qs)]
        # empty rows: -1e9 (merge weight 0) → +1e9, so the backward's
        # p = exp(s - lse) is exactly 0 there
        lse = [torch.where(x <= 0.5 * NEG_INF, -NEG_INF, x) for x in lse]
        ctx.save_for_backward(*qs, *ks, *vs, *o, *lse)
        ctx.ring, ctx.spec = ring, spec
        return tuple(o)

    @staticmethod
    def backward(ctx, *dos):
        ring, spec = ctx.ring, ctx.spec
        h = len(ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, os, lses = (saved[j * h:(j + 1) * h] for j in range(5))
        dos = [do.to(q.dtype) for do, q in zip(dos, qs)]
        dos = [do if do.stride(-1) == 1 else do.contiguous() for do in dos]
        delta = [(do.float() * o.float()).sum(dim=-1) for do, o in zip(dos, os)]
        n_local = qs[0].shape[2]
        dev = qs[0].device
        dq = [torch.zeros(q.shape, device=dev) for q in qs]
        dk = [torch.zeros(k.shape, device=dev) for k in ks]
        dv = [torch.zeros(v.shape, device=dev) for v in vs]
        k_cur, v_cur = list(ks), list(vs)
        for t in range(ring.nper):
            for i in range(h):
                for qr, kr, q_off, k_off in _pairs(ring, spec, t, i, n_local):
                    args = (_rows(qs[i], qr), _rows(k_cur[i], kr), _rows(v_cur[i], kr),
                            _rows(dos[i], qr), _rows(lses[i], qr), _rows(delta[i], qr),
                            q_off, k_off)
                    dq_t = chunk_flash_dq(*args, **spec.kw())
                    dk_t, dv_t = chunk_flash_dkv(*args, **spec.kw())
                    _rows(dq[i], qr).add_(dq_t)
                    _rows(dk[i], kr).add_(dk_t)
                    _rows(dv[i], kr).add_(dv_t)
            # dk/dv ride every hop (P in all, the last included), so each
            # chunk's gradient finishes the circle back at its home rank
            if t + 1 < ring.nper:
                moved = ring.shift(list(zip(k_cur, v_cur, dk, dv)))
                k_cur, v_cur = [x[0] for x in moved], [x[1] for x in moved]
                dk, dv = [x[2] for x in moved], [x[3] for x in moved]
            else:
                dk, dv = _shift_kv(ring, dk, dv)
        return (None, None, *[g.to(q.dtype) for g, q in zip(dq, qs)],
                *[g.to(k.dtype) for g, k in zip(dk, ks)],
                *[g.to(v.dtype) for g, v in zip(dv, vs)])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def zigzag_perm(nper: int, m: int) -> np.ndarray:
    """Sequence permutation placing sub-chunks (i, 2P-1-i) on rank i."""
    parts = []
    for i in range(nper):
        parts.append(np.arange(i * m, (i + 1) * m))
        j = 2 * nper - 1 - i
        parts.append(np.arange(j * m, (j + 1) * m))
    return np.concatenate(parts)


def _check_args(causal: bool, zigzag: bool, mask_spec):
    if mask_spec is not None and mask_spec[0] not in ("axial", "conv"):
        raise ValueError("ring attention supports structured (axial/conv) mask specs "
                         f"only, got {mask_spec!r}")
    if zigzag and not causal:
        raise ValueError("zigzag is a causal-balancing layout")


def _use_kernel(kernel: Optional[bool], chunk: int, device) -> bool:
    """The JAX package's rule, with the card for the TPU: K6 when the chunk
    tiles (``pick_block``) and is at least 512 rows, on CUDA tensors."""
    blk = pick_block(chunk)
    if kernel is None:
        kernel = blk is not None and chunk >= 512 and torch.device(device).type == "cuda"
    if kernel and blk is None:
        raise ValueError(f"chunk size {chunk} has no valid kernel tiling; use kernel=False")
    return bool(kernel)


def _run(ring, qs, ks, vs, *, causal, scale, n_valid, zigzag, kernel, mask_spec):
    if kernel:
        spec = _RingSpec(bool(causal), float(scale), int(n_valid), bool(zigzag), mask_spec)
        return list(_KernelRing.apply(ring, spec, *qs, *ks, *vs))
    elem_fn = elem_fn_from_spec(mask_spec)
    if zigzag:
        return _ring_body_zigzag(ring, qs, ks, vs, scale=scale, n_valid=n_valid,
                                 elem_fn=elem_fn)
    return _ring_body(ring, qs, ks, vs, causal=causal, scale=scale, n_valid=n_valid,
                      elem_fn=elem_fn)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, nper: int,
                   causal: bool = True, scale: Optional[float] = None, zigzag: bool = False,
                   kernel: Optional[bool] = None, mask_spec=None) -> torch.Tensor:
    """Sequence-parallel attention over global (b, h, n, d) tensors, its
    ``nper`` ranks run in this process (``LocalRing``). A sequence that does
    not divide into P (zigzag: 2P) chunks is zero-padded; padded keys are
    masked and padded query rows sliced off.

    ``zigzag`` (causal only): the balanced layout, exact.
    ``kernel``: each pair through K6 (True), the dense body (False), or
    None: K6 when the chunk tiles (``pick_block``) and has at least 512
    rows and the tensors are on the card. True on a chunk that does not
    tile raises ``ValueError``. The JAX package's ``block`` (the TPU tile)
    has no counterpart: the kernels tile by 64 rows.
    ``mask_spec``: an axial or conv spec on top of causality, tested on
    global positions; a tabled or block spec raises ``ValueError``."""
    _check_args(causal, zigzag, mask_spec)
    n = q.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    parts = 2 * nper if zigzag else nper
    n_pad = -(-n // parts) * parts
    chunk = n_pad // parts
    kernel = _use_kernel(kernel, chunk, q.device)
    if n_pad != n:
        q, k, v = (F.pad(t, (0, 0, 0, n_pad - n)) for t in (q, k, v))
    if zigzag:
        perm = zigzag_perm(nper, chunk)
        fwd = torch.from_numpy(perm).to(q.device)
        inv = torch.from_numpy(np.argsort(perm)).to(q.device)
        q, k, v = (t.index_select(2, fwd) for t in (q, k, v))
    n_local = n_pad // nper
    split = [tuple(t[:, :, r * n_local:(r + 1) * n_local] for r in range(nper))
             for t in (q, k, v)]
    outs = _run(LocalRing(nper), *split, causal=causal, scale=scale, n_valid=n,
                zigzag=zigzag, kernel=kernel, mask_spec=mask_spec)
    out = torch.cat(outs, dim=2)
    if zigzag:
        out = out.index_select(2, inv)
    return out[:, :, :n] if n_pad != n else out


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_valid: int,
                         group=None, causal: bool = True, scale: Optional[float] = None,
                         zigzag: bool = False, kernel: Optional[bool] = None,
                         mask_spec=None) -> torch.Tensor:
    """The per-rank call over a process group (``GroupRing``): what
    ``shard_map`` runs on each device. q, k, v (b, h, n_local, d) are this
    rank's chunk of the padded (and, with ``zigzag``, permuted by
    ``zigzag_perm``) sequence; ``n_valid`` is the unpadded length. Returns
    this rank's output chunk. Arguments as ``ring_attention``."""
    _check_args(causal, zigzag, mask_spec)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n_local = q.shape[2]
    if zigzag and n_local % 2:
        raise ValueError(f"a zigzag chunk holds two sub-chunks; {n_local} rows is odd")
    kernel = _use_kernel(kernel, n_local // 2 if zigzag else n_local, q.device)
    (out,) = _run(GroupRing(group), [q], [k], [v], causal=causal, scale=scale,
                  n_valid=n_valid, zigzag=zigzag, kernel=kernel, mask_spec=mask_spec)
    return out
