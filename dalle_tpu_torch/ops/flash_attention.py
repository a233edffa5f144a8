"""Block-sparse flash attention (K4): the attention-mode resolution, the
host-side schedule, the CUDA kernels' wrappers, their plain versions and the
``torch.autograd.Function`` that joins them.

Port of ``dalle_tpu/ops/flash_attention.py``: ``flash_attention`` over
(b, h, n, d) with an optional static (n, n) mask, a structured mask spec and
causality. The host lowers the mask to block lists (the k tiles each q tile
visits, and the q tiles each k tile visits); the kernels visit only the
listed tiles. The forward is ``csrc/flash_attention.cu::flash_attention_fwd``
(the Pallas ``_fwd_kernel``) and saves (o, lse); the backward is two kernels,
``::flash_attention_bwd_dq`` (``_bwd_dq_kernel``) and
``::flash_attention_bwd_dkv`` (``_bwd_dkv_kernel``), deterministic, with no
atomics. All three are built at first use (``_build.py``). On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version, which walks the same block lists in the same order with the same
online softmax. ``fwd_launches``, ``bwd_dq_launches`` and
``bwd_dkv_launches`` count kernel launches, and ``tc_fwd_launches``,
``tc_bwd_dq_launches`` and ``tc_bwd_dkv_launches`` those of them that took
the tensor-core route.

The kernels have two routes, chosen by the operands' dtype. f32 operands
keep the TPU kernel's arithmetic: q, k and v are cast to f32, q is scaled,
and scores, p and every product are f32. bf16 operands run on the tensor
cores: s = (q·kᵀ)·scale in f32, and p and dS are rounded to bf16 before
the second product (``operands="bf16"`` in the plain versions; the bound
against the f32 arithmetic is ``rounding_bound``). A bf16 operand needs
16-byte aligned rows, else the wrapper raises. Either way hidden pairs
score -1e9 and p is forced to 0 where s <= -5e8. A row with no visible key
gets l = 0, output 0 and lse = +1e9, so its backward p is 0.
``delta = rowsum(dO·o)`` is a plain PyTorch op between the forward and the
backward kernels, as it sits outside any kernel in the JAX package.

The TPU's block geometry does not carry over: its 128-lane rule, the
``_auto_block`` VMEM sizes and the lane-replicated (bq, 128) lse are Mosaic
constraints. The kernels here take one 64-row tile (as K1 does), mask the
ragged edge themselves and keep lse as (b, h, n) f32. Visibility inside a
visited tile comes, from the most to the least specific, from a structured
spec computed in the kernel (axial row or column, conv window), an int8
(n, n) table, or nothing; causality and ``n`` are always ANDed in. A
``("block", B)`` spec whose B is a multiple of the tile needs no element test:
each tile lies inside one pattern block, so the block lists alone encode it.
Any other B takes the tabled mask, as the JAX package falls back for a B
that is not lane-aligned.

``resolve_use_pallas`` keeps the JAX package's setting strings. Where the JAX
package asks for the TPU, the port asks for a CUDA device. The TPU's
``fused_fits`` / ``fused_fwd_fits`` gates and the ``fused_qkv_attention_xbwd``
tier have no counterpart: they budget Mosaic's scoped VMEM, and the CUDA
kernels tile the sequence, so every shape they take runs both their forward
and their backward. ``persistent_fits`` (K8's gate) is kept verbatim: it
decides which lengths take K8's arithmetic and which go dense, so it is a
routing rule rather than a memory budget.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
TILE = 64                     # the kernels' query and key tile
DIM_HEADS = (16, 32, 64, 128)  # the head widths the kernels are built for

# the element test a schedule hands the kernels (csrc/flash_attention.cu)
MASK_NONE, MASK_AXIAL_ROW, MASK_AXIAL_COL, MASK_CONV, MASK_TABLE = range(5)

# the JAX package's measured dense/flash crossover on the TPU: "auto" on the
# card picks K4 at and above it and K1 below, as the JAX package does on the
# TPU; the port has measured no crossover of its own yet (PERF.md)
PALLAS_AUTO_MIN_SEQ = 2048

# launches since the last reset (chip_smoke.py zeroes them around the main
# path to show the path went through the kernels)
fwd_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
# the share of those that took the tensor-core route (bf16 operands)
tc_fwd_launches = 0
tc_bwd_dq_launches = 0
tc_bwd_dkv_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class BlockLists(NamedTuple):
    """Host-side (numpy) sparsity schedule for the kernels."""
    k_ids: np.ndarray    # (nq, max_k)  active k-block ids per q block
    k_cnt: np.ndarray    # (nq,)        how many of k_ids are valid
    q_ids: np.ndarray    # (nk, max_q)  active q-block ids per k block
    q_cnt: np.ndarray    # (nk,)


def build_block_lists(n_pad: int, block_q: int, block_k: int,
                      mask: Optional[np.ndarray] = None,
                      causal: bool = True) -> BlockLists:
    """Lower a (seq, seq) boolean mask (True = may attend) to block lists.
    ``mask`` may be smaller than n_pad (padded rows and columns count as
    invisible) or larger: the transformer builds its masks for seq_len + 1
    and training feeds seq_len, so the mask is trimmed to n_pad."""
    nq, nk = n_pad // block_q, n_pad // block_k
    vis = np.zeros((n_pad, n_pad), dtype=bool)
    if mask is not None:
        s = min(mask.shape[0], n_pad)
        vis[:s, :s] = mask[:s, :s]
    else:
        vis[:, :] = True
    if causal:
        vis &= np.tril(np.ones((n_pad, n_pad), dtype=bool))
    blk = vis.reshape(nq, block_q, nk, block_k).any(axis=(1, 3))

    def lists(b):
        rows = [np.nonzero(r)[0] for r in b]
        mx = max((len(r) for r in rows), default=1) or 1
        ids = np.zeros((b.shape[0], mx), dtype=np.int32)
        cnt = np.zeros((b.shape[0],), dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            cnt[i] = len(r)
        return ids, cnt

    k_ids, k_cnt = lists(blk)
    q_ids, q_cnt = lists(blk.T)
    return BlockLists(k_ids, k_cnt, q_ids, q_cnt)


def sparsity_fraction(n: int, block_q: int = 128, block_k: int = 128,
                      mask: Optional[np.ndarray] = None,
                      causal: bool = True) -> float:
    """Fraction of (q, k) blocks actually visited: the compute saving."""
    n_pad = _ceil_to(n, max(block_q, block_k))
    lists = build_block_lists(n_pad, block_q, block_k, mask, causal)
    nq, nk = n_pad // block_q, n_pad // block_k
    return float(lists.k_cnt.sum()) / float(nq * nk)


def elem_fn_from_spec(spec):
    """The element visibility test of a structured mask spec,
    ("axial", text_len, fmap, axis) or ("conv", text_len, fmap, kernel,
    dilation), as a function of (qpos, kpos) arrays or integer tensors; None
    for the block spec and for no spec. Causality is not part of it."""
    if spec is None:
        return None
    kind = spec[0]
    if kind == "block":
        return None
    if kind == "axial":
        _, text_len, fmap, axis = spec

        def fn(qpos, kpos):
            qi, ki = qpos - text_len, kpos - text_len
            if axis == 0:
                same = (qi // fmap) == (ki // fmap)
            else:
                same = (qi % fmap) == (ki % fmap)
            img_pair = (qpos >= text_len) & (kpos >= text_len)
            return (kpos < text_len) | (img_pair & same)
        return fn
    if kind == "conv":
        _, text_len, fmap, kernel, dil = spec
        span = (kernel - 1) * dil

        def fn(qpos, kpos):
            qi, ki = qpos - text_len, kpos - text_len
            dr = qi // fmap - ki // fmap
            dc = qi % fmap - ki % fmap
            win = (dr >= 0) & (dr <= span) & (dc >= 0) & (dc <= span)
            if dil > 1:
                win &= (dr % dil == 0) & (dc % dil == 0)
            img_pair = (qpos >= text_len) & (kpos >= text_len)
            return (kpos < text_len) | (img_pair & win)
        return fn
    raise ValueError(f"unknown mask spec {spec!r}")


def resolve_use_pallas(setting: Union[str, bool], seq_len: int,
                       device=None, dim_head: int = 64) -> Union[str, bool]:
    """A config's ``use_pallas`` → "flash" (K4), "fused" (K1), "persist" (K8)
    or False (dense), for a model whose tensors live on ``device``.

    * "flash", "on", "1", "true", "yes" and True: K4 on any device (its CUDA
      kernels on the card, its plain version on the CPU).
    * "fused": K1 on any device, likewise.
    * "persist": K8 on any device where ``persistent_fits(seq_len,
      dim_head)``, dense where it does not (the JAX package's routing rule).
    * "auto": on the card K4 at ``PALLAS_AUTO_MIN_SEQ`` tokens and above and
      K1 below; dense on the CPU (as the JAX package is dense off the TPU).
    * "off"/False: dense."""
    from .persistent_attention import persistent_fits
    on_card = device is not None and torch.device(device).type == "cuda"
    s = str(setting).lower()
    if setting is True or s in ("1", "true", "on", "yes", "flash"):
        return "flash"
    if setting is False or s in ("0", "false", "off", "no", "none"):
        return False
    if s == "persist":
        return "persist" if persistent_fits(seq_len, dim_head) else False
    if s == "fused":
        return "fused"
    if s == "auto":
        if not on_card:
            return False
        return "flash" if seq_len >= PALLAS_AUTO_MIN_SEQ else "fused"
    raise ValueError(
        f"use_pallas must be auto/fused/flash/persist/on/off, got {setting!r}")


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlashSchedule:
    """One layer's K4 schedule at length ``n`` on one device: the block lists
    as int32 tensors (``k_ids`` (nq, max_k) and ``k_cnt`` (nq,): the k tiles
    each 64-row q tile visits, in order; ``q_ids``/``q_cnt`` the transpose),
    and the element test: ``kind`` (a ``MASK_*`` code) with its four integer
    parameters ``spec`` (text_len, fmap, kernel, dilation for a conv window;
    text_len, fmap for an axial one), or ``table``, (n, n) int8, 1 = the
    query row may attend the key column."""
    n: int
    causal: bool
    k_ids: torch.Tensor
    k_cnt: torch.Tensor
    q_ids: torch.Tensor
    q_cnt: torch.Tensor
    kind: int = MASK_NONE
    spec: tuple = (0, 0, 0, 0)
    table: Optional[torch.Tensor] = None

    @property
    def visited_tiles(self) -> int:
        """(q tile, k tile) pairs the kernels visit per (batch row, head)."""
        return int(self.k_cnt.sum())


def flash_schedule(n: int, mask: Optional[np.ndarray] = None, mask_spec=None,
                   causal: bool = True, device=None) -> FlashSchedule:
    """The ``FlashSchedule`` of a static mask (host numpy, True or nonzero =
    may attend, at least (n, n): its top-left block is used) and/or a mask
    spec at length ``n``. The block lists come from the mask, as the JAX
    package builds them; a structured spec replaces the element table."""
    if mask is not None:
        mask = np.asarray(mask) != 0
    if mask_spec is not None and mask_spec[0] == "block" and int(mask_spec[1]) % TILE:
        mask_spec = None            # a pattern block the tile does not divide
    lists = build_block_lists(_ceil_to(max(n, 1), TILE), TILE, TILE, mask, causal)
    kind, spec, table = MASK_NONE, (0, 0, 0, 0), None
    if mask_spec is not None and mask_spec[0] == "axial":
        _, text_len, fmap, axis = mask_spec
        kind = MASK_AXIAL_ROW if axis == 0 else MASK_AXIAL_COL
        spec = (int(text_len), int(fmap), 0, 0)
    elif mask_spec is not None and mask_spec[0] == "conv":
        _, text_len, fmap, kernel, dil = mask_spec
        kind, spec = MASK_CONV, (int(text_len), int(fmap), int(kernel), int(dil))
    elif mask_spec is None and mask is not None:
        if mask.shape[0] < n or mask.shape[1] < n:
            raise ValueError(f"mask {mask.shape} is smaller than ({n}, {n})")
        kind = MASK_TABLE
        table = torch.from_numpy(np.ascontiguousarray(mask[:n, :n]).astype(np.int8))
    elif mask_spec is not None and mask_spec[0] != "block":
        raise ValueError(f"unknown mask spec {mask_spec!r}")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FlashSchedule(n, bool(causal), dev(lists.k_ids), dev(lists.k_cnt),
                         dev(lists.q_ids), dev(lists.q_cnt), kind, spec,
                         None if table is None else table.to(device))


def _visible(sched: FlashSchedule, qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
    """The kernels' visibility of (qpos, kpos) integer tensors (broadcast):
    inside the sequence, causal when the schedule is, and the element test."""
    n = sched.n
    vis = (qpos < n) & (kpos < n)
    if sched.causal:
        vis = vis & (kpos <= qpos)
    text_len, fmap, a, b = sched.spec
    if sched.kind in (MASK_AXIAL_ROW, MASK_AXIAL_COL):
        axis = 0 if sched.kind == MASK_AXIAL_ROW else 1
        vis = vis & elem_fn_from_spec(("axial", text_len, fmap, axis))(qpos, kpos)
    elif sched.kind == MASK_CONV:
        vis = vis & elem_fn_from_spec(("conv", text_len, fmap, a, b))(qpos, kpos)
    elif sched.kind == MASK_TABLE:
        vis = vis & (sched.table[qpos.clamp(max=n - 1), kpos.clamp(max=n - 1)] != 0)
    return vis


def visible_pairs(sched: FlashSchedule) -> int:
    """How many (query, key) pairs the schedule makes visible, per (batch
    row, head): the pairs of the listed tiles that pass the element test,
    the work a kernel of this function cannot skip."""
    n, nt = sched.n, sched.k_ids.shape[0]
    dev = sched.k_ids.device
    listed = torch.zeros(nt, nt, dtype=torch.bool, device=dev)
    live = torch.arange(sched.k_ids.shape[1], device=dev)[None, :] < sched.k_cnt[:, None]
    rows = torch.arange(nt, device=dev)[:, None].expand_as(sched.k_ids)
    listed[rows[live], sched.k_ids.long()[live]] = True
    pos = torch.arange(n, device=dev)
    total = 0
    for i0 in range(0, n, 1024):
        q = pos[i0:i0 + 1024, None]
        vis = _visible(sched, q, pos[None, :]) & listed[q // TILE, pos[None, :] // TILE]
        total += int(vis.sum())
    return total


# ---------------------------------------------------------------------------
# plain versions (the kernels' functions in tensor code, tile by tile)
# ---------------------------------------------------------------------------

def _tiles(x: torch.Tensor, nt: int) -> torch.Tensor:
    """(b, h, n, ...) → f32 (b, h, nt, TILE, ...), zero beyond n."""
    pad = nt * TILE - x.shape[2]
    x = x.float()
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))
    return x.reshape(x.shape[0], x.shape[1], nt, TILE, *x.shape[3:])


def _tile_pos(ids: torch.Tensor) -> torch.Tensor:
    """Tile ids (m,) → their positions (m, TILE), int64."""
    return ids.long()[:, None] * TILE + torch.arange(TILE, device=ids.device)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _rounder(operands: str):
    """``operands`` → the rounding applied to a second product's operand:
    none for "f32" (the TPU's arithmetic), bf16 for "bf16" (the tensor-core
    route)."""
    if operands == "f32":
        return lambda x: x
    if operands == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    raise ValueError(f"operands must be 'f32' or 'bf16', got {operands!r}")


def _inputs(sc: float, operands: str, q, *rest):
    """f32 tiles of q (scaled for "f32") and the other operands (rounded to
    bf16 for "bf16", where the kernel scales s instead of q)."""
    nt = -(-q.shape[2] // TILE)
    rnd = _rounder(operands)
    qs = _tiles(q, nt) * sc if operands == "f32" else rnd(_tiles(q, nt))
    return (qs,) + tuple(rnd(_tiles(x, nt)) for x in rest)


def flash_fwd_plain(q, k, v, sched: FlashSchedule, scale: Optional[float] = None,
                    operands: str = "f32"):
    """The forward kernel's function → (o in q's dtype (b, h, n, d), lse f32
    (b, h, n)): each q tile walks its k tiles in list order with the online
    softmax (running max m, sum l and accumulator in f32). ``operands``
    "f32" is the TPU's arithmetic (the f32 route); "bf16" the tensor-core
    route's: s = (q·k)·scale, and p rounded to bf16 before p·v (l sums the
    unrounded p)."""
    b, h, n, d = q.shape
    nt = -(-n // TILE)
    sc = _scale(q, scale)
    rnd = _rounder(operands)
    qs, kt, vt = _inputs(sc, operands, q, k, v)
    qpos = _tile_pos(torch.arange(nt, device=q.device))[:, :, None]      # (nt, T, 1)
    acc = torch.zeros(b, h, nt, TILE, d, device=q.device)
    m = torch.full((b, h, nt, TILE, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    for t in range(sched.k_ids.shape[1]):
        live = (t < sched.k_cnt)[:, None, None]                           # (nt, 1, 1)
        jb = sched.k_ids[:, t].long()
        kb, vb = kt[:, :, jb], vt[:, :, jb]
        s = torch.einsum("bhqid,bhqjd->bhqij", qs, kb)
        if operands == "bf16":
            s = s * sc
        s = torch.where(_visible(sched, qpos, _tile_pos(jb)[:, None, :]), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = torch.where(live, l * corr + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(live, acc * corr + torch.einsum("bhqij,bhqjd->bhqid", rnd(p), vb), acc)
        m = torch.where(live, m_new, m)
    safe_l = torch.where(l > 0, l, 1.0)
    o = (acc / safe_l).reshape(b, h, nt * TILE, d)[:, :, :n]
    lse = torch.where(l > 0, m + torch.log(safe_l), -NEG_INF)
    return o.to(q.dtype), lse.reshape(b, h, nt * TILE)[:, :, :n].contiguous()


def flash_bwd_dq_plain(q, k, v, do, lse, delta, sched: FlashSchedule,
                       scale: Optional[float] = None, operands: str = "f32") -> torch.Tensor:
    """The dq kernel's function: p = exp(s - lse), dS = p·(dP - delta),
    dq = scale · Σ dS·k over each q tile's k tiles in list order; with
    ``operands="bf16"`` s = (q·k)·scale and dS is rounded to bf16 before
    dS·k."""
    b, h, n, d = q.shape
    nt = -(-n // TILE)
    sc = _scale(q, scale)
    rnd = _rounder(operands)
    qs, kt, vt, dot = _inputs(sc, operands, q, k, v, do)
    lse_t, delta_t = _tiles(lse[..., None], nt), _tiles(delta[..., None], nt)
    qpos = _tile_pos(torch.arange(nt, device=q.device))[:, :, None]
    dq = torch.zeros(b, h, nt, TILE, d, device=q.device)
    for t in range(sched.k_ids.shape[1]):
        live = (t < sched.k_cnt)[:, None, None]
        jb = sched.k_ids[:, t].long()
        kb, vb = kt[:, :, jb], vt[:, :, jb]
        s = torch.einsum("bhqid,bhqjd->bhqij", qs, kb)
        if operands == "bf16":
            s = s * sc
        s = torch.where(_visible(sched, qpos, _tile_pos(jb)[:, None, :]), s, NEG_INF)
        p = torch.exp(s - lse_t)
        dp = torch.einsum("bhqid,bhqjd->bhqij", dot, vb)
        ds = p * (dp - delta_t)
        dq = torch.where(live, dq + torch.einsum("bhqij,bhqjd->bhqid", rnd(ds), kb), dq)
    return (dq * sc).reshape(b, h, nt * TILE, d)[:, :, :n].to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched: FlashSchedule,
                        scale: Optional[float] = None, operands: str = "f32"):
    """The dk/dv kernel's function: each k tile walks its q tiles in list
    order; dv = Σ pᵀ·dO, dk = Σ dSᵀ·(scale·q), so dk needs no final scale.
    With ``operands="bf16"``: s = (q·k)·scale, p and dS rounded to bf16
    before pᵀ·dO and dSᵀ·q, and dk = scale · Σ dSᵀ·q."""
    b, h, n, d = q.shape
    nt = -(-n // TILE)
    sc = _scale(q, scale)
    rnd = _rounder(operands)
    qs, kt, vt, dot = _inputs(sc, operands, q, k, v, do)
    lse_t, delta_t = _tiles(lse[..., None], nt), _tiles(delta[..., None], nt)
    kpos = _tile_pos(torch.arange(nt, device=q.device))[:, None, :]     # (nt, 1, T)
    dk = torch.zeros(b, h, nt, TILE, d, device=q.device)
    dv = torch.zeros_like(dk)
    for t in range(sched.q_ids.shape[1]):
        live = (t < sched.q_cnt)[:, None, None]
        ib = sched.q_ids[:, t].long()
        qb, dob = qs[:, :, ib], dot[:, :, ib]
        s = torch.einsum("bhkid,bhkjd->bhkij", qb, kt)                  # (query, key)
        if operands == "bf16":
            s = s * sc
        s = torch.where(_visible(sched, _tile_pos(ib)[:, :, None], kpos), s, NEG_INF)
        p = torch.exp(s - lse_t[:, :, ib])
        dv = torch.where(live, dv + torch.einsum("bhkij,bhkid->bhkjd", rnd(p), dob), dv)
        dp = torch.einsum("bhkid,bhkjd->bhkij", dob, vt)
        ds = p * (dp - delta_t[:, :, ib])
        dk = torch.where(live, dk + torch.einsum("bhkij,bhkid->bhkjd", rnd(ds), qb), dk)
    if operands == "bf16":
        dk = dk * sc

    def out(x):
        return x.reshape(b, h, nt * TILE, d)[:, :, :n].to(q.dtype)
    return out(dk), out(dv)


def rounding_bound(q, k, v, do, lse, delta, sched: FlashSchedule,
                   scale: Optional[float] = None) -> dict:
    """Per element of o, dq, dk and dv (f32 (b, h, n, d)), the sum of the
    absolute products whose first factor the tensor-core route rounds to
    bf16: Σ|P|·|v| for o (P = exp(s - lse) = p / l), scale·Σ|dS|·|k| for
    dq, scale·Σ|dS|ᵀ·|q| for dk and Σ|P|ᵀ·|dO| for dv, over the pairs the
    schedule makes visible. Rounding to nearest moves each factor by at
    most 2^-8 of itself, so 2^-8 of this bounds what the rounding changes
    in the f32 sum; ``rounding_tolerance`` and ``tc_kernel_tolerance`` are
    built on it."""
    b, h, n, d = q.shape
    nt = -(-n // TILE)
    sc = _scale(q, scale)
    qs, kt, vt, dot = (_tiles(x, nt) for x in (q, k, v, do))
    lse_t, delta_t = _tiles(lse[..., None], nt), _tiles(delta[..., None], nt)
    qpos = _tile_pos(torch.arange(nt, device=q.device))[:, :, None]
    out = {w: torch.zeros(b, h, nt, TILE, d, device=q.device) for w in ("o", "dq", "dk", "dv")}
    for t in range(sched.k_ids.shape[1]):
        live = (t < sched.k_cnt)[:, None, None]
        jb = sched.k_ids[:, t].long()
        kb, vb = kt[:, :, jb], vt[:, :, jb]
        s = torch.einsum("bhqid,bhqjd->bhqij", qs, kb) * sc
        vis = _visible(sched, qpos, _tile_pos(jb)[:, None, :]) & live
        p = torch.where(vis, torch.exp(s - lse_t), 0.0)
        dp = torch.einsum("bhqid,bhqjd->bhqij", dot, vb)
        ds = (p * (dp - delta_t)).abs()
        out["o"] += torch.einsum("bhqij,bhqjd->bhqid", p, vb.abs())
        out["dq"] += torch.einsum("bhqij,bhqjd->bhqid", ds, kb.abs())
        out["dk"].index_add_(2, jb, torch.einsum("bhqij,bhqid->bhqjd", ds, qs.abs()))
        out["dv"].index_add_(2, jb, torch.einsum("bhqij,bhqid->bhqjd", p, dot.abs()))
    out["dq"] *= sc
    out["dk"] *= sc
    return {w: x.reshape(b, h, nt * TILE, d)[:, :, :n] for w, x in out.items()}


def kernel_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain version| for an output ``want``
    (o, dq, dk or dv) of the plain version. Both compute in f32 from the
    same inputs and differ only in the order of their sums: 2e-5 of the
    largest output (at least 1). A bf16 output adds its own rounding of
    values that differ that little: one bf16 ulp of the element, at most
    2^-7·|want|."""
    w = want.float().abs()
    margin = 2e-5 * max(1.0, w.max().item()) if w.numel() else 0.0
    if want.dtype == torch.bfloat16:
        return w * 2.0 ** -7 + margin
    return torch.full_like(w, margin)


def lse_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel lse − plain lse|: f32 logs of sums taken
    in another order, 1e-5 of max(1, |lse|); an empty row's +1e9 is exact
    on both sides."""
    return 1e-5 * want.abs().clamp(min=1.0)


def tc_kernel_tolerance(want: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |tensor-core kernel − plain version with
    ``operands="bf16"``| for an output ``want`` (o, dq, dk or dv) of that
    plain version, with ``bound`` its entry of ``rounding_bound``. Both
    sides round the same p and dS to bf16 but reach them through f32 sums
    taken in another order (and the kernel's exp through ex2.approx, within
    about 2^-21 of the plain version's), so a value on a rounding boundary
    may round up on one side and down on the other: one bf16 ulp, at most
    2^-7 of the value. If every rounded factor flipped, the output would
    move by 2^-7·bound; add ``kernel_tolerance`` for the f32 order of the sums and
    the rounding of a bf16 output."""
    return 2.0 ** -7 * bound.float() + kernel_tolerance(want)


def rounding_tolerance(want: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |tensor-core route − the TPU's f32 arithmetic|
    (``want`` from the plain version with ``operands="f32"``, ``bound``
    from ``rounding_bound``): rounding to nearest moves each p or dS by at
    most half a bf16 ulp, 2^-8 of itself, so the output by at most
    2^-8·bound; plus ``kernel_tolerance``. The cost of the route, not a
    bound the kernel is held to on the card."""
    return 2.0 ** -8 * bound.float() + kernel_tolerance(want)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import library
        fn = getattr(library("flash_attention"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention_fwd":
            # q k v, dtype, strides, ids cnt max, kind spec table, o lse,
            # b h n d causal scale stream
            fn.argtypes = [p, p, p, i, p, p, p, i, i, p, p, p, p, i, i, i, i, i, f, p]
        else:
            # q k v do, dtype, strides, ids cnt max, kind spec table, lse
            # delta, outputs, b h n d causal scale stream
            fn.argtypes = [p, p, p, p, i, p, p, p, i, i, p, p, p, p, p, p,
                           i, i, i, i, i, f, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_card(t: torch.Tensor, fn: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {t.device}")
    return True


def _check_operands(q, k, v, do=None, *, same_length: bool = True):
    """The q, k, v (and dO) that the flash and chunk kernels take: f32 or
    bf16 (b, h, n, d) of one dtype on one device, dim_head in
    ``DIM_HEADS``, dense along the head dim (strided views along b, h, n
    are fine). k and v have q's length, or any length when not
    ``same_length``. Raises on anything else; returns (b, h, nq, nk, d)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k must be (b, h, n, d), got {tuple(q.shape)}, {tuple(k.shape)}")
    b, h, nq, d = q.shape
    nk = nq if same_length else k.shape[2]
    if d not in DIM_HEADS:
        raise ValueError(f"dim_head {d} must be one of {DIM_HEADS}")
    named = [(k, "k", nk), (v, "v", nk)] + ([] if do is None else [(do, "dout", nq)])
    for t, what, n in [(q, "q", nq)] + named:
        if t.dtype != q.dtype or tuple(t.shape) != (b, h, n, d):
            raise ValueError(f"{what} must be {q.dtype} {(b, h, n, d)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what} must be on {q.device}, not {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what} must be dense along the head dim")
    return b, h, nq, nk, d


def _check_cuda(q, k, v, sched: FlashSchedule, do=None, lse=None, delta=None) -> int:
    """The shapes, types and layouts the kernels take; raises on anything
    else and returns dim_head. q, k, v (and dO) may be strided views (the
    head split of the qkv projection) as long as the head dim is dense."""
    b, h, n, _, d = _check_operands(q, k, v, do)
    if sched.n != n:
        raise ValueError(f"the schedule is for n={sched.n}, not {n}")
    nt = -(-n // TILE)
    for t, rows, what in ((sched.k_ids, nt, "k_ids"), (sched.k_cnt, nt, "k_cnt"),
                          (sched.q_ids, nt, "q_ids"), (sched.q_cnt, nt, "q_cnt")):
        if t.dtype != torch.int32 or t.shape[0] != rows or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"schedule {what} must be contiguous int32 with "
                             f"{rows} rows on {q.device}")
    if sched.kind == MASK_TABLE:
        t = sched.table
        if t is None or t.dtype != torch.int8 or tuple(t.shape) != (n, n) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"the mask table must be contiguous int8 {(n, n)} on {q.device}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if do is not None and (t is None or t.dtype != torch.float32
                               or tuple(t.shape) != (b, h, n) or not t.is_contiguous()
                               or t.device != q.device):
            raise ValueError(f"{what} must be contiguous float32 {(b, h, n)}")
    _check_tc_rows(q, k, v, do)
    return d


def _check_tc_rows(q, k, v, do=None):
    """bf16 operands take the tensor-core route, which copies 16-byte row
    pieces with cp.async: each must start on 16 bytes, with (b, h, n)
    strides that are multiples of 8 elements (every d in ``DIM_HEADS`` is a
    multiple of 16, so a dense tensor, or rows sliced from one, passes).
    Raises on any other; f32 operands need neither."""
    if q.dtype != torch.bfloat16:
        return
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (do, "dout")):
        if t is not None and (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {what} must start on 16 bytes with (b, h, n) "
                             f"strides that are multiples of 8, got strides {t.stride()}")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(*[s for t in ts for s in t.stride()[:3]])


def _sched_args(sched: FlashSchedule, dkv: bool):
    ids, cnt = (sched.q_ids, sched.q_cnt) if dkv else (sched.k_ids, sched.k_cnt)
    return (ids.data_ptr(), cnt.data_ptr(), ids.shape[1], sched.kind,
            (ctypes.c_int * 4)(*sched.spec),
            None if sched.table is None else sched.table.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, sched: FlashSchedule, scale: Optional[float] = None):
    """Forward: (o (b, h, n, d) in q's dtype, lse f32 (b, h, n))."""
    global fwd_launches, tc_fwd_launches
    if not _on_card(q, "flash_attention_fwd"):
        return flash_fwd_plain(q, k, v, sched, scale)
    d = _check_cuda(q, k, v, sched)
    b, h, n, _ = q.shape
    o = torch.empty(b, h, n, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    if b * h * n == 0:
        return o, lse
    rc = _kernel("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODE[q.dtype], _strides(q, k, v),
        *_sched_args(sched, False), o.data_ptr(), lse.data_ptr(), b, h, n, d,
        int(sched.causal), _scale(q, scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel failed to launch: CUDA error {rc}")
    fwd_launches += 1
    tc_fwd_launches += int(q.dtype == torch.bfloat16)
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, sched: FlashSchedule,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq (b, h, n, d) in q's dtype from the saved inputs, the output
    gradient, the forward's lse and delta = rowsum(dO·o), f32 (b, h, n)."""
    global bwd_dq_launches, tc_bwd_dq_launches
    if not _on_card(q, "flash_attention_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, sched, scale)
    d = _check_cuda(q, k, v, sched, do, lse, delta)
    b, h, n, _ = q.shape
    dq = torch.empty(b, h, n, d, dtype=q.dtype, device=q.device)
    if b * h * n == 0:
        return dq
    rc = _kernel("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _DTYPE_CODE[q.dtype],
        _strides(q, k, v, do), *_sched_args(sched, False), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), None, b, h, n, d, int(sched.causal),
        _scale(q, scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq kernel failed to launch: CUDA error {rc}")
    bwd_dq_launches += 1
    tc_bwd_dq_launches += int(q.dtype == torch.bfloat16)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, sched: FlashSchedule,
                            scale: Optional[float] = None):
    """(dk, dv) (b, h, n, d) in q's dtype, as ``flash_attention_bwd_dq``."""
    global bwd_dkv_launches, tc_bwd_dkv_launches
    if not _on_card(q, "flash_attention_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched, scale)
    d = _check_cuda(q, k, v, sched, do, lse, delta)
    b, h, n, _ = q.shape
    dk = torch.empty(b, h, n, d, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if b * h * n == 0:
        return dk, dv
    rc = _kernel("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _DTYPE_CODE[q.dtype],
        _strides(q, k, v, do), *_sched_args(sched, True), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, d, int(sched.causal),
        _scale(q, scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv kernel failed to launch: CUDA error {rc}")
    bwd_dkv_launches += 1
    tc_bwd_dkv_launches += int(q.dtype == torch.bfloat16)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel, and the two backward kernels as its gradient;
    saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, sched, scale):
        o, lse = flash_attention_fwd(q, k, v, sched, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sched, ctx.scale = sched, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.sched, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.sched, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: Optional[np.ndarray] = None, mask_spec=None,
                    causal: bool = True, scale: Optional[float] = None,
                    schedule: Optional[FlashSchedule] = None) -> torch.Tensor:
    """Flash attention over (b, h, n, d) with an optional static (n, n) host
    mask and mask spec, differentiable through the backward kernels. Tiles
    with no visible pair are skipped. ``schedule`` (from ``flash_schedule``)
    stands for mask, mask_spec and causal when the caller keeps one."""
    if schedule is None:
        schedule = flash_schedule(q.shape[2], mask, mask_spec, causal, q.device)
    elif schedule.causal != causal:
        raise ValueError(f"the schedule is causal={schedule.causal}, not {causal}")
    return FlashAttention.apply(q, k, v, schedule, scale)
