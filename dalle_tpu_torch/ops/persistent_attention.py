"""Whole-sequence causal attention (K8): the CUDA kernels' wrappers, their
plain versions and the ``torch.autograd.Function`` that joins them.

Port of ``dalle_tpu/ops/persistent_attention.py``: ``persistent_attention``
over (b, h, n, d) with optional visibility: an int8 (n, n) table (1 = the
query row may attend the key column, causality already in it) or a
``fused_attention.MaskTable`` (the table with its tile map, as the
transformer builds and keeps it); None means plain causal. The forward is
``csrc/persistent_attention.cu::persist_fwd`` (the Pallas ``_fwd_kernel``),
the backward ``::persist_bwd`` (``_bwd_kernel``: a dq kernel over q tiles,
then a dk/dv kernel over k tiles), both built at first use (``_build.py``).
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version, which repeats the TPU kernel's roundings step by
step. ``fwd_launches`` and ``bwd_launches`` count kernel launches (a
backward launch is one call that runs the two CUDA kernels).

The arithmetic is the TPU kernel's: q, k, v (and dO) are cast to bf16
first; qs = bf16(f32(q16)·scale); s = qs·kᵀ in f32, -1e9 where hidden; the
softmax is exact, not online: p = exp(s - m) / l over the whole row, and
p16 = bf16(p) multiplies v. The backward recomputes s and p; delta is
Σ o·dO with o = p16·v recomputed in f32 (not the forward's output, which may
be bf16); ds = bf16(p·(dp - delta)), dq = ds·k·scale, dk = dsᵀ·q16·scale
with the unscaled bf16 q, dv = p16ᵀ·bf16(dO). Outputs are in q's dtype. A
row that sees nothing has every score at -1e9, so the TPU kernel's softmax
spreads it evenly over all n keys (p = 1/n); the kernels do the same.

The kernels walk 64×64 tiles: a tile map says which hold a visible pair,
and one flag per q tile says that it holds a row that sees nothing (that
q tile then visits every k tile). A ``MaskTable`` brings its map, and its
table lets every query see itself (``mask_table`` checks it), so it needs
no flags; a raw table gets both from ``tile_map``, a few tensor ops per
call. The forward also writes each row's max and sum (m, l), f32
(b, h, n), which ``PersistentAttention`` saves with q, k and v: the
Pallas backward recomputes them from the scores, and the kernels' pass 1
gives the same bits. ``persist_bwd`` called without them runs the
forward's first pass for them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from .flash_attention import _on_card, _stream, _strides
from .fused_attention import TILE, MaskTable, fused_attention_fwd_plain
from .fused_attention import rounding_bound as _merged_rounding_bound

NEG_INF = -1e9
MAX_DIM_HEAD = 128
# the TPU kernel's routing budget: ~3 live (n, n) f32 tiles + operands within
# 8 MB of scoped VMEM (verbatim from the JAX package: the transformer routes
# by it, so it decides which layers take this arithmetic and which go dense)
_VMEM_BUDGET = 8 * 1024 * 1024

# launches since the last reset (chip_smoke.py zeroes them around the main
# path to show the path went through the kernels)
fwd_launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}

Table = Union[None, torch.Tensor, MaskTable]


def persistent_fits(n: int, d: int, itemsize: int = 2) -> bool:
    return 3 * n * n * 4 + 6 * n * d * itemsize <= _VMEM_BUDGET


def _dense(table: Table) -> Optional[torch.Tensor]:
    return table.table if isinstance(table, MaskTable) else table


def tile_map(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tiles, empty) of a dense (n, n) int8 table, on its device: tiles
    (nt, nt) int8, 1 = the 64×64 tile holds a visible pair; empty (nt,) int8,
    1 = the q tile holds a row that sees nothing."""
    n = table.shape[0]
    nt = -(-n // TILE)
    vis = torch.zeros(nt * TILE, nt * TILE, dtype=torch.bool, device=table.device)
    vis[:n, :n] = table != 0
    tiles = vis.view(nt, TILE, nt, TILE).any(dim=3).any(dim=1)
    blind = torch.zeros(nt * TILE, dtype=torch.bool, device=table.device)
    blind[:n] = ~vis[:n].any(dim=1)
    return tiles.to(torch.int8), blind.view(nt, TILE).any(dim=1).to(torch.int8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _probs(q16, k16, table, scale: float) -> torch.Tensor:
    """p = softmax of bf16(f32(q16)·scale)·k16ᵀ, -1e9 where hidden, f32
    (b, h, n, n)."""
    n = q16.shape[2]
    qs = (q16.float() * scale).to(torch.bfloat16)
    s = torch.einsum("bhid,bhjd->bhij", qs.float(), k16.float())
    if table is None:
        vis = torch.ones(n, n, dtype=torch.bool, device=q16.device).tril()
    else:
        vis = _dense(table).to(q16.device) != 0
    s = torch.where(vis, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def persist_fwd_plain(q, k, v, table: Table = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel's function in plain tensor code → o in q's dtype."""
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    p16 = _probs(q16, k16, table, _scale(q, scale)).to(torch.bfloat16)
    o = torch.einsum("bhij,bhjd->bhid", p16.float(), v16.float())
    return o.to(q.dtype)


def persist_bwd_plain(q, k, v, do, table: Table = None,
                      scale: Optional[float] = None):
    """The backward kernels' function in plain tensor code → (dq, dk, dv)."""
    scale = _scale(q, scale)
    q16, k16, v16 = (t.to(torch.bfloat16).float() for t in (q, k, v))
    do16 = do.to(torch.bfloat16).float()
    p = _probs(q16, k16, table, scale)
    p16 = p.to(torch.bfloat16).float()
    dp = torch.einsum("bhid,bhjd->bhij", do16, v16)
    o = torch.einsum("bhij,bhjd->bhid", p16, v16)
    delta = (o * do16).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    dq = torch.einsum("bhij,bhjd->bhid", ds, k16) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q16) * scale
    dv = torch.einsum("bhij,bhid->bhjd", p16, do16)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def rounding_bound(q, k, v, do, table: Optional[MaskTable] = None,
                   scale: Optional[float] = None):
    """``fused_attention.rounding_bound`` over K8's layout: per element of o,
    dq, dk, dv (b, h, n, d) f32, the sums of absolute products whose first
    factor the kernels round to bf16 (K1's arithmetic is K8's), for
    ``fused_attention.flip_tolerance``. A row that sees nothing gets no
    slack: its p, 1/n, is the same in every summation order."""
    b, h, n, d = q.shape
    qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * d) for t in (q, k, v)], dim=-1)
    dout = do.transpose(1, 2).reshape(b, n, h * d)
    _, m, l = fused_attention_fwd_plain(qkv, h, table, scale)
    out, dqkv = _merged_rounding_bound(qkv, dout, m, l, h, table, scale)
    split = (out,) + dqkv.chunk(3, dim=-1)
    return tuple(t.reshape(b, n, h, d).transpose(1, 2) for t in split)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import library
        fn = getattr(library("persistent_attention"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "persist_fwd":
            # q k v, strides, table tiles empty, out m l, out dtype, b h n d,
            # scale, stream
            fn.argtypes = [p] * 10 + [i] * 5 + [f, p]
        else:
            # q k v do, strides, table tiles empty, m l delta, dq dk dv,
            # out dtype, b h n d, scale, stream
            fn.argtypes = [p] * 14 + [i] * 5 + [f, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_int8(t: torch.Tensor, shape, device, what: str):
    if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{what} must be contiguous int8 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_cuda(q, k, v, table: Table, do=None, stats=None) -> int:
    """The shapes and types the kernels take; raises on anything else and
    returns dim_head. The operands may be strided views, as long as the
    head dim is dense (the wrapper casts them to bf16 and aligns them)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (b, h, n, d), got {tuple(q.shape)}")
    b, h, n, d = q.shape
    if d % 16 or not 0 < d <= MAX_DIM_HEAD:
        raise ValueError(f"dim_head {d} must be a multiple of 16 and <= {MAX_DIM_HEAD}")
    named = [(k, "k"), (v, "v")] + ([] if do is None else [(do, "dout")])
    for t, what in [(q, "q")] + named:
        if t.dtype not in _DTYPE_CODE or tuple(t.shape) != (b, h, n, d):
            raise ValueError(f"{what} must be float32 or bfloat16 {(b, h, n, d)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what} must be on {q.device}, not {t.device}")
    if table is not None:
        _check_int8(_dense(table), (n, n), q.device, "the table")
    if isinstance(table, MaskTable):
        nt = -(-n // TILE)
        _check_int8(table.tiles, (nt, nt), q.device, "the tile map")
    for t, what in zip(stats or (), ("row max", "row sum")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, n) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"the {what} must be contiguous float32 {(b, h, n)} on {q.device}")
    return d


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """The kernels read bf16 rows with 16-byte loads at 32-bit offsets
    inside a tile: cast (as the TPU wrapper does) and copy only a layout
    they cannot read."""
    t = t.to(torch.bfloat16)
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.stride(2) >= 2 ** 25
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _visibility(table: Table):
    """The kernels' (table, tile map, empty-row flags), each int8 or None."""
    if table is None:
        return None, None, None
    if isinstance(table, MaskTable):
        return table.table, table.tiles, None
    return (table, *tile_map(table))


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _launch_fwd(ops, vis, out, m, l, q, scale: float):
    """``persist_fwd``'s kernel on bf16 operands ``ops``; ``out`` None
    stops after the first pass: the row statistics alone."""
    b, h, n, d = q.shape
    rc = _kernel("persist_fwd")(
        *_ptrs(*ops), _strides(*ops), *_ptrs(*vis, out, m, l),
        _DTYPE_CODE[q.dtype], b, h, n, d, scale, _stream(q))
    if rc != 0:
        raise RuntimeError(f"persist_fwd kernel failed to launch: CUDA error {rc}")


def persist_fwd(q, k, v, table: Table = None, scale: Optional[float] = None,
                return_stats: bool = False):
    """Forward: o (b, h, n, d) in q's dtype; with ``return_stats``, (o,
    (m, l)), each row's max and sum f32 (b, h, n) for ``persist_bwd`` (None
    on the CPU, whose backward recomputes them)."""
    global fwd_launches
    if not _on_card(q, "persist_fwd"):
        out = persist_fwd_plain(q, k, v, table, scale)
        return (out, None) if return_stats else out
    d = _check_cuda(q, k, v, table)
    b, h, n, _ = q.shape
    out = torch.empty(b, h, n, d, dtype=q.dtype, device=q.device)
    stats = tuple(torch.empty(b, h, n, dtype=torch.float32, device=q.device) for _ in range(2))
    if b * h * n:
        _launch_fwd([_bf16(t) for t in (q, k, v)], _visibility(table), out, *stats, q,
                    _scale(q, scale))
        fwd_launches += 1
    return (out, stats) if return_stats else out


def persist_bwd(q, k, v, do, table: Table = None, scale: Optional[float] = None,
                stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Backward: (dq, dk, dv) (b, h, n, d) in q's dtype from the saved
    inputs, the output gradient and the forward's (m, l) (without them, the
    forward kernel's first pass computes them first)."""
    global bwd_launches
    if not _on_card(q, "persist_bwd"):
        return persist_bwd_plain(q, k, v, do, table, scale)
    d = _check_cuda(q, k, v, table, do, stats)
    b, h, n, _ = q.shape
    grads = [torch.empty(b, h, n, d, dtype=q.dtype, device=q.device) for _ in range(3)]
    if b * h * n == 0:
        return tuple(grads)
    ops = [_bf16(t) for t in (q, k, v, do)]
    vis, scale = _visibility(table), _scale(q, scale)
    if stats is None:
        stats = tuple(torch.empty(b, h, n, dtype=torch.float32, device=q.device)
                      for _ in range(2))
        _launch_fwd(ops[:3], vis, None, *stats, q, scale)
    delta = torch.empty_like(stats[0])
    rc = _kernel("persist_bwd")(
        *_ptrs(*ops), _strides(*ops), *_ptrs(*vis, *stats, delta, *grads),
        _DTYPE_CODE[q.dtype], b, h, n, d, scale, _stream(q))
    if rc != 0:
        raise RuntimeError(f"persist_bwd kernel failed to launch: CUDA error {rc}")
    bwd_launches += 1
    return tuple(grads)


class PersistentAttention(torch.autograd.Function):
    """Forward kernel, and the backward kernels as its gradient; saves q, k,
    v and, on the card, the forward's (m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, table, scale):
        out, stats = persist_fwd(q, k, v, table, scale, return_stats=True)
        ctx.save_for_backward(q, k, v, *(stats or ()))
        ctx.table, ctx.scale = table, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, *stats = ctx.saved_tensors
        dq, dk, dv = persist_bwd(q, k, v, do, ctx.table, ctx.scale, tuple(stats) or None)
        return dq, dk, dv, None, None


def persistent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         table: Table = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Causal whole-sequence attention over (b, h, n, d), differentiable
    through the backward kernels. ``table`` is an optional int8 (n, n)
    visibility table with causality in it, or a ``MaskTable`` (None = plain
    causal)."""
    return PersistentAttention.apply(q, k, v, table, scale)
