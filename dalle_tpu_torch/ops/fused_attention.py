"""Fused-boundary causal attention (K1): the CUDA kernels, their wrappers,
their plain versions and the ``torch.autograd.Function`` that joins them.

Port of ``dalle_tpu/ops/fused_attention.py``: ``fused_qkv_attention`` takes
the qkv projection's own (b, n, 3·h·d) layout, [q_0..q_{h-1} | k_0.. |
v_0..], and returns the merged (b, n, h·d) layout in the operand's dtype;
its backward writes dqkv in the (b, n, 3·h·d) layout. The forward is
``csrc/fused_attention.cu::fused_attention_fwd`` (the Pallas ``_fwd_kernel``),
the backward ``::fused_attention_bwd`` (``_bwd_kernel``), both built at first
use (``_build.py``). On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version, which repeats the
kernel's bf16 roundings step by step. ``fwd_launches`` and ``bwd_launches``
count kernel launches (a backward launch is one call that runs two CUDA
kernels, dq then dk/dv).

The arithmetic is the TPU kernel's: q, k, v and dO round to bf16; q is
scaled in f32 and rounded again; scores and the softmax are f32, hidden
pairs at -1e9; p rounds to bf16 before p·v; every product accumulates in
f32. The forward also returns each row's max m and sum l, f32 (b, h, n),
which the backward uses to recompute p (the Pallas backward recomputes
them from the scores; the two agree to f32 rounding). Every product is
bf16 × bf16 into f32, so the kernels run it on the tensor cores for f32
and bf16 qkv alike; they are held to the plain versions within
``kernel_tolerance``, and a peaked softmax within ``flip_tolerance``.

Visibility: plain causal (``table=None``), or a ``MaskTable`` built from a
static mask or a structured spec as the JAX package's ``validity_table``
does. The port always ANDs causality into the table, because the kernels
visit only the tiles at or below the diagonal; every table the transformer
builds is causal already, so this changes nothing there. Every query must
see itself (true of every mask the transformer builds), so that no row's
softmax is empty.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .attn_masks import build_mask
from .flash_attention import elem_fn_from_spec

NEG_INF = -1e9
TILE = 64            # the kernels' query and key tile
MAX_DIM_HEAD = 128

# launches since the last reset (chip_smoke.py zeroes them around the main
# path to show the path went through the kernels)
fwd_launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def use_spec(mask_spec) -> bool:
    """Structured (axial/conv) specs are built into the table from their
    (qpos, kpos) test; other layers pass their static mask table."""
    return mask_spec is not None and mask_spec[0] in ("axial", "conv")


def validity_table(n: int, mask=None, mask_spec=None) -> np.ndarray:
    """Host-side (n, n) int8 validity (1 = attend), causality ANDed in.
    ``mask`` may be larger than (n, n): its top-left block is used, as the
    Pallas kernel's (n, n) BlockSpec reads it."""
    causal = np.tril(np.ones((n, n), dtype=bool))
    if use_spec(mask_spec):
        ri = np.arange(n)[:, None]
        ci = np.arange(n)[None, :]
        vis = np.asarray(elem_fn_from_spec(mask_spec)(ri, ci), bool)
        return (vis & causal).astype(np.int8)
    if mask is not None:
        return (np.asarray(mask, bool)[:n, :n] & causal).astype(np.int8)
    return causal.astype(np.int8)


@dataclass(frozen=True)
class MaskTable:
    """A layer's visibility on one device: ``table`` (n, n) int8, 1 = the
    query row may attend the key column; ``tiles`` (nt, nt) int8, 1 = the
    64×64 tile holds a visible pair (the kernels skip the others)."""
    table: torch.Tensor
    tiles: torch.Tensor


def mask_table(n: int, mask=None, mask_spec=None, device=None) -> Optional[MaskTable]:
    """The ``MaskTable`` of a static mask / spec at sequence length ``n``;
    None when only causality applies (the kernels test j ≤ i themselves)."""
    if mask is None and not use_spec(mask_spec):
        return None
    tbl = validity_table(n, mask, mask_spec)
    if not tbl.diagonal().all():
        raise ValueError("every query must see itself: the mask hides a "
                         "diagonal position")
    nt = -(-n // TILE)
    padded = np.zeros((nt * TILE, nt * TILE), dtype=bool)
    padded[:n, :n] = tbl != 0
    tiles = padded.reshape(nt, TILE, nt, TILE).any(axis=(1, 3))
    return MaskTable(torch.from_numpy(tbl).to(device),
                     torch.from_numpy(tiles.astype(np.int8)).to(device))


def layer_table(kind: str, n: int, device=None,
                fmap: Optional[int] = None) -> Optional[MaskTable]:
    """The transformer's table for a layer kind ("full", "axial_row",
    "conv_like" or "sparse") at training length n, with the DALL·E layout:
    an ``fmap``×``fmap`` image grid (by default 16×16 when n > 256, else
    4×4) after n + 1 - fmap² text positions (<bos> included). For checks of
    the kernels against their plain versions at the shapes the model gives
    (``fmap=64`` at n = 4,352 is the long-sequence model's)."""
    if kind == "full":
        return None
    if fmap is None:
        fmap = 16 if n > 256 else 4
    text_len = n + 1 - fmap * fmap
    spec = {"axial_row": ("axial", text_len, fmap, 0),
            "conv_like": ("conv", text_len, fmap, 5, 1)}.get(kind)
    mask = build_mask(kind, text_len, fmap, block=128 if n > 256 else 8)
    return mask_table(n, mask, spec, device=device)


def kernel_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain version| for an output ``want``
    of the plain version. Both round the same values to bf16 but sum in
    another order, so a probability on a bf16 rounding boundary can flip:
    one bf16 ulp of p times |v|, within 2e-3 of the largest output (at
    least 1). A bf16 output adds its own rounding of values that differ
    that little: one bf16 ulp of the element, at most 2^-7·|want|."""
    w = want.float().abs()
    margin = 2e-3 * max(1.0, w.max().item()) if w.numel() else 0.0
    if want.dtype == torch.bfloat16:
        return w * 2.0 ** -7 + margin
    return torch.full_like(w, margin)


def rounding_bound(qkv: torch.Tensor, dout: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor, heads: int, table: Optional[MaskTable] = None,
                   scale: Optional[float] = None):
    """Per element of out (b, n, h·d) and dqkv (b, n, 3·h·d), f32: the sums
    of the absolute products whose first factor the kernels round to bf16,
    with (m, l) the forward's. out: Σ_j p·|v|; dv: Σ_i p·|dO|; dq and dk:
    Σ (|ds| + p·E)·|k| and Σ (|ds| + p·E)ᵀ·|q|, times scale, where
    E_i = Σ_d (Σ_j p·|v|)·|dO| carries a rounding of p16 in o through delta
    into ds = p·(dp − delta). Moving every rounded factor by one bf16 ulp
    (at most 2^-7 of itself) moves an output by at most 2^-7 of this."""
    b, n, _ = qkv.shape
    scale = _scale(qkv, heads, scale)
    q, k, v = _split_bf16(qkv, heads)
    vis = _visible(n, table, qkv.device)
    p = torch.where(vis, torch.exp(_scores(q, k, scale, vis) - m[..., None]) / l[..., None], 0.0)
    q, k, v = q.float().abs(), k.float(), v.float()
    do = dout.to(torch.bfloat16).reshape(b, n, heads, -1).float()
    o = torch.einsum("bhij,bjhd->bihd", p.to(torch.bfloat16).float(), v)
    delta = (o * do).sum(dim=-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bihd,bjhd->bhij", do, v)
    pv = torch.einsum("bhij,bjhd->bihd", p, v.abs())
    e = (pv * do.abs()).sum(dim=-1).transpose(1, 2)[..., None]            # (b, h, i, 1)
    w = (p * (dp - delta)).abs() + p * e
    dq = torch.einsum("bhij,bjhd->bihd", w, k.abs()) * scale
    dk = torch.einsum("bhij,bihd->bjhd", w, q) * scale
    dv = torch.einsum("bhij,bihd->bjhd", p, do.abs())
    return pv.reshape(b, n, -1), torch.cat([t.reshape(b, n, -1) for t in (dq, dk, dv)], dim=-1)


def flip_tolerance(want: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain version| for an output ``want``
    of the plain version, with ``bound`` its entry of ``rounding_bound``:
    ``kernel_tolerance`` assumes one flipped p of a few hundredths, but a
    peaked softmax puts p near 1, where one flip costs 2^-8·|v|, more than
    its margin. If every rounded factor flipped, the output would move by
    2^-7·bound; add ``kernel_tolerance`` for the rest."""
    return 2.0 ** -7 * bound.float() + kernel_tolerance(want)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _split_bf16(qkv: torch.Tensor, heads: int):
    """(b, n, 3·h·d) → q, k, v as bf16 (b, n, h, d) views."""
    b, n, hd3 = qkv.shape
    x = qkv.to(torch.bfloat16).reshape(b, n, 3 * heads, hd3 // (3 * heads))
    return x[:, :, :heads], x[:, :, heads:2 * heads], x[:, :, 2 * heads:]


def _visible(n: int, table: Optional[MaskTable], device) -> torch.Tensor:
    if table is None:
        return torch.ones(n, n, dtype=torch.bool, device=device).tril()
    return table.table.to(device) != 0


def _scores(q, k, scale: float, vis) -> torch.Tensor:
    """bf16(f32(q)·scale) · k in f32, -1e9 where hidden → (b, h, i, j)."""
    qs = (q.float() * scale).to(torch.bfloat16)
    s = torch.einsum("bihd,bjhd->bhij", qs.float(), k.float())
    return torch.where(vis, s, NEG_INF)


def _scale(qkv: torch.Tensor, heads: int, scale: Optional[float]) -> float:
    return (qkv.shape[-1] // (3 * heads)) ** -0.5 if scale is None else scale


def fused_attention_fwd_plain(qkv: torch.Tensor, heads: int,
                              table: Optional[MaskTable] = None,
                              scale: Optional[float] = None):
    """The forward kernel's function in plain tensor code → (out, m, l)."""
    b, n, _ = qkv.shape
    scale = _scale(qkv, heads, scale)
    q, k, v = _split_bf16(qkv, heads)
    s = _scores(q, k, scale, _visible(n, table, qkv.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p16 = (e / l).to(torch.bfloat16)
    o = torch.einsum("bhij,bjhd->bihd", p16.float(), v.float())
    return o.reshape(b, n, -1).to(qkv.dtype), m[..., 0], l[..., 0]


def fused_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                              m: torch.Tensor, l: torch.Tensor, heads: int,
                              table: Optional[MaskTable] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The backward kernels' function in plain tensor code → dqkv."""
    b, n, _ = qkv.shape
    scale = _scale(qkv, heads, scale)
    q, k, v = _split_bf16(qkv, heads)
    vis = _visible(n, table, qkv.device)
    s = _scores(q, k, scale, vis)
    p = torch.where(vis, torch.exp(s - m[..., None]) / l[..., None], 0.0)
    p16 = p.to(torch.bfloat16).float()
    do = dout.to(torch.bfloat16).reshape(b, n, heads, -1).float()
    dp = torch.einsum("bihd,bjhd->bhij", do, v.float())
    o = torch.einsum("bhij,bjhd->bihd", p16, v.float())
    delta = (o * do).sum(dim=-1).transpose(1, 2)[..., None]       # (b, h, i, 1)
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    dq = torch.einsum("bhij,bjhd->bihd", ds, k.float()) * scale
    dk = torch.einsum("bhij,bihd->bjhd", ds, q.float()) * scale
    dv = torch.einsum("bhij,bihd->bjhd", p16, do)
    return torch.cat([t.reshape(b, n, -1) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import library
        fn = getattr(library("fused_attention"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "fused_attention_fwd":
            fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        else:
            fn.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_dense(t: torch.Tensor, device, what: str):
    if t.device != device:
        raise ValueError(f"{what} must be on {device}, not {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_cuda(qkv: torch.Tensor, heads: int, table: Optional[MaskTable],
                dout: Optional[torch.Tensor] = None,
                m: Optional[torch.Tensor] = None,
                l: Optional[torch.Tensor] = None) -> int:
    """The shapes and types the kernels take; raises on anything else and
    returns dim_head."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (b, n, 3·h·d), got {tuple(qkv.shape)}")
    b, n, hd3 = qkv.shape
    if heads <= 0 or hd3 % (3 * heads):
        raise ValueError(f"qkv width {hd3} is not 3·{heads}·d")
    d = hd3 // (3 * heads)
    if d % 16 or d > MAX_DIM_HEAD:
        raise ValueError(f"dim_head {d} must be a multiple of 16 and <= "
                         f"{MAX_DIM_HEAD}")
    _check_dense(qkv, qkv.device, "qkv")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    if table is not None:
        nt = -(-n // TILE)
        for t, shape, what in ((table.table, (n, n), "mask table"),
                               (table.tiles, (nt, nt), "tile map")):
            if t.dtype != torch.int8 or tuple(t.shape) != shape:
                raise ValueError(f"{what} must be int8 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            _check_dense(t, qkv.device, what)
    if dout is not None:
        if dout.dtype != qkv.dtype or tuple(dout.shape) != (b, n, hd3 // 3):
            raise ValueError(f"dout must be {qkv.dtype} {(b, n, hd3 // 3)}, got "
                             f"{dout.dtype} {tuple(dout.shape)}")
        _check_dense(dout, qkv.device, "dout")
        if dout.data_ptr() % 16:
            raise ValueError("dout must be 16-byte aligned")
        for t, what in ((m, "row max"), (l, "row sum")):
            if t is None or t.dtype != torch.float32 or tuple(t.shape) != (b, heads, n):
                raise ValueError(f"{what} must be float32 {(b, heads, n)}")
            _check_dense(t, qkv.device, what)
    return d


def _ptrs(table: Optional[MaskTable]):
    if table is None:
        return None, None
    return table.table.data_ptr(), table.tiles.data_ptr()


def _on_card(t: torch.Tensor, fn: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {t.device}")
    return True


def fused_attention_fwd(qkv: torch.Tensor, heads: int,
                        table: Optional[MaskTable] = None,
                        scale: Optional[float] = None):
    """Forward: (b, n, 3·h·d) → (out (b, n, h·d) in qkv's dtype, m, l f32
    (b, h, n))."""
    global fwd_launches
    if not _on_card(qkv, "fused_attention_fwd"):
        return fused_attention_fwd_plain(qkv, heads, table, scale)
    d = _check_cuda(qkv, heads, table)
    b, n, hd3 = qkv.shape
    out = torch.empty(b, n, hd3 // 3, dtype=qkv.dtype, device=qkv.device)
    m = torch.empty(b, heads, n, dtype=torch.float32, device=qkv.device)
    l = torch.empty_like(m)
    if b * n == 0:
        return out, m, l
    tptr, tiles = _ptrs(table)
    rc = _kernel("fused_attention_fwd")(
        qkv.data_ptr(), _DTYPE_CODE[qkv.dtype], tptr, tiles, out.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, n, heads, d, float(_scale(qkv, heads, scale)),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention_fwd kernel failed to launch: CUDA error {rc}")
    fwd_launches += 1
    return out, m, l


def fused_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                        m: torch.Tensor, l: torch.Tensor, heads: int,
                        table: Optional[MaskTable] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Backward: dqkv (b, n, 3·h·d) in qkv's dtype from the saved qkv, the
    output gradient and the forward's (m, l)."""
    global bwd_launches
    if not _on_card(qkv, "fused_attention_bwd"):
        return fused_attention_bwd_plain(qkv, dout, m, l, heads, table, scale)
    d = _check_cuda(qkv, heads, table, dout, m, l)
    b, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    if b * n == 0:
        return dqkv
    delta = torch.empty_like(m)
    tptr, tiles = _ptrs(table)
    rc = _kernel("fused_attention_bwd")(
        qkv.data_ptr(), dout.data_ptr(), _DTYPE_CODE[qkv.dtype], tptr, tiles,
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, n,
        heads, d, float(_scale(qkv, heads, scale)),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention_bwd kernel failed to launch: CUDA error {rc}")
    bwd_launches += 1
    return dqkv


class FusedQKVAttention(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient; saves qkv
    and the per-row (m, l)."""

    @staticmethod
    def forward(ctx, qkv, heads, table, scale):
        out, m, l = fused_attention_fwd(qkv, heads, table, scale)
        ctx.save_for_backward(qkv, m, l)
        ctx.heads, ctx.table, ctx.scale = heads, table, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, m, l = ctx.saved_tensors
        dqkv = fused_attention_bwd(qkv, dout.contiguous(), m, l, ctx.heads,
                                   ctx.table, ctx.scale)
        return dqkv, None, None, None


def fused_qkv_attention(qkv: torch.Tensor, heads: int,
                        table: Optional[MaskTable] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Causal multi-head attention straight off the qkv projection:
    (b, n, 3·h·d) → (b, n, h·d), differentiable through the backward
    kernel. ``table`` None is plain causal."""
    return FusedQKVAttention.apply(qkv, heads, table, scale)
