"""Flash attention over one (q-chunk, k-chunk) pair at global offsets (K6):
the ring-attention inner step. The CUDA kernels' wrappers, their plain
versions, ``pick_block`` and ``merge_chunk``.

Port of ``dalle_tpu/ops/chunk_attention.py``. A pair is a q chunk
(b, h, cq, d) whose row i sits at global position ``q_off + i`` and a k/v
chunk (b, h, ck, d) whose column j sits at ``k_off + j``. A pair is visible
when the key is before ``n_valid`` (the unpadded length), not after the
query when causal, and passes the structured element test of an axial or
conv spec on the global positions. Query rows are not cut by ``n_valid``:
the ring computes its padded rows and slices them off.

* ``chunk_flash_fwd`` → (o, lse), both f32: the online softmax over the
  pair; an empty row gets o = 0 and lse = -1e9, so ``merge_chunk`` (an
  exact logaddexp merge) weights it 0.
* ``chunk_flash_dq`` → the pair's f32 dq, recomputed from q, k, v, dO, the
  final lse and delta = rowsum(dO·o).
* ``chunk_flash_dkv`` → the held k chunk's f32 (dk, dv) from the q chunk.

The kernels are ``csrc/chunk_attention.cu::chunk_attention_fwd``, ``_dq``
and ``_dkv``, built at first use (``_build.py``). The offsets and
``n_valid`` are runtime arguments: one build serves every ring step, and
the kernels bound the tiles they visit themselves (the TPU kernels'
``_hi_blocks`` and ``lo``), with no host block lists. On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version. ``fwd_launches``, ``dq_launches`` and ``dkv_launches`` count
kernel launches, and ``tc_fwd_launches``, ``tc_dq_launches`` and
``tc_dkv_launches`` those of them that took the tensor-core route.

The kernels have two routes, chosen by the operands' dtype, as K4's do.
f32 operands keep the TPU kernels' arithmetic: q, k, v (and dO) cast to
f32, q scaled, scores, p and every product f32; a hidden pair scores -1e9,
and the forward forces its p to 0 (s <= -5e8). The plain versions'
default, ``operands="f32"``, computes that function over the whole pair at
once (its exact row max rather than the running one: the sums in another
order, within ``kernel_tolerance``); the CPU path takes it. bf16 operands
run on the tensor cores (``tc_*_kernel``, K4's design) with K4's
bf16 arithmetic: s = (q·kᵀ)·scale in f32, the forward walks the pair's
64-key tiles in order with a running max and rounds p to bf16 before p·v
(l sums the unrounded p), and the backward rounds p and dS to bf16 before
the second products. ``operands="bf16"`` computes exactly that; the kernels
are held to it within ``tc_kernel_tolerance`` (2^-7 of ``rounding_bound``,
one bf16 ulp of every rounded factor, plus ``kernel_tolerance``), and the
route costs at most ``rounding_tolerance`` (2^-8 of the bound) against the
f32 arithmetic; lse stays within ``lse_tolerance`` of either. A bf16
operand needs 16-byte aligned rows, else the wrapper raises. The TPU's tile
(``block``, from ``pick_block``) does not carry over: the kernels tile by
64 rows and mask a chunk's ragged edge themselves; ``pick_block`` stays
the ring's rule for which chunks take the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .flash_attention import (MASK_AXIAL_COL, MASK_AXIAL_ROW, MASK_CONV, MASK_NONE, TILE,
                              _check_operands, _check_tc_rows, _on_card, _rounder, _stream,
                              _strides, elem_fn_from_spec)

NEG_INF = -1e9

# launches since the last reset (chip_smoke.py zeroes them around the main
# path to show the path went through the kernels)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
# the share of those that took the tensor-core route (bf16 operands)
tc_fwd_launches = 0
tc_dq_launches = 0
tc_dkv_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def pick_block(n: int, cap: int = 256) -> Optional[int]:
    """Largest power-of-two divisor of ``n`` up to ``cap``; None if no tiling
    ≥ 8 exists (the ring takes its dense body for such chunks)."""
    b = 1
    while b * 2 <= min(n, cap) and n % (b * 2) == 0:
        b *= 2
    return b if b >= 8 else None


def merge_chunk(o, lse, o_t, lse_t):
    """Online logaddexp merge of per-chunk flash results: the exact
    streaming softmax combination. Empty contributions (lse = -1e9) get
    weight 0."""
    lse_new = torch.logaddexp(lse, lse_t)
    w1 = torch.exp(lse - lse_new)[..., None]
    w2 = torch.exp(lse_t - lse_new)[..., None]
    return o * w1 + o_t * w2, lse_new


def _check_spec(mask_spec):
    if mask_spec is not None and mask_spec[0] not in ("axial", "conv"):
        raise ValueError(f"the chunk kernels take axial or conv specs only, got {mask_spec!r}")


def chunk_visible(cq: int, ck: int, q_off: int, k_off: int, *, n_valid: int,
                  causal: bool = True, mask_spec=None, device=None) -> torch.Tensor:
    """The pair's (cq, ck) bool visibility on global positions."""
    _check_spec(mask_spec)
    qpos = (q_off + torch.arange(cq, device=device))[:, None]
    kpos = (k_off + torch.arange(ck, device=device))[None, :]
    vis = (kpos < n_valid).expand(cq, ck)
    if causal:
        vis = vis & (kpos <= qpos)
    elem = elem_fn_from_spec(mask_spec)
    if elem is not None:
        vis = vis & elem(qpos, kpos)
    return vis


def _scores(q, k, vis, scale):
    s = torch.einsum("bhid,bhjd->bhij", q.float() * scale, k.float())
    return torch.where(vis, s, NEG_INF)


# ---------------------------------------------------------------------------
# plain versions (the kernels' functions in tensor code)
# ---------------------------------------------------------------------------

def chunk_flash_fwd_plain(q, k, v, q_off: int, k_off: int, *, scale: float,
                          n_valid: int, causal: bool = True, mask_spec=None,
                          operands: str = "f32"):
    """The forward kernel's function → (o f32 (b, h, cq, d), lse f32
    (b, h, cq)); an empty row gets o = 0 and lse = -1e9. ``operands`` "f32"
    is the TPU's arithmetic (the f32 route), over the whole pair at once;
    "bf16" the tensor-core route's: s = (q·k)·scale, the 64-key tiles in
    order with a running max m, and p = exp(s - m) rounded to bf16 before
    p·v (l sums the unrounded p). A tile past the kernel's last visited one
    is hidden for every row, so walking it changes nothing."""
    rnd = _rounder(operands)
    vis = chunk_visible(q.shape[2], k.shape[2], q_off, k_off, n_valid=n_valid,
                        causal=causal, mask_spec=mask_spec, device=q.device)
    if operands == "f32":
        s = _scores(q, k, vis, scale)
        m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhij,bhjd->bhid", p, v.float())
    else:
        qb, kb, vb = (rnd(x.float()) for x in (q, k, v))
        s_all = torch.where(vis, torch.einsum("bhid,bhjd->bhij", qb, kb) * scale, NEG_INF)
        m = torch.full((*q.shape[:3], 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, device=q.device)
        for j0 in range(0, k.shape[2], TILE):
            s = s_all[..., j0:j0 + TILE]
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhij,bhjd->bhid", rnd(p), vb[:, :, j0:j0 + TILE])
            m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return acc / safe_l, lse[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, vis, scale, operands):
    """(p, dS, the f32 operands q, k, dO): for "bf16" the operands rounded
    to bf16 and s = (q·k)·scale."""
    if operands == "f32":
        p = torch.exp(_scores(q, k, vis, scale) - lse[..., None])
        dp = torch.einsum("bhid,bhjd->bhij", do.float(), v.float())
        return p, p * (dp - delta[..., None]), (q.float() * scale, k.float(), do.float())
    rnd = _rounder(operands)
    qb, kb, vb, dob = (rnd(x.float()) for x in (q, k, v, do))
    s = torch.where(vis, torch.einsum("bhid,bhjd->bhij", qb, kb) * scale, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhid,bhjd->bhij", dob, vb)
    return p, p * (dp - delta[..., None]), (qb, kb, dob)


def chunk_flash_dq_plain(q, k, v, do, lse, delta, q_off: int, k_off: int, *,
                         scale: float, n_valid: int, causal: bool = True,
                         mask_spec=None, operands: str = "f32") -> torch.Tensor:
    """The dq kernel's function: p = exp(s - lse), dS = p·(dP - delta),
    dq = scale · dS·k, f32 (b, h, cq, d); with ``operands="bf16"``
    s = (q·k)·scale and dS is rounded to bf16 before dS·k."""
    rnd = _rounder(operands)
    vis = chunk_visible(q.shape[2], k.shape[2], q_off, k_off, n_valid=n_valid,
                        causal=causal, mask_spec=mask_spec, device=q.device)
    _, ds, (_, kf, _) = _probs_and_ds(q, k, v, do, lse, delta, vis, scale, operands)
    return torch.einsum("bhij,bhjd->bhid", rnd(ds), kf) * scale


def chunk_flash_dkv_plain(q, k, v, do, lse, delta, q_off: int, k_off: int, *,
                          scale: float, n_valid: int, causal: bool = True,
                          mask_spec=None, operands: str = "f32"):
    """The dk/dv kernel's function: dv = pᵀ·dO, dk = dSᵀ·(scale·q), f32
    (b, h, ck, d) each; with ``operands="bf16"`` s = (q·k)·scale, p and dS
    rounded to bf16 before pᵀ·dO and dSᵀ·q, and dk = scale · dSᵀ·q."""
    rnd = _rounder(operands)
    vis = chunk_visible(q.shape[2], k.shape[2], q_off, k_off, n_valid=n_valid,
                        causal=causal, mask_spec=mask_spec, device=q.device)
    p, ds, (qf, _, dof) = _probs_and_ds(q, k, v, do, lse, delta, vis, scale, operands)
    dv = torch.einsum("bhij,bhid->bhjd", rnd(p), dof)
    dk = torch.einsum("bhij,bhid->bhjd", rnd(ds), qf)
    return (dk, dv) if operands == "f32" else (dk * scale, dv)


def rounding_bound(q, k, v, do, lse, delta, q_off: int, k_off: int, *, scale: float,
                   n_valid: int, causal: bool = True, mask_spec=None) -> dict:
    """Per element of o, dq (f32 (b, h, cq, d)), dk and dv (f32
    (b, h, ck, d)), the sum of the absolute products whose first factor the
    tensor-core route rounds to bf16: Σ|P|·|v| for o, scale·Σ|dS|·|k| for
    dq, scale·Σ|dS|ᵀ·|q| for dk and Σ|P|ᵀ·|dO| for dv, over the visible
    pairs, with P = exp(s - lse). Given the pair's own lse, P = p / l of the
    pair, the weights o is made of. Rounding to nearest moves each factor by
    at most 2^-8 of itself, so 2^-8 of this bounds what the rounding changes
    in the f32 sum; ``rounding_tolerance`` and ``tc_kernel_tolerance`` are
    built on it."""
    vis = chunk_visible(q.shape[2], k.shape[2], q_off, k_off, n_valid=n_valid,
                        causal=causal, mask_spec=mask_spec, device=q.device)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bhid,bhjd->bhij", qf, kf) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhid,bhjd->bhij", dof, vf)
    ds = (p * (dp - delta[..., None])).abs()
    return dict(o=torch.einsum("bhij,bhjd->bhid", p, vf.abs()),
                dq=torch.einsum("bhij,bhjd->bhid", ds, kf.abs()) * scale,
                dk=torch.einsum("bhij,bhid->bhjd", ds, qf.abs()) * scale,
                dv=torch.einsum("bhij,bhid->bhjd", p, dof.abs()))


def kernel_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain version| for an f32 output
    ``want`` (o, dq, dk or dv): both compute in f32 from the same inputs and
    differ only in the order of their sums (the kernel's online softmax
    over 64-key tiles, the plain version's whole-row max): 2e-5 of the
    largest output, at least 2e-5."""
    w = want.float().abs()
    margin = 2e-5 * max(1.0, w.max().item()) if w.numel() else 0.0
    return torch.full_like(w, margin)


def lse_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel lse − plain lse|: f32 logs of sums taken
    in another order, 1e-5 of max(1, |lse|); an empty row's -1e9 is exact
    on both sides."""
    return 1e-5 * want.abs().clamp(min=1.0)


def tc_kernel_tolerance(want: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |tensor-core kernel − plain version with
    ``operands="bf16"``| for an output ``want`` (o, dq, dk or dv) of that
    plain version, ``bound`` its entry of ``rounding_bound``. Both sides
    round the same p and dS to bf16 but reach them through f32 sums taken
    in another order (and the kernel's exp through ex2.approx), so a value
    on a rounding boundary may round up on one side and down on the other:
    one bf16 ulp, at most 2^-7 of the value. If every rounded factor
    flipped, the output would move by 2^-7·bound; add ``kernel_tolerance``
    for the f32 order of the sums."""
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
        fn = getattr(library("chunk_attention"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "chunk_attention_fwd":
            # q k v, dtype, strides, q_off k_off n_valid causal kind spec,
            # o lse, b h cq ck d scale stream
            fn.argtypes = [p, p, p, i, p, i, i, i, i, i, p, p, p, i, i, i, i, i, f, p]
        else:
            # q k v do, dtype, strides, lse delta stat_strides, q_off k_off
            # n_valid causal kind spec, outputs, b h cq ck d scale stream
            fn.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, p, p, p,
                           i, i, i, i, i, f, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _spec_args(mask_spec):
    """(kind, 4 ints) of a spec for the kernels."""
    _check_spec(mask_spec)
    if mask_spec is None:
        return MASK_NONE, (ctypes.c_int * 4)(0, 0, 0, 0)
    if mask_spec[0] == "axial":
        _, text_len, fmap, axis = mask_spec
        kind = MASK_AXIAL_ROW if axis == 0 else MASK_AXIAL_COL
        return kind, (ctypes.c_int * 4)(int(text_len), int(fmap), 0, 0)
    _, text_len, fmap, kernel, dil = mask_spec
    return MASK_CONV, (ctypes.c_int * 4)(int(text_len), int(fmap), int(kernel), int(dil))


def _check_cuda(q, k, v, do=None, lse=None, delta=None) -> int:
    """The shapes, types and layouts the kernels take; raises on anything
    else and returns dim_head. q, k, v (and dO) as ``_check_operands``
    with chunks of two lengths: f32 or bf16 of one dtype, dim_head in
    ``flash_attention.DIM_HEADS`` (16, 32, 64, 128), dense along it. bf16
    operands go to the tensor cores, whose cp.async copies move 16-byte row
    pieces: each must start on 16 bytes with (b, h, n) strides that are
    multiples of 8 elements, or this raises rather than take another route
    (``_check_tc_rows``; the ring's zigzag sub-chunks and row slices lie at
    row offsets × d and pass). lse and delta may be strided along (b, h) as
    long as they are dense along the chunk."""
    b, h, cq, _, d = _check_operands(q, k, v, do, same_length=False)
    if do is not None:
        for t, what in ((lse, "lse"), (delta, "delta")):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, h, cq) \
                    or t.stride(-1) != 1 or t.device != q.device:
                raise ValueError(f"{what} must be float32 {(b, h, cq)} on {q.device}, "
                                 "dense along the chunk")
    _check_tc_rows(q, k, v, do)
    return d


def _stat_strides(lse, delta) -> ctypes.Array:
    return (ctypes.c_longlong * 4)(*lse.stride()[:2], *delta.stride()[:2])


def _launch_error(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {rc}")


def chunk_flash_fwd(q, k, v, q_off: int, k_off: int, *, scale: float, n_valid: int,
                    causal: bool = True, mask_spec=None):
    """Flash forward over one pair → (o f32 (b, h, cq, d), lse f32
    (b, h, cq)); empty rows get o = 0 and lse = -1e9."""
    global fwd_launches, tc_fwd_launches
    kw = dict(scale=scale, n_valid=n_valid, causal=causal, mask_spec=mask_spec)
    if not _on_card(q, "chunk_flash_fwd"):
        return chunk_flash_fwd_plain(q, k, v, q_off, k_off, **kw)
    d = _check_cuda(q, k, v)
    b, h, cq, _ = q.shape
    ck = k.shape[2]
    o = torch.empty(b, h, cq, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, h, cq, dtype=torch.float32, device=q.device)
    if b * h * cq == 0:
        return o, lse
    kind, spec = _spec_args(mask_spec)
    _launch_error("chunk_flash_fwd", _kernel("chunk_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODE[q.dtype], _strides(q, k, v),
        int(q_off), int(k_off), int(n_valid), int(causal), kind, spec, o.data_ptr(),
        lse.data_ptr(), b, h, cq, ck, d, float(scale), _stream(q)))
    fwd_launches += 1
    tc_fwd_launches += int(q.dtype == torch.bfloat16)
    return o, lse


def chunk_flash_dq(q, k, v, do, lse, delta, q_off: int, k_off: int, *, scale: float,
                   n_valid: int, causal: bool = True, mask_spec=None) -> torch.Tensor:
    """The pair's dq, f32 (b, h, cq, d). ``lse`` and ``delta``: f32
    (b, h, cq), the final (merged) lse with empty rows at +1e9."""
    global dq_launches, tc_dq_launches
    kw = dict(scale=scale, n_valid=n_valid, causal=causal, mask_spec=mask_spec)
    if not _on_card(q, "chunk_flash_dq"):
        return chunk_flash_dq_plain(q, k, v, do, lse, delta, q_off, k_off, **kw)
    d = _check_cuda(q, k, v, do, lse, delta)
    b, h, cq, _ = q.shape
    ck = k.shape[2]
    dq = torch.empty(b, h, cq, d, dtype=torch.float32, device=q.device)
    if b * h * cq == 0:
        return dq
    if ck == 0:
        return dq.zero_()
    kind, spec = _spec_args(mask_spec)
    _launch_error("chunk_flash_dq", _kernel("chunk_attention_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _DTYPE_CODE[q.dtype],
        _strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(), _stat_strides(lse, delta),
        int(q_off), int(k_off), int(n_valid), int(causal), kind, spec, dq.data_ptr(), None,
        b, h, cq, ck, d, float(scale), _stream(q)))
    dq_launches += 1
    tc_dq_launches += int(q.dtype == torch.bfloat16)
    return dq


def chunk_flash_dkv(q, k, v, do, lse, delta, q_off: int, k_off: int, *, scale: float,
                    n_valid: int, causal: bool = True, mask_spec=None):
    """The held k chunk's (dk, dv), f32 (b, h, ck, d) each, from the q
    chunk; arguments as ``chunk_flash_dq``."""
    global dkv_launches, tc_dkv_launches
    kw = dict(scale=scale, n_valid=n_valid, causal=causal, mask_spec=mask_spec)
    if not _on_card(q, "chunk_flash_dkv"):
        return chunk_flash_dkv_plain(q, k, v, do, lse, delta, q_off, k_off, **kw)
    d = _check_cuda(q, k, v, do, lse, delta)
    b, h, cq, _ = q.shape
    ck = k.shape[2]
    dk = torch.empty(b, h, ck, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if b * h * ck == 0:
        return dk, dv
    if cq == 0:
        return dk.zero_(), dv.zero_()
    kind, spec = _spec_args(mask_spec)
    _launch_error("chunk_flash_dkv", _kernel("chunk_attention_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _DTYPE_CODE[q.dtype],
        _strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(), _stat_strides(lse, delta),
        int(q_off), int(k_off), int(n_valid), int(causal), kind, spec, dk.data_ptr(),
        dv.data_ptr(), b, h, cq, ck, d, float(scale), _stream(q)))
    dkv_launches += 1
    tc_dkv_launches += int(q.dtype == torch.bfloat16)
    return dk, dv
