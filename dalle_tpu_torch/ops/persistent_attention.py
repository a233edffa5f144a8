"""Whole-sequence causal attention (K8): the CUDA kernels' wrappers, their
plain versions and the ``torch.autograd.Function`` that joins them.

Port of ``dalle_tpu/ops/persistent_attention.py``: ``persistent_attention``
over (b, h, n, d) with an optional int8 (n, n) visibility table (1 = the
query row may attend the key column, causality already in it; None means
plain causal). The forward is ``csrc/persistent_attention.cu::persist_fwd``
(the Pallas ``_fwd_kernel``), the backward ``::persist_bwd`` (``_bwd_kernel``:
a dq kernel over row strips, then a dk/dv kernel over column strips), both
built at first use (``_build.py``). On a CUDA tensor a wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version, which repeats
the TPU kernel's roundings step by step. ``fwd_launches`` and
``bwd_launches`` count kernel launches (a backward launch is one call that
runs the two CUDA kernels).

The arithmetic is the TPU kernel's: q, k, v (and dO) are cast to bf16
first; qs = bf16(f32(q16)·scale); s = qs·kᵀ in f32, -1e9 where hidden; the
softmax is exact, not online: p = exp(s - m) / l over the whole row, and
p16 = bf16(p) multiplies v. The backward recomputes s, m, l and p; delta is
Σ o·dO with o = p16·v recomputed in f32 (not the forward's output, which may
be bf16); ds = bf16(p·(dp - delta)), dq = ds·k·scale, dk = dsᵀ·q16·scale
with the unscaled bf16 q, dv = p16ᵀ·bf16(dO). Outputs are in q's dtype. A
row that sees nothing has every score at -1e9, so the TPU kernel's softmax
spreads it evenly over all n keys (p = 1/n); the kernels do the same.

The function saves only (q, k, v), as the JAX ``custom_vjp`` does: the dq
kernel recomputes each row's (m, l) and delta and hands them to the dk/dv
kernel through a (3, b, h, n) f32 workspace.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .flash_attention import _on_card, _stream, _strides

NEG_INF = -1e9
MAX_DIM_HEAD = 128
# the TPU kernel's routing budget: ~3 live (n, n) f32 tiles + operands within
# 8 MB of scoped VMEM (verbatim from the JAX package: the transformer routes
# by it, so it decides which layers take this arithmetic and which go dense)
_VMEM_BUDGET = 8 * 1024 * 1024
# shared memory a block can use on Hopper
_MAX_SMEM = 227 * 1024

# launches since the last reset (chip_smoke.py zeroes them around the main
# path to show the path went through the kernels)
fwd_launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def persistent_fits(n: int, d: int, itemsize: int = 2) -> bool:
    return 3 * n * n * 4 + 6 * n * d * itemsize <= _VMEM_BUDGET


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
        vis = table.to(q16.device) != 0
    s = torch.where(vis, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def persist_fwd_plain(q, k, v, table: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel's function in plain tensor code → o in q's dtype."""
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    p16 = _probs(q16, k16, table, _scale(q, scale)).to(torch.bfloat16)
    o = torch.einsum("bhij,bhjd->bhid", p16.float(), v16.float())
    return o.to(q.dtype)


def persist_bwd_plain(q, k, v, do, table: Optional[torch.Tensor] = None,
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
            # q k v, strides, table, out, out dtype, b h n d, scale, stream
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
            fn.restype = ctypes.c_int
        elif name == "persist_bwd":
            # q k v do, strides, table, stats, dq dk dv, out dtype, b h n d,
            # scale, stream
            fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
            fn.restype = ctypes.c_int
        else:                          # persist_smem_bytes(n, d)
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_longlong
        _fns[name] = fn
    return fn


def _check_cuda(q, k, v, table, do=None) -> int:
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
    if table is not None and (table.dtype != torch.int8 or tuple(table.shape) != (n, n)
                              or not table.is_contiguous() or table.device != q.device):
        raise ValueError(f"the table must be contiguous int8 {(n, n)} on {q.device}, "
                         f"got {table.dtype} {tuple(table.shape)}")
    if q.device.type == "cuda":
        smem = _kernel("persist_smem_bytes")(n, d)
        if not 0 < smem <= _MAX_SMEM:
            raise ValueError(f"n={n} at d={d} needs {smem} bytes of shared memory, "
                             f"more than a block has ({_MAX_SMEM})")
    return d


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """The kernels read bf16 rows with 16-byte loads: cast (as the TPU
    wrapper does) and copy only a layout they cannot read."""
    t = t.to(torch.bfloat16)
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def persist_fwd(q, k, v, table: Optional[torch.Tensor] = None,
                scale: Optional[float] = None) -> torch.Tensor:
    """Forward: o (b, h, n, d) in q's dtype."""
    global fwd_launches
    if not _on_card(q, "persist_fwd"):
        return persist_fwd_plain(q, k, v, table, scale)
    d = _check_cuda(q, k, v, table)
    b, h, n, _ = q.shape
    out = torch.empty(b, h, n, d, dtype=q.dtype, device=q.device)
    if b * h * n == 0:
        return out
    q16, k16, v16 = (_bf16(t) for t in (q, k, v))
    rc = _kernel("persist_fwd")(
        q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), _strides(q16, k16, v16),
        None if table is None else table.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, n, d, _scale(q, scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"persist_fwd kernel failed to launch: CUDA error {rc}")
    fwd_launches += 1
    return out


def persist_bwd(q, k, v, do, table: Optional[torch.Tensor] = None,
                scale: Optional[float] = None):
    """Backward: (dq, dk, dv) (b, h, n, d) in q's dtype from the saved
    inputs and the output gradient."""
    global bwd_launches
    if not _on_card(q, "persist_bwd"):
        return persist_bwd_plain(q, k, v, do, table, scale)
    d = _check_cuda(q, k, v, table, do)
    b, h, n, _ = q.shape
    grads = [torch.empty(b, h, n, d, dtype=q.dtype, device=q.device) for _ in range(3)]
    if b * h * n == 0:
        return tuple(grads)
    q16, k16, v16, do16 = (_bf16(t) for t in (q, k, v, do))
    stats = torch.empty(3, b, h, n, dtype=torch.float32, device=q.device)
    rc = _kernel("persist_bwd")(
        q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), do16.data_ptr(),
        _strides(q16, k16, v16, do16), None if table is None else table.data_ptr(),
        stats.data_ptr(), *(g.data_ptr() for g in grads), _DTYPE_CODE[q.dtype],
        b, h, n, d, _scale(q, scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"persist_bwd kernel failed to launch: CUDA error {rc}")
    bwd_launches += 1
    return tuple(grads)


class PersistentAttention(torch.autograd.Function):
    """Forward kernel, and the backward kernels as its gradient; saves only
    q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, table, scale):
        ctx.save_for_backward(q, k, v)
        ctx.table, ctx.scale = table, scale
        return persist_fwd(q, k, v, table, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = persist_bwd(q, k, v, do, ctx.table, ctx.scale)
        return dq, dk, dv, None, None


def persistent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         table: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Causal whole-sequence attention over (b, h, n, d), differentiable
    through the backward kernels. ``table`` is an optional int8 (n, n)
    visibility table with causality in it (None = plain causal)."""
    return PersistentAttention.apply(q, k, v, table, scale)
