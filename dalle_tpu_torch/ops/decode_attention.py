"""Single-token decode attention: the CUDA kernel, its wrapper and its plain
version.

``decode_attend`` is the port of the JAX package's Pallas kernel
``dalle_tpu/ops/decode_attention.py::decode_attend_kernel``. On a CUDA tensor
it launches ``csrc/decode_attention.cu`` (built at first use, see
``_build.py``) or raises; on a CPU tensor it runs ``decode_attend_plain``,
the same function in plain tensor code. ``launches`` counts kernel launches.

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
from typing import Optional

import torch

NEG_INF = -1e9
MAX_DIM_HEAD = 256

# kernel launches since the last reset (the chip smoke test zeroes it around
# the main path to show the path went through the kernel)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEMS_PER_16B = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16}
# the kernel keeps the (S,) score row and a few small buffers in shared
# memory; 227 KB per block on Hopper
_MAX_SMEM = 227 * 1024
_fn = None


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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
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
    if 4 * (S + 2 * d + 16) + 4 * 256 * _ELEMS_PER_16B[kv.dtype] > _MAX_SMEM:
        raise ValueError(f"cache length {S} exceeds the kernel's shared memory")
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
    rc = _kernel()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], kv.data_ptr(), _DTYPE_CODE[kv.dtype],
        None if kv_scale is None else kv_scale.data_ptr(),
        None if mask_row is None else mask_row.data_ptr(),
        out.data_ptr(), b, h, S, d, int(length), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attend kernel failed to launch: CUDA error {rc}")
    launches += 1
    return out
