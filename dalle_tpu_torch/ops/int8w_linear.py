"""The int8-weight product W8: a CUDA kernel, its wrapper and plain version.

``int8w_linear(x, q, s, b)`` computes ``x · (T(q) * T(s))ᵀ + b`` for x (..., K)
in T = bfloat16 or float32, q (N, K) int8, s (N,) f32 per output channel and
an optional bias (N,): the JAX package's ``QDense`` int8 branch
(``dalle_tpu/ops/quantize_weights.py:48-58``), where XLA fuses the dequant
into the matmul's operand load. No TPU kernel stands behind it, so it
replaces no ``pallas_call``: in PyTorch a dequantize followed by
``F.linear`` reads a weight's int8 byte, writes two bytes of bf16 and reads
them again, which would make int8 weights slower than bf16 in the decode
steps they exist to speed up.

The function is routed by shape, on the card:

* up to ``MAX_ROWS`` (64) rows (a decode step, a speculative window, the
  engine's steps): ``csrc/int8w_linear.cu``, route ``"tc"`` for bf16 x
  (``mma.sync`` with the weights converted in registers) or ``"fma"`` for
  f32 x. Only the int8 bytes cross HBM.
* more rows (prefills and refill windows, bound by compute): the weight is
  dequantized into a scratch of T and multiplied by ``torch.matmul``, the
  counterpart of XLA's dot outside any Pallas kernel. This is a route by
  shape, not a fallback: a kernel that fails to build or launch raises.

``MAX_ROWS`` is the kernel's own limit: on an H100 80GB HBM3 at 700 W the
kernel took less time than the matmul route at every QLinear shape of the
1.4B model and every row count from 8 to 64 (``chip_smoke.py``, its
``w8_routes`` line; ``PERF.md``), so the crossover lies above what the
kernel takes.

On a CPU tensor the wrapper runs ``int8w_linear_plain``, the JAX formula in
tensor code. ``launches`` counts kernel launches, ``tc_launches`` and
``fma_launches`` those of each route, and ``matmul_calls`` the calls that
took the ``torch.matmul`` route (no kernel of this module).

A row's output does not depend on M or on the row's place in a launch of
the kernel (``csrc/int8w_linear.cu``): without that the serve engine's
tokens could not equal sequential generation's. (They do at f32 compute;
in the bf16 modes the two paths' attention rounds at other points, an open
fault in ``ROADMAP.md``.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

MAX_ROWS = 64         # rows the kernel takes (four tiles of 16); more go to torch.matmul
STEP = 64             # weight bytes of a row per step of the kernel
WARPS = 8             # the contraction is split across a CTA's warps in runs of steps

launches = 0
tc_launches = 0
fma_launches = 0
matmul_calls = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """(N, K) weights in ``dtype``: ``dtype(q) * dtype(s)``, each product
    rounded to ``dtype`` (the JAX package's ``kernel.astype(x.dtype) *
    scale.astype(x.dtype)``)."""
    return q.to(dtype) * s.to(dtype)[:, None]


def int8w_linear_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function in plain tensor code: the dequantized weight in x's dtype,
    the products (exact in f32) summed in f32 and rounded to x's dtype, then
    the bias added in that dtype. The sum runs as an f32 ``F.linear``: the
    CPU's bf16 product would give a row other bits at other row counts,
    and the serve engine's tokens rest on a row's bits not depending on
    them."""
    y = F.linear(x.float(), dequantize(q, s, x.dtype).float()).to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


def int8w_tolerance(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    b: Optional[torch.Tensor], want: torch.Tensor) -> torch.Tensor:
    """Per-element bound of the kernel against the plain version on the same
    inputs. Both form the same dequantized weights and sum their products in
    f32, in other orders: 2^-20 of Σ_k |x_k·w_k| (K up to 2^13 terms, each
    sum's rounding error within K·2^-24 of it, and far less in practice).
    With bf16 x each side then rounds the sum to bf16, and the sum plus the
    bias again: a value on a rounding boundary may round the other way, one
    bf16 ulp (at most 2^-7 of the value) at each rounding, of the sum
    (|want - b|, within an ulp) and of the output (|want|); 2^-6 of each
    covers both sides."""
    w = dequantize(q, s, x.dtype).float()
    bound = 2.0 ** -20 * F.linear(x.float().abs(), w.abs())
    if x.dtype == torch.bfloat16:
        want = want.float()
        pre = want if b is None else want - b.float()
        bound = bound + 2.0 ** -6 * (want.abs() + pre.abs())
    return bound


def _kernel():
    global _fn
    if _fn is None:
        from ._build import library
        fn = library("int8w_linear").int8w_linear
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, x dtype, q, s, bias, out, M N K, stream
        fn.argtypes = [p, i, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x2, q, s, b):
    M, K = x2.shape
    N = q.shape[0]
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != K:
        raise ValueError(f"weights must be int8 (N, {K}), got {q.dtype} {tuple(q.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (N,):
        raise ValueError(f"scales must be float32 ({N},), got {s.dtype} {tuple(s.shape)}")
    if b is not None and (b.dtype != x2.dtype or tuple(b.shape) != (N,)):
        raise ValueError(f"bias must be {x2.dtype} ({N},)")
    if K % 16:
        raise ValueError(f"the kernel takes K a multiple of 16, got {K}")
    for t in [x2, q, s] + ([] if b is None else [b]):
        if t.device != x2.device:
            raise ValueError("int8w_linear operands must share one device")
        if not t.is_contiguous():
            raise ValueError("int8w_linear operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("int8w_linear operands must be 16-byte aligned")


def int8w_linear_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The route above ``MAX_ROWS`` rows: x2 (M, K) times the weight
    dequantized into a scratch of x's dtype, by ``torch.matmul``."""
    y = torch.matmul(x2, dequantize(q, s, x2.dtype).t())
    return y if b is None else y + b.to(y.dtype)


def int8w_linear(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) × int8 q (N, K) with f32 per-channel scales s (N,), plus an
    optional bias (N,) → (..., N) in x's dtype. CPU tensors run the plain
    version; CUDA tensors run the kernel (at most ``MAX_ROWS`` rows) or
    ``torch.matmul`` on the dequantized weight (more rows)."""
    global matmul_calls
    if x.device.type == "cpu":
        return int8w_linear_plain(x, q, s, b)
    if x.device.type != "cuda":
        raise ValueError(f"int8w_linear runs on cuda or cpu, not {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M, N = x2.shape[0], q.shape[0]
    if M > MAX_ROWS:
        matmul_calls += 1
        return int8w_linear_matmul(x2, q, s, b).reshape(*lead, N)
    return int8w_linear_kernel(x2, q, s, b).reshape(*lead, N)


def int8w_linear_kernel(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel alone on CUDA x2 (M, K), M up to ``MAX_ROWS``; counted in
    ``launches`` and its route's count."""
    global launches, tc_launches, fma_launches
    M, K = x2.shape
    N = q.shape[0]
    if M > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} rows, got {M}")
    if b is not None:
        b = b.to(x2.dtype)
    x2 = x2.contiguous()
    _check(x2, q, s, b)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    rc = _kernel()(x2.data_ptr(), _DTYPE_CODE[x2.dtype], q.data_ptr(), s.data_ptr(),
                   None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
                   torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8w_linear kernel failed to launch: CUDA error {rc}")
    launches += 1
    if x2.dtype == torch.bfloat16:
        tc_launches += 1
    else:
        fma_launches += 1
    return out
