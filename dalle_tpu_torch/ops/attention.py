"""Attention math shared by every attention layer, and the decode cache.

Port of ``dalle_tpu/ops/attention.py``: dense causal ``attend`` with stable
softmax, key mask and static-mask alignment; the merged sequence-major
``KVCache``; ``cached_attend``, which sends a decode step to the CUDA kernel
(``ops/decode_attention.py``) on the card and to its plain version on the
CPU; and ``cached_attend_window``, the serve engine's per-row windowed
attend, which sends a dense slab to K3 and a paged pool to K5. Both take
the JAX package's ``use_kernel`` pin: ``False`` runs the JAX package's
dense formula instead of any kernel, on either device.

Windowed writes (``append_rows``) take their per-row offsets on the host.
A ``WindowPlan`` turns them, once per dispatch, into the kernel's (b,)
starts and the flat rows each new position lands in, uploaded in one copy
and shared by every layer. Positions outside the cache (a parked row sits at
offset max_seq) and unmapped pages are dropped there, as the JAX package's
out-of-bounds scatters drop them; PyTorch would raise on such an index.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import to_device
from .decode_attention import (decode_attend, decode_attend_window,
                               decode_attend_window_paged)

NEG_INF = -1e9


def stable_softmax(t: torch.Tensor, dim: int = -1, alpha: float = 32.0 ** 2) -> torch.Tensor:
    """Softmax with pre-division by alpha and detached-max subtraction."""
    t = t / alpha
    t = t - t.amax(dim=dim, keepdim=True).detach()
    return torch.softmax(t * alpha, dim=dim)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True,
           key_mask: Optional[torch.Tensor] = None,      # (b, j) True=valid
           static_mask: Optional[torch.Tensor] = None,   # (i, j) True=may attend
           stable: bool = False,
           softmax_f32: bool = True,
           scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention. q: (b,h,i,d), k/v: (b,h,j,d) → (b,h,i,d).

    When i < j (cached decode), causality aligns the query block to the
    *end* of the key sequence, and static-mask rows are indexed by key
    position: rows j-i..j-1.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dots = torch.matmul(q * scale, k.transpose(-1, -2))
    i, j = dots.shape[-2], dots.shape[-1]
    if key_mask is not None:
        dots = dots.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        qpos = torch.arange(i, device=q.device) + (j - i)
        kpos = torch.arange(j, device=q.device)
        dots = dots.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    if static_mask is not None:
        dots = dots.masked_fill(static_mask[j - i:j, :j] == 0, NEG_INF)
    softmax = stable_softmax if stable else torch.softmax
    sm_dtype = torch.float32 if softmax_f32 else dots.dtype
    attn = softmax(dots.to(sm_dtype), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _quantize_int8(x: torch.Tensor):
    """Per-(b, h, position) symmetric int8 quantization over the head dim
    (round half to even, clip to ±127). Returns (q int8, scale f32 with a
    trailing singleton dim)."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


class WindowPlan:
    """Where a window of ``w`` new positions per row lands: ``pos`` (b, w)
    absolute positions and ``starts`` (b,) int32 on the cache's device;
    ``src`` (n,) the rows of the flattened (b·w) window that are written and
    ``dst`` (n,) the flat cache row each lands in (``dst_b``/``dst_p``: its
    batch row and position, for the dense scale layout). Built on the host
    from ``offsets`` and ``targets`` ((b, w) positions → flat rows, -1 =
    dropped), uploaded in one copy."""

    def __init__(self, offsets, w: int, targets: Callable, device, slab_len: int = 0):
        offsets = _host(offsets).reshape(-1)
        b = offsets.shape[0]
        pos = offsets[:, None] + np.arange(w, dtype=np.int64)[None, :]
        dst = targets(pos).reshape(-1)
        src = np.flatnonzero(dst >= 0)
        dst = dst[src]
        n = src.shape[0]
        parts = [offsets, pos.reshape(-1), src, dst]
        if slab_len:
            parts += [dst // slab_len, dst % slab_len]
        flat = to_device(np.concatenate(parts), device)
        cut = np.cumsum([b, b * w, n, n, n, n])
        self.starts = flat[:cut[0]].to(torch.int32)
        self.pos = flat[cut[0]:cut[1]].view(b, w)
        self.src, self.dst = flat[cut[1]:cut[2]], flat[cut[2]:cut[3]]
        if slab_len:
            self.dst_b, self.dst_p = flat[cut[3]:cut[4]], flat[cut[4]:cut[5]]
        self._rot = None

    def rotary_rows(self, table: torch.Tensor) -> torch.Tensor:
        """(b, 1, w, r) rotary rows at the window's positions, clamped into
        the table (a parked row overshoots it), gathered once per plan."""
        if self._rot is None or self._rot[0] is not table:
            rows = table[self.pos.clamp(0, table.shape[0] - 1)][:, None]
            self._rot = (table, rows)
        return self._rot[1]


def window_rows(k_new: torch.Tensor, v_new: torch.Tensor, dtype):
    """(b,h,w,d) keys and values → (b·w, 2hd) cache rows in ``dtype`` and,
    for int8, their (b·w, 2h) scales (K heads, then V heads)."""
    b, h, w, d = k_new.shape
    if dtype == torch.int8:
        kq, ks = _quantize_int8(k_new)
        vq, vs = _quantize_int8(v_new)
        rows = torch.cat([KVCache._flatten(kq), KVCache._flatten(vq)], dim=2)
        sc = torch.cat([ks[..., 0], vs[..., 0]], dim=1).transpose(1, 2)   # (b,w,2h)
        return rows.reshape(b * w, -1), sc.reshape(b * w, -1)
    rows = torch.cat([KVCache._flatten(k_new.to(dtype)),
                      KVCache._flatten(v_new.to(dtype))], dim=2)
    return rows.reshape(b * w, -1), None


class KVCache:
    """Preallocated decode cache for one attention layer.

    ONE merged buffer (b, max_seq, 2*h*d), sequence-major, K in the first
    h*d lanes of each position and V in the rest: the decode kernel reads
    one contiguous row per position. ``dtype=torch.int8`` stores quantized
    rows with per-(b, h, position) f32 scales in a (b, 2h, max_seq) tensor
    (K scales in rows 0..h-1).
    """

    def __init__(self, kv: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 heads: int = 1):
        self.kv = kv
        self.scale = scale
        self.heads = heads

    @property
    def max_seq(self) -> int:
        """Sequence capacity, which is also the park offset."""
        return self.kv.shape[1]

    @classmethod
    def init(cls, batch: int, heads: int, max_seq: int, dim_head: int,
             dtype=torch.float32, device=None) -> "KVCache":
        z = torch.zeros((batch, max_seq, 2 * heads * dim_head), dtype=dtype,
                        device=device)
        if dtype == torch.int8:
            s = torch.zeros((batch, 2 * heads, max_seq), dtype=torch.float32,
                            device=device)
            return cls(z, s, heads=heads)
        return cls(z, heads=heads)

    @staticmethod
    def _flatten(x: torch.Tensor) -> torch.Tensor:
        """(b,h,n,d) → (b,n,h*d) rows."""
        b, h, n, d = x.shape
        return x.transpose(1, 2).reshape(b, n, h * d)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               offset: int) -> "KVCache":
        """Write (b,h,n,d) new keys/values at position ``offset``. Writes in
        place into the preallocated buffer, where the JAX package returns a
        new cache from ``lax.dynamic_update_slice``; returns self."""
        n = k_new.shape[2]
        hd = self.kv.shape[2] // 2
        rows = self.kv[:, offset:offset + n]
        if self.scale is not None:
            kq, ks = _quantize_int8(k_new)
            vq, vs = _quantize_int8(v_new)
            rows[..., :hd] = self._flatten(kq)
            rows[..., hd:] = self._flatten(vq)
            self.scale[:, :self.heads, offset:offset + n] = ks[..., 0]
            self.scale[:, self.heads:, offset:offset + n] = vs[..., 0]
        else:
            rows[..., :hd] = self._flatten(k_new)
            rows[..., hd:] = self._flatten(v_new)
        return self

    def window_plan(self, offsets, w: int) -> WindowPlan:
        """The plan of a window of ``w`` positions per row at the host
        ``offsets`` (b,); positions outside [0, max_seq) are dropped."""
        B, S = self.kv.shape[:2]

        def targets(pos):
            rows = np.arange(pos.shape[0], dtype=np.int64)[:, None] * S + pos
            return np.where((pos >= 0) & (pos < S), rows, -1)

        return WindowPlan(offsets, w, targets, self.kv.device, slab_len=S)

    def append_rows(self, k_new: torch.Tensor, v_new: torch.Tensor,
                    offsets) -> "KVCache":
        """Write (b,h,w,d) new keys/values at PER-ROW positions ``offsets``
        ((b,) on the host, or a ``WindowPlan``), in place; positions outside
        the cache are dropped. Returns self."""
        plan = (offsets if isinstance(offsets, WindowPlan)
                else self.window_plan(offsets, k_new.shape[2]))
        rows, sc = window_rows(k_new, v_new, self.kv.dtype)
        self.kv.view(-1, self.kv.shape[2]).index_copy_(0, plan.dst, rows[plan.src])
        if sc is not None:
            self.scale[plan.dst_b, :, plan.dst_p] = sc[plan.src]
        return self

    def read_kv(self, dtype=None):
        """(k, v) as (b, h, S, d), dequantized when stored int8 (in ``dtype``,
        default bf16; pass the query dtype to match the matmul)."""
        b, S, hd2 = self.kv.shape
        h = self.heads
        kv = self.kv.reshape(b, S, 2, h, hd2 // (2 * h))
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        if self.scale is not None:
            dt = dtype or torch.bfloat16
            ks = self.scale[:, :h, :, None].to(dt)
            vs = self.scale[:, h:, :, None].to(dt)
            return k.to(dt) * ks, v.to(dt) * vs
        return k, v


def _dense_cached(q: torch.Tensor, cache: KVCache, valid: torch.Tensor, *,
                  stable: bool, scale: Optional[float]) -> torch.Tensor:
    """The JAX package's dense cached attend (``use_kernel=False``,
    ``dalle_tpu/ops/attention.py:244-261`` and :316 on): q·scale and the
    scores in q's dtype against the whole cache read in q's dtype, the
    positions outside ``valid`` (broadcast to (b, h, w, S)) masked, the
    softmax in f32 cast to the cache's read dtype, then p·v, each batch row
    in its own products. Output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q = q * scale
    ck, cv = cache.read_kv(dtype=q.dtype)
    ck = ck.to(torch.promote_types(q.dtype, ck.dtype))
    # each batch row in its own products: cuBLAS picks its kernel by the
    # batch count, and a row's bits must not depend on how many rows share
    # the call (the engine's slots against a b=1 sequential request)
    dots = torch.cat([torch.matmul(q[i:i + 1], ck[i:i + 1].transpose(-1, -2))
                      for i in range(q.shape[0])])
    dots = dots.masked_fill(~valid, NEG_INF)
    softmax = stable_softmax if stable else torch.softmax
    attn = softmax(dots.to(torch.float32), dim=-1).to(cv.dtype)
    return torch.cat([torch.matmul(attn[i:i + 1], cv[i:i + 1])
                      for i in range(q.shape[0])]).to(q.dtype)


def cached_attend(q: torch.Tensor, cache: KVCache, length: int, *,
                  static_mask: Optional[torch.Tensor] = None,
                  stable: bool = False, qpos: Optional[int] = None,
                  scale: Optional[float] = None,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Single-step decode: q is (b,h,1,d); attends to cache[:length].
    ``qpos`` (default length-1) indexes the static_mask row.

    ``use_kernel`` None or True runs the decode kernel (``decode_attend``:
    CUDA on the card, its plain version on the CPU), a layer with the
    stable softmax too: dividing the scores by alpha = 1024 (a power of
    two), subtracting their max and multiplying back is exact in f32, so it
    is the kernel's f32 max-subtracted softmax. ``use_kernel=False`` pins
    the JAX package's dense formula on either device (``_dense_cached``),
    the same attend as ``cached_attend_window``'s pinned path: the parity
    mode, in which the serve engine's tokens equal sequential
    generation's bit for bit."""
    row = None
    if static_mask is not None:
        row = static_mask[length - 1 if qpos is None else qpos]
    if use_kernel is False:
        S = cache.max_seq
        valid = torch.arange(S, device=q.device) < length
        if row is not None:
            # the mask may cover more positions than the cache holds
            valid = valid & (row[:S] != 0)
        return _dense_cached(q, cache, valid, stable=stable, scale=scale)
    # q may be a strided view of the qkv projection (rotary off); the kernel
    # takes it dense
    return decode_attend(q.contiguous(), cache, length, mask_row=row, scale=scale)


def cached_attend_window(q: torch.Tensor, cache, starts, *,
                         stable: bool = False,
                         scale: Optional[float] = None,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Multi-token cached decode with PER-ROW positions: q (b, h, w, d), row
    b's queries at ``starts[b] .. starts[b]+w-1``, query j attending the
    cache positions <= starts[b]+j. ``use_kernel`` None or True sends a
    dense ``KVCache`` to K3 (``decode_attend_window``) and a paged
    ``PagedKVCache`` to K5 (``decode_attend_window_paged``): CUDA on the
    card, their plain versions on the CPU. A layer with the stable softmax
    takes them too: dividing the scores by alpha, subtracting their max and
    multiplying back is the kernels' f32 max-subtracted softmax.
    ``use_kernel=False`` pins the JAX package's dense formula
    (``_dense_cached``); a paged cache first gathers its dense slab, as the
    JAX package does."""
    if use_kernel is False:
        if hasattr(cache, "pool"):
            cache = cache.gather_dense()
        w = q.shape[2]
        starts = torch.as_tensor(starts, device=q.device).long()
        qabs = starts[:, None] + torch.arange(w, device=q.device)[None, :]      # (b, w)
        valid = (torch.arange(cache.max_seq, device=q.device)[None, None, :]
                 <= qabs[:, :, None])[:, None]                                   # (b,1,w,S)
        return _dense_cached(q, cache, valid, stable=stable, scale=scale)
    if hasattr(cache, "pool"):
        return decode_attend_window_paged(q, cache, starts, scale=scale)
    return decode_attend_window(q, cache, starts, scale=scale)
