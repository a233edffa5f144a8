"""Attention math shared by every attention layer, and the decode cache.

Port of ``dalle_tpu/ops/attention.py``: dense causal ``attend`` with stable
softmax, key mask and static-mask alignment; the merged sequence-major
``KVCache``; ``cached_attend``, which sends a decode step to the CUDA kernel
(``ops/decode_attention.py``) on the card and to its plain version on the
CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attend

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


def _cached_attend_stable(q: torch.Tensor, cache: KVCache, length: int, *,
                          static_mask: Optional[torch.Tensor] = None,
                          qpos: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's dense cached path with the stable softmax: the
    whole cache in the matmul, positions ≥ length masked, int8 dequantized
    in the query dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q = q * scale
    ck, cv = cache.read_kv(dtype=q.dtype)
    dots = torch.matmul(q, ck.transpose(-1, -2))            # (b,h,1,max)
    valid = torch.arange(ck.shape[2], device=q.device) < length
    if static_mask is not None:
        if qpos is None:
            qpos = length - 1
        # the mask may cover more positions than the cache holds — trim
        valid = valid & (static_mask[qpos, :ck.shape[2]] != 0)
    dots = torch.where(valid, dots, NEG_INF)
    attn = stable_softmax(dots.float(), dim=-1).to(cv.dtype)
    return torch.matmul(attn, cv)


def cached_attend(q: torch.Tensor, cache: KVCache, length: int, *,
                  static_mask: Optional[torch.Tensor] = None,
                  stable: bool = False, qpos: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode: q is (b,h,1,d); attends to cache[:length].
    ``qpos`` (default length-1) indexes the static_mask row.

    Runs the decode kernel (``decode_attend``: CUDA on the card, its plain
    version on the CPU). ``stable=True`` takes the dense path instead, as
    the JAX package does: its pre-division changes the softmax the kernel
    computes."""
    if stable:
        return _cached_attend_stable(q, cache, length, static_mask=static_mask,
                                     qpos=qpos, scale=scale)
    row = None
    if static_mask is not None:
        row = static_mask[length - 1 if qpos is None else qpos]
    # q may be a strided view of the qkv projection (rotary off); the kernel
    # takes it dense
    return decode_attend(q.contiguous(), cache, length, mask_row=row, scale=scale)
