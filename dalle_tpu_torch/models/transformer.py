"""The transformer stack: full forward, prefill and cached one-token decode.

Port of ``dalle_tpu/models/transformer.py``. Module and parameter names
follow the flax tree (``attn_{i}``, ``ff_{i}``, ``layer_attn_{i}``,
``layer_ff_{i}``), so ``convert.py`` maps one onto the other by path.

* Layer sharing (``shared_attn_ids``/``shared_ff_ids``) is module reuse: one
  ``Attention``/``GEGLUFeedForward`` serves several depths. Caches stay
  per depth.
* Every sparse attention kind is the dense core plus a static mask, kept
  as an int32 (seq, seq) buffer whose rows feed the decode kernel directly.
* The forward is the inference forward (dropout off). Token shift and
  reversible blocks raise ``NotImplementedError``; remat only changes what
  a backward pass keeps, and the port has no training step yet.
"""

from __future__ import annotations

from itertools import cycle, islice
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from ..ops.attention import KVCache, attend, cached_attend
from ..ops.attn_masks import build_mask
from ..ops.rotary import apply_rotary, dalle_pos_emb

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def layerscale_init_eps(layer_index_1based: int) -> float:
    """Per-layer LayerScale init: 0.1 up to depth 18, 1e-5 to 24, 1e-6 beyond."""
    if layer_index_1based <= 18:
        return 0.1
    if layer_index_1based <= 24:
        return 1e-5
    return 1e-6


class DivideMax(nn.Module):
    """Divide by the detached max (stable-output trick)."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return x / x.amax(dim=self.dim, keepdim=True).detach()


class GEGLUFeedForward(nn.Module):
    """Linear(dim→dim·mult·2) → GEGLU (tanh GELU, as jax.nn.gelu) →
    Linear(dim·mult→dim)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.w1 = nn.Linear(dim, dim * mult * 2)
        self.w2 = nn.Linear(dim * mult, dim)

    def forward(self, x):
        x, gates = self.w1(x).chunk(2, dim=-1)
        return self.w2(x * F.gelu(gates, approximate="tanh"))


class Attention(nn.Module):
    """Multi-head attention over the dense core. Rotary is applied to q, k
    AND v (the reference's behaviour)."""

    def __init__(self, dim: int, heads: int, dim_head: int, *,
                 causal: bool = True, stable: bool = False,
                 softmax_f32: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.stable, self.softmax_f32 = causal, stable, softmax_f32
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def _split(self, x):
        """(b, n, dim) → q, k, v as (b, h, n, d), head-major [q|k|v] split."""
        b, n, _ = x.shape
        return [t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                for t in self.to_qkv(x).chunk(3, dim=-1)]

    def _merge(self, out):
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))

    def forward(self, x, *, key_mask=None, rotary=None, static_mask=None):
        q, k, v = self._split(x)
        if rotary is not None:
            rot = rotary[:x.shape[1]][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        out = attend(q, k, v, causal=self.causal, key_mask=key_mask,
                     static_mask=static_mask, stable=self.stable,
                     softmax_f32=self.softmax_f32)
        return self._merge(out)

    def prefill(self, x, cache: KVCache, *, rotary=None, static_mask=None):
        """Full-prefix forward that also fills the KV cache from position 0
        (f32 softmax, as the JAX package's prefill)."""
        q, k, v = self._split(x)
        if rotary is not None:
            rot = rotary[:x.shape[1]][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        cache.append(k, v, 0)
        out = attend(q, k, v, causal=self.causal, static_mask=static_mask,
                     stable=self.stable)
        return self._merge(out), cache

    def decode(self, x_t, cache: KVCache, offset: int, *, rotary=None,
               static_mask=None):
        """One-token step at position ``offset``: append, then attend to
        positions 0..offset (the mask row is row ``offset``)."""
        q, k, v = self._split(x_t)
        if rotary is not None:
            rot = rotary[offset:offset + 1][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        cache.append(k, v, offset)
        out = cached_attend(q, cache, offset + 1, static_mask=static_mask,
                            stable=self.stable, qpos=offset)
        return self._merge(out), cache


class TransformerLayer(nn.Module):
    """PreNorm(+sandwich norm) around a function the caller passes, scaled by
    LayerScale; the caller adds the residual. One instance per (depth, role);
    the function itself may be shared between depths."""

    def __init__(self, dim: int, index: int, sandwich: bool = False):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_out = nn.LayerNorm(dim, eps=LN_EPS) if sandwich else None
        self.scale = nn.Parameter(
            torch.full((1, 1, dim), layerscale_init_eps(index)))

    def post(self, y):
        if self.norm_out is not None:
            y = self.norm_out(y)
        return y * self.scale

    def forward(self, x, fn, **kw):
        return self.post(fn(self.norm(x), **kw))


class Transformer(nn.Module):
    """depth × (attn, ff) with the per-layer attention kind from the cyclic
    ``attn_types`` tuple, layer sharing, the rotary table and static masks."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.shift_tokens:
            raise NotImplementedError("shift_tokens is not ported yet")
        if c.reversible:
            raise NotImplementedError("reversible blocks are not ported yet")
        fmap = c.image_fmap_size
        self.text_len = c.seq_len + 1 - fmap * fmap if c.causal else 0

        attn_types = tuple(c.attn_types) or ("full",)
        types = list(islice(cycle(attn_types), c.depth))
        attn_ids = list(islice(cycle(c.shared_attn_ids or range(c.depth)), c.depth))
        ff_ids = list(islice(cycle(c.shared_ff_ids or range(c.depth)), c.depth))

        # static masks ('full' is plain causal, handled in attend); 'sparse'
        # draws one pattern per layer from sparse_mask_seed + layer index
        self.mask_keys = [f"sparse_{i}" if t == "sparse" else t
                          for i, t in enumerate(types)]
        self._mask_buffers: Dict[str, Optional[str]] = {}
        for ind, (mk, t) in enumerate(zip(self.mask_keys, types)):
            if mk in self._mask_buffers:
                continue
            if t == "full" or not c.causal:
                self._mask_buffers[mk] = None
                continue
            m = build_mask(t, self.text_len, fmap, kernel_size=c.sparse_attn_kernel,
                           block=c.sparse_block_size,
                           num_random_blocks=c.sparse_num_random_blocks,
                           seed=c.sparse_mask_seed + ind)
            name = f"mask_{mk}"
            self.register_buffer(name, torch.from_numpy(m.astype("int32")),
                                 persistent=False)
            self._mask_buffers[mk] = name

        self.attn_names, self.ff_names = [], []
        attn_type_of: Dict[Any, str] = {}
        for ind in range(c.depth):
            aid, fid, t = attn_ids[ind], ff_ids[ind], types[ind]
            if aid in attn_type_of:
                if attn_type_of[aid] != t:
                    raise ValueError(
                        f"attn_types do not match shared_attn_ids (ind={ind}, "
                        f'attn_type="{t}", reused="{attn_type_of[aid]}")')
            else:
                attn_type_of[aid] = t
                self.add_module(f"attn_{aid}", Attention(
                    c.dim, c.heads, c.dim_head, causal=c.causal,
                    stable=c.stable, softmax_f32=c.attn_softmax_f32))
            if not hasattr(self, f"ff_{fid}"):
                self.add_module(f"ff_{fid}", GEGLUFeedForward(c.dim, c.ff_mult))
            self.attn_names.append(f"attn_{aid}")
            self.ff_names.append(f"ff_{fid}")
            self.add_module(f"layer_attn_{ind}",
                            TransformerLayer(c.dim, ind + 1, c.sandwich_norm))
            self.add_module(f"layer_ff_{ind}",
                            TransformerLayer(c.dim, ind + 1, c.sandwich_norm))

        rotary = None
        if c.rotary_emb and c.causal:
            rotary = torch.from_numpy(dalle_pos_emb(self.text_len, fmap, c.dim_head))
        self.register_buffer("rotary", rotary, persistent=False)

    def _layer(self, ind: int):
        return (getattr(self, f"layer_attn_{ind}"), getattr(self, self.attn_names[ind]),
                getattr(self, f"layer_ff_{ind}"), getattr(self, self.ff_names[ind]),
                self.static_mask(ind))

    def static_mask(self, ind: int) -> Optional[torch.Tensor]:
        """Layer ``ind``'s (seq, seq) int32 mask, None for full attention."""
        name = self._mask_buffers[self.mask_keys[ind]]
        return None if name is None else getattr(self, name)

    def forward(self, x, key_mask=None):
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, mask = self._layer(ind)
            x = x + la(x, attn, key_mask=key_mask, rotary=self.rotary,
                       static_mask=mask)
            x = x + lf(x, ff)
        return x

    # -- cached decode -----------------------------------------------------
    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   dtype=torch.float32) -> Dict[str, KVCache]:
        c = self.cfg
        device = self.layer_attn_0.scale.device
        return {f"kv_{ind}": KVCache.init(batch, c.heads, max_seq or c.seq_len + 1,
                                          c.dim_head, dtype, device=device)
                for ind in range(c.depth)}

    def prefill(self, x, cache: Dict[str, KVCache]):
        """Run the full prefix, filling every layer's cache. Returns (y, cache)."""
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, mask = self._layer(ind)
            y, _ = attn.prefill(la.norm(x), cache[f"kv_{ind}"],
                                rotary=self.rotary, static_mask=mask)
            x = x + la.post(y)
            x = x + lf(x, ff)
        return x, cache

    def decode_step(self, x_t, cache: Dict[str, KVCache], offset: int):
        """One token at position ``offset``. Returns (y_t, cache)."""
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, mask = self._layer(ind)
            y, _ = attn.decode(la.norm(x_t), cache[f"kv_{ind}"], offset,
                               rotary=self.rotary, static_mask=mask)
            x_t = x_t + la.post(y)
            x_t = x_t + lf(x_t, ff)
        return x_t, cache
