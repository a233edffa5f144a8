"""The transformer stack: full forward, prefill and cached one-token decode.

Port of ``dalle_tpu/models/transformer.py``. Module and parameter names
follow the flax tree (``attn_{i}``, ``ff_{i}``, ``layer_attn_{i}``,
``layer_ff_{i}``), so ``convert.py`` maps one onto the other by path.

* Layer sharing (``shared_attn_ids``/``shared_ff_ids``) is module reuse: one
  ``Attention``/``GEGLUFeedForward`` serves several depths. Caches stay
  per depth.
* Every sparse attention kind is the dense core plus a static mask, kept
  as an int32 (seq, seq) buffer whose rows feed the decode kernel directly.
* The full-sequence forward resolves ``use_pallas`` against the device
  (``ops/flash_attention.resolve_use_pallas``) into a mode: "fused",
  "flash", "persist" or False (dense ``attend``). A layer with a key mask is
  dense. In "fused" mode the causal layers without the stable softmax run the
  fused-boundary kernel K1 (``ops/fused_attention.py``) straight off the
  qkv projection, rotary applied on its (b, n, 3h, d) view. In "persist"
  mode, taken only by a causal model without the stable softmax (else the
  model is dense, as in the JAX package), every layer runs the whole-sequence
  kernel K8 (``ops/persistent_attention.py``) on the split (b, h, n, d) q, k,
  v after rotary, its visibility K1's table. In "flash" mode
  every layer runs the block-sparse kernel K4 (``ops/flash_attention.py``)
  on the split (b, h, n, d) q, k, v after rotary: stable layers too (the
  flash softmax subtracts the max, which subsumes the stable variant) and
  non-causal ones. K1's mask tables and K4's schedules (block lists plus a
  structured spec, or an int8 table) are built once per (layer kind,
  length, device) and kept; K8 reads K1's tables.
* ``Transformer(cfg, sp=P)`` with P > 1 is sequence parallel, the JAX
  package's ``sp_mesh``: the mode is "ring" whatever ``use_pallas`` says,
  and every layer's full-sequence forward runs ``ring_attention`` (zigzag,
  ``parallel/ring_attention.py``) on the split q, k, v after rotary, over P
  ranks in this process; its pairs go through the chunk kernels K6 where
  they tile (``ops/chunk_attention.py``). Full, axial and conv layers only;
  causal, no key mask; the stable softmax is ignored. Prefill and decode
  keep the dense core.
* ``reversible`` runs the layers as the two-stream coupling y1 = x1 +
  attn(x2), y2 = x2 + ff(y1), output (y1 + y2) / 2
  (``models/reversible.py``): the forward keeps no block's activations and
  the backward recomputes each branch from the inverted coupling, K1's
  forward and backward (or K4's, K8's) inside that recompute. The dropout
  masks are drawn before the forward, so the recompute reuses them; a
  shared layer's gradient sums over its uses. Prefill and decode run the
  sequential stack, as in the JAX package.
* ``use_remat`` recomputes each attn+ff block pair in the backward
  (``torch.utils.checkpoint``), as ``nn.remat`` does in the JAX package;
  the recompute runs K1's, K4's or K8's forward again.
* Dropout (``attn_dropout``, ``ff_dropout``), as the JAX package places it:
  on the attention block's output after ``to_out`` and on the feed-forward
  hidden after GEGLU, before ``w2``, each ``where(keep, x / (1 - p), 0)``.
  It acts only where the caller passes keep masks to ``forward``
  (``dropout_masks`` draws them from a generator, each layer's attention
  mask then its feed-forward mask): the training loss does, prefill, decode
  and the engine never do, whatever the module's ``training`` flag says.
  The masks are drawn outside the blocks and passed in, so ``use_remat``'s
  recompute sees the same ones (``torch.utils.checkpoint`` restores only
  the default generators, not an explicit one).
* Every projection is a ``QLinear`` (``ops/quantize_weights.py``): an
  ``nn.Linear`` until its weight is made int8, then the W8 product.
* Token shift (``shift_tokens``), as the JAX package does it: between each
  layer's norm and its function, text positions take the first half of
  their channels from the previous position and image positions the first
  quarter from the grid neighbour above and the second from the one to the
  left (``shift_tokens_full``). Cached decode keeps per-depth ring buffers
  of the last ``image_fmap_size`` *pre-shift* chunks (``ShiftState``,
  ``shift_prefill_state``, ``shift_decode_step``), bf16 beside an int8
  cache; text-position steps do not write the image rings. Layer sharing
  shares functions, not shift state. ``decode_window`` refuses shift, as
  the JAX package does: the rings are one token at a time.
"""

from __future__ import annotations

from itertools import cycle, islice
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TransformerConfig
from ..ops.attention import (KVCache, WindowPlan, attend, cached_attend,
                             cached_attend_window)
from ..ops.attn_masks import build_mask
from ..ops.flash_attention import (FlashSchedule, flash_attention, flash_schedule,
                                   resolve_use_pallas)
from ..ops.fused_attention import MaskTable, fused_qkv_attention, mask_table
from ..ops.paged_kv import PagedKVCache
from ..ops.persistent_attention import persistent_attention
from ..ops.quantize_weights import QLinear
from ..ops.rotary import apply_rotary, dalle_pos_emb
from ..parallel.ring_attention import ring_attention
from .reversible import run_reversible

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


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with its keep mask given: ``x / (1 - rate)``
    where ``keep``, else 0."""
    return torch.where(keep, x / (1.0 - rate), 0)


def drawn_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """``dropout`` with its keep mask drawn from ``generator`` (True with
    probability 1 - rate); ``x`` itself when rate is 0."""
    if rate <= 0:
        return x
    return dropout(x, torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate,
                   rate)


class GEGLUFeedForward(nn.Module):
    """Linear(dim→dim·mult·2) → GEGLU (tanh GELU, as jax.nn.gelu) → dropout
    (with a keep mask ``drop``) → Linear(dim·mult→dim)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.w1 = QLinear(dim, dim * mult * 2)
        self.w2 = QLinear(dim * mult, dim)

    def forward(self, x, drop: Optional[torch.Tensor] = None):
        x, gates = self.w1(x).chunk(2, dim=-1)
        x = x * F.gelu(gates, approximate="tanh")
        if drop is not None:
            x = dropout(x, drop, self.dropout)
        return self.w2(x)


class Attention(nn.Module):
    """Multi-head attention over the dense core. Rotary is applied to q, k
    AND v (the reference's behaviour)."""

    def __init__(self, dim: int, heads: int, dim_head: int, *,
                 causal: bool = True, stable: bool = False,
                 softmax_f32: bool = True, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.stable, self.softmax_f32 = causal, stable, softmax_f32
        inner = heads * dim_head
        self.to_qkv = QLinear(dim, inner * 3, bias=False)
        self.to_out = QLinear(inner, dim)

    def _split(self, x):
        """(b, n, dim) → q, k, v as (b, h, n, d), head-major [q|k|v] split."""
        b, n, _ = x.shape
        return [t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                for t in self.to_qkv(x).chunk(3, dim=-1)]

    def _merge(self, out):
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))

    def forward(self, x, *, drop: Optional[torch.Tensor] = None, **kw):
        """The full-sequence attention (``_attend``'s keywords), then dropout
        with the keep mask ``drop`` on the output."""
        out = self._attend(x, **kw)
        return out if drop is None else dropout(out, drop, self.dropout)

    def _attend(self, x, *, key_mask=None, rotary=None, static_mask=None,
                fused: bool = False, persist: bool = False,
                table: Optional[MaskTable] = None,
                flash: Optional[FlashSchedule] = None,
                ring: int = 1, ring_spec=None):
        """``ring`` > 1 sends the layer through ring attention over that many
        ranks, with the structured spec ``ring_spec`` of its static mask;
        ``fused`` sends a causal, non-stable layer without a key mask
        through K1, ``persist`` through K8, both with visibility ``table``
        (None = plain causal); ``flash`` (a schedule) sends a layer without a
        key mask through K4; otherwise ``static_mask`` feeds the dense core."""
        if fused and key_mask is None and self.causal and not self.stable:
            b, n, _ = x.shape
            qkv = self.to_qkv(x)
            if rotary is not None:
                # rotary on the (b, n, 3h, d) view: a reshape, no transpose
                qkv = apply_rotary(rotary[:n][:, None], qkv.reshape(
                    b, n, 3 * self.heads, self.dim_head)).reshape(b, n, -1)
            out = fused_qkv_attention(qkv, self.heads, table)
            return self.to_out(out.to(x.dtype))
        q, k, v = self._split(x)
        if rotary is not None:
            rot = rotary[:x.shape[1]][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        if ring > 1:
            # full causal plus the structured (axial/conv) masks, whose test
            # is a function of global positions; a tabled mask has none
            if key_mask is not None or not self.causal:
                raise ValueError("sequence parallelism requires causal attention "
                                 "and no key mask")
            if static_mask is not None and (ring_spec is None
                                            or ring_spec[0] not in ("axial", "conv")):
                raise ValueError("sequence parallelism supports full/axial/conv "
                                 "attention only")
            out = ring_attention(q, k, v, nper=ring, causal=True, zigzag=True,
                                 mask_spec=ring_spec if static_mask is not None else None)
            return self._merge(out.to(x.dtype))
        if persist and key_mask is None and self.causal and not self.stable:
            out = persistent_attention(q, k, v, table)
            return self._merge(out.to(x.dtype))
        if flash is not None and key_mask is None:
            out = flash_attention(q, k, v, causal=self.causal, schedule=flash)
            return self._merge(out.to(x.dtype))
        out = attend(q, k, v, causal=self.causal, key_mask=key_mask,
                     static_mask=static_mask, stable=self.stable,
                     softmax_f32=self.softmax_f32)
        return self._merge(out)

    def prefill(self, x, cache: KVCache, *, rotary=None, static_mask=None,
                use_kernel=None):
        """Full-prefix forward that also fills the KV cache from position 0
        (f32 softmax, as the JAX package's prefill), attending the fresh
        keys and values. Under ``use_kernel=False`` a causal layer without a
        static mask attends the cache rows it has just written instead, a
        window of n positions at 0 through the pinned
        ``cached_attend_window``: the serve engine's refill window, so an
        int8 cache's quantized prefix is what both paths see."""
        q, k, v = self._split(x)
        if rotary is not None:
            rot = rotary[:x.shape[1]][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        cache.append(k, v, 0)
        if use_kernel is False and self.causal and static_mask is None:
            starts = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
            out = cached_attend_window(q, cache, starts, stable=self.stable,
                                       use_kernel=False)
        else:
            out = attend(q, k, v, causal=self.causal, static_mask=static_mask,
                         stable=self.stable)
        return self._merge(out), cache

    def decode(self, x_t, cache: KVCache, offset: int, *, rotary=None,
               static_mask=None, use_kernel=None):
        """One-token step at position ``offset``: append, then attend to
        positions 0..offset (the mask row is row ``offset``). ``use_kernel``
        pins the attend (``cached_attend``: False is the dense formula)."""
        q, k, v = self._split(x_t)
        if rotary is not None:
            rot = rotary[offset:offset + 1][None, None]
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        cache.append(k, v, offset)
        out = cached_attend(q, cache, offset + 1, static_mask=static_mask,
                            stable=self.stable, qpos=offset, use_kernel=use_kernel)
        return self._merge(out), cache

    def decode_window(self, x_w, cache, offsets, *, rotary=None, use_kernel=None):
        """``w`` tokens per row at PER-ROW positions ``offsets[b] ..
        offsets[b]+w-1`` (host (b,) offsets or a ``WindowPlan``): append
        them (a dense ``KVCache`` or a ``PagedKVCache``), then attend through
        ``cached_attend_window`` (K3 or K5; the dense formula under
        ``use_kernel=False``). Rotary rows come from the full table at each
        (row, slot), clamped into it. Full attention only."""
        plan = (offsets if isinstance(offsets, WindowPlan)
                else cache.window_plan(offsets, x_w.shape[1]))
        q, k, v = self._split(x_w)
        if rotary is not None:
            rot = plan.rotary_rows(rotary)
            q, k, v = (apply_rotary(rot, t) for t in (q, k, v))
        cache.append_rows(k, v, plan)
        # q is a strided view of the projection when rotary is off
        out = cached_attend_window(q.contiguous(), cache, plan.starts,
                                   stable=self.stable, use_kernel=use_kernel)
        return self._merge(out), cache


class ShiftState(NamedTuple):
    """Ring buffers for cached token-shift decode: the (top, left)
    quarter-chunks of the last ``image_size`` *pre-shift* inputs, and the
    latest token's pre-shift first half (the text shift's source)."""
    top: torch.Tensor    # (b, image_size, d4)
    left: torch.Tensor   # (b, image_size, d4)
    prev: torch.Tensor   # (b, 2·d4)

    @classmethod
    def init(cls, batch: int, image_size: int, d4: int, dtype=torch.float32,
             device=None) -> "ShiftState":
        z = torch.zeros((batch, image_size, d4), dtype=dtype, device=device)
        return cls(z, z.clone(), torch.zeros((batch, 2 * d4), dtype=dtype, device=device))


def shift_tokens_full(x: torch.Tensor, text_len: int, image_size: int) -> torch.Tensor:
    """Token shift over a full (b, n, d) sequence: text positions take their
    first half of channels from position t−1; image positions their first
    quarter from the grid neighbour above and the second from the one to the
    left (zeros off the grid)."""
    b, n, d = x.shape
    if n < text_len:   # no image tokens yet: shift text only
        half, rest = x.chunk(2, dim=-1)
        half = F.pad(half, (0, 0, 1, 0))[:, :n]
        return torch.cat((half, rest), dim=-1)
    img_len = n - text_len
    x_text, x_img = x[:, :text_len], x[:, text_len:]
    t_shift, t_pass = x_text.chunk(2, dim=-1)
    t_shift = F.pad(t_shift, (0, 0, 1, 0))[:, :text_len]
    x_text = torch.cat((t_shift, t_pass), dim=-1)
    pad_to = image_size * image_size - img_len
    xi = F.pad(x_img, (0, 0, 0, pad_to)).reshape(b, image_size, image_size, d)
    d4 = d // 4
    top, left, rest = xi[..., :d4], xi[..., d4:2 * d4], xi[..., 2 * d4:]
    top = F.pad(top, (0, 0, 0, 0, 1, 0))[:, :image_size]
    left = F.pad(left, (0, 0, 1, 0))[:, :, :image_size]
    xi = torch.cat((top, left, rest), dim=-1)
    x_img = xi.reshape(b, image_size * image_size, d)[:, :img_len]
    return torch.cat((x_text, x_img), dim=1)


def shift_prefill_state(x: torch.Tensor, text_len: int, image_size: int,
                        state: ShiftState) -> ShiftState:
    """The ring buffers after a full-prefix forward of pre-shift ``x``: the
    slots of the last image positions get their (top, left) chunks, text
    slots stay zero, ``prev`` is the last position's first half. Writes
    take the buffers' dtype."""
    b, n, d = x.shape
    d4 = d // 4
    prev = x[:, -1, :2 * d4].to(state.prev.dtype)
    img_len = max(n - text_len, 0)
    if img_len == 0:
        return ShiftState(state.top, state.left, prev)
    take = min(img_len, image_size)
    chunk = x[:, n - take:n]
    slots = torch.arange(n - take - text_len, n - text_len, device=x.device) % image_size
    top, left = state.top.clone(), state.left.clone()
    top[:, slots] = chunk[..., :d4].to(top.dtype)
    left[:, slots] = chunk[..., d4:2 * d4].to(left.dtype)
    return ShiftState(top, left, prev)


def shift_decode_step(x_t: torch.Tensor, state: ShiftState, offset: int, text_len: int,
                      image_size: int):
    """Cached one-token shift of (b, 1, d) pre-shift ``x_t`` at position
    ``offset``: a text position takes the previous token's first half, an
    image position the (top, left) neighbours' chunks from the rings (zero
    top on the first grid row, zero left at column 0). Returns (shifted x_t,
    new state); a text step leaves the image rings as they were."""
    d = x_t.shape[-1]
    d4 = d // 4
    d2 = 2 * d4
    cur = x_t[:, 0]
    prev = cur[..., :d2].to(state.prev.dtype)
    if offset < text_len:
        # cat promotes a bf16 state beside f32 activations, as jnp.concatenate
        shifted = torch.cat([state.prev, cur[..., d2:]], dim=-1)
        return shifted[:, None], ShiftState(state.top, state.left, prev)
    img_pos = offset - text_len
    ptr = img_pos % image_size
    # the top neighbour was written image_size steps ago: the current slot
    top_n = state.top[:, ptr]
    left_n = state.left[:, (ptr - 1) % image_size]
    if img_pos < image_size:
        top_n = torch.zeros_like(top_n)
    if img_pos % image_size == 0:
        left_n = torch.zeros_like(left_n)
    shifted = torch.cat([top_n, left_n, cur[..., d2:]], dim=-1)
    top, left = state.top.clone(), state.left.clone()
    top[:, ptr] = cur[..., :d4].to(top.dtype)
    left[:, ptr] = cur[..., d4:d2].to(left.dtype)
    return shifted[:, None], ShiftState(top, left, prev)


class TransformerLayer(nn.Module):
    """PreNorm(+sandwich norm) → optional token shift → a function the caller
    passes, scaled by LayerScale; the caller adds the residual. One instance
    per (depth, role); the function itself may be shared between depths."""

    def __init__(self, dim: int, index: int, sandwich: bool = False, *,
                 shift: bool = False, text_len: int = 0, image_size: int = 0):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_out = nn.LayerNorm(dim, eps=LN_EPS) if sandwich else None
        self.scale = nn.Parameter(
            torch.full((1, 1, dim), layerscale_init_eps(index)))
        self.shift, self.text_len, self.image_size = shift, text_len, image_size

    def post(self, y):
        if self.norm_out is not None:
            y = self.norm_out(y)
        return y * self.scale

    def pre(self, x):
        """The norm, then the full-sequence token shift."""
        y = self.norm(x)
        return shift_tokens_full(y, self.text_len, self.image_size) if self.shift else y

    def pre_prefill(self, x, state: Optional[ShiftState]):
        """``pre`` for a prefill: also the ring buffers from the pre-shift
        chunks. Returns (y, state)."""
        y = self.norm(x)
        if not self.shift:
            return y, state
        state = shift_prefill_state(y, self.text_len, self.image_size, state)
        return shift_tokens_full(y, self.text_len, self.image_size), state

    def pre_decode(self, x_t, state: Optional[ShiftState], offset: int):
        """``pre`` for one decode token at ``offset``. Returns (y, state)."""
        y = self.norm(x_t)
        if not self.shift:
            return y, state
        return shift_decode_step(y, state, offset, self.text_len, self.image_size)

    def forward(self, x, fn, **kw):
        return self.post(fn(self.pre(x), **kw))


class Transformer(nn.Module):
    """depth × (attn, ff) with the per-layer attention kind from the cyclic
    ``attn_types`` tuple, layer sharing, the rotary table and static masks."""

    def __init__(self, cfg: TransformerConfig, sp: int = 1):
        super().__init__()
        c = self.cfg = cfg
        self.sp = sp
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
        # structured specs for K1's tables and K4's schedules (the JAX
        # package's mask_specs), and the tables and schedules built from them
        # and the masks
        self._mask_specs: Dict[str, Optional[tuple]] = {}
        self._tables: Dict[Tuple[str, int, str], Optional[MaskTable]] = {}
        self._schedules: Dict[Tuple[str, int, str], FlashSchedule] = {}
        for ind, (mk, t) in enumerate(zip(self.mask_keys, types)):
            if mk in self._mask_buffers:
                continue
            if t == "full" or not c.causal:
                self._mask_buffers[mk] = None
                self._mask_specs[mk] = None
                continue
            m = build_mask(t, self.text_len, fmap, kernel_size=c.sparse_attn_kernel,
                           block=c.sparse_block_size,
                           num_random_blocks=c.sparse_num_random_blocks,
                           seed=c.sparse_mask_seed + ind)
            name = f"mask_{mk}"
            self.register_buffer(name, torch.from_numpy(m.astype("int32")),
                                 persistent=False)
            self._mask_buffers[mk] = name
            if t in ("axial_row", "axial_col"):
                self._mask_specs[mk] = ("axial", self.text_len, fmap,
                                        0 if t == "axial_row" else 1)
            elif t == "conv_like":
                self._mask_specs[mk] = ("conv", self.text_len, fmap,
                                        c.sparse_attn_kernel, 1)
            else:
                self._mask_specs[mk] = ("block", c.sparse_block_size)

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
                    stable=c.stable, softmax_f32=c.attn_softmax_f32,
                    dropout=c.attn_dropout))
            if not hasattr(self, f"ff_{fid}"):
                self.add_module(f"ff_{fid}", GEGLUFeedForward(c.dim, c.ff_mult,
                                                              c.ff_dropout))
            self.attn_names.append(f"attn_{aid}")
            self.ff_names.append(f"ff_{fid}")
            shift = dict(shift=c.shift_tokens, text_len=self.text_len, image_size=fmap)
            self.add_module(f"layer_attn_{ind}",
                            TransformerLayer(c.dim, ind + 1, c.sandwich_norm, **shift))
            self.add_module(f"layer_ff_{ind}",
                            TransformerLayer(c.dim, ind + 1, c.sandwich_norm, **shift))

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

    def fused_table(self, ind: int, n: int, device) -> Optional[MaskTable]:
        """Layer ``ind``'s K1 (and K8) visibility at length ``n`` on
        ``device`` (None for full attention), built on first use and kept."""
        mk = self.mask_keys[ind]
        key = (mk, n, str(device))
        if key not in self._tables:
            mask = self.static_mask(ind)
            self._tables[key] = mask_table(
                n, None if mask is None else mask.cpu().numpy(),
                self._mask_specs[mk], device)
        return self._tables[key]

    def flash_schedule(self, ind: int, n: int, device) -> FlashSchedule:
        """Layer ``ind``'s K4 schedule at length ``n`` on ``device``: block
        lists from its static mask, and its structured spec or else the mask
        as an int8 table; built on first use and kept."""
        mk = self.mask_keys[ind]
        key = (mk, n, str(device))
        if key not in self._schedules:
            mask = self.static_mask(ind)
            self._schedules[key] = flash_schedule(
                n, None if mask is None else mask.cpu().numpy(), self._mask_specs[mk],
                self.cfg.causal, device)
        return self._schedules[key]

    def _attn_branch(self, x, ind: int, key_mask, mode, drop=None):
        """Layer ``ind``'s attention residual branch on ``x``; ``drop`` its
        keep mask, or None."""
        la, attn, _, _, mask = self._layer(ind)
        n = x.shape[1]
        table = (self.fused_table(ind, n, x.device) if mode in ("fused", "persist")
                 else None)
        sched = self.flash_schedule(ind, n, x.device) if mode == "flash" else None
        ring = self.sp if mode == "ring" else 1
        return la(x, attn, key_mask=key_mask, rotary=self.rotary, static_mask=mask,
                  fused=mode == "fused", persist=mode == "persist", table=table,
                  flash=sched, ring=ring, ring_spec=self._mask_specs[self.mask_keys[ind]],
                  drop=drop)

    def _ff_branch(self, x, ind: int, drop=None):
        return getattr(self, f"layer_ff_{ind}")(x, getattr(self, self.ff_names[ind]), drop=drop)

    def _block(self, x, ind: int, key_mask, mode, drop=(None, None)):
        """One attn + ff residual pair (the unit ``use_remat`` recomputes);
        ``drop`` holds its two keep masks, or None."""
        x = x + self._attn_branch(x, ind, key_mask, mode, drop[0])
        return x + self._ff_branch(x, ind, drop[1])

    def reversible_blocks(self, key_mask=None, dropout_masks=None, mode=False):
        """The (f, g) pairs and their parameter tuples of the reversible
        coupling (``models/reversible.py``): f the attention branch and g
        the feed-forward branch of each layer, each closed over its dropout
        mask and reading its parameters from the modules."""
        fns, params = [], []
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, _ = self._layer(ind)
            drop = (None, None) if dropout_masks is None else dropout_masks[ind]

            def f(_p, h, _ind=ind, _drop=drop[0]):
                return self._attn_branch(h, _ind, key_mask, mode, _drop)

            def g(_p, h, _ind=ind, _drop=drop[1]):
                return self._ff_branch(h, _ind, _drop)

            fns.append((f, g))
            params.append((tuple(la.parameters()) + tuple(attn.parameters()),
                           tuple(lf.parameters()) + tuple(ff.parameters())))
        return fns, params

    def attention_mode(self, device, key_mask=None):
        """The resolved full-sequence mode on ``device``: "ring" whenever
        ``sp`` > 1 (before any kernel setting, as in the JAX package), else
        "fused", "flash", "persist" or False. A key mask takes the dense
        path, and K1 and K8 take only causal layers without the stable
        softmax."""
        c = self.cfg
        if self.sp > 1:
            return "ring"
        mode = resolve_use_pallas(c.use_pallas, c.seq_len, device, c.dim_head)
        if key_mask is not None or (mode in ("fused", "persist")
                                    and (not c.causal or c.stable)):
            return False
        return mode

    def dropout_masks(self, batch: int, n: int, generator: Optional[torch.Generator],
                      device) -> Optional[List[Tuple[Optional[torch.Tensor],
                                                     Optional[torch.Tensor]]]]:
        """Every layer's (attention, feed-forward) keep masks for a (batch,
        n) forward, drawn from ``generator`` layer by layer, attention
        first: True with probability 1 - p (flax's ``bernoulli(keep)``),
        None where p = 0. None when the model has no dropout."""
        c = self.cfg
        if c.attn_dropout <= 0 and c.ff_dropout <= 0:
            return None

        def keep(rate, width):
            if rate <= 0:
                return None
            return torch.rand((batch, n, width), generator=generator,
                              device=device) < 1.0 - rate
        return [(keep(c.attn_dropout, c.dim), keep(c.ff_dropout, c.dim * c.ff_mult))
                for _ in range(c.depth)]

    def forward(self, x, key_mask=None, dropout_masks=None, reversible_naive: bool = False):
        """The full-sequence forward; ``dropout_masks`` (``dropout_masks``'s
        form) switches dropout on. A ``reversible`` model runs the coupling
        of ``models/reversible.py`` (``reversible_naive``: through
        autograd's stored activations, the oracle) and ignores
        ``use_remat``, as the JAX package does."""
        c = self.cfg
        mode = self.attention_mode(x.device, key_mask)
        if c.reversible:
            fns, params = self.reversible_blocks(key_mask, dropout_masks, mode)
            return run_reversible(fns, params, x, naive=reversible_naive)
        remat = c.use_remat and torch.is_grad_enabled()
        for ind in range(c.depth):
            drop = (None, None) if dropout_masks is None else dropout_masks[ind]
            if remat:
                x = checkpoint(self._block, x, ind, key_mask, mode, drop,
                               use_reentrant=False)
            else:
                x = self._block(x, ind, key_mask, mode, drop)
        return x

    # -- cached decode -----------------------------------------------------
    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   dtype=torch.float32) -> Dict[str, Any]:
        """Every layer's ``KVCache`` (``kv_{i}``) and, with token shift, its
        two ``ShiftState``s (``shift_attn_{i}``, ``shift_ff_{i}``). An int8
        cache quantizes the KV storage only: the rings hold raw hidden
        slices and are bf16 beside it."""
        c = self.cfg
        device = self.layer_attn_0.scale.device
        cache: Dict[str, Any] = {}
        shift_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
        for ind in range(c.depth):
            cache[f"kv_{ind}"] = KVCache.init(batch, c.heads, max_seq or c.seq_len + 1,
                                              c.dim_head, dtype, device=device)
            if c.shift_tokens:
                for role in ("attn", "ff"):
                    cache[f"shift_{role}_{ind}"] = ShiftState.init(
                        batch, c.image_fmap_size, c.dim // 4, shift_dtype, device=device)
        return cache

    def init_cache_paged(self, num_blocks: int, block_tokens: int, max_seq: int,
                         dtype=torch.float32) -> Dict[str, PagedKVCache]:
        """Paged twin of ``init_cache``: one block pool per layer. The page
        table is the serve engine's, bound to every layer (``bind``)."""
        c = self.cfg
        device = self.layer_attn_0.scale.device
        return {f"kv_{ind}": PagedKVCache.init(num_blocks, block_tokens, c.heads,
                                               max_seq, c.dim_head, dtype, device=device)
                for ind in range(c.depth)}

    def prefill(self, x, cache: Dict[str, Any], *, use_kernel=None):
        """Run the full prefix, filling every layer's caches; ``use_kernel``
        as in ``Attention.prefill``. Returns (y, cache)."""
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, mask = self._layer(ind)
            y = self._shifted(cache, f"shift_attn_{ind}", la.pre_prefill, x)
            y, _ = attn.prefill(y, cache[f"kv_{ind}"], rotary=self.rotary, static_mask=mask,
                                use_kernel=use_kernel)
            x = x + la.post(y)
            x = x + lf.post(ff(self._shifted(cache, f"shift_ff_{ind}", lf.pre_prefill, x)))
        return x, cache

    def decode_step(self, x_t, cache: Dict[str, Any], offset: int, *,
                    use_kernel=None):
        """One token at position ``offset``; ``use_kernel`` pins every
        layer's attend (``cached_attend``). Returns (y_t, cache)."""
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, mask = self._layer(ind)
            y = self._shifted(cache, f"shift_attn_{ind}", la.pre_decode, x_t, offset)
            y, _ = attn.decode(y, cache[f"kv_{ind}"], offset, rotary=self.rotary,
                               static_mask=mask, use_kernel=use_kernel)
            x_t = x_t + la.post(y)
            y = self._shifted(cache, f"shift_ff_{ind}", lf.pre_decode, x_t, offset)
            x_t = x_t + lf.post(ff(y))
        return x_t, cache

    @staticmethod
    def _shifted(cache: Dict[str, Any], key: str, pre, x, *args):
        """``pre(x, cache[key], *args)``: the normed (and shifted) input, the
        layer's new shift state stored back under ``key`` when it has one."""
        y, state = pre(x, cache.get(key), *args)
        if state is not None:
            cache[key] = state
        return y

    def decode_window(self, x_w, cache: Dict[str, Any], offsets, *,
                      use_kernel=None):
        """w tokens per row at per-row positions ``offsets`` ((b,) on the
        host, or a ``WindowPlan``): the serve engine's refill windows, prefill
        chunks and decode steps, and the speculative verify. One
        ``WindowPlan`` serves every layer; ``use_kernel`` pins every layer's
        attend (``cached_attend_window``). Full attention and no token shift
        (the JAX package's errors). Returns (y_w, cache)."""
        if self.cfg.shift_tokens:
            raise ValueError("speculative decode does not support shift_tokens")
        if any(m != "full" for m in self.mask_keys):
            raise ValueError("speculative decode supports full attention only, got "
                             f"{sorted(set(self.mask_keys))}")
        plan = (offsets if isinstance(offsets, WindowPlan)
                else cache["kv_0"].window_plan(offsets, x_w.shape[1]))
        for ind in range(self.cfg.depth):
            la, attn, lf, ff, _ = self._layer(ind)
            y, _ = attn.decode_window(la.norm(x_w), cache[f"kv_{ind}"], plan,
                                      rotary=self.rotary, use_kernel=use_kernel)
            x_w = x_w + la.post(y)
            x_w = x_w + lf(x_w, ff)
        return x_w, cache
