"""Paged KV storage: a block pool shared by every serve slot.

Port of ``dalle_tpu/ops/paged_kv.py``. The dense per-slot slab
(``ops/attention.KVCache``, one private (max_seq, 2hd) stripe per slot)
becomes a fixed pool of ``block_tokens``-position blocks, addressed through a
``(B, max_blocks)`` int32 page table (-1 = unmapped). The serve engine owns
the table: it binds one host copy and one device copy to every layer
(``bind``) after each admission pass.

Reads go to K5 (``ops/decode_attention.decode_attend_window_paged``), which
follows the page table inside the kernel and computes exactly what K3
computes on the gathered slab (``gather_dense``): every request's tokens are
bitwise those of the dense engine. Unmapped positions read as zeros, the
dense slab's never-written value.

Writes land in place, as the port's ``KVCache.append`` does. A block is
written by at most one row (shared radix blocks are read-only; the engine
copy-on-write forks a block before a row writes into it), and positions of
unmapped pages or at/after ``max_seq`` (a parked row) are dropped. int8
pools page their f32 scales with the blocks, sequence-major per block, so a
block copy moves rows and scales with the same index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import to_device
from .attention import KVCache, WindowPlan, window_rows


class PagedKVCache:
    """One attention layer's block-pool KV store.

    ``pool``: (num_blocks, block_tokens, 2·h·d), K in the first h·d lanes.
    ``scale``: (num_blocks, block_tokens, 2h) f32 (int8 storage only).
    ``pages`` / ``pages_host``: the bound (b, max_blocks) int32 page table on
    the pool's device and on the host. ``max_seq``: the logical length every
    read covers, also the park offset."""

    def __init__(self, pool: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
                 heads: int = 1, block_tokens: int = 16, max_seq: int = 1):
        self.pool = pool
        self.scale = scale
        self.heads = heads
        self.block_tokens = block_tokens
        self.max_seq = max_seq
        self.pages: Optional[torch.Tensor] = None
        self.pages_host: Optional[np.ndarray] = None

    @classmethod
    def init(cls, num_blocks: int, block_tokens: int, heads: int, max_seq: int,
             dim_head: int, dtype=torch.float32, device=None) -> "PagedKVCache":
        z = torch.zeros((num_blocks, block_tokens, 2 * heads * dim_head),
                        dtype=dtype, device=device)
        s = None
        if dtype == torch.int8:
            s = torch.zeros((num_blocks, block_tokens, 2 * heads),
                            dtype=torch.float32, device=device)
        return cls(z, s, heads=heads, block_tokens=block_tokens, max_seq=max_seq)

    @property
    def num_blocks(self) -> int:
        return self.pool.shape[0]

    def bind(self, pages_host: np.ndarray, pages: Optional[torch.Tensor] = None
             ) -> "PagedKVCache":
        """Bind the page table: ``pages_host`` (b, max_blocks) int32 and its
        device copy (uploaded here when not given). Returns self."""
        pages_host = np.asarray(pages_host, np.int32)
        if pages_host.shape[1] * self.block_tokens < self.max_seq:
            raise ValueError(f"{pages_host.shape[1]} pages of {self.block_tokens} "
                             f"cannot cover max_seq {self.max_seq}")
        self.pages_host = pages_host
        self.pages = pages if pages is not None else to_device(pages_host, self.pool.device)
        return self

    # -- write path --------------------------------------------------------
    def window_plan(self, offsets, w: int) -> WindowPlan:
        """The plan of a window of ``w`` positions per row at the host
        ``offsets``: each position's flat pool row, dropped (-1) for an
        unmapped page or a position outside [0, max_seq)."""
        if self.pages_host is None:
            raise RuntimeError("PagedKVCache needs its page table bound (bind)")
        bt, pages = self.block_tokens, self.pages_host

        def targets(pos):
            blk = np.clip(pos // bt, 0, pages.shape[1] - 1)
            page = np.take_along_axis(pages, blk, axis=1).astype(np.int64)
            valid = (pos >= 0) & (pos < self.max_seq) & (page >= 0)
            return np.where(valid, page * bt + pos % bt, -1)

        return WindowPlan(offsets, w, targets, self.pool.device)

    def append_rows(self, k_new: torch.Tensor, v_new: torch.Tensor,
                    offsets) -> "PagedKVCache":
        """Write (b,h,w,d) keys/values at per-row positions ((b,) host
        offsets or a ``WindowPlan``) through the page table, in place.
        Returns self."""
        plan = (offsets if isinstance(offsets, WindowPlan)
                else self.window_plan(offsets, k_new.shape[2]))
        rows, sc = window_rows(k_new, v_new, self.pool.dtype)
        n = self.num_blocks * self.block_tokens
        self.pool.view(n, -1).index_copy_(0, plan.dst, rows[plan.src])
        if sc is not None:
            self.scale.view(n, -1).index_copy_(0, plan.dst, sc[plan.src])
        return self

    # -- read path ---------------------------------------------------------
    def gather_dense(self) -> KVCache:
        """The dense (b, max_seq, 2hd) slab view through the bound page table;
        unmapped positions fill with 0."""
        if self.pages is None:
            raise RuntimeError("PagedKVCache needs its page table bound (bind)")
        bt, n = self.block_tokens, self.num_blocks * self.block_tokens
        pos = torch.arange(self.max_seq, device=self.pool.device)
        page = self.pages.long()[:, pos // bt]                     # (b, max_seq)
        valid = (page >= 0)[..., None]
        flat = torch.where(page >= 0, page * bt + pos % bt, 0)
        kv = torch.where(valid, self.pool.view(n, -1)[flat],
                         torch.zeros((), dtype=self.pool.dtype, device=self.pool.device))
        scale = None
        if self.scale is not None:
            scale = torch.where(valid, self.scale.view(n, -1)[flat], 0.0)
            scale = scale.transpose(1, 2).contiguous()
        return KVCache(kv, scale, heads=self.heads)

    # -- block ops (driven by the engine) ----------------------------------
    def copy_blocks(self, src, dst) -> "PagedKVCache":
        """Copy-on-write fork: pool[dst[i]] = pool[src[i]], scales with their
        blocks. ``src``/``dst`` are host index arrays; a lane whose dst lies
        outside the pool is dropped. Returns self."""
        src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        keep = (dst >= 0) & (dst < self.num_blocks)
        if not keep.any():
            return self
        idx = to_device(np.concatenate([src[keep], dst[keep]]), self.pool.device)
        s, d = idx[:keep.sum()], idx[keep.sum():]
        self.pool.index_copy_(0, d, self.pool[s])
        if self.scale is not None:
            self.scale.index_copy_(0, d, self.scale[s])
        return self
