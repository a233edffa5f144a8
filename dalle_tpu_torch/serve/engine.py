"""Slot-based continuous-batching decode engine (Orca-style iteration-level
scheduling, Yu et al., OSDI '22).

Port of ``dalle_tpu/serve/engine.py``. A fixed batch of B decode slots
shares one KV cache, a dense slab or (``kv_block_tokens > 0``) a paged block
pool behind a radix prefix cache. Each slot carries its own prompt, cache
offset, decode length and draw source. When a row emits its last image
token, the next iteration refills it from the ``RequestQueue`` by
prefilling the new prompt at that row; the other rows keep decoding.

The JAX engine's jitted device programs are plain eager methods here:
``_refill`` (a multi-row prefill window), ``_refill_row`` (a b=1 prefill
copied into one row), ``_refill_shared`` (one prefill copied into a
shared-prefix cohort), ``_refill_chunk`` (one bounded window of a chunked
or paged prefill), ``_cow_copy`` (copy-on-write block forks) and ``_step``
(sample one token per slot, then decode it). Every dispatch except the
b=1 prefills goes through ``DALLE.serve_*`` → ``Transformer.decode_window``
→ ``cached_attend_window``: K3 on a dense slab, K5 on a paged pool. The
per-row scalars (positions, lengths, activity, CFG pairing) live on the
host, so each dispatch uploads one small plan and reads nothing back; a
step's tokens come back in one read per ``steps_per_sync`` steps.

Randomness: every occupied slot owns a ``torch.Generator`` on the engine's
device seeded with its request's seed, and draws (1, V) once per token the
row emits (a CFG pair's null row is seeded alike, so both rows draw the
same). So at f32 compute a request's tokens are those of the port's
sequential ``generate_images_tokens(text[None], generator=torch.Generator(dev)
.manual_seed(seed))``, in any admission order; in the bf16 modes a near-tie
may flip one (``DalleWithVae.serve_engine``). ``noise_fn(seed, t) -> (V,)``
replaces the generators with an injected draw for token t (the tests feed
the JAX engine's draws through it).

Not ported: ``decode_health`` and ``topk_approx`` (raise
``NotImplementedError``), the AOT executables (``install_executables``;
CUDA-graph capture is its counterpart), the obs spans, gauges and events,
and the chaos step hook. The JAX engine's ``use_kernel`` knob has no
counterpart: the card always runs the kernels, the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..models.dalle import DALLE
from ..ops.sampling import gumbel_sample_rows, row_noise
from .paged import BlockPool, RadixCache
from .queue import CompletedRequest, Request, RequestQueue
from .scheduler import SlotScheduler


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    refills: int = 0
    # shared-prefix admissions: cohorts of one group admitted together pay
    # ONE text prefill; ``shared_prefills_saved`` counts the (N-1) per cohort
    shared_refills: int = 0
    shared_prefills_saved: int = 0
    # chunked-prefill dispatches (prefill_chunk > 0, and every paged suffix)
    prefill_chunks: int = 0
    # dispatches that attend through Transformer.decode_window (decode
    # steps with a decoding row, refill windows, prefill chunks): each runs
    # the windowed kernel once per layer
    window_dispatches: int = 0
    # wall seconds of the decode steps, host reads of their tokens included
    step_seconds: float = 0.0
    # running mean of occupancy at iterations where the queue still held work
    occupancy_sum: float = 0.0
    occupancy_n: int = 0
    # paged-KV ledger: radix prefix-cache outcomes, COW forks, evictions
    radix_full_hits: int = 0
    radix_partial_hits: int = 0
    radix_misses: int = 0
    prefix_hit_tokens: int = 0
    cow_forks: int = 0
    pages_evicted: int = 0
    # request ids still mid-decode when a max_steps bound tripped
    aborted_in_flight: List[int] = dataclasses.field(default_factory=list)

    def sample_occupancy(self, value: float) -> None:
        self.occupancy_sum += float(value)
        self.occupancy_n += 1

    @property
    def occupancy_while_queued(self) -> float:
        if not self.occupancy_n:
            return 1.0
        return self.occupancy_sum / self.occupancy_n


@dataclasses.dataclass
class _ChunkJob:
    """One in-flight chunked-prefill admission (prefill_chunk > 0): the
    remapped prompt ids of the rows admitted together, dispatched one
    bounded window per engine iteration."""
    ids: np.ndarray        # (B, prefix_len) remapped+bos'd full-vocab ids
    seeds: np.ndarray      # (B,)
    n_rows: np.ndarray     # (B,)
    mask: np.ndarray       # (B,) bool
    pairs: list            # [(slot, Request)]
    start: int = 0         # next chunk's first position


class DecodeEngine:
    """Continuous-batching image-token decode over a DALLE model.

    ``slots``: the batch B. ``cache_dtype``: KV storage (float32, bfloat16
    or int8); the model's own compute dtype (``DALLE.compute_dtype``) is
    the engine's, int8 weights (``quantize_params_int8``) included. Sampling knobs
    mirror ``generate_images_tokens``. ``device``: where the engine runs, the
    CUDA card unless the caller passes "cpu"; the model must be there."""

    def __init__(self, model: DALLE, *, slots: int, cache_dtype=torch.float32,
                 filter_thres: float = 0.5, temperature: float = 1.0,
                 topk_approx: bool = False, steps_per_sync: int = 1,
                 decode_health: bool = False, prefill_chunk: int = 0,
                 kv_block_tokens: int = 0, kv_pool_blocks: Optional[int] = None,
                 radix_cache: bool = True,
                 noise_fn: Optional[Callable[[int, int], object]] = None,
                 device=None):
        c = model.cfg
        attn_types = tuple(c.attn_types) or ("full",)
        if any(t != "full" for t in attn_types) or c.shift_tokens:
            raise ValueError(
                "the serve engine requires full attention and "
                f"shift_tokens=False (got attn_types={attn_types}, "
                f"shift_tokens={c.shift_tokens})")
        if decode_health:
            raise NotImplementedError("decode_health needs obs/health.py, not ported yet")
        if topk_approx:
            raise NotImplementedError("topk_approx (approx_max_k) is a TPU unit; "
                                      "the port samples with the exact top-k")
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type or want.index not in (None, self.device.index):
            raise ValueError(f"the model is on {self.device}, the engine asked for {want}")
        self.model = model
        self.slots = int(slots)
        self.cache_dtype = cache_dtype
        self.filter_thres = filter_thres
        self.temperature = temperature
        self.noise_fn = noise_fn

        self.text_seq_len = c.text_seq_len
        self.prefix_len = c.text_seq_len + 1          # <bos> + text
        self.n_steps = c.image_seq_len
        self.park = c.total_seq_len                   # cache max_seq
        self.num_text_tokens = c.num_text_tokens + c.text_seq_len
        # multi-step scheduling: K decode steps per host read of the tokens.
        # A freed slot waits up to K-1 steps for its refill; tokens do not
        # change.
        assert steps_per_sync >= 1
        self.steps_per_sync = int(steps_per_sync)
        self.row_len = c.image_fmap_size

        # chunked prefill: window and trickle admissions of prompts longer
        # than prefill_chunk dispatch as bounded chunks with decode steps in
        # between (0 = one-shot windows). Chunked tokens equal unchunked.
        assert prefill_chunk >= 0
        self.prefill_chunk = int(prefill_chunk)

        # paged KV: kv_block_tokens > 0 swaps the dense per-slot slab for a
        # shared block pool + (B, max_blocks) page table; admission walks the
        # radix tree, maps resident blocks, COW-forks the divergent tail and
        # prefills only the miss suffix in block-width chunks
        assert kv_block_tokens >= 0
        self.kv_block_tokens = int(kv_block_tokens)
        self.paged = self.kv_block_tokens > 0
        self.radix_cache = bool(radix_cache)
        if self.paged:
            if self.prefill_chunk:
                raise ValueError(
                    "kv_block_tokens and prefill_chunk are mutually "
                    "exclusive: paged admission already dispatches prefill "
                    "in block-width chunks")
            bt = self.kv_block_tokens
            self.max_blocks = -(-self.park // bt)      # blocks per slot
            pool_blocks = (int(kv_pool_blocks) if kv_pool_blocks
                           else self.slots * self.max_blocks)
            # the largest admission unit (a CFG pair = two full rows) must
            # fit the pool outright
            min_need = self.max_blocks * (2 if self.slots >= 2 else 1)
            if pool_blocks < min_need:
                raise ValueError(
                    f"kv_pool_blocks={pool_blocks} cannot hold one "
                    f"admission unit ({min_need} blocks of {bt} tokens)")
            self.kv_pool_blocks = pool_blocks
        else:
            self.max_blocks = 0
            self.kv_pool_blocks = 0
        self.stats = EngineStats()
        self.block_pool: Optional[BlockPool] = None
        self.radix: Optional[RadixCache] = None

    # -- device state --------------------------------------------------------
    def _init_state(self) -> None:
        B = self.slots
        if self.paged:
            self.cache = self.model.serve_init_cache_paged(
                self.kv_pool_blocks, self.kv_block_tokens, self.cache_dtype)
            self._pages_host = np.full((B, self.max_blocks), -1, np.int32)
            self._bind_pages()
        else:
            self.cache = self.model.serve_init_cache(B, self.cache_dtype)
        # the logits keep the dtype the model emits (bf16 and int8 weights
        # emit bf16)
        dtype = self.model.compute_dtype
        self.logits = torch.zeros((B, self.model.total_tokens), dtype=dtype,
                                  device=self.device)
        # parked until admitted
        self._t_idx = np.full((B,), self.n_steps, np.int64)
        self._n_row = np.full((B,), self.n_steps, np.int64)
        self._active = np.zeros((B,), bool)
        self._sources: List[object] = [None] * B

    def _bind_pages(self) -> None:
        """Upload the host page table once and bind it to every layer."""
        host = self._pages_host.copy()
        dev = to_device(host, self.device)
        for c in self.cache.values():
            c.bind(host, dev)

    def _source(self, seed: int):
        if self.noise_fn is not None:
            return int(seed)
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _activate(self, rows, seeds, n_rows, logits) -> None:
        """Rows turn active: their first-token logits ((len(rows), V), or
        (1, V) for all), fresh draw sources, step 0."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self.logits[to_device(rows, self.device)] = logits.to(self.logits.dtype)
        for r in rows:
            self._sources[r] = self._source(seeds[r])
        self._t_idx[rows] = 0
        self._n_row[rows] = np.asarray(n_rows)[rows]
        self._active[rows] = True

    # -- device dispatches -------------------------------------------------
    @torch.no_grad()
    def _refill(self, texts, seeds, n_rows, mask) -> None:
        logits_r, self.cache = self.model.serve_refill(texts, self.cache, mask)
        self.stats.window_dispatches += 1
        rows = np.flatnonzero(mask)
        self._activate(rows, seeds, n_rows, logits_r[to_device(rows, self.device)])

    @torch.no_grad()
    def _refill_row(self, text1, seed: int, n_tok: int, row: int) -> None:
        """Admit ONE request into slot ``row``: a b=1 prefill (the
        sequential ``_prefill``) copied into the shared cache."""
        logits1, cache1 = self.model.serve_prefill_row(text1, self.cache_dtype)
        for name, small in cache1.items():
            big = self.cache[name]
            big.kv[row] = small.kv[0]
            if big.scale is not None:
                big.scale[row] = small.scale[0]
        seeds = np.zeros((self.slots,), np.int64)
        seeds[row] = seed
        n_rows = np.full((self.slots,), self.n_steps, np.int64)
        n_rows[row] = n_tok
        self._activate([row], seeds, n_rows, logits1)

    @torch.no_grad()
    def _refill_shared(self, text1, seeds, n_rows, mask) -> None:
        """Shared-prefix admission: one b=1 prefill copied into every masked
        row, each row with its own seed."""
        logits1, self.cache = self.model.serve_refill_shared(
            text1, self.cache, mask, self.cache_dtype)
        self._activate(np.flatnonzero(mask), seeds, n_rows, logits1)

    @torch.no_grad()
    def _refill_chunk(self, ids_chunk, start: int, seeds, n_rows, mask,
                      last: bool) -> None:
        """One bounded window of a chunked prefill at [start, start+w) of the
        masked rows; rows turn active only on the final chunk."""
        logits_r, self.cache = self.model.serve_refill_window(
            ids_chunk, self.cache, mask, int(start))
        self.stats.window_dispatches += 1
        if last:
            rows = np.flatnonzero(mask)
            self._activate(rows, seeds, n_rows, logits_r[to_device(rows, self.device)])

    @torch.no_grad()
    def _cow_copy(self, src, dst) -> None:
        """Copy-on-write forks in every layer's pool: pool[dst] = pool[src]
        (lanes with an out-of-pool dst do nothing)."""
        for c in self.cache.values():
            c.copy_blocks(src, dst)

    def _cfg_merge(self, img: torch.Tensor) -> torch.Tensor:
        """Classifier-free guidance on paired rows: both rows of a pair sample
        from ``null + (cond - null) * cond_scale``, the sequential path's
        expression in the logits' dtype with the scale as a Python float.
        Rows with cond_scale 1 keep their logits untouched."""
        if (self._cfg_host == 1.0).all():
            return img
        out, merged = img.clone(), {}
        for r in np.flatnonzero(self._cfg_host != 1.0):
            c = int(self._pair_host[r]) if self._uncond_host[r] else int(r)
            if c not in merged:
                n = int(self._pair_host[c])
                merged[c] = img[n] + (img[c] - img[n]) * float(self._cfg_host[c])
            out[r] = merged[c]
        return out

    @torch.no_grad()
    def _step(self):
        """Sample one token per active slot, then decode the rows that go on.
        Returns (tokens (B,) on the device, finished (B,) host bool)."""
        B = self.slots
        t_idx, n_row, active = self._t_idx, self._n_row, self._active
        j = np.minimum(t_idx, n_row - 1)
        final = j == n_row - 1
        decode_rows = active & ~final
        finished = active & final
        if not active.any():
            return torch.zeros((B,), dtype=torch.long, device=self.device), finished
        offsets = np.where(decode_rows, self.prefix_len + j, self.park)
        sources = [None] * B
        for s in np.flatnonzero(active):
            src = self._sources[s]
            sources[s] = self.noise_fn(src, int(j[s])) if self.noise_fn is not None else src
        noise = row_noise(sources, self.model.cfg.image_vocab_size, self.device)
        img = self._cfg_merge(self.logits[:, self.num_text_tokens:])
        tok = gumbel_sample_rows(img, noise, thres=self.filter_thres,
                                 temperature=self.temperature)
        if decode_rows.any():
            new_logits, self.cache = self.model.serve_decode(tok, j, offsets, self.cache)
            self.stats.window_dispatches += 1
            rows = to_device(np.flatnonzero(decode_rows), self.device)
            self.logits[rows] = new_logits[rows]
        self._t_idx = np.where(active, t_idx + 1, t_idx)
        self._active = decode_rows
        return tok, finished

    def _multi_step(self):
        """steps_per_sync × _step, then one host read: (K, B) tokens and
        finished flags."""
        toks, fins = [], []
        for _ in range(self.steps_per_sync):
            tok, fin = self._step()
            toks.append(tok)
            fins.append(fin)
        return torch.stack(toks).cpu().numpy(), np.stack(fins)

    # -- host loop ---------------------------------------------------------
    def _pad_text(self, text: np.ndarray) -> np.ndarray:
        out = np.zeros((self.text_seq_len,), np.int32)
        n = min(len(text), self.text_seq_len)
        out[:n] = text[:n]
        return out

    def _n_tokens(self, req: Request) -> int:
        if req.max_tokens is None:
            return self.n_steps
        return int(np.clip(req.max_tokens, 1, self.n_steps))

    def _remap_bos_host(self, texts: np.ndarray) -> np.ndarray:
        """Host-side ``remap_and_bos`` for the chunked-prefill path: 0-pads →
        unique per-position pad ids, <bos>=0 prepended."""
        B, T = texts.shape
        pad_ids = (np.arange(T, dtype=np.int32)
                   + np.int32(self.num_text_tokens - self.text_seq_len))
        out = np.where(texts == 0, pad_ids[None, :], texts).astype(np.int32)
        return np.concatenate([np.zeros((B, 1), np.int32), out], axis=1)

    # -- admission units (CFG pairing + paged planning) --------------------
    def _expand_unit(self, req: Request) -> List[Request]:
        """One row normally, two for cond_scale != 1.0: the request plus a
        synthetic null-text partner (negative request_id, never surfaced)
        with the same seed."""
        if req.cond_scale == 1.0:
            return [req]
        if self.slots < 2:
            raise ValueError(
                "cond_scale != 1.0 needs an engine with slots >= 2 (the "
                "CFG pair occupies two decode slots)")
        null = dataclasses.replace(
            req, request_id=-req.request_id - 1,
            text=np.zeros_like(np.asarray(req.text)),
            group_id=None, group_size=1, group_index=0)
        return [req, null]

    def _take_units(self, queue, n_free: int):
        """Deferred units first (strict FIFO), then fresh queue takes,
        expanded into units. Returns (placeable units, requests taken)."""
        units = self._overflow
        self._overflow = []
        taken = 0
        have = sum(len(u) for u in units)
        if have < n_free:
            for req in queue.take(n_free - have):
                taken += 1
                units.append(self._expand_unit(req))
        placed, rows = [], 0
        for i, u in enumerate(units):
            if rows + len(u) > n_free:
                self._overflow = units[i:]
                break
            placed.append(u)
            rows += len(u)
        return placed, taken

    def _set_pair_state(self, pairs_u) -> None:
        """The CFG pairing of one admitted unit."""
        if len(pairs_u) == 2:
            (cs, creq), (ns, _) = pairs_u
            self._pair_host[cs], self._pair_host[ns] = ns, cs
            self._cfg_host[cs] = self._cfg_host[ns] = creq.cond_scale
            self._uncond_host[cs], self._uncond_host[ns] = False, True
        else:
            slot = pairs_u[0][0]
            self._pair_host[slot] = slot
            self._cfg_host[slot] = 1.0
            self._uncond_host[slot] = False

    # -- paged admission ---------------------------------------------------
    def _plan_row(self, req: Request) -> dict:
        """Radix-match one row's prompt and size its block demand: the blocks
        it can map, the block it must COW-fork (full hit) and the fresh
        blocks for the unmatched suffix and its decode tokens. Written
        positions span [0, prefix_len + n_tok - 1)."""
        bt = self.kv_block_tokens
        ids = self._remap_bos_host(self._pad_text(req.text)[None])[0]
        key = tuple(int(x) for x in ids)
        n_tok = self._n_tokens(req)
        total = -(-(self.prefix_len + n_tok - 1) // bt)
        pr = {"req": req, "key": key, "ids": ids, "n_tok": n_tok,
              "shared": [], "fork_src": None, "fresh_n": total,
              "full": False, "hit_tok": 0, "match": None}
        if not self.radix_cache:
            return pr
        # record=False: a deferred unit is re-planned every retry; the
        # ledger commits once, in _plan_unit, when the unit admits
        m = self.radix.match(key, record=False)
        pr["match"] = m
        if m.full:
            # the block holding position prefix_len-1 is forked before the
            # width-1 logits recompute rewrites it
            shared = list(m.blocks) if self.prefix_len % bt else \
                list(m.blocks[:-1])
            pr.update(shared=shared, fork_src=m.tail_block,
                      fresh_n=total - len(shared), full=True,
                      hit_tok=m.hit_tokens)
        elif m.blocks:
            pr.update(shared=list(m.blocks),
                      fresh_n=total - len(m.blocks), hit_tok=m.hit_tokens)
        return pr

    def _plan_unit(self, unit) -> Optional[dict]:
        """Block feasibility for one admission unit, atomically: retain what
        the unit reads, evict radix-only leaves for the rest, allocate every
        block the unit will write. None (retains rolled back) when the pool
        cannot cover it."""
        pool = self.block_pool
        rows = [self._plan_row(r) for r in unit]
        retained = []
        for pr in rows:
            for bid in pr["shared"]:
                pool.retain(bid)
                retained.append(bid)
            if pr["fork_src"] is not None:
                pool.retain(pr["fork_src"])
                retained.append(pr["fork_src"])
        need = sum(pr["fresh_n"] for pr in rows)
        if pool.free_count < need and self.radix_cache:
            self.stats.pages_evicted += self.radix.evict(need - pool.free_count)
        if pool.free_count < need:
            for bid in retained:
                pool.release(bid)
            return None
        bt = self.kv_block_tokens
        n_full = self.prefix_len // bt
        t = self.prefix_len % bt
        tmp = []
        for pr in rows:
            pr["fresh"] = [pool.alloc() for _ in range(pr["fresh_n"])]
            if pr["fork_src"] is not None:
                pr["fork_dst"] = pr["fresh"][0]
                tmp.append(pr["fork_src"])   # held only until the copy runs
            elif self.radix_cache:
                # register the prompt's blocks now: this pass's dispatches
                # write them, so same-pass siblings already hit
                combined = pr["shared"] + pr["fresh"]
                self.radix.insert(pr["key"], combined[:n_full],
                                  combined[n_full] if t else None)
        for pr in rows:
            if pr["match"] is not None:
                self.radix.record(pr["match"])
            if pr["full"]:
                self.stats.radix_full_hits += 1
                self.stats.shared_prefills_saved += 1
                self.stats.prefix_hit_tokens += pr["hit_tok"]
            elif pr["shared"]:
                self.stats.radix_partial_hits += 1
                self.stats.prefix_hit_tokens += pr["hit_tok"]
            else:
                self.stats.radix_misses += 1
        return {"rows": rows, "tmp": tmp}

    def _admit_paged(self, placed) -> None:
        """One paged admission pass, in this order: page-table upload →
        full-miss windows → partial-hit suffix chunks → COW forks → full-hit
        width-1 recomputes."""
        B = self.slots
        bt = self.kv_block_tokens
        pool = self.block_pool
        tmp = []
        miss_mask = np.zeros((B,), bool)
        texts = np.zeros((B, self.text_seq_len), np.int32)
        seeds = np.zeros((B,), np.int64)
        n_rows_arr = np.full((B,), self.n_steps, np.int64)
        suffix: Dict[int, list] = {}
        forks = []
        hit_rows = []
        for pairs_u, plan in placed:
            tmp.extend(plan["tmp"])
            for (slot, req), pr in zip(pairs_u, plan["rows"]):
                blocks = pr["shared"] + pr["fresh"]
                self._pages_host[slot, :] = -1
                self._pages_host[slot, :len(blocks)] = blocks
                self._slot_blocks[slot] = blocks
                seeds[slot] = req.seed
                n_rows_arr[slot] = pr["n_tok"]
                if pr["full"]:
                    forks.append((pr["fork_src"], pr["fork_dst"]))
                    hit_rows.append((slot, pr))
                elif pr["shared"]:
                    suffix.setdefault(len(pr["shared"]) * bt, []).append((slot, pr))
                else:
                    miss_mask[slot] = True
                    texts[slot] = self._pad_text(req.text)
        self._bind_pages()
        if miss_mask.any():
            self._refill(texts, seeds, n_rows_arr, miss_mask)
            self.stats.refills += 1
        for start in sorted(suffix):
            mask = np.zeros((B,), bool)
            ids = np.zeros((B, self.prefix_len), np.int32)
            for slot, pr in suffix[start]:
                mask[slot] = True
                ids[slot] = pr["ids"]
            pos = start
            while pos < self.prefix_len:
                w = min(bt, self.prefix_len - pos)
                last = pos + w >= self.prefix_len
                self._refill_chunk(ids[:, pos:pos + w], pos, seeds, n_rows_arr,
                                   mask, last)
                self.stats.prefill_chunks += 1
                pos += w
            self.stats.refills += 1
        if forks:
            src = np.zeros((B,), np.int64)
            dst = pool.num_blocks + np.arange(B, dtype=np.int64)
            for i, (s, d) in enumerate(forks):
                src[i] = s
                dst[i] = d
            self._cow_copy(src, dst)
            self.stats.cow_forks += len(forks)
            pool.cow_copies += len(forks)
        if hit_rows:
            # full-prefix hits recompute only position prefix_len-1: a
            # width-1 window whose logits are the one-shot window's last
            mask = np.zeros((B,), bool)
            ids = np.zeros((B, self.prefix_len), np.int32)
            for slot, pr in hit_rows:
                mask[slot] = True
                ids[slot] = pr["ids"]
            self._refill_chunk(ids[:, self.prefix_len - 1:], self.prefix_len - 1,
                               seeds, n_rows_arr, mask, True)
            self.stats.refills += 1
        for bid in tmp:
            pool.release(bid)

    def _release_slot_blocks(self, slot: int) -> None:
        """Completion: drop the row's refs on every block it mapped. The
        device page table keeps the stale row until the slot's next
        admission: an inactive row's writes drop at the park offset."""
        for bid in self._slot_blocks.pop(slot, ()):
            self.block_pool.release(bid)
        self._pages_host[slot, :] = -1

    def kv_stats(self) -> dict:
        """Page-pool and radix counters."""
        if not self.paged:
            return {"paged": False}
        out = {"paged": True, "block_tokens": self.kv_block_tokens,
               "pool_blocks": self.kv_pool_blocks,
               "blocks_per_slot": self.max_blocks,
               "radix_cache": self.radix_cache}
        pool, rx = self.block_pool, self.radix
        if pool is not None:
            out.update(pages_free=pool.free_count, pages_used=pool.used_count,
                       pages_shared=pool.shared_count, cow_copies=pool.cow_copies)
        if rx is not None:
            out.update(radix_nodes=rx.resident_nodes, radix_lookups=rx.lookups,
                       radix_full_hits=rx.full_hits,
                       radix_partial_hits=rx.partial_hits,
                       prefix_hit_tokens=rx.hit_tokens_total,
                       radix_evictions=rx.evictions)
        return out

    @staticmethod
    def _split_cohorts(pairs):
        """Partition one admission pass into shared-prefix cohorts (≥2
        members of one group with identical text) and singles. CFG members
        ride the single paths; group members with mismatched text are
        demoted to singles."""
        by_gid: Dict[int, list] = {}
        singles = []
        for slot, req in pairs:
            if req.group_id is not None and req.cond_scale == 1.0:
                by_gid.setdefault(req.group_id, []).append((slot, req))
            else:
                singles.append((slot, req))
        cohorts = []
        for members in by_gid.values():
            text0 = members[0][1].text
            if len(members) >= 2 and all(
                    np.array_equal(r.text, text0) for _, r in members[1:]):
                cohorts.append(members)
            else:
                singles.extend(members)
        singles.sort(key=lambda p: p[0])
        return cohorts, singles

    def run(self, queue: RequestQueue, *, max_steps: Optional[int] = None,
            poll_s: float = 0.02, on_complete=None,
            on_rows=None) -> List[CompletedRequest]:
        """Serve until the queue is drained (closed + empty + nothing in
        flight). Producers may keep submitting from other threads. Returns
        completions in completion order, or hands each to ``on_complete``
        and keeps none. ``on_rows(request, row_idx, row_tokens)`` streams
        each committed grid row. ``max_steps`` bounds the loop; requests
        still mid-decode then are listed in ``stats.aborted_in_flight``."""
        B = self.slots
        sched = SlotScheduler(B)
        if self.paged:
            self.block_pool = BlockPool(self.kv_pool_blocks)
            self.radix = RadixCache(self.kv_block_tokens, self.block_pool)
            self._slot_blocks: Dict[int, List[int]] = {}
        self._pair_host = np.arange(B, dtype=np.int64)
        self._cfg_host = np.ones((B,), np.float32)
        self._uncond_host = np.zeros((B,), bool)
        self._overflow: List[List[Request]] = []
        self.stats = EngineStats()
        self._init_state()
        return self._run(queue, sched, max_steps=max_steps, poll_s=poll_s,
                         on_complete=on_complete, on_rows=on_rows)

    def _admit_shared(self, members) -> None:
        B = self.slots
        seeds = np.zeros((B,), np.int64)
        n_rows = np.full((B,), self.n_steps, np.int64)
        mask = np.zeros((B,), bool)
        for slot, req in members:
            seeds[slot] = req.seed
            n_rows[slot] = self._n_tokens(req)
            mask[slot] = True
        self._refill_shared(self._pad_text(members[0][1].text)[None], seeds,
                            n_rows, mask)
        self.stats.refills += 1
        self.stats.shared_refills += 1
        self.stats.shared_prefills_saved += len(members) - 1

    def _dispatch_chunk(self, chunk_jobs, pending) -> None:
        """Advance the oldest pending chunked prefill by ONE window; on the
        final chunk its rows turn active."""
        job = chunk_jobs[0]
        prefix = job.ids.shape[1]
        w = min(self.prefill_chunk, prefix - job.start)
        last = job.start + w >= prefix
        self._refill_chunk(job.ids[:, job.start:job.start + w], job.start,
                           job.seeds, job.n_rows, job.mask, last)
        self.stats.prefill_chunks += 1
        job.start += w
        if last:
            chunk_jobs.pop(0)
            self.stats.refills += 1
            for slot, _ in job.pairs:
                pending.discard(slot)

    def _admit_dense(self, pairs, chunk_jobs, pending) -> None:
        """Shared-prefix cohorts first (one prefill per group), then singles:
        one multi-row window when they fill at least half the slots (or
        through chunk jobs when prefill_chunk is set), else a b=1 prefill
        per row."""
        B = self.slots
        cohorts, singles = self._split_cohorts(pairs)
        for members in cohorts:
            self._admit_shared(members)
        chunk_on = 0 < self.prefill_chunk < self.prefix_len
        if singles and (2 * len(singles) >= B or chunk_on):
            texts = np.zeros((B, self.text_seq_len), np.int32)
            seeds = np.zeros((B,), np.int64)
            n_rows = np.full((B,), self.n_steps, np.int64)
            mask = np.zeros((B,), bool)
            for slot, req in singles:
                texts[slot] = self._pad_text(req.text)
                seeds[slot] = req.seed
                n_rows[slot] = self._n_tokens(req)
                mask[slot] = True
            if chunk_on:
                chunk_jobs.append(_ChunkJob(
                    ids=self._remap_bos_host(texts), seeds=seeds,
                    n_rows=n_rows, mask=mask, pairs=list(singles)))
                pending.update(s for s, _ in singles)
            else:
                self._refill(texts, seeds, n_rows, mask)
                self.stats.refills += 1
        else:
            for slot, req in singles:
                self._refill_row(self._pad_text(req.text)[None], req.seed,
                                 self._n_tokens(req), slot)
                self.stats.refills += 1

    def _run(self, queue, sched, *, max_steps, poll_s, on_complete, on_rows):
        buffers: Dict[int, List[int]] = {}
        completed: List[CompletedRequest] = []
        chunk_jobs: List[_ChunkJob] = []
        pending: set = set()       # slots admitted but mid-chunked-prefill
        while not (queue.drained and not sched.any_active
                   and not self._overflow):
            if max_steps is not None and self.stats.steps >= max_steps:
                break

            # admission: fill every free slot the queue can cover, FIFO, in
            # lockstep units (single rows, or cond+null CFG pairs)
            pre_q = queue.qsize()
            free = sched.free_slots()
            admitted = 0
            if free:
                units, admitted = self._take_units(queue, len(free))
                placed = []
                for i, unit in enumerate(units):
                    plan = None
                    if self.paged:
                        plan = self._plan_unit(unit)
                        if plan is None:
                            # the pool cannot cover the unit: defer it and
                            # everything behind it (FIFO)
                            self._overflow = units[i:] + self._overflow
                            break
                    placed.append((sched.admit(unit), plan))
                if placed:
                    pairs = []
                    now = time.perf_counter()
                    for pairs_u, _ in placed:
                        self._set_pair_state(pairs_u)
                        for slot, req in pairs_u:
                            req.admitted_at = now
                            buffers[slot] = []
                            pairs.append((slot, req))
                    if self.paged:
                        self._admit_paged(placed)
                    else:
                        self._admit_dense(pairs, chunk_jobs, pending)
            # work conservation is sampled where requests already queued at
            # the take instant went unplaced
            backlog = (pre_q - admitted) > 0

            if chunk_jobs:
                self._dispatch_chunk(chunk_jobs, pending)

            if not any(s not in pending for s in sched.active_slots()):
                if chunk_jobs or self._overflow:
                    continue
                if queue.drained:
                    break
                queue.wait_nonempty(timeout=poll_s)
                continue

            if backlog:
                self.stats.sample_occupancy(sched.occupancy)

            t0 = time.perf_counter()
            toks, fins = self._multi_step()
            now = time.perf_counter()
            self.stats.step_seconds += now - t0
            for k in range(toks.shape[0]):
                active = [s for s in sched.active_slots() if s not in pending]
                if not active:
                    break
                for slot in active:
                    req = sched.request_at(slot)
                    if req.first_token_at is None:
                        req.first_token_at = now
                    buf = buffers[slot]
                    buf.append(int(toks[k, slot]))
                    if (on_rows is not None and len(buf) % self.row_len == 0
                            and req.request_id >= 0):
                        row = len(buf) // self.row_len - 1
                        on_rows(req, row, buf[row * self.row_len:])
                for slot in active:
                    if not fins[k, slot]:
                        continue
                    req = sched.complete(slot)
                    if self.paged:
                        self._release_slot_blocks(slot)
                    if req.request_id < 0:
                        # synthetic CFG-null row: nothing to surface
                        buffers.pop(slot, None)
                        continue
                    tail = len(buffers[slot]) % self.row_len
                    if tail and on_rows is not None:
                        on_rows(req, len(buffers[slot]) // self.row_len,
                                buffers[slot][-tail:])
                    cr = CompletedRequest(
                        request_id=req.request_id,
                        tokens=np.asarray(buffers.pop(slot), np.int32),
                        seed=req.seed, submitted_at=req.submitted_at,
                        admitted_at=req.admitted_at,
                        first_token_at=req.first_token_at, completed_at=now)
                    if on_complete is not None:
                        on_complete(cr)
                    else:
                        completed.append(cr)
                self.stats.steps += 1
        self.stats.aborted_in_flight = [
            sched.request_at(s).request_id for s in sched.active_slots()
            if sched.request_at(s).request_id >= 0]
        return completed
