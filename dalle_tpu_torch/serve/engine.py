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
same). So a request's tokens are those of the port's sequential
``generate_images_tokens(text[None], generator=torch.Generator(dev)
.manual_seed(seed))``, in any admission order, under the reference's
contract (``DalleWithVae.serve_engine``): bit for bit with
``use_kernel=False`` here and on the sequential call, at f32 compute under
either mode, and in the bf16 modes under ``auto`` up to a near-tie.
``noise_fn(seed, t) -> (V,)`` replaces the generators with an injected draw
for token t (the tests feed the JAX engine's draws through it).

Telemetry, as the JAX engine records it (``obs``, off by default and one
``None`` check a site when off): the spans ``serve/prefill`` (one per
admitted request, ``mode`` window · row · shared · chunked · paged ·
paged-partial · paged-hit), ``pipeline/prefill_shared``,
``serve/prefill_chunk``, ``serve/request_queue_wait``, ``serve/decode_row``,
``serve/request`` and ``serve/request_ttft``; the ``kv.*`` gauges and
``serve.queue_depth``, ``serve.slot_occupancy``, ``serve.queue_wait_s``,
``serve.request_latency_s``; the histograms ``serve.prefill_chunk_seconds``,
``serve.queue_wait_seconds``, ``serve.decode_row_seconds``,
``serve.ttft_seconds``; the counters ``kv.prefix_hit_tokens_total``,
``serve.tokens_emitted_total``, ``serve.requests_completed_total``; the
flight-recorder events ``request_admitted``, ``request_completed`` and
(with ``decode_health``) ``decode_quality``; and a state provider while
``run`` is live. Spans are timed on the host: a dispatch's span ends when
its launches return. ``decode_health`` computes ``obs.decode_quality`` of
the (CFG-merged) logits each row samples from, on the card, and reads it
in the same host read as the tokens; it draws nothing, so the tokens do
not change. The chaos ``step_hook`` runs before each decode dispatch.

Not ported: ``topk_approx`` (raises ``NotImplementedError``) and the AOT
executables (``install_executables``; CUDA-graph capture is its
counterpart, ``ROADMAP.md`` Queue 1 item 2).

``use_kernel`` is the JAX engine's pin of the attend in every dispatch
(``serve_refill``, ``serve_refill_window``, ``serve_decode``). None (the
default) or True runs the windowed kernels K3/K5, their plain versions on
the CPU; False runs the JAX package's dense formula on either device, the
one ``generate_images_tokens(use_kernel=False)`` runs in its decode steps.
The b=1 prefills (``_refill_row``, ``_refill_shared``) are the sequential
``_prefill`` in either mode; under the pin it attends the cache rows it
writes, as the refill windows do, so an int8 cache's quantized prefix is
what every admission path and sequential generation see.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..chaos.faults import step_hook as chaos_step_hook
from ..device import resolve_device, to_device
from ..models.dalle import DALLE
from ..obs import (counter_add, gauge_set, histogram_observe, record_event,
                   record_span, register_state_provider,
                   unregister_state_provider)
from ..obs.health import decode_quality
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
    def progress(self) -> int:
        """Monotonic engine-iteration counter: every dispatch the host loop
        completes (decode steps, refill windows, prefill chunks) advances
        it. A busy engine whose progress stops is wedged."""
        return self.steps + self.refills + self.prefill_chunks

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
    t0: float              # admission wall-clock (serve/prefill span start)
    start: int = 0         # next chunk's first position


class DecodeEngine:
    """Continuous-batching image-token decode over a DALLE model.

    ``slots``: the batch B. ``cache_dtype``: KV storage (float32, bfloat16
    or int8); the model's own compute dtype (``DALLE.compute_dtype``) is
    the engine's, int8 weights (``quantize_params_int8``) included. Sampling knobs
    mirror ``generate_images_tokens``. ``use_kernel`` pins the attend of
    every dispatch (module docstring). ``decode_health`` adds the per-row
    entropy and top-k mass of the sampled distribution to each request's
    ``serve/request`` span (with its ``repeat_ratio``), the
    ``health.decode_*`` gauges and a ``decode_quality`` event. ``device``:
    where the engine runs, the CUDA card unless the caller passes "cpu";
    the model must be there."""

    def __init__(self, model: DALLE, *, slots: int, cache_dtype=torch.float32,
                 filter_thres: float = 0.5, temperature: float = 1.0,
                 topk_approx: bool = False, steps_per_sync: int = 1,
                 decode_health: bool = False, prefill_chunk: int = 0,
                 kv_block_tokens: int = 0, kv_pool_blocks: Optional[int] = None,
                 radix_cache: bool = True, use_kernel=None,
                 noise_fn: Optional[Callable[[int, int], object]] = None,
                 device=None):
        c = model.cfg
        attn_types = tuple(c.attn_types) or ("full",)
        if any(t != "full" for t in attn_types) or c.shift_tokens:
            raise ValueError(
                "the serve engine requires full attention and "
                f"shift_tokens=False (got attn_types={attn_types}, "
                f"shift_tokens={c.shift_tokens})")
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
        self.use_kernel = use_kernel
        self.decode_health = bool(decode_health)

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

    def chunk_widths(self) -> tuple:
        """The fixed set of prefill-chunk widths this engine dispatches:
        every chunked or paged admission decomposes into windows of these
        widths. A dense engine without chunking returns ()."""
        if self.paged:
            bt = self.kv_block_tokens
            widths = {1}                        # full-hit logits recompute
            if bt < self.prefix_len:
                widths.add(bt)                  # miss-suffix body chunks
                if self.prefix_len % bt:
                    widths.add(self.prefix_len % bt)   # suffix tail
            return tuple(sorted(widths))
        if 0 < self.prefill_chunk < self.prefix_len:
            widths = {self.prefill_chunk}
            if self.prefix_len % self.prefill_chunk:
                widths.add(self.prefix_len % self.prefill_chunk)
            return tuple(sorted(widths))
        return ()

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
        logits_r, self.cache = self.model.serve_refill(texts, self.cache, mask,
                                                       self.use_kernel)
        self.stats.window_dispatches += 1
        rows = np.flatnonzero(mask)
        self._activate(rows, seeds, n_rows, logits_r[to_device(rows, self.device)])

    @torch.no_grad()
    def _refill_row(self, text1, seed: int, n_tok: int, row: int) -> None:
        """Admit ONE request into slot ``row``: a b=1 prefill (the
        sequential ``_prefill``) copied into the shared cache."""
        logits1, cache1 = self.model.serve_prefill_row(text1, self.cache_dtype,
                                                       self.use_kernel)
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
            text1, self.cache, mask, self.cache_dtype, self.use_kernel)
        self._activate(np.flatnonzero(mask), seeds, n_rows, logits1)

    @torch.no_grad()
    def _refill_chunk(self, ids_chunk, start: int, seeds, n_rows, mask,
                      last: bool) -> None:
        """One bounded window of a chunked prefill at [start, start+w) of the
        masked rows; rows turn active only on the final chunk."""
        logits_r, self.cache = self.model.serve_refill_window(
            ids_chunk, self.cache, mask, int(start), self.use_kernel)
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
        Returns (tokens (B,) on the device, finished (B,) host bool, and
        with ``decode_health`` the per-row ``decode_quality`` of the
        distribution sampled from, (B,) f32 each on the device, else {})."""
        B = self.slots
        t_idx, n_row, active = self._t_idx, self._n_row, self._active
        j = np.minimum(t_idx, n_row - 1)
        final = j == n_row - 1
        decode_rows = active & ~final
        finished = active & final
        if not active.any():
            tok = torch.zeros((B,), dtype=torch.long, device=self.device)
            stats = {}
            if self.decode_health:
                zero = torch.zeros((B,), dtype=torch.float32, device=self.device)
                stats = {"entropy": zero, "topk_mass": zero}
            return tok, finished, stats
        offsets = np.where(decode_rows, self.prefix_len + j, self.park)
        sources = [None] * B
        for s in np.flatnonzero(active):
            src = self._sources[s]
            sources[s] = self.noise_fn(src, int(j[s])) if self.noise_fn is not None else src
        noise = row_noise(sources, self.model.cfg.image_vocab_size, self.device)
        img = self._cfg_merge(self.logits[:, self.num_text_tokens:])
        # the quality of the distribution sampled from (the CFG-merged,
        # pre-gumbel logits), left on the card for the tokens' read
        stats = decode_quality(img) if self.decode_health else {}
        tok = gumbel_sample_rows(img, noise, thres=self.filter_thres,
                                 temperature=self.temperature)
        if decode_rows.any():
            new_logits, self.cache = self.model.serve_decode(tok, j, offsets, self.cache,
                                                             self.use_kernel)
            self.stats.window_dispatches += 1
            rows = to_device(np.flatnonzero(decode_rows), self.device)
            self.logits[rows] = new_logits[rows]
        self._t_idx = np.where(active, t_idx + 1, t_idx)
        self._active = decode_rows
        return tok, finished, stats

    def _multi_step(self):
        """steps_per_sync × _step, then one host read: (K, B) tokens and
        finished flags, and with ``decode_health`` (K, B) f32 entropy and
        top-k mass (else None), read with the tokens: their f32 bits ride
        as int32 in the tokens' int64 block, so the step waits on the card
        once either way."""
        toks, fins, ents, masses = [], [], [], []
        for _ in range(self.steps_per_sync):
            tok, fin, stats = self._step()
            toks.append(tok)
            fins.append(fin)
            if stats:
                ents.append(stats["entropy"])
                masses.append(stats["topk_mass"])
        block = torch.stack(toks)
        if not self.decode_health:
            return block.cpu().numpy(), np.stack(fins), None
        K = len(toks)
        bits = torch.stack(ents + masses).contiguous().view(torch.int32).to(torch.int64)
        host = torch.cat([block, bits]).cpu().numpy()
        q = host[K:].astype(np.int32).view(np.float32)
        return host[:K], np.stack(fins), {"entropy": q[:K], "topk_mass": q[K:]}

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
        all_rows = []
        for pairs_u, plan in placed:
            tmp.extend(plan["tmp"])
            for (slot, req), pr in zip(pairs_u, plan["rows"]):
                blocks = pr["shared"] + pr["fresh"]
                self._pages_host[slot, :] = -1
                self._pages_host[slot, :len(blocks)] = blocks
                self._slot_blocks[slot] = blocks
                seeds[slot] = req.seed
                n_rows_arr[slot] = pr["n_tok"]
                all_rows.append((slot, req, pr))
                if pr["full"]:
                    forks.append((pr["fork_src"], pr["fork_dst"]))
                    hit_rows.append((slot, pr))
                elif pr["shared"]:
                    suffix.setdefault(len(pr["shared"]) * bt, []).append((slot, pr))
                else:
                    miss_mask[slot] = True
                    texts[slot] = self._pad_text(req.text)
        self._bind_pages()
        t0 = time.perf_counter()
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
        t1 = time.perf_counter()
        for bid in tmp:
            pool.release(bid)
        for slot, req, pr in all_rows:
            if req.request_id >= 0:
                mode = ("paged-hit" if pr["full"] else
                        "paged-partial" if pr["shared"] else "paged")
                record_span("serve/prefill", t0, t1 - t0, request_id=req.request_id,
                            trace_id=req.trace_id, mode=mode)
            self._row_t0[slot] = t1
        gauge_set("kv.pages_free", float(pool.free_count))
        gauge_set("kv.pages_used", float(pool.used_count))
        gauge_set("kv.pages_shared", float(pool.shared_count))
        gauge_set("kv.pages_cow_copies", float(pool.cow_copies))
        counter_add("kv.prefix_hit_tokens_total",
                    float(sum(pr["hit_tok"] for _, _, pr in all_rows)))

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
        self._buffers: Dict[int, List[int]] = {}
        self._row_t0: Dict[int, float] = {}    # per-slot start of the open grid row
        # per-slot decode-quality accumulators [Σentropy, Σtopk_mass, n]
        # (decode_health only; reset at admission, reduced at completion)
        self._qual: Dict[int, List[float]] = {}

        # the flight recorder's view of the live loop: queue depth, slot
        # occupancy and in-flight requests, read from other threads (each
        # value a point-in-time copy)
        def _engine_state() -> dict:
            inflight = []
            for s in sched.active_slots():
                r = sched.request_at(s)
                if r is not None:
                    inflight.append({
                        "slot": s, "request_id": r.request_id,
                        "trace_id": r.trace_id,
                        "tokens_done": len(self._buffers.get(s, ()))})
            return {"queue_depth": queue.qsize(),
                    "slot_occupancy": sched.occupancy,
                    "steps": self.stats.steps, "inflight": inflight}

        provider = register_state_provider(
            f"serve.engine[{threading.current_thread().name}]", _engine_state)
        try:
            return self._run(queue, sched, max_steps=max_steps, poll_s=poll_s,
                             on_complete=on_complete, on_rows=on_rows)
        finally:
            unregister_state_provider(provider)

    def _admit_shared(self, members) -> None:
        B = self.slots
        seeds = np.zeros((B,), np.int64)
        n_rows = np.full((B,), self.n_steps, np.int64)
        mask = np.zeros((B,), bool)
        for slot, req in members:
            seeds[slot] = req.seed
            n_rows[slot] = self._n_tokens(req)
            mask[slot] = True
        t0 = time.perf_counter()
        self._refill_shared(self._pad_text(members[0][1].text)[None], seeds,
                            n_rows, mask)
        t1 = time.perf_counter()
        self.stats.refills += 1
        self.stats.shared_refills += 1
        self.stats.shared_prefills_saved += len(members) - 1
        record_span("pipeline/prefill_shared", t0, t1 - t0,
                    group_id=members[0][1].group_id, candidates=len(members),
                    trace_id=members[0][1].trace_id)
        for slot, req in members:
            record_span("serve/prefill", t0, t1 - t0, request_id=req.request_id,
                        trace_id=req.trace_id, mode="shared")
            self._row_t0[slot] = t1

    def _dispatch_chunk(self, chunk_jobs, pending) -> None:
        """Advance the oldest pending chunked prefill by ONE window; on the
        final chunk its rows turn active."""
        job = chunk_jobs[0]
        prefix = job.ids.shape[1]
        w = min(self.prefill_chunk, prefix - job.start)
        last = job.start + w >= prefix
        t0 = time.perf_counter()
        self._refill_chunk(job.ids[:, job.start:job.start + w], job.start,
                           job.seeds, job.n_rows, job.mask, last)
        t1 = time.perf_counter()
        self.stats.prefill_chunks += 1
        record_span("serve/prefill_chunk", t0, t1 - t0, start=job.start, width=w,
                    step=self.stats.steps, trace_id=job.pairs[0][1].trace_id)
        histogram_observe("serve.prefill_chunk_seconds", t1 - t0,
                          trace_id=job.pairs[0][1].trace_id)
        job.start += w
        if last:
            chunk_jobs.pop(0)
            self.stats.refills += 1
            for slot, req in job.pairs:
                pending.discard(slot)
                record_span("serve/prefill", job.t0, t1 - job.t0,
                            request_id=req.request_id, trace_id=req.trace_id,
                            mode="chunked")
                self._row_t0[slot] = t1

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
                    n_rows=n_rows, mask=mask, pairs=list(singles),
                    t0=time.perf_counter()))
                pending.update(s for s, _ in singles)
            else:
                t0 = time.perf_counter()
                self._refill(texts, seeds, n_rows, mask)
                t1 = time.perf_counter()
                self.stats.refills += 1
                # one window, one span per admitted request
                for slot, req in singles:
                    record_span("serve/prefill", t0, t1 - t0,
                                request_id=req.request_id,
                                trace_id=req.trace_id, mode="window")
                    self._row_t0[slot] = t1
        else:
            for slot, req in singles:
                t0 = time.perf_counter()
                self._refill_row(self._pad_text(req.text)[None], req.seed,
                                 self._n_tokens(req), slot)
                t1 = time.perf_counter()
                self.stats.refills += 1
                record_span("serve/prefill", t0, t1 - t0, request_id=req.request_id,
                            trace_id=req.trace_id, mode="row")
                self._row_t0[slot] = t1

    def _run(self, queue, sched, *, max_steps, poll_s, on_complete, on_rows):
        buffers, row_t0, qual = self._buffers, self._row_t0, self._qual
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
                            qual[slot] = [0.0, 0.0, 0]
                            pairs.append((slot, req))
                            if req.request_id < 0:
                                continue   # synthetic CFG-null row
                            # queue wait as its own span (TTFT = queue wait +
                            # prefill + first step), gauge and histogram
                            record_span("serve/request_queue_wait", req.submitted_at,
                                        now - req.submitted_at,
                                        request_id=req.request_id,
                                        trace_id=req.trace_id)
                            gauge_set("serve.queue_wait_s", now - req.submitted_at)
                            histogram_observe("serve.queue_wait_seconds",
                                              now - req.submitted_at,
                                              trace_id=req.trace_id)
                            record_event("request_admitted", slot=slot,
                                         request_id=req.request_id,
                                         trace_id=req.trace_id)
                    if self.paged:
                        self._admit_paged(placed)
                    else:
                        self._admit_dense(pairs, chunk_jobs, pending)
            # work conservation is sampled where requests already queued at
            # the take instant went unplaced
            backlog = (pre_q - admitted) > 0
            gauge_set("serve.queue_depth", float(queue.qsize()))
            gauge_set("serve.slot_occupancy", sched.occupancy)

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

            # a FaultPlan can kill, hang or slow the loop here, between row
            # commits; one module-global None check when chaos is off
            chaos_step_hook(self.stats.steps)

            t0 = time.perf_counter()
            toks, fins, qstats = self._multi_step()
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
                    if qstats is not None:
                        acc = qual.setdefault(slot, [0.0, 0.0, 0])
                        acc[0] += float(qstats["entropy"][k, slot])
                        acc[1] += float(qstats["topk_mass"][k, slot])
                        acc[2] += 1
                    if len(buf) % self.row_len == 0 and req.request_id >= 0:
                        row = len(buf) // self.row_len - 1
                        # one committed grid row, one span (rows finishing in
                        # one multi-step read share its timestamp)
                        t0r = row_t0.get(slot, now)
                        record_span("serve/decode_row", t0r, now - t0r,
                                    request_id=req.request_id,
                                    trace_id=req.trace_id, row=row)
                        histogram_observe("serve.decode_row_seconds", now - t0r,
                                          trace_id=req.trace_id)
                        row_t0[slot] = now
                        if on_rows is not None:
                            on_rows(req, row, buf[row * self.row_len:])
                # CFG-null rows emit nothing a caller sees: goodput only
                counter_add("serve.tokens_emitted_total",
                            float(sum(1 for s in active
                                      if sched.request_at(s).request_id >= 0)))
                for slot in active:
                    if not fins[k, slot]:
                        continue
                    req = sched.complete(slot)
                    if self.paged:
                        self._release_slot_blocks(slot)
                    if req.request_id < 0:
                        # synthetic CFG-null row: nothing to surface
                        buffers.pop(slot, None)
                        qual.pop(slot, None)
                        row_t0.pop(slot, None)
                        continue
                    tail = len(buffers[slot]) % self.row_len
                    if tail:
                        # the trailing partial row of a max_tokens request
                        t0r = row_t0.get(slot, now)
                        record_span("serve/decode_row", t0r, now - t0r,
                                    request_id=req.request_id,
                                    trace_id=req.trace_id,
                                    row=len(buffers[slot]) // self.row_len,
                                    partial=True)
                        if on_rows is not None:
                            on_rows(req, len(buffers[slot]) // self.row_len,
                                    buffers[slot][-tail:])
                    row_t0.pop(slot, None)
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
                    # per-request decode quality: the means of the taps and
                    # the host's repeated-token ratio, as span args and
                    # unlabelled gauges (never as metric labels)
                    q_args = {}
                    acc = qual.pop(slot, None)
                    if acc is not None and acc[2] > 0:
                        t = cr.tokens
                        rep = (float(np.mean(t[1:] == t[:-1]))
                               if t.shape[0] > 1 else 0.0)
                        q_args = {"entropy": round(acc[0] / acc[2], 4),
                                  "topk_mass": round(acc[1] / acc[2], 4),
                                  "repeat_ratio": round(rep, 4)}
                        gauge_set("health.decode_entropy", acc[0] / acc[2])
                        gauge_set("health.decode_topk_mass", acc[1] / acc[2])
                        gauge_set("health.decode_repeat_ratio", rep)
                        record_event("decode_quality", request_id=req.request_id,
                                     trace_id=req.trace_id, **q_args)
                    # after the fact: requests overlap in this thread
                    record_span("serve/request", req.admitted_at,
                                now - req.admitted_at, request_id=req.request_id,
                                trace_id=req.trace_id,
                                tokens=int(cr.tokens.shape[0]), **q_args)
                    record_span("serve/request_ttft", req.submitted_at, cr.ttft_s,
                                request_id=req.request_id, trace_id=req.trace_id)
                    histogram_observe("serve.ttft_seconds", cr.ttft_s,
                                      trace_id=req.trace_id)
                    record_event("request_completed", request_id=req.request_id,
                                 trace_id=req.trace_id, latency_s=cr.latency_s)
                    counter_add("serve.requests_completed_total", 1.0)
                    gauge_set("serve.request_latency_s", cr.latency_s)
                self.stats.steps += 1
        self.stats.aborted_in_flight = [
            sched.request_at(s).request_id for s in sched.active_slots()
            if sched.request_at(s).request_id >= 0]
        return completed
