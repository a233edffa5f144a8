"""Host-side paged-KV bookkeeping: block pool + radix prefix cache.

A copy of ``dalle_tpu/serve/paged.py`` (it imports no JAX). The paged
cache's control plane. The device side (ops/paged_kv.PagedKVCache) is a
dumb block pool addressed through a page table; everything that DECIDES —
which blocks a new request maps, which prefixes are resident, what gets
copy-on-write forked, what eviction may reclaim — lives here, in plain
Python on the engine thread: the host mutates numpy page tables and integer
refcounts, uploads data, and only ever dispatches the same fixed set of
device calls.

``BlockPool`` — free list + per-block refcounts. A block is freed when its
refcount reaches zero; holders are (a) the rows currently mapping it and
(b) the radix tree (exactly one ref per resident node), so "evict only at
refcount 0" in the radix sense is "pool refcount == 1 (the tree's own)".

``RadixCache`` — a prefix tree over REMAPPED prompt ids (bos + pad-remap,
so identical prompts key identically) at BLOCK granularity: each full edge
is the tuple of ``block_tokens`` ids one resident block covers; a partial
trailing block hangs off its parent as a TAIL node and is only shareable on
an exact full-prefix match (its block also receives the owner's decode
tokens, so a full-prefix hit must COW-fork it — the engine does, at
admission, before any divergent write). Matching walks greedily (longest
prefix); insertion adds only missing nodes; eviction removes LRU leaves
whose block no live row maps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class BlockPool:
    """Refcounted fixed-size block allocator (host mirror of the device
    pool). Not thread-safe — engine-thread only, like the page tables."""

    def __init__(self, num_blocks: int):
        assert num_blocks >= 1
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self.cow_copies = 0      # fork ledger (kv.pages_cow_copies gauge)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks with more than one holder — the bytes the slab design
        would have duplicated."""
        return sum(1 for r in self._ref if r >= 2)

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def alloc(self) -> Optional[int]:
        """One fresh block at refcount 1, or None when the pool is dry
        (caller evicts via the radix tree and retries, or defers)."""
        if not self._free:
            return None
        bid = self._free.pop()
        assert self._ref[bid] == 0
        self._ref[bid] = 1
        return bid

    def retain(self, bid: int) -> None:
        assert self._ref[bid] >= 1, f"retain of free block {bid}"
        self._ref[bid] += 1

    def release(self, bid: int) -> None:
        assert self._ref[bid] >= 1, f"release of free block {bid}"
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)


@dataclasses.dataclass
class _Node:
    """One resident block: ``edge`` is the id tuple it covers (length ==
    block_tokens for full nodes, < block_tokens for tail nodes)."""
    edge: Tuple[int, ...]
    block: int
    parent: Optional["_Node"]
    tail: bool = False
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    tails: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.tails


@dataclasses.dataclass
class Match:
    """Longest-prefix match: ``blocks`` are the matched FULL blocks in
    position order (read-only shares); ``tail_block`` is the resident tail
    block on an exact full-prefix hit (COW-fork source), else None.
    ``hit_tokens`` counts prompt positions whose KV the hit makes
    recompute-free (the engine still recomputes the final prompt position
    for its logits)."""
    blocks: List[int]
    tail_block: Optional[int]
    hit_tokens: int

    @property
    def full(self) -> bool:
        return self.tail_block is not None


class RadixCache:
    """Block-granular radix tree over remapped prompt-id tuples."""

    def __init__(self, block_tokens: int, pool: BlockPool):
        assert block_tokens >= 1
        self.block_tokens = int(block_tokens)
        self.pool = pool
        self._root = _Node(edge=(), block=-1, parent=None)
        self._clock = 0
        self._nodes = 0
        # hit ledger (EngineStats)
        self.lookups = 0
        self.full_hits = 0
        self.partial_hits = 0
        self.hit_tokens_total = 0
        self.evictions = 0

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    @property
    def resident_nodes(self) -> int:
        return self._nodes

    def match(self, key: Tuple[int, ...], record: bool = True) -> Match:
        """Greedy longest-prefix walk. A full-prefix hit additionally
        requires the TAIL tuple resident (exact prompt seen before); when
        the prompt length is a block multiple there is no tail and full
        coverage of the full blocks IS the full hit (the engine then forks
        the LAST full block — it contains the final prompt position the
        width-1 logits recompute rewrites).

        ``record=False`` leaves the hit ledger untouched — the engine plans
        deferred admission units afresh every retry iteration (matched
        blocks are unprotected while a unit waits, so a cached match could
        dangle across an eviction), and counting each retry would inflate
        the hit rate and the tokens-saved ledger by the retry count; it
        commits via :meth:`record` only when the unit actually admits."""
        bt = self.block_tokens
        node, blocks = self._root, []
        n_full = len(key) // bt
        for i in range(n_full):
            edge = tuple(key[i * bt:(i + 1) * bt])
            child = node.children.get(edge)
            if child is None:
                break
            self._touch(child)
            node, blocks = child, blocks + [child.block]
        tail_block = None
        tail = tuple(key[n_full * bt:])
        if len(blocks) == n_full:
            if tail:
                tnode = node.tails.get(tail)
                if tnode is not None:
                    self._touch(tnode)
                    tail_block = tnode.block
            elif blocks:
                # block-aligned prompt: the last full block doubles as the
                # COW-fork source of a full hit
                tail_block = blocks[-1]
        hit_tokens = len(blocks) * bt
        if tail_block is not None and tail:
            hit_tokens += len(tail)
        m = Match(blocks=blocks, tail_block=tail_block,
                  hit_tokens=hit_tokens if tail_block is not None
                  else len(blocks) * bt)
        if record:
            self.record(m)
        return m

    def record(self, m: Match) -> None:
        """Commit one match to the hit ledger (see ``match(record=False)``)."""
        self.lookups += 1
        if m.full:
            self.full_hits += 1
        elif m.blocks:
            self.partial_hits += 1
        self.hit_tokens_total += m.hit_tokens

    def insert(self, key: Tuple[int, ...], full_blocks: List[int],
               tail_block: Optional[int]) -> None:
        """Register a freshly prefilled prompt's blocks. Only MISSING nodes
        are added (each new node retains its block once — the tree's own
        ref); blocks already resident keep the incumbent, and the caller's
        duplicate block simply stays private to its row. ``full_blocks``
        must cover the full-block prefix of ``key`` in order."""
        bt = self.block_tokens
        node = self._root
        for i, bid in enumerate(full_blocks):
            edge = tuple(key[i * bt:(i + 1) * bt])
            child = node.children.get(edge)
            if child is None:
                child = _Node(edge=edge, block=bid, parent=node)
                self.pool.retain(bid)
                node.children[edge] = child
                self._nodes += 1
            self._touch(child)
            node = child
        tail = tuple(key[len(full_blocks) * bt:])
        if tail and tail_block is not None and tail not in node.tails:
            tnode = _Node(edge=tail, block=tail_block, parent=node,
                          tail=True)
            self.pool.retain(tail_block)
            node.tails[tail] = tnode
            self._nodes += 1
            self._touch(tnode)

    # -- eviction ----------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                stack.append(c)
                if c.is_leaf:
                    out.append(c)
            for t in n.tails.values():
                out.append(t)
        return out

    def evictable_count(self) -> int:
        """Upper bound on blocks eviction could free RIGHT NOW (leaves no
        row maps). Interior nodes become leaves as their subtrees go, so
        full pressure can eventually reclaim more — the admission loop
        re-asks after each pass."""
        return sum(1 for leaf in self._leaves()
                   if self.pool.refcount(leaf.block) == 1)

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks, LRU leaves first, ONLY where the tree
        holds the sole reference (refcount 1 == radix refcount 0: no live
        row maps the block). Returns the number freed."""
        freed = 0
        while freed < n:
            cands = [leaf for leaf in self._leaves()
                     if self.pool.refcount(leaf.block) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.last_used)
            parent = victim.parent
            if victim.tail:
                del parent.tails[victim.edge]
            else:
                del parent.children[victim.edge]
            self._nodes -= 1
            self.pool.release(victim.block)
            self.evictions += 1
            freed += 1
        return freed
