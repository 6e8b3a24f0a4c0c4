"""Paged/block KV cache of the decode tier (counterpart of
deeplearning4j_tpu/serving/paged.py).

- **One slot-flat pool per layer**: (S, H, Dh) K and V tensors on the
  device with ``S = (num_blocks + 1) * block_size`` token slots. Block 0
  is the trash block: every position outside a stream's reservation
  (bucket padding, padded batch rows) writes there, and every read is
  masked by position before the softmax, so its content is never seen.
- **A page table per stream**: the host's list of physical block ids
  behind logical positions ``[0, ceil((len + max_new) / block_size) *
  block_size)``. The decode program takes the tables as data
  (B, max_blocks), so one program per batch bucket serves every mix of
  context lengths.
- **All-or-nothing admission**: :meth:`BlockPool.reserve` gives a batch
  every block its streams need for the whole generation, or raises
  :class:`PoolExhaustedError` with nothing allocated (the scheduler's 429).
- **Refcounted blocks, shared prefixes**: +1 for each stream whose table
  maps a block, +1 when the :class:`PrefixCache` trie indexes it; a block
  returns to the free list when its last holder drops it
  (:meth:`BlockPool.conservation` audits this).
- **Copy-on-write**: a stream about to write into a block another holder
  also maps first takes a private copy (:meth:`BlockPool.cow_split`; the
  generator's copy program moves the device rows).

Rejected speculative positions keep their reservation; their stale K/V
rows are overwritten before any read (the next window covers them, and
every read in between is masked to ``k_pos <= position``).

The device pools are static state of the generator's programs, written in
place; replacing them (growth, reset) is the generator's business.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.resilience import PoolExhaustedError
from deeplearning4j_tpu_torch.util import telemetry as tm

__all__ = ["BlockPool", "PrefixCache", "PoolExhaustedError"]


class BlockPool:
    """Host-side allocator + device-side slot-flat K/V pools (module doc).

    ``num_blocks`` usable blocks of ``block_size`` token slots each; the
    device tensors carry one extra (trash) block at index 0. Device state
    lives in ``self.pools`` — one ``{"k": (S,H,Dh), "v": (S,H,Dh)}`` per
    transformer layer on ``device``, created by the blocks' ``init_pool``
    and written in place by the generator's programs. Allocation is REFCOUNTED: ``reserve`` hands out blocks
    at refcount 1, ``incref`` adds holders (prefix-cache hits, the trie
    index itself), and a block frees only when ``decref`` reaches 0."""

    def __init__(self, blocks, *, block_size: int, num_blocks: int,
                 max_length: int, model_id: str = "",
                 dtype=None, device=None):
        if block_size < 1 or num_blocks < 1:
            raise ValueError("block_size and num_blocks must be >= 1")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_length = int(max_length)
        self.model_id = str(model_id)
        #: page-table width: enough blocks to map every logical position
        self.max_blocks_per_stream = math.ceil(self.max_length
                                               / self.block_size)
        self.num_slots = (self.num_blocks + 1) * self.block_size
        self.dtype = dtype or torch.float32
        self.device = device
        self.pools = [blk.init_pool(self.num_slots, self.dtype, device)
                      for blk in blocks]
        self._lock = threading.RLock()
        # block 0 is the trash block — never handed out
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        #: refcount per ALLOCATED block (absent = free)
        self._ref: Dict[int, int] = {}
        self._streams = 0
        self.peak_streams = 0
        self._gauges()

    # ---------------------------------------------------------- accounting
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks one stream needs for its WHOLE generation."""
        return math.ceil((prompt_len + max_new) / self.block_size)

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(int(block), 0)

    def shared_blocks(self) -> int:
        """Blocks with more than one holder — the physical dedup the
        prefix cache achieves (``serving.prefix_blocks_shared``)."""
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 1)

    def bytes_per_token(self) -> int:
        """Device bytes one token slot costs across every layer (K + V).
        Pure shape arithmetic — this runs on every stats poll, and
        slicing (``p["k"][0]``) would dispatch an eager device gather per
        layer just to read sizes."""
        return sum(int(t[0].numel() * t.element_size())
                   for p in self.pools for t in (p["k"], p["v"]))

    def pool_bytes(self) -> int:
        """Total device bytes of the usable pool (trash block excluded)."""
        return self.num_blocks * self.block_size * self.bytes_per_token()

    def contiguous_stream_ceiling(self) -> int:
        """How many streams the same bytes hold in the contiguous layout
        (every stream pays ``max_length`` slots)."""
        return (self.num_blocks * self.block_size) // self.max_length

    def _gauges(self):
        tm.gauge("serving.kv_pool_blocks_total", self.num_blocks,
                 model=self.model_id)
        tm.gauge("serving.kv_pool_blocks_free", len(self._free),
                 model=self.model_id)
        tm.gauge("serving.concurrent_streams", self._streams,
                 model=self.model_id)
        tm.gauge("serving.prefix_blocks_shared",
                 sum(1 for r in self._ref.values() if r > 1),
                 model=self.model_id)

    # ----------------------------------------------------------- admission
    def reserve(self, counts: Sequence[int]) -> List[List[int]]:
        """All-or-nothing: allocate ``counts[i]`` blocks for stream i
        (each at refcount 1), or raise :class:`PoolExhaustedError` having
        allocated NOTHING."""
        need = int(sum(counts))
        with self._lock:
            if need > len(self._free):
                tm.counter("serving.pool_exhausted_total",
                           model=self.model_id)
                raise PoolExhaustedError(
                    f"{self.model_id or 'paged-kv'}: batch needs {need} "
                    f"KV blocks, pool has {len(self._free)} free "
                    f"(of {self.num_blocks})")
            out = []
            for c in counts:
                blocks = [self._free.pop() for _ in range(int(c))]
                for b in blocks:
                    self._ref[b] = 1
                out.append(blocks)
            self._streams += len(counts)
            self.peak_streams = max(self.peak_streams, self._streams)
            self._gauges()
            return out

    def incref(self, blocks: Sequence[int]):
        """Add one holder to each block (a prefix-cache hit sharing the
        physical block, or the trie indexing it)."""
        with self._lock:
            for b in blocks:
                b = int(b)
                if b not in self._ref:
                    raise ValueError(
                        f"incref of unallocated block {b} "
                        f"({self.model_id or 'paged-kv'})")
                self._ref[b] += 1
            self._gauges()

    def decref(self, blocks: Sequence[int]):
        """Drop one holder from each block; a block frees only at
        refcount 0. Decref of a free block is a DOUBLE-FREE and raises —
        the bug class :meth:`conservation` exists to catch."""
        with self._lock:
            for b in blocks:
                b = int(b)
                r = self._ref.get(b)
                if r is None:
                    raise ValueError(
                        f"double-free: decref of free block {b} "
                        f"({self.model_id or 'paged-kv'})")
                if r <= 1:
                    del self._ref[b]
                    self._free.append(b)
                else:
                    self._ref[b] = r - 1
            self._gauges()

    def release(self, tables: Sequence[Sequence[int]]):
        """Drop every stream's hold on its blocks (eos / batch done /
        shed rollback). Shared blocks — a prefix another stream or the
        trie still references — stay allocated; only the LAST holder
        returns a block to the free list."""
        with self._lock:
            for t in tables:
                self.decref(t)
            self._streams = max(0, self._streams - len(list(tables)))
            self._gauges()

    def cow_split(self, block: int) -> int:
        """Copy-on-write split: give the caller a PRIVATE block in place
        of shared ``block`` — allocates a fresh block at refcount 1 and
        drops the caller's hold on the original (which the other holders
        keep). The caller must copy the device rows (the generator's
        ``_copy_block`` program) before writing. Raises
        :class:`PoolExhaustedError` (nothing changed) when no block is
        free."""
        with self._lock:
            b = int(block)
            if b not in self._ref:
                raise ValueError(f"cow_split of free block {b}")
            if not self._free:
                tm.counter("serving.pool_exhausted_total",
                           model=self.model_id)
                raise PoolExhaustedError(
                    f"{self.model_id or 'paged-kv'}: COW split needs 1 "
                    f"free block, pool has 0 (of {self.num_blocks})")
            nb = self._free.pop()
            self._ref[nb] = 1
            self.decref([b])
            tm.counter("serving.prefix_cow_splits_total",
                       model=self.model_id)
            self._gauges()
            return nb

    # -------------------------------------------------------- conservation
    def conservation(self) -> Tuple[bool, str]:
        """Audit the allocator invariants (the all-trash health probe's
        steady-state leak/double-free check):
        free + allocated == num_blocks, no block both free and allocated,
        no duplicate free-list entries, every refcount >= 1, and the
        trash block never tracked. Returns (ok, detail)."""
        with self._lock:
            free = list(self._free)
            refs = dict(self._ref)
        problems = []
        if len(set(free)) != len(free):
            problems.append("duplicate free-list entries (double-free)")
        if 0 in free or 0 in refs:
            problems.append("trash block 0 entered the allocator")
        overlap = set(free) & set(refs)
        if overlap:
            problems.append(f"{len(overlap)} block(s) both free and "
                            f"allocated ({sorted(overlap)[:4]}…)")
        bad_ref = [b for b, r in refs.items() if r < 1]
        if bad_ref:
            problems.append(f"refcount < 1 on {bad_ref[:4]}")
        total = len(set(free)) + len(refs)
        if total != self.num_blocks:
            kind = "leak" if total < self.num_blocks else "over-count"
            problems.append(
                f"{kind}: free {len(set(free))} + allocated {len(refs)} "
                f"= {total} != {self.num_blocks} blocks")
        return (not problems,
                "; ".join(problems) if problems else
                f"free {len(free)} + allocated {len(refs)} "
                f"== {self.num_blocks}")

    # ------------------------------------------------------------ programs
    def table_array(self, tables: Sequence[Sequence[int]],
                    batch: int) -> np.ndarray:
        """Page tables as the decode program's (B, max_blocks) int32
        input — unallocated entries (and padded batch rows) point at the
        trash block (0)."""
        out = np.zeros((batch, self.max_blocks_per_stream), np.int32)
        for i, t in enumerate(tables):
            out[i, :len(t)] = np.asarray(t, np.int32)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "block_size": self.block_size,
                "blocks_total": self.num_blocks,
                "blocks_free": len(self._free),
                "blocks_shared": sum(1 for r in self._ref.values()
                                     if r > 1),
                "streams": self._streams,
                "peak_streams": self.peak_streams,
                "pool_bytes": self.pool_bytes(),
                "contiguous_stream_ceiling":
                    self.contiguous_stream_ceiling(),
                # in-use fraction
                "utilization": round(
                    1.0 - len(self._free) / max(1, self.num_blocks), 4),
            }


class _TrieNode:
    """One block-granular radix-trie edge: ``key`` (a block_size-token
    tuple) → the physical block caching those tokens' K/V."""

    __slots__ = ("key", "block", "parent", "children", "pending",
                 "last_used")

    def __init__(self, key, block: int, parent):
        self.key = key
        self.block = int(block)
        self.parent = parent
        self.children: Dict[tuple, "_TrieNode"] = {}
        #: inserted this batch — device content not yet written by the
        #: owning stream's prefill, so sharers may take the BLOCKS (the
        #: owner's rows fill them inside the same program) but must still
        #: COMPUTE those positions themselves
        self.pending = True
        self.last_used = 0


class PrefixCache:
    """Radix/trie index over token prefixes → chains of cached KV blocks
    (reference ``:340``).

    The trie is BLOCK-GRANULAR: each edge is a full ``block_size``-token
    tuple, so only prompt prefixes that fill whole blocks are indexed —
    the partial tail block (which generation writes into) stays private
    to its stream by construction, and shared blocks are therefore never
    written after their first fill. Every indexed block carries one
    trie hold on the :class:`BlockPool` refcount in addition to its
    stream holds; eviction (LRU leaves whose only holder is the trie)
    runs when admission would otherwise shed or grow.

    ``match`` walks the trie for a prompt, increfs the matched chain
    (the caller's stream holds) and reports how many leading tokens are
    COMMITTED (written by a prior batch) — the resume point prefill may
    skip. Nodes inserted for the current batch are ``pending`` until
    :meth:`commit`: a same-batch sharer takes their blocks (byte dedup)
    but recomputes their positions (the write-before-read ordering only
    holds inside one program for identical window shapes). ``flush``
    drops everything — pool growth and the exception-path pool reset
    destroy cached device content, so the trie must forget it."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self.root: Dict[tuple, _TrieNode] = {}
        self._nodes = 0
        self._tick = 0
        # lifetime telemetry (serving.prefix_cache_hit_rate)
        self.lookups = 0
        self.hits = 0
        self.lookup_tokens = 0
        self.hit_tokens = 0
        self.evictions = 0

    # -------------------------------------------------------------- match
    def _keys(self, tokens: Sequence[int]):
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Walk the trie along ``tokens``' full blocks. Returns
        ``(blocks, committed_tokens)``: the matched chain's block ids —
        each increffed as the calling stream's hold — and how many
        leading tokens are committed (a prior batch's prefill wrote
        them; the caller may resume from there). Pending blocks extend
        ``blocks`` (physical sharing) but not ``committed_tokens``."""
        with self.pool._lock:
            self._tick += 1
            self.lookups += 1
            self.lookup_tokens += len(tokens)
            blocks: List[int] = []
            committed = 0
            level = self.root
            for key in self._keys(tokens):
                node = level.get(key)
                if node is None:
                    break
                node.last_used = self._tick
                blocks.append(node.block)
                if not node.pending and committed == len(blocks) - 1:
                    committed += 1
                level = node.children
            if blocks:
                self.hits += 1
                self.hit_tokens += committed * self.block_size
                self.pool.incref(blocks)
            return blocks, committed * self.block_size

    # -------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int],
               table: Sequence[int]) -> List[_TrieNode]:
        """Index ``tokens``' full prompt blocks as ``table``'s leading
        blocks. Existing nodes are kept (their block is already shared
        into ``table`` by ``match``); each NEW node takes one trie hold
        (incref) on its block and stays ``pending`` until the caller
        :meth:`commit`\\ s it. Returns the new nodes — pending
        bookkeeping is PER BATCH (the caller holds the list), because a
        chunk-yield can nest another batch's admit/commit inside this
        batch's prefill."""
        with self.pool._lock:
            self._tick += 1
            added: List[_TrieNode] = []
            level = self.root
            parent = None
            for i, key in enumerate(self._keys(tokens)):
                node = level.get(key)
                if node is None:
                    node = _TrieNode(key, table[i], parent)
                    self.pool.incref([node.block])
                    level[key] = node
                    self._nodes += 1
                    added.append(node)
                node.last_used = self._tick
                parent = node
                level = node.children
            return added

    def commit(self, nodes: Sequence[_TrieNode]):
        """Mark a batch's inserted nodes committed — their device content
        is now written, so FUTURE batches may resume past them (called by
        the generator right after its prefill executes)."""
        with self.pool._lock:
            for node in nodes:
                node.pending = False

    def rollback(self, nodes: Sequence[_TrieNode]):
        """Un-insert a batch's pending nodes (admission failed before any
        device write — their blocks hold no valid content and must not
        linger in the trie). Reverse insertion order, so children drop
        before parents. A node that acquired children is SKIPPED: a
        chunk-yield-nested batch built (and possibly committed) a subtree
        under it, and dropping it would orphan that subtree — the node
        stays pending (never matched as committed) until :meth:`evict`
        reclaims it as an abandoned leaf or :meth:`flush` tears down."""
        with self.pool._lock:
            for node in reversed(list(nodes)):
                if node.pending and not node.children:
                    self._drop_node(node)

    # ------------------------------------------------------------ eviction
    def _leaves(self):
        out = []

        def walk(level):
            for node in level.values():
                if node.children:
                    walk(node.children)
                else:
                    out.append(node)

        walk(self.root)
        return out

    def _drop_node(self, node: _TrieNode):
        level = node.parent.children if node.parent is not None else self.root
        level.pop(node.key, None)
        self._nodes -= 1
        self.pool.decref([node.block])

    def evict(self, want_free: int) -> int:
        """LRU-evict cache-only leaves (no children, no stream holds —
        pool refcount exactly the trie's 1) until ``want_free`` blocks
        are free or nothing more is evictable. Returns blocks freed.
        Walks leaf-up: freeing a leaf may expose its parent. Pending
        leaves at refcount 1 are evictable too: a live batch always holds
        a stream ref on its pending blocks (ref >= 2), so pending+1 can
        only be a rollback-skipped abandoned node (see :meth:`rollback`)
        that nothing will ever commit."""
        freed = 0
        with self.pool._lock:
            while len(self.pool._free) < want_free:
                victims = [n for n in self._leaves()
                           if self.pool._ref.get(n.block, 0) == 1]
                if not victims:
                    break
                node = min(victims, key=lambda n: n.last_used)
                self._drop_node(node)
                self.evictions += 1
                freed += 1
            if freed:
                tm.counter("serving.prefix_cache_evictions_total", freed,
                           model=self.pool.model_id)
        return freed

    def flush(self):
        """Forget every cached prefix and drop the trie's holds. Called
        on pool growth and the exception-path pool reset — both replace
        the device buffers, so every cached K/V row is gone."""
        with self.pool._lock:
            # leaf-up teardown: dropping a leaf exposes its parent
            while self.root:
                for node in self._leaves():
                    self._drop_node(node)

    def rebind(self, pool: BlockPool):
        """Point the (flushed) cache at a replacement pool — used by the
        generator after auto-growth swaps in a bigger :class:`BlockPool`
        (lifetime hit/miss telemetry carries over)."""
        if self.root:
            raise RuntimeError("rebind of a non-empty PrefixCache — "
                               "flush() first")
        self.pool = pool
        self.block_size = pool.block_size

    # --------------------------------------------------------------- audit
    def check(self, strict_idle: bool = False) -> Tuple[bool, str]:
        """Trie-side conservation: every indexed block must be allocated
        in the pool with refcount >= 1 (its own trie hold), and node
        count must match the walk. With ``strict_idle`` (the health
        probe, when no streams are live) the converse holds too: the
        trie's holds are the ONLY holds, so every allocated pool block
        must be trie-indexed at refcount exactly 1 — anything else is a
        leaked stream ref. Returns (ok, detail)."""
        with self.pool._lock:
            problems = []
            seen = 0
            trie_blocks = set()
            stack = list(self.root.values())
            while stack:
                node = stack.pop()
                seen += 1
                trie_blocks.add(node.block)
                if self.pool._ref.get(node.block, 0) < 1:
                    problems.append(
                        f"trie block {node.block} not allocated")
                stack.extend(node.children.values())
            if seen != self._nodes:
                problems.append(f"node count drift: walked {seen}, "
                                f"tracked {self._nodes}")
            if strict_idle:
                stray = {b: r for b, r in self.pool._ref.items()
                         if b not in trie_blocks or r != 1}
                if stray:
                    problems.append(
                        f"idle pool holds {len(stray)} non-trie/"
                        f"over-held block(s) ({sorted(stray)[:4]}…)")
            return (not problems,
                    "; ".join(problems) if problems else
                    f"{seen} trie nodes consistent")

    def hit_rate(self) -> float:
        """Lifetime fraction of looked-up prompt tokens served from
        committed cache blocks (the ``serving.prefix_cache_hit_rate``
        gauge)."""
        return (self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0)

    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": round(self.hit_rate(), 4),
            "evictions": self.evictions,
        }


def default_pool_blocks(batch_buckets, max_length: int,
                        block_size: int) -> int:
    """Default pool size: the largest decode batch bucket at full
    ``max_length`` context — the paged pool then NEVER sheds a batch the
    contiguous layout could have served (admission only bites when the
    operator deliberately sizes the pool below that, trading worst-case
    headroom for more concurrent typical-length streams)."""
    top = max(int(b) for b in batch_buckets) if batch_buckets else 32
    return top * math.ceil(max_length / block_size)
