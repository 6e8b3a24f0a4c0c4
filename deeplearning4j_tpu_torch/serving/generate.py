"""The decode tier: paged KV cache, prefix cache, chunked prefill,
speculative decoding and int8 (counterpart of
deeplearning4j_tpu/serving/generate.py).

A decoder-only LM made of the port's transformer layers
(``BertEmbeddingLayer`` -> ``TransformerEncoderBlock(causal=True)`` x N ->
``RnnOutputLayer``, e.g. ``zoo.Bert(causal=True, task="mlm")``) is served by
programs built once per shape:

- **prefill**: one causal forward over the prompt (lengths round up to the
  sequence buckets); the prompt's K/V go into the paged pool through each
  stream's page table (``serving/paged.py``);
- **decode step**: one token a call through the page table: gather the
  stream's K/V rows, attend ``k_pos <= position``, write the new token's
  K/V. The table is data, so one program per batch bucket serves every mix
  of context lengths;
- **verify**: the speculative window. A small draft net proposes
  ``spec_tokens`` greedy tokens one step at a time, the target checks the
  whole window in one call and emits every leading token the draft got
  right plus one of its own, so greedy speculative output is the target's
  greedy output token for token;
- **prefill window**: a prompt's suffix from a prefix-cache hit, or one
  chunk of a chunked prefill (``prefill_chunk``), write-then-attend as the
  verify window;
- **copy-on-write copy** of one block's rows.

Each is an ``nn/capture.py`` :class:`~deeplearning4j_tpu_torch.nn.capture.Program`
per batch bucket (and per sequence bucket or window width): a CUDA graph on
the card, its body run eagerly on static buffers on the CPU, and, inside
``capture.disabled()``, no program at all. The K/V pools (and the
contiguous engine's per-bucket caches) are the programs' static state,
written in place, the analogue of the reference's donated buffers.
Replacing the pools (``_grow``, ``_reset_pools``) bumps ``_pool_epoch``
and drops the programs built on the old ones. Each program notes its build
under the reference's name (``serving.prefill_paged``,
``serving.decode_step_paged``, ``serving.verify_paged``,
``serving.prefill_window_paged``, ``serving.cow_copy``,
``serving.prefill``, ``serving.decode_step``), so the compile watcher
counts what the reference's counts. The eos check, sampling and the host
bookkeeping stay outside the programs.

Every attention here is the exact one, as in the reference (which runs no
Pallas kernel on this path): the prompt's never takes the flash kernel, so
paged, contiguous and full-recompute decode compute the same rows.

Admission sheds a batch whose streams cannot all get blocks with
:class:`PoolExhaustedError` (429) before any device work when the pool
size was pinned; an automatically sized pool grows instead.
``quantize="int8"`` holds int8 weights with per-channel scales and
dequantizes inside every program (``serving/quantize.py``).

Sampling (``temperature > 0``) draws Gumbel noise from a
``torch.Generator`` on the logits' device: ``key`` is a seed or a
generator (default seed 0), taken where the reference takes a PRNG key,
and the paged, contiguous and recompute paths draw the same stream.
``generate_full_recompute`` is the oracle: the contiguous prefill rerun
over the whole grown sequence for every token.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.serving.paged import (BlockPool,
                                                    PoolExhaustedError,
                                                    PrefixCache,
                                                    default_pool_blocks)
from deeplearning4j_tpu_torch.serving.quantize import maybe_quantize
from deeplearning4j_tpu_torch.tree import tree_leaves
from deeplearning4j_tpu_torch.util import telemetry as tm

_I64 = torch.int64


def _decoder_parts(net, what: str):
    """Validate and split a decoder-only MLN into (emb, blocks, head)."""
    from deeplearning4j_tpu_torch.nn.transformer import (
        BertEmbeddingLayer, TransformerEncoderBlock)

    layers = getattr(net, "layers", None)
    if not layers or not isinstance(layers[0], BertEmbeddingLayer):
        raise ValueError(f"{what} needs a BertEmbeddingLayer input "
                         "(e.g. zoo.Bert(causal=True, task='mlm'))")
    blocks = layers[1:-1]
    if not blocks or not all(isinstance(b, TransformerEncoderBlock)
                             for b in blocks):
        raise ValueError(f"{what} needs TransformerEncoderBlock middle "
                         "layers")
    if not all(b.causal for b in blocks):
        raise ValueError(f"{what} needs causal=True blocks: a "
                         "bidirectional encoder cannot decode "
                         "autoregressively")
    if not hasattr(layers[-1], "_logits"):
        raise ValueError(f"{what} needs a per-token logits head "
                         "(RnnOutputLayer, task='mlm')")
    return layers[0], list(blocks), layers[-1]


def _generator(key, device) -> torch.Generator:
    """The sampling stream: ``key`` a torch.Generator (used as it is) or
    a seed (default 0)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


class Generator:
    """Decode serving head over a decoder-only MultiLayerNetwork (module
    doc).

    ``batch_buckets`` / ``prefill_buckets`` default to the conf's bucketing
    knobs; ``max_length`` to the embedding's ``max_position``, and bounds
    prompt + generated tokens. ``paged`` (default True; ``paged=False`` is
    the contiguous-cache engine), ``block_size`` / ``pool_blocks`` (the
    pool's geometry; by default the largest batch bucket at full context,
    grown on demand), ``prefix_cache``, ``prefill_chunk``, ``draft_net`` +
    ``spec_tokens`` (speculative decoding; the draft runs a contiguous
    generator of its own) and ``quantize`` ("int8")."""

    def __init__(self, net, *, max_length: Optional[int] = None,
                 batch_buckets=None, prefill_buckets=None,
                 paged: bool = True, block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 draft_net=None, spec_tokens: int = 4,
                 quantize: Optional[str] = None,
                 model_id: str = ""):
        self.emb, self.blocks, self.head = _decoder_parts(net, "Generator")
        self.net = net
        self.device = net.device
        self.model_id = str(model_id)
        self.max_length = int(max_length or self.emb.max_position)
        conf_policy = BucketingPolicy.from_conf(getattr(net, "conf", None))
        if batch_buckets is None and conf_policy is not None:
            batch_buckets = conf_policy.batch_buckets
        if prefill_buckets is None and conf_policy is not None:
            prefill_buckets = conf_policy.seq_buckets
        self.policy = BucketingPolicy(
            batch_buckets=batch_buckets or "pow2",
            seq_buckets=prefill_buckets or "pow2")
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self._qp = maybe_quantize(net, quantize, model_id=self.model_id)
        #: programs by (function name, signature)
        self._programs: Dict[tuple, capture.Program] = {}
        self._graph_pool = None
        #: the contiguous engine's caches, one list of layers a batch bucket
        self._caches: Dict[int, list] = {}
        self.pool: Optional[BlockPool] = None
        if self.paged:
            # an automatically sized pool grows instead of shedding; a
            # pinned one sheds (the operator chose the budget)
            self._pool_auto = pool_blocks is None
            if pool_blocks is None:
                bb = self.policy.batch_buckets
                pool_blocks = default_pool_blocks(
                    bb if isinstance(bb, tuple) else (32,),
                    self.max_length, self.block_size)
            self.pool = self._new_pool(int(pool_blocks))
        self.prefix_cache = bool(prefix_cache) and self.paged
        self.cache: Optional[PrefixCache] = (
            PrefixCache(self.pool) if self.prefix_cache else None)
        if prefill_chunk is not None and not self.paged:
            raise ValueError("prefill_chunk needs paged=True (the chunk "
                             "window is a paged program)")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        #: nesting depth of generate(): > 1 while a chunk yield runs a
        #: nested batch, which never grows or resets the pool
        self._depth = 0
        #: bumped whenever the pool buffers are replaced
        self._pool_epoch = 0
        self.spec_tokens = int(spec_tokens)
        self.draft: Optional[Generator] = None
        if draft_net is not None:
            if not self.paged:
                raise ValueError("speculative decoding needs paged=True "
                                 "(the verify window is a paged program)")
            self.draft = Generator(
                draft_net, max_length=self.max_length,
                batch_buckets=self.policy.batch_buckets,
                prefill_buckets=self.policy.seq_buckets,
                paged=False, model_id=f"{self.model_id}/draft"
                if self.model_id else "")
            if self.draft.emb.max_position < self.max_length:
                raise ValueError(
                    f"draft net max_position {self.draft.emb.max_position} "
                    f"< target max_length {self.max_length}")

    def _new_pool(self, num_blocks: int) -> BlockPool:
        return BlockPool(self.blocks, block_size=self.block_size,
                         num_blocks=num_blocks, max_length=self.max_length,
                         model_id=self.model_id, device=self.device)

    # ----------------------------------------------------------- parameters
    def _params(self):
        """The parameter tree the layers consume: the live fp32 tree, or,
        for int8, the in-forward dequantize of the resident leaves."""
        if self._qp is None:
            return self.net.params
        return self._qp.rebuild()

    # ------------------------------------------------------------- programs
    def _run(self, name: str, body, args: tuple, state):
        """``body(*args)`` through its program (built on first sight of the
        signature), or eagerly inside ``capture.disabled()``. ``state``:
        what the body writes in place besides its inputs."""
        if not capture.enabled():
            with torch.no_grad():
                return body(*args)
        key = (name, capture.dispatch_sig(*args))
        prog = self._programs.get(key)
        if prog is None:
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()

            def run(*a):
                with torch.no_grad():
                    return body(*a)

            prog = self._programs[key] = capture.Program(
                name, run, args, device=self.device, pool=self._graph_pool,
                state=tree_leaves(state))
        return prog(*args)

    def programs(self) -> Dict[str, capture.Program]:
        """Every program built so far, by function name and signature."""
        return {f"{name} {sig}": p
                for (name, sig), p in self._programs.items()}

    def _drop_paged_programs(self):
        self._programs = {k: p for k, p in self._programs.items()
                          if not k[0].endswith("_paged")
                          and k[0] != "serving.cow_copy"}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=_I64,
                               device=self.device)

    def _pad_mask(self, lengths, t, dtype):
        cols = torch.arange(t, device=lengths.device)
        return (cols[None, :] < lengths[:, None]).to(dtype)

    def _last_rows(self, x, idx):
        return x[torch.arange(x.shape[0], device=x.device), idx]

    # ----------------------------------------------------- contiguous engine
    def _cache_of(self, batch: int) -> list:
        caches = self._caches.get(batch)
        if caches is None:
            caches = self._caches[batch] = [
                blk.init_cache(batch, self.max_length, device=self.device)
                for blk in self.blocks]
        return caches

    def _prefill(self, tokens, lengths):
        """Contiguous prefill (reference ``:230``): tokens (B, T), lengths
        (B,) -> next-token logits (B, V); the prompt's K/V go into the
        bucket's cache."""
        caches = self._cache_of(int(tokens.shape[0]))

        def body(tokens, lengths):
            params = self._params()
            x, _ = self.emb.apply(params[0], {}, tokens)
            pad = self._pad_mask(lengths, tokens.shape[1], x.dtype)
            for i, blk in enumerate(self.blocks):
                x, _ = blk.prefill(params[i + 1], x, caches[i], mask=pad)
            return self.head._logits(params[-1],
                                     self._last_rows(x, lengths - 1))

        return self._run("serving.prefill", body, (tokens, lengths), caches)

    def _decode(self, tokens, positions):
        """One contiguous step (reference ``:251``): tokens (B,) at
        ``positions`` (B,) -> logits (B, V)."""
        caches = self._cache_of(int(tokens.shape[0]))

        def body(tokens, positions):
            params = self._params()
            x = self.emb.embed_step(params[0], tokens, positions)[:, None]
            for i, blk in enumerate(self.blocks):
                x, _ = blk.decode_step(params[i + 1], x, caches[i],
                                       positions)
            return self.head._logits(params[-1], x[:, 0])

        return self._run("serving.decode_step", body, (tokens, positions),
                         caches)

    # ---------------------------------------------------------- paged engine
    def _slots_of(self, tables):
        """Page tables (B, max_blocks) -> flat slots (B, max_length), cut
        to exactly max_length so the gathered layout is the contiguous
        cache's (reference ``:264``)."""
        bs = self.block_size
        s = tables[:, :, None] * bs + torch.arange(bs, device=tables.device)
        return s.reshape(tables.shape[0], -1)[:, :self.max_length]

    def _prefill_paged(self, tokens, lengths, tables):
        """Paged prefill (reference ``:274``)."""
        pools = self.pool.pools

        def body(tokens, lengths, tables):
            params = self._params()
            t = tokens.shape[1]
            x, _ = self.emb.apply(params[0], {}, tokens)
            pad = self._pad_mask(lengths, t, x.dtype)
            slots = self._slots_of(tables)[:, :t]
            for i, blk in enumerate(self.blocks):
                x, _ = blk.prefill_paged(params[i + 1], x, pools[i], slots,
                                         mask=pad)
            return self.head._logits(params[-1],
                                     self._last_rows(x, lengths - 1))

        return self._run("serving.prefill_paged", body,
                         (tokens, lengths, tables), pools)

    def _window_paged(self, method, tables, window, pos_w, limits):
        """The write-then-attend window through the page table, the body
        of the decode step and the verify (the blocks'
        ``decode_window_paged``) and of the prefill window
        (``prefill_resume_paged``)."""
        params = self._params()
        x = self.emb.embed_window(
            params[0], window, torch.clamp(pos_w, max=self.max_length - 1))
        slots = self._slots_of(tables)
        for i, blk in enumerate(self.blocks):
            x, _ = getattr(blk, method)(params[i + 1], x, self.pool.pools[i],
                                        slots, pos_w, limits=limits)
        return params, x

    def _decode_paged(self, tables, tokens, positions, limits):
        """One paged step (reference ``:294``); ``limits`` (B,) each
        stream's last valid position."""
        name = "serving.decode_step_paged"

        def body(tables, tokens, positions, limits):
            params, x = self._window_paged("decode_window_paged", tables,
                                           tokens[:, None],
                                           positions[:, None], limits)
            return self.head._logits(params[-1], x[:, 0])

        return self._run(name, body, (tables, tokens, positions, limits),
                         self.pool.pools)

    def _verify_paged(self, tables, window, positions0, limits):
        """The speculative verify (reference ``:312``): ``window`` (B, W)
        at ``positions0 + [0, W)`` -> logits (B, W, V). A window that
        overhangs ``max_length`` embeds its overhang at the last position
        (the reference embeds NaN there, and its trash block then spoils
        the next batches; ROADMAP Queue 3); those columns write to the
        trash block, past their stream's limit, and no token of theirs is
        ever emitted."""
        name = "serving.verify_paged"

        def body(tables, window, positions0, limits):
            w = window.shape[1]
            pos_w = positions0[:, None] + torch.arange(
                w, device=window.device)[None, :]
            params, x = self._window_paged("decode_window_paged", tables,
                                           window, pos_w, limits)
            return self.head._logits(params[-1], x)

        return self._run(name, body, (tables, window, positions0, limits),
                         self.pool.pools)

    def _prefill_window_paged(self, window, positions, tables, limits,
                              last_idx):
        """Resumed prefill over one chunk (reference ``:332``): ``window``
        (B, W) at absolute ``positions`` (B, W); ``last_idx`` picks each
        row's last-prompt column for the logits."""
        name = "serving.prefill_window_paged"

        def body(window, positions, tables, limits, last_idx):
            pos_w = torch.clamp(positions, max=self.max_length - 1)
            params, x = self._window_paged("prefill_resume_paged", tables,
                                           window, pos_w, limits)
            return self.head._logits(params[-1],
                                     self._last_rows(x, last_idx))

        return self._run(name, body,
                         (window, positions, tables, limits, last_idx),
                         self.pool.pools)

    def _copy_block(self, src, dst):
        """Copy-on-write (reference ``:365``): block ``src``'s rows into
        ``dst`` in every layer's K and V pool; block ids are data."""
        bs = self.block_size

        def body(src, dst):
            r = torch.arange(bs, device=src.device)
            rows_src, rows_dst = src * bs + r, dst * bs + r
            for p in self.pool.pools:
                p["k"][rows_dst] = p["k"][rows_src]
                p["v"][rows_dst] = p["v"][rows_src]

        self._run("serving.cow_copy", body, (src, dst), self.pool.pools)

    # ------------------------------------------------------------- sampling
    @staticmethod
    def _sample(logits, temperature: float, gen):
        """Greedy argmax, or (``temperature > 0``) a categorical draw by
        Gumbel-max from ``gen``."""
        if temperature and temperature > 0.0:
            u = torch.rand(logits.shape, generator=gen,
                           device=logits.device, dtype=torch.float32)
            return torch.argmax(logits / temperature - torch.log(
                -torch.log(u)), dim=-1)
        return torch.argmax(logits, dim=-1)

    def _prefill_len(self, longest: int) -> int:
        """The prefill width of the longest prompt: its sequence bucket,
        with ``max_length`` as the implicit last bucket (reference
        ``:388``)."""
        t = self.policy.bucket_seq(longest)
        top = self.policy.seq_buckets
        if isinstance(top, tuple) and longest > top[-1]:
            return self.max_length
        return min(t, self.max_length)

    def _prep(self, prompts: Sequence[Sequence[int]], max_new_tokens: int):
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt ({max(lens)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_length ({self.max_length})")
        b_real = len(prompts)
        b = self.policy.bucket_batch(b_real)
        t = self._prefill_len(max(lens))
        tokens = np.zeros((b, t), np.int64)
        lengths = np.ones((b,), np.int64)  # padded rows: 1 fake token
        for i, p in enumerate(prompts):
            tokens[i, :lens[i]] = np.asarray(p, np.int64)
            lengths[i] = lens[i]
        return self._tensor(tokens), self._tensor(lengths), b_real, lens

    @staticmethod
    def _trim_row(row: List[int], max_new: int,
                  eos_id: Optional[int]) -> List[int]:
        row = row[:max_new]
        if eos_id is not None and eos_id in row:
            row = row[: row.index(eos_id) + 1]
        return row

    def _trim(self, steps, b_real: int, max_new_tokens: int,
              eos_id: Optional[int]) -> List[List[int]]:
        stacked = torch.stack(steps, dim=1).cpu().numpy()
        return [self._trim_row([int(v) for v in stacked[i]],
                               max_new_tokens, eos_id)
                for i in range(b_real)]

    # ------------------------------------------------------------ admission
    def _grow(self, need: int):
        """A pool twice the size (or ``need`` blocks) in place of this one
        (reference ``:433``). The old buffers are dropped before the new
        allocation, the trie is flushed, and the programs built on the old
        buffers go."""
        grown = max(need, 2 * self.pool.num_blocks)
        tm.counter("serving.kv_pool_grown_total", model=self.model_id)
        tm.instant("serving.kv_pool_grown", model=self.model_id,
                   blocks=grown)
        if self.cache is not None:
            self.cache.flush()
        old_peak = self.pool.peak_streams
        self.pool.pools = None
        self._drop_paged_programs()
        self.pool = self._new_pool(grown)
        self.pool.peak_streams = old_peak
        self._pool_epoch += 1
        if self.cache is not None:
            self.cache.rebind(self.pool)

    def _admit(self, lens, max_new: int, batch: int, prompts=None):
        """Reserve every stream's blocks for the whole generation, all or
        nothing (reference ``:460``); an automatically sized pool grows
        instead of shedding, except in a nested batch. Returns
        ``(tables_list, tables, starts, cow, pending)``."""
        if self.cache is not None and prompts is not None:
            return self._admit_prefix(prompts, lens, max_new, batch)
        counts = [self.pool.blocks_needed(n, max_new) for n in lens]
        try:
            tables_list = self.pool.reserve(counts)
        except PoolExhaustedError:
            if not self._pool_auto or self._depth > 1:
                raise
            self._grow(int(sum(counts)))
            tables_list = self.pool.reserve(counts)
        tables = self._tensor(self.pool.table_array(tables_list, batch))
        return tables_list, tables, [0] * len(lens), [], []

    def _admit_prefix(self, prompts, lens, max_new: int, batch: int):
        """Prefix-aware admission with its retry ladder (reference
        ``:490``): evict cache-only blocks, then (automatic pools, not
        nested) grow."""
        worst = sum(self.pool.blocks_needed(n, max_new) for n in lens)
        try:
            return self._admit_prefix_once(prompts, lens, max_new, batch)
        except PoolExhaustedError:
            pass
        self.cache.evict(worst)
        try:
            return self._admit_prefix_once(prompts, lens, max_new, batch)
        except PoolExhaustedError:
            if not self._pool_auto or self._depth > 1:
                raise
        self._grow(worst)
        return self._admit_prefix_once(prompts, lens, max_new, batch)

    def _admit_prefix_once(self, prompts, lens, max_new: int, batch: int):
        """One admission attempt, all or nothing across the batch
        (reference ``:510``): on exhaustion every hold it took is rolled
        back before the raise."""
        pool, cache, bs = self.pool, self.cache, self.block_size
        tables_list, starts, cow, pending = [], [], [], []
        with pool._lock:
            try:
                for p, n in zip(prompts, lens):
                    blocks, committed = cache.match(p)  # increfs matched
                    need = pool.blocks_needed(n, max_new)
                    try:
                        fresh = pool.reserve([need - len(blocks)])[0]
                    except PoolExhaustedError:
                        pool.decref(blocks)
                        raise
                    table = list(blocks) + fresh
                    # resume after the committed tokens, but recompute at
                    # least the last prompt token for its logits
                    start = min(committed, n - 1)
                    if start < committed:
                        # a block-aligned full hit: the recomputed position
                        # lies in a shared block, copied before the write
                        bi = start // bs
                        try:
                            nb = pool.cow_split(table[bi])
                        except PoolExhaustedError:
                            pool.release([table])
                            raise
                        cow.append((table[bi], nb))
                        table[bi] = nb
                    pending.extend(cache.insert(p, table))
                    tables_list.append(table)
                    starts.append(start)
            except PoolExhaustedError:
                cache.rollback(pending)
                pool.release(tables_list)
                raise
        tm.gauge("serving.prefix_cache_hit_rate",
                 round(cache.hit_rate(), 4), model=self.model_id)
        tables = self._tensor(pool.table_array(tables_list, batch))
        return tables_list, tables, starts, cow, pending

    # ------------------------------------------------------------- decoding
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16, *, temperature: float = 0.0,
                 key=None, eos_id: Optional[int] = None,
                 trace: bool = False, stats: Optional[Dict] = None,
                 yield_hook=None) -> List[List[int]]:
        """Decode ``prompts`` (reference ``:562``): one prefill and a step
        a token (or verify windows when a draft is attached and the decode
        is greedy). ``temperature=0`` is greedy; otherwise a categorical
        draw from ``key`` (a seed or a torch.Generator; default seed 0).
        ``stats`` (a dict) is filled with ``draft_accept_rate`` per row
        and ``spec_accept_rate`` when speculating, and ``prefix_hit_rate``,
        ``resumed_positions`` and ``prefill_chunks`` with the prefix cache
        or chunked prefill. ``yield_hook`` runs between prefill chunks."""
        if max_new_tokens < 1:
            return [[] for _ in prompts]
        if not self.paged:
            return self._generate_contiguous(
                prompts, max_new_tokens, temperature=temperature, key=key,
                eos_id=eos_id, trace=trace)
        tokens, lengths, b_real, lens = self._prep(prompts, max_new_tokens)
        batch = int(tokens.shape[0])
        self._depth += 1
        try:
            # admission stays outside the reset-on-failure block: a shed
            # allocated nothing and must not reset live pool content
            tables_list, tables, starts, cow, pending = self._admit(
                lens, max_new_tokens, batch, prompts=prompts)
        except BaseException:
            self._depth -= 1
            raise
        if stats is not None and self.cache is not None:
            stats["prefix_hit_rate"] = round(
                sum(starts) / max(1, sum(lens)), 4)
            stats["resumed_positions"] = list(starts)
        try:
            speculate = (self.draft is not None and self.spec_tokens > 0
                         and not (temperature and temperature > 0.0))
            if speculate:
                return self._generate_speculative(
                    tokens, lengths, tables, b_real, lens, max_new_tokens,
                    eos_id=eos_id, trace=trace, stats=stats,
                    starts=starts, cow=cow, pending=pending,
                    yield_hook=yield_hook)
            return self._generate_paged(
                tokens, lengths, tables, b_real, lens, max_new_tokens,
                temperature=temperature, key=key, eos_id=eos_id,
                trace=trace, stats=stats, starts=starts, cow=cow,
                pending=pending, yield_hook=yield_hook)
        except BaseException:
            # pool content never outlives a batch except cached prefixes,
            # which the reset flushes
            if self.cache is not None:
                self.cache.rollback(pending)
            self._reset_pools()
            raise
        finally:
            self._depth -= 1
            self.pool.release(tables_list)

    def _reset_pools(self):
        if self.cache is not None:
            self.cache.flush()
        self.pool.pools = None
        self._drop_paged_programs()
        self.pool.pools = [blk.init_pool(self.pool.num_slots,
                                         device=self.device)
                           for blk in self.blocks]
        self._pool_epoch += 1

    def _window_width(self, max_rem: int) -> int:
        """A chunk window's width: ``prefill_chunk`` when set, else one
        bucketed window over the whole remainder (reference ``:639``)."""
        if self.prefill_chunk is not None:
            return min(self.prefill_chunk, self.max_length)
        return self._prefill_len(max_rem)

    def _run_prefill(self, tokens, lengths, tables, b_real, lens, starts,
                     cow, pending, tele, stats, yield_hook,
                     speculative: bool = False):
        """The prompt phase (reference ``:648``): copy-on-write copies,
        then the whole-prompt prefill (no cache hit, no chunking) or the
        window loop, then the batch's trie nodes committed. Returns the
        next-token logits (B, V)."""
        batch, t = int(tokens.shape[0]), int(tokens.shape[1])
        for src, dst in cow:
            self._copy_block(self._tensor(src), self._tensor(dst))
        t_pf = time.time_ns() if tele else 0
        whole = (not any(starts)) and (self.prefill_chunk is None
                                       or t <= self.prefill_chunk)
        if whole:
            logits = self._prefill_paged(tokens, lengths, tables)
            n_chunks = 1
        else:
            logits, n_chunks = self._prefill_windowed(
                tokens, lengths, tables, b_real, lens, starts, yield_hook)
        if tele:
            tele.event_deferred(
                "serving.generate.prefill", t_pf, time.time_ns(),
                batch=batch, seq=t, paged=True, speculative=speculative,
                prefix_hit=bool(any(starts)),
                resumed=int(sum(starts)), chunks=n_chunks)
        if stats is not None:
            stats["prefill_chunks"] = n_chunks
        if self.cache is not None and pending:
            # the prefill that writes these blocks has been issued; stream
            # order puts every later read after it
            self.cache.commit(pending)
        return logits

    def _prefill_windowed(self, tokens, lengths, tables, b_real, lens,
                          starts, yield_hook):
        """The resume/chunk window loop (reference ``:688``): each row
        computes only its uncached suffix, ``W`` positions a chunk, in
        lockstep (chunk c covers ``start_i + c * W + [0, W)``); rows past
        their prompt pad with columns that write to the trash block.
        ``yield_hook`` runs between chunks; a pool reset under it aborts
        the batch."""
        batch, t = int(tokens.shape[0]), int(tokens.shape[1])
        tokens_np = tokens.cpu().numpy()
        lengths_np = lengths.cpu().numpy()
        starts_np = np.zeros((batch,), np.int64)
        starts_np[:b_real] = np.asarray(starts, np.int64)
        max_rem = max(int(n - s) for n, s in zip(lens, starts))
        w = self._window_width(max_rem)
        n_chunks = math.ceil(max_rem / w)
        limits = self._tensor(lengths_np - 1)
        final: List[Optional[torch.Tensor]] = [None] * batch
        for c in range(n_chunks):
            if c and yield_hook is not None:
                epoch0 = self._pool_epoch
                yield_hook()
                if self._pool_epoch != epoch0:
                    raise RuntimeError(
                        "KV pool reset during chunked-prefill yield; "
                        "aborting the outer batch")
            base = starts_np + c * w
            cols = base[:, None] + np.arange(w, dtype=np.int64)[None, :]
            window = np.take_along_axis(
                tokens_np, np.minimum(cols, t - 1), axis=1)
            window = np.where(cols < lengths_np[:, None], window, 0)
            li = lengths_np - 1 - base
            in_chunk = (li >= 0) & (li < w)
            last_idx = np.clip(li, 0, w - 1)
            logits_c = self._prefill_window_paged(
                self._tensor(window), self._tensor(cols), tables, limits,
                self._tensor(last_idx))
            for i in np.nonzero(in_chunk)[0]:
                final[i] = logits_c[i].clone()  # the next call reuses it
        tm.counter("serving.chunked_prefill_chunks_total", n_chunks,
                   model=self.model_id)
        return torch.stack(final), n_chunks

    def _generate_paged(self, tokens, lengths, tables, b_real, lens,
                        max_new: int, *, temperature: float, key,
                        eos_id: Optional[int], trace: bool, stats=None,
                        starts=(), cow=(), pending=(), yield_hook=None):
        """The per-token paged loop, greedy or sampled (reference
        ``:741``): the contiguous path's sampling stream, so paged equals
        contiguous token for token."""
        gen = _generator(key, self.device)
        tele = tm.get_telemetry() if trace else None
        batch = int(tokens.shape[0])
        limits = self._tensor([n + max_new - 1 for n in lens]
                              + [0] * (batch - b_real))
        logits = self._run_prefill(tokens, lengths, tables, b_real, lens,
                                   starts, cow, pending, tele, stats,
                                   yield_hook)
        positions = lengths
        steps = []
        done = np.zeros(b_real, bool)
        cur = self._sample(logits, temperature, gen)
        for i in range(max_new):
            steps.append(cur)
            if eos_id is not None:
                done |= cur[:b_real].cpu().numpy() == eos_id
                if done.all():
                    break  # every live stream finished: free blocks early
            if i == max_new - 1:
                break
            t_dt = time.time_ns() if tele else 0
            logits = self._decode_paged(tables, cur, positions, limits)
            if tele:
                tele.event_deferred("serving.generate.decode_token", t_dt,
                                    time.time_ns(), step=i + 1, batch=batch)
            positions = positions + 1
            cur = self._sample(logits, temperature, gen)
        return self._trim(steps, b_real, max_new, eos_id)

    def _generate_speculative(self, tokens, lengths, tables, b_real, lens,
                              max_new: int, *, eos_id: Optional[int],
                              trace: bool, stats: Optional[Dict],
                              starts=(), cow=(), pending=(),
                              yield_hook=None):
        """Greedy speculative decode (reference ``:786``). Every emitted
        token is the target's argmax; the draft decides only how many one
        verify window commits. The draft keeps its own contiguous cache,
        filled by its own whole prefill."""
        draft = self.draft
        tele = tm.get_telemetry() if trace else None
        batch = int(tokens.shape[0])
        w = self.spec_tokens + 1  # the window: last accepted + k proposals
        limits = self._tensor([n + max_new - 1 for n in lens]
                              + [0] * (batch - b_real))
        logits = self._run_prefill(tokens, lengths, tables, b_real, lens,
                                   starts, cow, pending, tele, stats,
                                   yield_hook, speculative=True)
        draft._prefill(tokens, lengths)

        cur = torch.argmax(logits, dim=-1)  # the token AT pos
        pos_np = lengths.cpu().numpy()      # cur's position, per row
        rows_t = torch.arange(batch, device=tokens.device)
        prev = tokens[rows_t, lengths - 1]
        emitted: List[List[int]] = [[] for _ in range(batch)]
        done = np.zeros(b_real, bool)
        accept_num = np.zeros(batch, np.int64)
        accept_den = np.zeros(batch, np.int64)
        host_cur = cur.cpu().numpy()
        for i in range(b_real):
            emitted[i].append(int(host_cur[i]))
            if eos_id is not None and int(host_cur[i]) == eos_id:
                done[i] = True

        rounds = 0
        while not done.all() and any(len(emitted[i]) < max_new
                                     for i in range(b_real)
                                     if not done[i]):
            rounds += 1
            positions = self._tensor(np.minimum(pos_np,
                                                self.max_length - 1))
            # the draft's proposal: repair the slot behind cur (idempotent:
            # a K/V write is a function of token and position), then chain
            # spec_tokens greedy draft steps
            draft._decode(prev, torch.clamp(positions - 1, min=0))
            window_cols = [cur]
            dcur = cur
            for j in range(self.spec_tokens):
                dlogits = draft._decode(
                    dcur, torch.clamp(positions + j,
                                      max=self.max_length - 1))
                dcur = torch.argmax(dlogits, dim=-1)
                window_cols.append(dcur)
            window = torch.stack(window_cols, dim=1)  # (B, w)
            live = int((~done).sum())
            t_vf = time.time_ns() if tele else 0
            glogits = self._verify_paged(tables, window, positions, limits)
            g = torch.argmax(glogits, dim=-1).cpu().numpy()  # (B, w)
            win = window.cpu().numpy()
            # accept the longest prefix the draft got right: window[j] is
            # committed iff it equals the target's own next token g[j-1]
            match = win[:, 1:] == g[:, :-1]
            m = 1 + np.cumprod(match, axis=1).sum(axis=1)  # in [1, w]
            accepted_total = 0
            for i in range(b_real):
                if done[i]:
                    continue
                mi = int(m[i])
                accept_num[i] += mi - 1
                accept_den[i] += w - 1
                accepted_total += mi - 1
                for t_new in g[i, :mi]:
                    emitted[i].append(int(t_new))
                    if eos_id is not None and int(t_new) == eos_id:
                        done[i] = True
                        break
                if len(emitted[i]) >= max_new:
                    done[i] = True
            if tele:
                tele.event_deferred(
                    "serving.generate.verify", t_vf, time.time_ns(),
                    batch=batch, window=w, round=rounds,
                    accepted=accepted_total, proposed=live * (w - 1))
            # commit: cur' = g[m-1] at pos+m, prev' = the token at pos+m-1;
            # rejected positions keep their reservation and are rewritten
            # before any read
            rows = np.arange(batch)
            new_cur = g[rows, np.minimum(m, w) - 1]
            new_prev = np.where(m >= 2, g[rows, np.maximum(m - 2, 0)],
                                cur.cpu().numpy())
            cur = self._tensor(new_cur)
            prev = self._tensor(new_prev)
            pos_np = pos_np + m
        if stats is not None:
            rates = [(float(accept_num[i] / accept_den[i])
                      if accept_den[i] else None) for i in range(b_real)]
            stats["draft_accept_rate"] = rates
            real = [r for r in rates if r is not None]
            stats["spec_accept_rate"] = (sum(real) / len(real)
                                         if real else None)
            stats["spec_rounds"] = rounds
        return [self._trim_row(emitted[i], max_new, eos_id)
                for i in range(b_real)]

    def _generate_contiguous(self, prompts, max_new_tokens: int, *,
                             temperature: float, key,
                             eos_id: Optional[int], trace: bool):
        """The contiguous-cache engine (``paged=False``, reference
        ``:902``), the paged path's identity oracle."""
        tokens, lengths, b_real, _ = self._prep(prompts, max_new_tokens)
        gen = _generator(key, self.device)
        tele = tm.get_telemetry() if trace else None
        batch = int(tokens.shape[0])
        t_pf = time.time_ns() if tele else 0
        logits = self._prefill(tokens, lengths)
        if tele:
            tele.event_deferred("serving.generate.prefill", t_pf,
                                time.time_ns(), batch=batch,
                                seq=int(tokens.shape[1]))
        positions = lengths
        steps = []
        cur = self._sample(logits, temperature, gen)
        for i in range(max_new_tokens):
            steps.append(cur)
            if i == max_new_tokens - 1:
                break
            t_dt = time.time_ns() if tele else 0
            logits = self._decode(cur, positions)
            if tele:
                tele.event_deferred("serving.generate.decode_token", t_dt,
                                    time.time_ns(), step=i + 1, batch=batch)
            positions = positions + 1
            cur = self._sample(logits, temperature, gen)
        return self._trim(steps, b_real, max_new_tokens, eos_id)

    def generate_full_recompute(self, prompts: Sequence[Sequence[int]],
                                max_new_tokens: int = 16, *,
                                temperature: float = 0.0, key=None,
                                eos_id: Optional[int] = None,
                                logits_out: Optional[list] = None
                                ) -> List[List[int]]:
        """O(T^2) decode (reference ``:942``): the contiguous prefill
        rerun over the whole grown sequence for every token, with the
        sampling stream of :meth:`generate`; the KV-cache paths must
        reproduce it. ``logits_out`` (a list) receives each step's
        (rows, V) logits on the host, for near-tie checks."""
        if max_new_tokens < 1:
            return [[] for _ in prompts]
        grown = [list(p) for p in prompts]
        gen = _generator(key, self.device)
        steps = []
        for _ in range(max_new_tokens):
            tokens, lengths, b_real, _ = self._prep(grown, 1)
            logits = self._prefill(tokens, lengths)
            if logits_out is not None:
                logits_out.append(logits[:b_real].cpu().numpy())
            cur = self._sample(logits, temperature, gen)
            steps.append(cur)
            host = cur.cpu().numpy()
            for r in range(len(grown)):
                grown[r].append(int(host[r]))
        return self._trim(steps, len(prompts), max_new_tokens, eos_id)

    # -------------------------------------------------------------- health
    def health_probe(self) -> bool:
        """Finite-logits canary (reference ``:974``): one tiny prompt
        through the smallest-bucket prefill. The paged probe first audits
        the pool's refcount conservation (and the trie's, with the prefix
        cache), then runs with an all-trash page table."""
        b = int(self.policy.bucket_batch(1))
        t = self._prefill_len(1)
        tokens = torch.ones((b, t), dtype=_I64, device=self.device)
        lengths = torch.ones((b,), dtype=_I64, device=self.device)
        if self.paged:
            ok, detail = self.pool.conservation()
            if ok and self.cache is not None:
                ok, detail = self.cache.check(
                    strict_idle=(self.pool._streams == 0))
            check = ("serving.kv_pool_conservation"
                     + (f".{self.model_id}" if self.model_id else ""))
            tm.set_health(check, ok, detail)
            if not ok:
                return False
            tables = torch.zeros((b, self.pool.max_blocks_per_stream),
                                 dtype=_I64, device=self.device)
            logits = self._prefill_paged(tokens, lengths, tables)
        else:
            logits = self._prefill(tokens, lengths)
        return bool(torch.isfinite(logits).all())

    # -------------------------------------------------------------- warmup
    def warmup(self, batch_sizes=None, prompt_lengths=None) -> int:
        """Build every (batch bucket x prefill bucket) prefill, each batch
        bucket's decode step, and, when speculating, each verify window and
        the draft's programs, so steady-state serving builds nothing
        (reference ``:1012``). Returns the number of programs primed."""
        if batch_sizes is None:
            if not isinstance(self.policy.batch_buckets, tuple):
                raise ValueError("warmup() without batch_sizes needs "
                                 "explicit batch buckets")
            batch_sizes = self.policy.batch_buckets
        if prompt_lengths is None:
            if isinstance(self.policy.seq_buckets, tuple):
                prompt_lengths = tuple(self.policy.seq_buckets) \
                    + (self.max_length,)
            else:
                prompt_lengths = tuple(
                    2 ** i for i in range(self.max_length.bit_length())
                ) + (self.max_length,)
        primed = 0
        window = self.paged and (self.cache is not None
                                 or self.prefill_chunk is not None)

        def z(*shape):
            return torch.zeros(shape, dtype=_I64, device=self.device)

        for b in batch_sizes:
            b = int(b)
            tables = (z(b, self.pool.max_blocks_per_stream) if self.paged
                      else None)
            widths = sorted({min(int(t), self.max_length)
                             for t in prompt_lengths})
            ones = torch.ones((b,), dtype=_I64, device=self.device)
            for t in widths:
                if self.paged:
                    self._prefill_paged(z(b, t), ones, tables)
                else:
                    self._prefill(z(b, t), ones)
                primed += 1
            if window:
                for t in ((min(self.prefill_chunk, self.max_length),)
                          if self.prefill_chunk is not None else widths):
                    self._prefill_window_paged(z(b, t), z(b, t), tables,
                                               z(b), z(b))
                    primed += 1
            cur = z(b)
            if self.paged:
                limits = torch.full((b,), self.max_length - 1, dtype=_I64,
                                    device=self.device)
                self._decode_paged(tables, cur, ones, limits)
                primed += 1
                if self.draft is not None and self.spec_tokens > 0:
                    self._verify_paged(tables, z(b, self.spec_tokens + 1),
                                       ones, limits)
                    primed += 1
            else:
                self._decode(cur, ones)
                primed += 1
        if window:
            self._copy_block(z(), z())
            primed += 1
        if self.draft is not None:
            primed += self.draft.warmup(batch_sizes=batch_sizes,
                                        prompt_lengths=prompt_lengths)
        return primed

    # ---------------------------------------------------------------- stats
    def pool_stats(self) -> Optional[dict]:
        if self.pool is None:
            return None
        s = self.pool.stats()
        if self.cache is not None:
            s["prefix_cache"] = self.cache.stats()
        if self.prefill_chunk is not None:
            s["prefill_chunk"] = self.prefill_chunk
        return s

    def prefix_hit_rate(self) -> Optional[float]:
        """Lifetime prefix-cache token hit rate, or None without the
        cache."""
        if self.cache is None:
            return None
        return round(self.cache.hit_rate(), 4)
