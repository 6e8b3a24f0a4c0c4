"""The port's paged KV allocator and prefix cache against the JAX
package's (``serving/paged.py``), on the CPU.

Seeded random sequences of reserve, release, copy-on-write splits, trie
match, insert, commit, rollback, eviction and flush drive both packages'
``BlockPool`` and ``PrefixCache`` side by side; after every operation the
free lists, refcounts, stream counts, page-table arrays, ``stats()``,
``conservation()`` and the trie's ``check()`` must agree, and so must
every raised ``PoolExhaustedError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.serving import paged as jpaged  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch.serving import paged as tpaged  # noqa: E402
from deeplearning4j_tpu_torch.zoo import Bert as TBert  # noqa: E402

BS = 4


class Side:
    """One package's pool and cache, the live streams' tables, and the
    pending trie nodes of streams whose batch has not resolved them yet
    (a stream is released only after its nodes are committed or rolled
    back, as the generator does)."""

    def __init__(self, mod, num_blocks, max_length):
        self.mod = mod
        self.pool = mod.BlockPool([], block_size=BS, num_blocks=num_blocks,
                                  max_length=max_length)
        self.cache = mod.PrefixCache(self.pool)
        self.tables = []
        self.pending = {}  # table index -> its batch's pending nodes

    def state(self):
        p, c = self.pool, self.cache
        return {
            "free": list(p._free), "ref": dict(p._ref),
            "streams": p._streams, "peak": p.peak_streams,
            "stats": p.stats(), "cache": c.stats(),
            "conservation": p.conservation(),
            "check": c.check(strict_idle=(p._streams == 0)),
            "shared": p.shared_blocks(),
            "tables": p.table_array(self.tables, max(1, len(self.tables)))
            .tolist(),
        }


def _apply(side, op):
    """Run one operation; returns its result or the error's type name."""
    kind, args = op
    try:
        if kind == "admit":
            tokens, max_new = args
            with side.pool._lock:
                blocks, committed = side.cache.match(tokens)
                need = side.pool.blocks_needed(len(tokens), max_new)
                try:
                    fresh = side.pool.reserve([need - len(blocks)])[0]
                except side.mod.PoolExhaustedError:
                    side.pool.decref(blocks)
                    raise
                table = list(blocks) + fresh
                side.pending[id(table)] = side.cache.insert(tokens, table)
                side.tables.append(table)
            return (list(blocks), committed, table)
        if kind == "reserve":
            out = side.pool.reserve(args)
            side.tables.extend(out)
            return out
        if kind == "release":
            done = [t for t in side.tables if id(t) not in side.pending]
            if not done:
                return None
            t = done[args % len(done)]
            del side.tables[next(i for i, x in enumerate(side.tables)
                                 if x is t)]
            side.pool.release([t])
            return t
        if kind == "cow":  # a resolved stream's shared block
            shared = [(i, j) for i, t in enumerate(side.tables)
                      if id(t) not in side.pending
                      for j, b in enumerate(t) if side.pool.refcount(b) > 1]
            if not shared:
                return None
            i, j = shared[args % len(shared)]
            nb = side.pool.cow_split(side.tables[i][j])
            side.tables[i][j] = nb
            return nb
        if kind in ("commit", "rollback"):
            keys = [id(t) for t in side.tables if id(t) in side.pending]
            if not keys:
                return None
            nodes = side.pending.pop(keys[args % len(keys)])
            getattr(side.cache, kind)(nodes)
            return [n.block for n in nodes]
        if kind == "evict":
            return side.cache.evict(args)
        if kind == "flush":  # a pool reset: every batch rolled back first
            for t in side.tables:
                side.cache.rollback(side.pending.pop(id(t), []))
            side.cache.flush()
            return None
        if kind == "match_only":
            blocks, committed = side.cache.match(args)
            side.pool.decref(blocks)
            return (blocks, committed)
    except (side.mod.PoolExhaustedError, ValueError) as e:
        return type(e).__name__
    raise AssertionError(kind)


def _ops(seed, n):
    rng = np.random.default_rng(seed)
    bases = [list(rng.integers(0, 5, size=12)) for _ in range(3)]
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            base = bases[rng.integers(0, 3)]
            cut = int(rng.integers(1, 13))
            tail = list(rng.integers(0, 5, size=int(rng.integers(0, 6))))
            ops.append(("admit", (base[:cut] + tail,
                                  int(rng.integers(1, 6)))))
        elif r < 0.45:
            ops.append(("reserve", [int(c) for c in rng.integers(
                0, 4, size=int(rng.integers(1, 4)))]))
        elif r < 0.62:
            ops.append(("release", int(rng.integers(0, 100))))
        elif r < 0.70:
            ops.append(("cow", int(rng.integers(0, 100))))
        elif r < 0.80:
            ops.append(("commit", int(rng.integers(0, 100))))
        elif r < 0.85:
            ops.append(("rollback", int(rng.integers(0, 100))))
        elif r < 0.93:
            ops.append(("evict", int(rng.integers(1, 12))))
        elif r < 0.98:
            ops.append(("match_only", bases[rng.integers(0, 3)][
                :int(rng.integers(1, 13))]))
        else:
            ops.append(("flush", None))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_pool_and_cache_follow_reference(seed):
    num_blocks = (12, 20, 32, 48, 16, 24)[seed]
    ref = Side(jpaged, num_blocks, 32)
    port = Side(tpaged, num_blocks, 32)
    for step, op in enumerate(_ops(seed, 160)):
        a, b = _apply(ref, op), _apply(port, op)
        assert a == b, (step, op, a, b)
        assert ref.state() == port.state(), (step, op)
    for side in (ref, port):  # wind down: every block comes back
        for t in side.tables:
            side.cache.commit(side.pending.pop(id(t), []))
        while side.tables:
            _apply(side, ("release", 0))
        side.cache.flush()
    assert ref.state() == port.state()
    assert port.pool.free_blocks() == num_blocks
    assert port.state()["conservation"][0]


def test_default_pool_blocks_and_geometry():
    for bb in ((1, 2, 4), (32,), ()):
        assert tpaged.default_pool_blocks(bb, 512, 16) == \
            jpaged.default_pool_blocks(bb, 512, 16)
    jnet = JBert.tiny(causal=True, task="mlm", vocab_size=97,
                      max_length=32).init()
    tnet = TBert.tiny(causal=True, task="mlm", vocab_size=97,
                      max_length=32).init(device="cpu")
    jp = jpaged.BlockPool(jnet.layers[1:-1], block_size=4, num_blocks=9,
                          max_length=32)
    tp = tpaged.BlockPool(tnet.layers[1:-1], block_size=4, num_blocks=9,
                          max_length=32, device="cpu")
    assert tp.bytes_per_token() == jp.bytes_per_token() == 2 * 2 * 128 * 4
    assert tp.pool_bytes() == jp.pool_bytes()
    assert tp.num_slots == jp.num_slots == 40
    assert [tuple(p["k"].shape) for p in tp.pools] == \
        [tuple(p["k"].shape) for p in jp.pools]
    assert all(p["k"].data_ptr() != p["v"].data_ptr() for p in tp.pools)
    assert tp.stats() == jp.stats()


def test_allocator_faults_raise_like_reference():
    for mod in (jpaged, tpaged):
        pool = mod.BlockPool([], block_size=4, num_blocks=3, max_length=16)
        t = pool.reserve([2])[0]
        with pytest.raises(ValueError, match="incref of unallocated"):
            pool.incref([1])  # reserve took 3 and 2
        pool.release([t])
        with pytest.raises(ValueError, match="double-free"):
            pool.decref(t[:1])
        with pytest.raises(ValueError, match="cow_split of free"):
            pool.cow_split(t[0])
        pool._free.append(pool._free[0])  # a corrupted free list
        ok, detail = pool.conservation()
        assert not ok and "double-free" in detail
        cache = mod.PrefixCache(mod.BlockPool([], block_size=4, num_blocks=3,
                                              max_length=16))
        t = cache.pool.reserve([1])[0]
        cache.insert([1, 2, 3, 4], t)
        with pytest.raises(RuntimeError, match="flush"):
            cache.rebind(cache.pool)
