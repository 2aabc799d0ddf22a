"""The port's radix prefix cache (``llm_sharding_tpu_torch/runtime/radix.py``)
against the JAX package's (``llm_sharding_tpu/runtime/radix.py``), each over
its own package's ``BlockAllocator``, with numpy read/write callbacks
standing in for the arena.

Each scenario mirrors a unit test of ``tests/test_radix.py`` or
``tests/test_disk_tier.py`` and runs the same sequence of operations
through both caches, recording what each call returns and, after each
step, the state: match lengths, block ids, ``stats()``, the allocator's
refcounts, cache marks and free list, every node's tier, blocks and host
copies byte for byte, and the disk pool's file names. The two records must
be equal, exactly. The bf16 case hands the JAX tree ``ml_dtypes`` bfloat16
arrays and the port's tree their ``uint16`` views (numpy has no bfloat16),
and holds the bytes equal.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX package is the reference

from llm_sharding_tpu.runtime import blocks as jblocks
from llm_sharding_tpu.runtime import radix as jradix
from llm_sharding_tpu_torch.runtime import blocks as tblocks
from llm_sharding_tpu_torch.runtime import radix as tradix

BS = 8
SIDES = {"jax": (jradix, jblocks), "port": (tradix, tblocks)}


class Store:
    """Per-block host copies ``(k, v)`` of shape ``[1, 1, BS, 1, 1]``: the
    arena the callbacks read and write."""

    def __init__(self, dtype=np.float32):
        self.blocks = {}
        self.dtype = dtype

    def read_kv(self, blocks):
        k = np.stack([self.blocks[b][0] for b in blocks], axis=2)
        v = np.stack([self.blocks[b][1] for b in blocks], axis=2)
        return k, v

    def write_kv(self, blocks, k, v):
        assert k.dtype == self.dtype and v.dtype == self.dtype
        for i, b in enumerate(blocks):
            self.blocks[b] = (k[:, :, i], v[:, :, i])

    def fill(self, blocks):
        for b in blocks:
            self.blocks[b] = (
                np.full((1, 1, BS, 1, 1), b, np.float32).astype(self.dtype),
                np.full((1, 1, BS, 1, 1), -b, np.float32).astype(self.dtype),
            )


class Side:
    """One package's allocator, cache and store, and the record of what
    they did."""

    def __init__(self, name, tmp=None, host=16, disk=0, nblocks=64, store=None, **kw):
        radix, blocks = SIDES[name]
        self.store = store or Store()
        self.a = blocks.BlockAllocator(nblocks, BS)
        self.tmp = tmp
        self.c = radix.RadixCache(
            self.a, BS, host_pool_blocks=host, read_kv=self.store.read_kv,
            write_kv=self.store.write_kv,
            disk_pool_dir=None if tmp is None else str(tmp), disk_pool_blocks=disk, **kw,
        )
        self.log = []

    def rec(self, tag, value):
        self.log.append((tag, value))
        return value

    def alloc(self, n, fill=True):
        b = self.a.alloc(n)
        if fill:
            self.store.fill(b)
        return self.rec("alloc", b)

    def take(self, ids, n):
        ref = self.c.take(ids, n)
        self.rec("take", None if ref is None else (ref.n, list(ref.blocks), ref.tier_tokens))
        return ref

    def snap(self, tag):
        """The whole observable state, after both invariants are checked."""
        self.c.check()
        self.a.check()
        nodes = []
        for n in self.c._iter_nodes():
            host = None if n.host_kv is None else [
                (a.shape, a.dtype.itemsize, a.tobytes()) for a in n.host_kv
            ]
            nodes.append((tuple(int(t) for t in self.c._prefix_of(n)), n.tier(),
                          list(n.blocks), n.refs, n.last_used, n.disk_entry, n.host_owners, host))
        files = sorted(os.listdir(self.tmp)) if self.tmp is not None else None
        self.rec(tag, dict(
            stats=self.c.stats(), ref=self.a._ref.tolist(), cached=self.a._cached.tolist(),
            free=list(self.a._free), nodes=nodes, files=files,
        ))


def twin(scenario, tmp_path=None, **kw):
    """Run ``scenario(side)`` through both packages; their records must be
    equal."""
    logs = {}
    for name in SIDES:
        tmp = None
        if tmp_path is not None:
            tmp = tmp_path / name
            tmp.mkdir()
        side = Side(name, tmp, **kw)
        scenario(side)
        logs[name] = side.log
    assert len(logs["port"]) == len(logs["jax"])
    for (tj, vj), (tp, vp) in zip(logs["jax"], logs["port"]):
        assert tj == tp
        assert vp == vj, f"{tj}: port {vp!r} != jax {vj!r}"


def arange(s, n):
    return np.arange(s, s + n, dtype=np.int32)


# ------------------------------------------------- test_radix.py units


def test_insert_match_split_and_block_alignment():
    def run(s):
        a, c = s.a, s.c
        ids = arange(100, 3 * BS)
        blocks = s.alloc(3)
        s.rec("insert", sorted(c.insert(ids, blocks)))
        s.snap("inserted")
        s.rec("m_full", c.match_tokens(ids))
        s.rec("m_floor", c.match_tokens(ids[: 2 * BS - 1]))
        s.rec("m_miss", c.match_tokens(ids + 1000))
        dup = s.alloc(2)
        s.rec("insert_dup", sorted(c.insert(ids[: 2 * BS], dup)))
        a.free(dup)
        ids2 = ids.copy()
        ids2[2 * BS] = 7
        b2 = s.alloc(3)
        s.rec("insert_split", sorted(c.insert(ids2, b2)))
        a.free(b2[:2])
        s.snap("split")
        s.rec("m2", (c.match_tokens(ids2), c.match_tokens(ids)))
        ids3 = ids.copy()
        ids3[2 * BS + 1] = 9
        b3 = s.alloc(3)
        s.rec("insert_sub_block", sorted(c.insert(ids3, b3)))
        a.free(b3)
        s.snap("end")

    twin(run)


def test_pins_block_eviction_and_lru_order():
    def run(s):
        a, c = s.a, s.c
        seqs = [arange(x, 2 * BS) for x in (0, 500, 900)]
        for ids in seqs:
            c.insert(ids, s.alloc(2))
        s.rec("evictable", c.evictable_blocks())
        ref = s.take(seqs[0], 2 * BS)
        s.rec("evictable_pinned", c.evictable_blocks())
        s.rec("ensure_free", c.ensure_free(a.num_free + 2))
        s.snap("evicted")
        s.rec("pinned_match", c.match_tokens(seqs[0]))
        c.release(ref)
        s.rec("evictable_after", c.evictable_blocks())
        demoted = next(ids for ids in seqs[1:] if c.match_tokens(ids) == 2 * BS)
        ref2 = s.take(demoted, 2 * BS)
        s.rec("restored_bytes", s.store.read_kv(ref2.blocks)[0].tobytes())
        c.release(ref2)
        s.snap("end")

    twin(run)


def test_insert_through_host_node_keeps_block_cursor():
    def run(s):
        a, c = s.a, s.c
        c.insert(arange(0, 3 * BS), s.alloc(3))
        s.rec("ensure_free", c.ensure_free(a.num_free + 3))
        s.snap("demoted")
        ids2 = arange(0, 4 * BS)
        b2 = s.alloc(4)
        s.rec("consumed", sorted(c.insert(ids2, b2)))
        a.free(b2[:3])
        s.snap("inserted")
        ref = s.take(ids2, 4 * BS)
        c.release(ref)
        s.snap("end")

    twin(run)


def test_insert_splits_pinned_edge_at_block_boundary():
    def run(s):
        a, c = s.a, s.c
        ids = arange(0, 3 * BS)
        c.insert(ids, s.alloc(3))
        ref = s.take(ids, 3 * BS)
        ids2 = ids.copy()
        ids2[2 * BS] = 7
        b2 = s.alloc(3)
        s.rec("consumed", sorted(c.insert(ids2, b2)))
        a.free(b2[:2])
        s.snap("split_pinned")
        s.rec("match", (c.match_tokens(ids2), c.match_tokens(ids)))
        c.release(ref)
        ref2 = s.take(ids2, 3 * BS)
        c.release(ref2)
        s.snap("end")

    twin(run)


def test_host_pool_cap_drops_lru():
    def run(s):
        for x in (0, 500):
            s.c.insert(arange(x, 2 * BS), s.alloc(2))
        s.rec("ensure_free", s.c.ensure_free(s.a.num_free + 4))
        s.snap("end")

    twin(run, host=2)


def test_pin_release_drop_all_and_misuse():
    """``pin`` (a co-admitted row's extra pin), ``drop_all`` keeping the
    pinned path, and the same refusals of misuse."""
    def run(s):
        c = s.c
        ids = arange(40, 2 * BS)
        c.insert(ids, s.alloc(2))
        c.insert(arange(300, BS), s.alloc(1))
        ref = s.take(ids, 2 * BS)
        c.pin(ref)
        c.drop_all()
        s.snap("pinned_kept")
        c.release(ref)
        c.release(ref)
        with pytest.raises(AssertionError, match="without a matching pin"):
            c.release(ref)
        with pytest.raises(ValueError, match="not a multiple of the block size"):
            c.insert(arange(0, BS + 1), [1, 2])
        with pytest.raises(ValueError, match="do not cover"):
            c.insert(arange(0, 2 * BS), [1])
        c.drop_all()
        s.snap("end")

    twin(run)


@pytest.mark.parametrize("kw, match", [
    (dict(host_pool_blocks=-1), "host_pool_blocks must be >= 0"),
    (dict(host_pool_blocks=4), "needs read_kv/write_kv"),
    (dict(disk_pool_blocks=-1), "disk_pool_blocks must be >= 0"),
    (dict(disk_pool_blocks=4), "needs a disk_pool_dir"),
    (dict(disk_pool_blocks=4, disk_pool_dir="unused"), "needs host_pool_blocks > 0"),
])
def test_constructor_refusals_match(kw, match):
    for name in SIDES:
        radix, blocks = SIDES[name]
        with pytest.raises(ValueError, match=match):
            radix.RadixCache(blocks.BlockAllocator(8, BS), BS, **kw)


def test_snapshot_restore_of_the_tree():
    """The tree's own ``snapshot`` / ``restore`` (device and host tiers):
    the snapshot's node metadata and arrays equal the JAX tree's, and a
    fresh cache over an allocator ``restore``d with the device nodes'
    blocks comes back with the same state."""
    def run(s):
        c = s.c
        c.insert(arange(0, 3 * BS), s.alloc(3))
        c.insert(arange(600, 2 * BS), s.alloc(2))
        c.hit_tokens, c.eligible_tokens = 16, 40
        s.c.ensure_free(s.a.num_free + 2)  # one node to the host tier
        snap = c.snapshot()
        arrays = {k: v.tobytes() for k, v in snap["arrays"].items()}
        s.rec("snapshot", (snap["nodes"], arrays, snap["counters"]))
        radix, blocks = (tradix, tblocks) if isinstance(c, tradix.RadixCache) else (jradix, jblocks)
        a2 = blocks.BlockAllocator(64, BS)
        dev = [m["blocks"] for m in snap["nodes"] if m["tier"] == "hbm"]
        a2.restore(dev, [])
        c2 = radix.RadixCache(a2, BS, host_pool_blocks=16, read_kv=s.store.read_kv,
                              write_kv=s.store.write_kv)
        c2.restore(snap, snap["arrays"])
        s.c, s.a = c2, a2
        s.snap("restored")
        ref = s.take(arange(600, 2 * BS), 2 * BS)
        c2.release(ref)
        s.snap("end")

    twin(run)


def test_allocator_share_restore_and_cache_marks_match():
    """``share``, ``restore`` and the cache marks of the port's allocator
    against the JAX one, misuse included."""
    for name in SIDES:
        blocks = SIDES[name][1]
        a = blocks.BlockAllocator(10, 4)
        x = a.alloc(3)
        a.share(x[:2])
        a.mark_cached(x[:1])
        with pytest.raises(ValueError, match="share of unallocated"):
            a.share([0])
        with pytest.raises(ValueError, match="mark_cached of unallocated"):
            a.mark_cached([9])
        a.check()
        if name == "jax":
            want = (a._ref.tolist(), a._cached.tolist())
        else:
            assert (a._ref.tolist(), a._cached.tolist()) == want
    for name in SIDES:
        blocks = SIDES[name][1]
        a = blocks.BlockAllocator(10, 4)
        a.restore([[3, 1], [5]], [[7, 8], [7]])
        a.check()
        with pytest.raises(ValueError, match="non-empty"):
            a.restore([], [])
        if name == "jax":
            want = (a._ref.tolist(), list(a._free))
        else:
            assert (a._ref.tolist(), list(a._free)) == want
    for name in SIDES:
        blocks = SIDES[name][1]
        a = blocks.BlockAllocator(10, 4)
        with pytest.raises(ValueError, match="double-owned"):
            a.restore([[3], [3]], [])


# --------------------------------------------- test_disk_tier.py units


def test_ladder_demote_promote_byte_exact(tmp_path):
    def run(s):
        c = s.c
        ids = arange(0, 3 * BS)
        c.insert(ids, s.alloc(3))
        s.rec("moved", c.demote_all(to_disk=True))
        s.snap("on_disk")
        meta = json.load(open(s.tmp / "e0.json"))
        s.rec("meta", (meta["prefix"], meta["edge"], meta["comps"], meta["crc"]))
        ref = s.take(ids, 3 * BS)
        s.rec("promoted", [s.store.blocks[b][0].tobytes() for b in ref.blocks])
        c.release(ref)
        s.snap("end")

    twin(run, tmp_path, disk=16)


def test_disk_entry_carries_bf16_bytes(tmp_path):
    """A bf16 arena round-trips the disk tier byte-exactly: the JAX tree
    holds ml_dtypes bfloat16 arrays, the port's their uint16 views, with
    the same bytes at every step."""
    import ml_dtypes

    bf16 = np.dtype(ml_dtypes.bfloat16)
    rng = np.random.default_rng(97)
    vals = rng.standard_normal((2, 2, 1, 1, BS, 1, 1)).astype(bf16)
    logs = {}
    for name, dt in (("jax", bf16), ("port", np.uint16)):
        tmp = tmp_path / name
        tmp.mkdir()
        s = Side(name, tmp, disk=16, store=Store(dt))
        b = s.a.alloc(2)
        for i, blk in enumerate(b):
            s.store.blocks[blk] = (vals[i, 0].view(dt), vals[i, 1].view(dt))
        s.c.insert(arange(0, 2 * BS), b)
        s.rec("moved", s.c.demote_all(to_disk=True))
        meta = json.load(open(tmp / "e0.json"))
        s.rec("crc", meta["crc"])
        s.snap("on_disk")
        ref = s.take(arange(0, 2 * BS), 2 * BS)
        s.rec("bytes", [(s.store.blocks[x][0].tobytes(), s.store.blocks[x][1].tobytes())
                        for x in ref.blocks])
        s.c.release(ref)
        s.snap("end")
        logs[name] = s.log
    assert logs["port"] == logs["jax"]
    assert logs["port"][-2][1] == [(vals[i, 0].tobytes(), vals[i, 1].tobytes()) for i in range(2)]


def test_disk_entry_tagged_extension_dtype_reads_back_raw(tmp_path):
    """A meta naming an extension dtype (as a JAX-era bf16 entry's would)
    reads back in the port as the raw view, no ml_dtypes needed."""
    assert tradix.RadixCache._np_dtype("bfloat16") == np.dtype(np.uint16)
    assert tradix.RadixCache._np_dtype("float8_e4m3fn") == np.dtype(np.uint8)
    assert tradix.RadixCache._np_dtype("int8") == np.dtype(np.int8)
    with pytest.raises(TypeError):
        tradix.RadixCache._np_dtype("no_such_dtype")


def test_disk_pool_cap_drops_lru(tmp_path):
    def run(s):
        c = s.c
        for x in (0, 500):
            c.insert(arange(x, 2 * BS), s.alloc(2))
        s.rec("moved", c.demote_all(to_disk=True))
        s.snap("capped")
        s.rec("match", (c.match_tokens(arange(0, 2 * BS)), c.match_tokens(arange(500, 2 * BS))))
        ids = arange(900, 3 * BS)
        c.insert(ids, s.alloc(3))
        c.demote_all(to_disk=True)
        s.rec("parked", c.match_tokens(ids))
        s.snap("end")

    twin(run, tmp_path, disk=2)


def test_crash_mid_spill_is_invisible(tmp_path):
    def run(s):
        c = s.c
        ids = arange(0, 2 * BS)
        b = s.alloc(2)
        c.insert(ids, b)
        c.demote_all(to_disk=True)
        open(s.tmp / "e1.kv0.npy", "wb").write(b"\x93NUMPY partial")
        open(s.tmp / "e1.kv1.npy.tmp", "wb").write(b"torn tmp")
        radix, blocks = (tradix, tblocks) if isinstance(c, tradix.RadixCache) else (jradix, jblocks)
        store2 = Store()
        a2 = blocks.BlockAllocator(64, BS)
        c2 = radix.RadixCache(a2, BS, host_pool_blocks=16, read_kv=store2.read_kv,
                              write_kv=store2.write_kv, disk_pool_dir=str(s.tmp),
                              disk_pool_blocks=16)
        s.rec("adopted", c2.adopt_pool())
        s.c, s.a, s.store = c2, a2, store2
        s.snap("adopted")
        ref = s.take(ids, 2 * BS)
        s.rec("promoted", [store2.blocks[x][1].tobytes() for x in ref.blocks])
        c2.release(ref)
        s.rec("seq", c2._entry_seq)
        s.snap("end")

    twin(run, tmp_path, disk=16)


def test_corrupt_entry_drops_node_and_truncates_match(tmp_path):
    def run(s):
        c = s.c
        ids = arange(0, 2 * BS)
        c.insert(ids, s.alloc(2))
        c.demote_all(to_disk=True)
        path = s.tmp / "e0.kv0.npy"
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF
        path.write_bytes(bytes(raw))
        s.take(ids, 2 * BS)
        s.snap("corrupt")
        ids2 = arange(700, 2 * BS)
        c.insert(ids2, s.alloc(2))
        c.demote_all(to_disk=True)
        os.unlink([s.tmp / f for f in os.listdir(s.tmp) if f.endswith(".kv1.npy")][0])
        s.take(ids2, 2 * BS)
        s.snap("end")

    twin(run, tmp_path, disk=16)


def test_adopt_pool_chains_and_owner_tags(tmp_path):
    def run(s):
        c = s.c
        ids = arange(0, 3 * BS)
        c.insert(ids, s.alloc(3))
        ids2 = ids.copy()
        ids2[2 * BS] = 7
        c.insert(ids2, s.alloc(3))
        c.demote_all(to_disk=True)
        s.snap("spilled")
        radix, blocks = (tradix, tblocks) if isinstance(c, tradix.RadixCache) else (jradix, jblocks)

        def fresh():
            store = Store()
            a = blocks.BlockAllocator(64, BS)
            return a, store, radix.RadixCache(
                a, BS, host_pool_blocks=16, read_kv=store.read_kv, write_kv=store.write_kv,
                disk_pool_dir=str(s.tmp), disk_pool_blocks=16, block_owner=lambda b: b % 2,
            )

        a2, store2, c2 = fresh()
        s.rec("adopted", c2.adopt_pool())
        s.c, s.a, s.store = c2, a2, store2
        s.snap("adopted")
        s.rec("match", (c2.match_tokens(ids), c2.match_tokens(ids2)))
        metas = [json.load(open(s.tmp / f)) for f in os.listdir(s.tmp) if f.endswith(".json")]
        root = min((m["prefix"] for m in metas), key=len)
        for f in list(os.listdir(s.tmp)):
            if f.endswith(".json") and json.load(open(s.tmp / f))["prefix"] == root:
                os.unlink(s.tmp / f)
        a3, store3, c3 = fresh()
        s.rec("orphans_adopted", c3.adopt_pool())
        s.c, s.a, s.store = c3, a3, store3
        s.snap("end")

    twin(run, tmp_path, disk=16, block_owner=lambda b: b % 2)
