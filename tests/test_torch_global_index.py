"""The port's cluster-global radix index (``runtime/global_index.py``)
against the JAX package's ``GlobalRadixIndex``: the chained block hashes
are byte-identical, so over mirrored op sequences (publish, remove,
drop_replica, scores, best) the two maps hold the same keys with the same
entries, and every lookup and ``stats()`` agrees exactly. Then the fleets
of both packages (tiny_llama, f32, paged, ``prefix_cache="hbm"``, one CPU
device per replica) serve the same requests: the indexes the replicas
publish into end equal, the router places a warm prompt on the warm
replica without probing any tree, ``global_index=False`` turns both off,
and ``/indexz`` on the port's ingress serves the port index's stats.
Every comparison here is exact (tolerance 0).
"""

import http.client
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime import global_index as jgi
from llm_sharding_tpu.runtime.replicated import ReplicatedServer as JReplicated
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.runtime import global_index as tgi
from llm_sharding_tpu_torch.runtime.ingress import IngressServer
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

LAYERS = 2
CFG = tcfg.tiny_llama(num_hidden_layers=LAYERS)
BS = 4
CAP = 64
TIERS = ("hbm", "host", "disk")


def ids(seed, n):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n).astype(np.int32)


@pytest.mark.parametrize("bs", [1, 4, 8, 16])
@pytest.mark.parametrize("n", [0, 7, 33])
def test_chain_bytes_equal_jax(bs, n):
    seq = ids(bs * 100 + n, n)
    got = tgi.GlobalRadixIndex(bs)._chain(seq)
    want = jgi.GlobalRadixIndex(bs)._chain(seq)
    assert got == want and len(got) == n // bs
    assert tgi.TIER_WEIGHT == jgi.TIER_WEIGHT


def test_block_size_refusal_equals_jax():
    with pytest.raises(ValueError) as t:
        tgi.GlobalRadixIndex(0)
    with pytest.raises(ValueError) as j:
        jgi.GlobalRadixIndex(0)
    assert str(t.value) == str(j.value)


def _mirror(seed: int, bs: int, steps: int = 120):
    """One random op sequence over a pool of shared-prefix prompts, run on
    both indexes; every returned value compared as it comes."""
    rng = np.random.default_rng(seed)
    trunk = ids(seed, 6 * bs)
    pool = [np.concatenate([trunk[: bs * rng.integers(0, 6)], ids(seed * 31 + i, rng.integers(0, 4 * bs))])
            for i in range(10)]
    reps = [f"g{i}" for i in range(4)]
    t, j = tgi.GlobalRadixIndex(bs), jgi.GlobalRadixIndex(bs)
    for _ in range(steps):
        op = rng.integers(0, 10)
        p = pool[rng.integers(0, len(pool))]
        r = reps[rng.integers(0, len(reps))]
        if op < 5:
            tier = TIERS[rng.integers(0, 3)] if op < 4 else None
            t.publish(r, p, tier)
            j.publish(r, p, tier)
            assert tmetrics.GLOBAL_INDEX_ENTRIES.value == jmetrics.GLOBAL_INDEX_ENTRIES.value
        elif op < 6:
            assert t.drop_replica(r) == j.drop_replica(r)
        elif op < 8:
            sub = reps[: rng.integers(1, len(reps) + 1)]
            assert t.scores(p, sub) == j.scores(p, sub)
        else:
            ex = tuple(reps[: rng.integers(0, 3)])
            assert t.best(p, exclude=ex) == j.best(p, exclude=ex)
    return t, j


@pytest.mark.parametrize("seed", range(6))
def test_mirrored_op_sequences_equal_jax(seed):
    t, j = _mirror(seed, bs=(4, 8)[seed % 2])
    assert t._map == j._map  # key for key, entry for entry
    assert t._keys == j._keys
    assert t.stats() == j.stats() and t.entries() == j.entries()
    assert tmetrics.GLOBAL_INDEX_ENTRIES.value == t.entries()


def test_depth_then_tier_scoring_and_subblock_noop():
    ix = tgi.GlobalRadixIndex(BS)
    p = ids(5, 3 * BS)
    ix.publish("g0", p[: BS - 1], "hbm")  # a sub-block prefix: ignored
    assert ix.entries() == 0
    ix.publish("g0", p[: BS], "hbm")
    ix.publish("g1", p[: 2 * BS], "disk")
    ix.publish("g2", p[: 2 * BS], "host")
    assert ix.scores(p, ["g0", "g1", "g2", "g3"]) == {
        "g0": (BS, 3), "g1": (2 * BS, 1), "g2": (2 * BS, 2), "g3": (0, 0)}
    assert ix.best(p) == ("g2", "host", 2 * BS)
    assert ix.best(p, exclude=("g2", "g1")) == ("g0", "hbm", BS)
    assert ix.best(ids(6, 3 * BS)) is None


# ------------------------------------------------------------ the fleets


@pytest.fixture(scope="module")
def trees():
    cj = jcfg.tiny_llama(num_hidden_layers=LAYERS)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(17), dtype=jnp.float32))
    return cj, tree


def fleets(trees, **kw):
    cj, tree = trees
    kw = dict(dict(capacity=CAP, kv_block_size=BS, kv_blocks=4 * CAP // BS + 1,
                   prefix_cache="hbm"), **kw)
    t = ReplicatedServer(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"),
                         data_parallel=2, devices=["cpu"] * 2, **kw)
    j = JReplicated(cj, jax.tree.map(jnp.asarray, tree), data_parallel=2,
                    devices=jax.devices()[:2], cache_dtype=jnp.float32, **kw)
    return t, j


def count_probes(rsrv):
    calls = {"n": 0}
    for s in rsrv.servers:
        def probe(x, _orig=s.radix_match_tokens):
            calls["n"] += 1
            return _orig(x)
        s.radix_match_tokens = probe
    return calls


def test_fleet_indexes_equal_jax_and_route_warm(trees):
    """Warm replica 1 directly, then send prompts sharing its prefix through
    the routers: both land them on group 1 without a tree probe, the
    streams agree, and the two cluster maps end equal."""
    t, j = fleets(trees)
    try:
        warm = ids(101, 3 * BS)
        for srv in (t, j):
            r = srv._by_group[1].submit(warm, 4)
            srv.run_until_idle()
            assert r.error is None
        probes = count_probes(t)
        follow = [np.concatenate([warm, ids(102 + i, 3)]) for i in range(2)] + [ids(110, 9)]
        tr = [t.submit(p, 5) for p in follow]
        jr = [j.submit(p, 5) for p in follow]
        assert [t._group_of[t._owner[r]] for r in tr] == [j._group_of[j._owner[r]] for r in jr]
        assert [t._group_of[t._owner[r]] for r in tr[:2]] == [1, 1]
        assert probes["n"] == 0  # one index lookup, no tree probe
        t.run_until_idle()
        j.run_until_idle()
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert t._gindex._map == j._gindex._map
        assert t.stats()["global_index"] == j.stats()["global_index"]
    finally:
        t.close()
        j.close()


def test_tier_ladder_rides_the_index(trees):
    """Demotion republishes the entry at its colder tier, a routed resubmit
    still lands on the warm replica and promotes it back to hbm, eviction
    removes it: the two packages' indexes agree at every rung."""
    t, j = fleets(trees, prefix_cache="host", host_pool_blocks=4 * CAP // BS)
    try:
        p1 = ids(211, 3 * BS + 1)
        for srv in (t, j):
            r1 = srv._by_group[0].submit(p1, 4)
            srv.run_until_idle()
            assert r1.error is None
        ladder = []
        for srv in (t, j):
            gx, warm = srv._gindex, srv._by_group[0]
            seen = [gx.best(p1)]
            with warm._mutex:
                warm._radix.demote_all()
            seen.append(gx.best(p1))
            r2 = srv.submit(p1, 4)
            seen.append(srv._owner[r2] is warm)
            srv.run_until_idle()
            seen += [gx.best(p1), list(r2.tokens)]
            with warm._mutex:
                warm._radix.drop_all()
            seen += [gx.best(p1), gx.stats()]
            ladder.append(seen)
        assert ladder[0] == ladder[1]
        assert ladder[0][:4] == [("g0", "hbm", 3 * BS), ("g0", "host", 3 * BS), True,
                                 ("g0", "hbm", 3 * BS)]
        assert ladder[0][5] is None and ladder[0][6]["entries"] == 0
    finally:
        t.close()
        j.close()


def test_global_index_false_disables_index_and_probe(trees):
    t, j = fleets(trees, global_index=False)
    try:
        assert t._gindex is None and j._gindex is None
        warm = ids(301, 2 * BS)
        for srv in (t, j):
            srv._by_group[1].submit(warm, 3)
            srv.run_until_idle()
        probes = count_probes(t)
        tr = [t.submit(np.concatenate([warm, ids(302 + i, 2)]), 3) for i in range(3)]
        jr = [j.submit(np.concatenate([warm, ids(302 + i, 2)]), 3) for i in range(3)]
        assert probes["n"] == 0
        # plain least-loaded round robin on both
        assert [t._group_of[t._owner[r]] for r in tr] == [j._group_of[j._owner[r]] for r in jr]
        t.run_until_idle()
        j.run_until_idle()
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert "global_index" not in t.stats()
    finally:
        t.close()
        j.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_indexz_endpoint_on_the_port_fleet(trees):
    t, j = fleets(trees)
    j.close()
    try:
        r = t._by_group[0].submit(ids(401, 2 * BS + 1), 4)
        t.run_until_idle()
        assert r.error is None
        ing = IngressServer(t, poll_interval_s=0.0005)
        ing.start()
        try:
            status, body = _get(ing.port, "/indexz")
            assert status == 200 and body == t._gindex.stats()
            assert body["replicas"] == ["g0"] and body["entries"] >= 1
        finally:
            ing.stop()
    finally:
        t.close()
