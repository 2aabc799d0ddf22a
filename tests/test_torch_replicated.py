"""The port's supervised replica router (``runtime/replicated.py``) against
the JAX package's ``ReplicatedServer``: both fleets built from one seeded
numpy tree (tiny_llama, 2 layers, f32), each replica on one CPU device
(the JAX one on ``jax.devices()[:dp]``, one stage each), serving the same
requests in the same order. Parametrised over dp 2 and 3 where routing is
compared.

Held equal to JAX, exactly (tolerance 0): the group each request lands on
(``_pick``'s round robin, health and cache classes), greedy f32 streams,
migrated counts and the deltas of ``server_replica_failovers_total``,
``server_replica_drains_total``, ``server_replica_spawns_total`` and
``server_requests_migrated_total{outcome}`` through failover, drain /
spawn, a quarantined replica's queued re-route and a prefix-bound
request's handle re-resolve. Greedy streams are also held to the port's
``generate``; sampled streams (whose random numbers differ from JAX's) to
the port's own uninterrupted fleet run. Snapshot / ``restore_into``, the
trace files (``.router`` beside ``.r<d>``, merged by ``trace-report``), the
step-profiler fan-out, ``adopt(front=False)`` and the fleet metric
families' registrations (name, kind, labels, help) complete it.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime.faults import FaultPlan as JFaultPlan
from llm_sharding_tpu.runtime.replicated import ReplicatedServer as JReplicated
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.obs.report import load_events, report_json
from llm_sharding_tpu_torch.runtime.faults import FaultPlan
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedPrefixHandle, ReplicatedServer
from llm_sharding_tpu_torch.runtime.server import DEGRADED, SERVING, ServerClosed

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

LAYERS = 2
CFG = tcfg.tiny_llama(num_hidden_layers=LAYERS)
CJ = jcfg.tiny_llama(num_hidden_layers=LAYERS)
KW = dict(capacity=64, batch_per_slot=2)
DPS = [2, 3]

FLEET_FAMILIES = [
    "server_global_index_entries", "server_replica_failovers_total",
    "server_replica_drains_total", "server_replica_spawns_total",
    "server_requests_migrated_total", "server_replica_state",
    "server_disagg_handoffs_total", "server_handoff_bytes_total", "server_replica_role",
    "server_disagg_ttft_error", "server_autoscale_spawns_total",
    "server_autoscale_drains_total", "server_autoscale_replicas", "server_autoscale_load",
]


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(5), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


def tfleet(tparams, dp, **kw):
    return ReplicatedServer(CFG, tparams, data_parallel=dp, devices=["cpu"] * dp,
                            **dict(KW, **kw))


def jfleet(tree, dp, **kw):
    return JReplicated(CJ, jax.tree.map(jnp.asarray, tree), data_parallel=dp,
                       devices=jax.devices()[:dp], cache_dtype=jnp.float32, **dict(KW, **kw))


def oracle(tparams, p, n, **kw):
    res = tgenerate(CFG, tparams, p[None], n, **kw)
    return res.tokens[0, len(p): int(res.lengths[0])].tolist()


def prompts_of(seed, n, lo=3, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, int(m)).astype(np.int32) for m in rng.integers(lo, hi, n)]


def groups(srv, reqs):
    return [srv._group_of.get(srv._owner.get(r), -1) for r in reqs]


def tally(m):
    return {
        "failovers": m.REPLICA_FAILOVERS.value, "drains": m.REPLICA_DRAINS.value,
        "spawns": m.REPLICA_SPAWNS.value,
        "ok": m.REQUESTS_MIGRATED.labels(outcome="ok").value,
        "failed": m.REQUESTS_MIGRATED.labels(outcome="failed").value,
    }


def delta(before, after):
    return {k: after[k] - before[k] for k in before}


@pytest.mark.parametrize("dp", DPS)
def test_routing_and_streams_equal_jax(tree, tparams, dp):
    """Dense replicas, 3 requests per replica: every request lands on the
    group JAX's router picks, and every stream equals JAX's and the
    port's ``generate``."""
    t, j = tfleet(tparams, dp), jfleet(tree, dp)
    try:
        ps = prompts_of(dp, 3 * dp)
        tr = [t.submit(p, 8) for p in ps]
        jr = [j.submit(p, 8) for p in ps]
        assert groups(t, tr) == groups(j, jr)
        assert sorted(set(groups(t, tr))) == list(range(dp))
        t.run_until_idle()
        j.run_until_idle()
        for r, rj, p in zip(tr, jr, ps):
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 8)
        assert t.counters.snapshot()["requests_completed"] == 3 * dp
    finally:
        t.close()
        j.close()


def test_paged_chunked_cache_aware_routing_equal_jax(tree, tparams, dp=2):
    """Paged arenas with a prefix cache and chunked prefill: a first wave,
    then prompts that extend its prompts route to the warm replica through
    the cluster index in both packages, with equal streams."""
    kw = dict(kv_block_size=4, kv_blocks=48, prefix_cache="hbm", prefill_chunk=8)
    t, j = tfleet(tparams, dp, **kw), jfleet(tree, dp, **kw)
    try:
        first = prompts_of(10 + dp, dp, lo=9, hi=14)
        second = [np.concatenate([p, q]) for p, q in zip(first[::-1], prompts_of(20, dp, 2, 4))]
        for wave in (first, second):
            tr = [t.submit(p, 6) for p in wave]
            jr = [j.submit(p, 6) for p in wave]
            assert groups(t, tr) == groups(j, jr)
            t.run_until_idle()
            j.run_until_idle()
            for r, rj, p in zip(tr, jr, wave):
                assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 6)
        assert t._gindex._map == j._gindex._map
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("dp", DPS)
def test_failover_mid_decode_equal_jax(tree, tparams, dp):
    """A permanent ``replica_step`` fault on group 0 from its 4th step:
    the greedy streams finish as JAX's and ``generate``; the sampled one
    (on group 0, migrated with its generator state) as the port's
    unfaulted fleet; the metric deltas and final owners equal JAX's (the
    JAX fleet serves that request greedy: its random numbers differ, and
    routing and migration do not depend on them)."""
    n = 2 * dp
    ps = prompts_of(4 + dp, n)
    kws = [dict(temperature=1.1, seed=7, top_k=5)] + [{}] * (n - 1)
    ref = tfleet(tparams, dp)
    ref_reqs = [ref.submit(p, 12, **k) for p, k in zip(ps, kws)]
    ref.run_until_idle()
    ref.close()
    t = tfleet(tparams, dp, fault_plan=FaultPlan.permanent("replica_step", key=0, start=4))
    j = jfleet(tree, dp, fault_plan=JFaultPlan.permanent("replica_step", key=0, start=4))
    try:
        tr = [t.submit(p, 12, **k) for p, k in zip(ps, kws)]
        jr = [j.submit(p, 12) for p in ps]  # JAX's draws differ: greedy there
        assert groups(t, tr) == groups(j, jr) and groups(t, tr)[0] == 0
        b_t, b_j = tally(tmetrics), tally(jmetrics)
        t.run_until_idle()
        j.run_until_idle()
        d_t = delta(b_t, tally(tmetrics))
        assert d_t == delta(b_j, tally(jmetrics))
        assert d_t["failovers"] == 1 and d_t["ok"] >= 1 and d_t["failed"] == 0
        assert groups(t, tr) == groups(j, jr)
        assert len(t.servers) == dp - 1 and 0 not in t._by_group
        assert tr[0].error is None and tr[0].tokens == ref_reqs[0].tokens
        for r, rj, p in list(zip(tr, jr, ps))[1:]:
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 12)
        fam = tmetrics.REGISTRY.get("server_replica_state")
        assert fam.labels(replica="0", state="OFFLINE").value == 1.0
        assert fam.labels(replica="0", state="SERVING").value == 0.0
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("dp", DPS)
def test_drain_and_spawn_under_load_equal_jax(tree, tparams, dp):
    """``drain(0)`` after 4 steps migrates the same number of live
    requests as JAX's; ``spawn_replica()`` revives group 0, which serves
    new traffic; every stream completes once, greedy as JAX's, sampled as
    the port's undrained fleet."""
    n = 3 * dp
    ps = prompts_of(5 + dp, n)
    kws = [dict(temperature=0.9, seed=i) if i % 3 == 0 else {} for i in range(n)]
    ref = tfleet(tparams, dp)
    ref_reqs = [ref.submit(p, 16, **k) for p, k in zip(ps, kws)]
    ref.run_until_idle()
    ref.close()
    t, j = tfleet(tparams, dp), jfleet(tree, dp)
    try:
        tr = [t.submit(p, 16, **k) for p, k in zip(ps, kws)]
        jr = [j.submit(p, 16) for p in ps]  # JAX's draws differ: greedy there
        for _ in range(4):
            t.step()
            j.step()
        victim = t._by_group[0]
        b_t, b_j = tally(tmetrics), tally(jmetrics)
        moved = t.drain(0)
        assert moved == j.drain(0) > 0
        assert victim._closed and len(t.servers) == dp - 1
        spawned = t.spawn_replica()
        j.spawn_replica()
        assert t._by_group[0] is spawned
        assert delta(b_t, tally(tmetrics)) == delta(b_j, tally(jmetrics))
        extra = [ps[0], ps[1]]
        te = [t.submit(p, 6) for p in extra]
        je = [j.submit(p, 6) for p in extra]
        assert groups(t, te) == groups(j, je)
        t.run_until_idle()
        j.run_until_idle()
        assert groups(t, tr) == groups(j, jr)
        for r, rj, rr, k in zip(tr, jr, ref_reqs, kws):
            assert r.error is None and r.tokens == rr.tokens
            if not k:
                assert r.tokens == rj.tokens
        assert [r.tokens for r in te] == [r.tokens for r in je]
        done = t.counters.requests_completed + victim.counters.requests_completed
        assert done == n + 2  # zero drops, zero duplicates
    finally:
        t.close()
        j.close()


def test_quarantine_reroutes_queued_requests_equal_jax(tree, tparams):
    """A replica whose decode dispatch fails persistently crosses the
    containment threshold: its in-flight rows fail typed, its QUEUED
    requests migrate and complete on the survivor, as in JAX."""
    t, j = tfleet(tparams, 2, failure_threshold=1), jfleet(tree, 2, failure_threshold=1)
    try:
        ps = [p[:4] for p in prompts_of(6, 8, lo=4, hi=5)]
        tr = [t.submit(p, 6) for p in ps]
        jr = [j.submit(p, 6) for p in ps]
        t.step()
        j.step()
        t.servers[0]._fault_plan = FaultPlan.permanent("chunk_dispatch")
        j.servers[0]._fault_plan = JFaultPlan.permanent("chunk_dispatch")
        b_t, b_j = tally(tmetrics), tally(jmetrics)
        t.run_until_idle()
        j.run_until_idle()
        assert delta(b_t, tally(tmetrics)) == delta(b_j, tally(jmetrics))
        assert len(t.servers) == 1
        failed = [r.error is not None for r in tr]
        assert failed == [r.error is not None for r in jr] and any(failed) and not all(failed)
        for r, rj, p in zip(tr, jr, ps):
            if r.error is None:
                assert r.tokens == rj.tokens == oracle(tparams, p, 6)
            else:
                assert r.done and isinstance(r.error, Exception)
    finally:
        t.close()
        j.close()


def test_prefix_bound_migration_re_resolves_local_handle(tree, tparams):
    t, j = tfleet(tparams, 2), jfleet(tree, 2)
    try:
        rng = np.random.default_rng(7)
        pfx = rng.integers(1, CFG.vocab_size, 8).astype(np.int32)
        sfx = [rng.integers(1, CFG.vocab_size, k).astype(np.int32) for k in (3, 4)]
        out = []
        for srv in (t, j):
            h = srv.prefill_prefix(pfx)
            reqs = [srv.submit(s, 10, prefix=h) for s in sfx]
            srv.step()
            src = srv._owner[reqs[0]]
            moved = srv.drain(srv._group_of[src])
            assert moved >= 1 and srv._owner[reqs[0]] is not src
            assert reqs[0].prefix is h.per_server[srv._owner[reqs[0]]]
            srv.run_until_idle()
            out.append(([r.tokens for r in reqs], moved))
            srv.release_prefix(h)
        assert out[0] == out[1]
        assert out[0][0] == [oracle(tparams, np.concatenate([pfx, s]), 10) for s in sfx]
        with pytest.raises(ValueError, match="no live replica holds this prefix"):
            t.submit(sfx[0], 4, prefix=ReplicatedPrefixHandle({}))
        with pytest.raises(ValueError, match="bare PrefixHandle"):
            t.submit(sfx[0], 4, prefix=t.servers[0].prefill_prefix(pfx))
    finally:
        t.close()
        j.close()


def test_bounds_and_refusals_equal_jax(tree, tparams):
    """min_replicas guards drain, a full set refuses spawn, and the
    supervision knobs refuse as JAX's do, with its messages; tensor
    parallelism names its later slice, and replicas of 2-stage pipelines
    serve the oracle's streams."""
    t, j = tfleet(tparams, 2, min_replicas=1), jfleet(tree, 2, min_replicas=1)
    try:
        for srv in (t, j):
            srv.drain(1)
        msgs = []
        for srv in (t, j):
            got = []
            for call in (lambda: srv.drain(0), lambda: srv.drain(1)):
                with pytest.raises(ValueError) as e:
                    call()
                got.append(str(e.value))
            srv.spawn_replica()
            with pytest.raises(ValueError) as e:
                srv.spawn_replica()
            got.append(str(e.value))
            msgs.append(got)
        assert msgs[0] == msgs[1]
        assert len(t.servers) == 2 and t.least_loaded_group() == j.least_loaded_group()
    finally:
        t.close()
        j.close()
    for kw in (dict(failure_threshold=0), dict(failure_window_s=0.0), dict(min_replicas=3),
               dict(data_parallel=0)):
        args = dict(dict(data_parallel=2), **kw)
        with pytest.raises(ValueError) as te:
            ReplicatedServer(CFG, tparams, devices=["cpu"] * 2, **args)
        with pytest.raises(ValueError) as je:
            JReplicated(CJ, tree, devices=jax.devices()[:2], **args)
        assert str(te.value) == str(je.value)
    # a tensor-parallel replica needs tp devices in its group: one is refused
    with pytest.raises(ValueError) as te:
        ReplicatedServer(CFG, tparams, data_parallel=2, devices=["cpu"] * 2, tensor_parallel=2)
    with pytest.raises(ValueError) as je:
        JReplicated(CJ, tree, data_parallel=2, devices=jax.devices()[:2], tensor_parallel=2)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        ReplicatedServer(CFG, tparams, data_parallel=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError) as je:
        JReplicated(CJ, tree, data_parallel=2, devices=jax.devices()[:3])
    assert str(te.value) == str(je.value)
    # replicas of pipelines: two 2-stage replicas, each over its group of two
    two = ReplicatedServer(CFG, tparams, data_parallel=2, num_stages=2, devices=["cpu"] * 4,
                           **KW)
    try:
        assert [e.num_stages for e in two.engines] == [2, 2] and two.servers[0].rows == 4
        ps = prompts_of(31, 3)
        reqs = [two.submit(p, 6) for p in ps]
        assert [list(two.stream(r)) for r in reqs] == [oracle(tparams, p, 6) for p in ps]
    finally:
        two.close()
    if not torch.cuda.is_available():  # devices=None means the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplicatedServer(CFG, tparams, data_parallel=2)


def test_stream_cancel_embedding_health_and_stats(tparams):
    t = tfleet(tparams, 2, kv_block_size=4, kv_blocks=40, prefix_cache="hbm")
    try:
        ps = prompts_of(9, 4)
        a, b = t.submit(ps[0], 10), t.submit(ps[1], 10)
        assert t._owner[a] is not t._owner[b]
        assert t.cancel(b) and not t.cancel(b)
        assert list(t.stream(a)) == oracle(tparams, ps[0], 10)
        emb = t.embed_prompt(ps[2])[0]
        e = t.submit_embedding(emb, 6)
        assert list(t.stream(e)) == oracle(tparams, ps[2], 6)
        assert t.health == SERVING
        st = t.stats()
        assert [r["replica"] for r in st["replicas"]] == [0, 1]
        assert st["offline_groups"] == []
        assert {"kv_blocks_in_use", "prefix_cache", "host_occupancy"} <= set(st["replicas"][0])
        assert st["counters"]["requests_cancelled"] == 1
        t.servers[1]._health = DEGRADED
        assert t.health == DEGRADED
        assert t._pick() is t.servers[0]  # a degraded replica loses the tie
        t.servers[1]._health = SERVING
        assert set(t.stepline_stats()) == set(t.stepline_snapshot(4)) == {"r0", "r1"}
        cap = t.stepline_capture(1, wait_s=0.01)
        assert set(cap) == {"r0", "r1"}
    finally:
        t.close()
    with pytest.raises(ServerClosed, match="no live replica"):
        t.submit(ps[3], 4)


def test_snapshot_restore_into_continues_streams(tparams):
    """Per-replica snapshots taken mid-decode resume into a fresh fleet of
    the same shape: ownership is rebuilt and every stream finishes as the
    uninterrupted run's (greedy and sampled)."""
    kw = dict(kv_block_size=4, kv_blocks=40)
    ps = prompts_of(11, 4)
    kws = [dict(temperature=0.8, seed=3), {}, {}, {}]
    ref = tfleet(tparams, 2, **kw)
    want = [list(ref.stream(ref.submit(p, 10, **k))) for p, k in zip(ps, kws)]
    ref.close()
    t = tfleet(tparams, 2, **kw)
    reqs = [t.submit(p, 10, **k) for p, k in zip(ps, kws)]
    for _ in range(3):
        t.step()
    live = [i for i, r in enumerate(reqs) if not r.done]
    assert len(live) >= 2 and 0 in live  # the sampled one among them
    snaps = t.snapshot()
    t.close()
    t2 = ReplicatedServer.restore_into(tfleet(tparams, 2, **kw), snaps)
    try:
        revived = sorted((r for s in t2.servers for r in list(s._req) + list(s._queue)
                          if r is not None), key=lambda r: r.id)
        assert len(revived) == len(live) and all(t2._owner[r] is not None for r in revived)
        t2.run_until_idle()
        assert sorted(tuple(want[i]) for i in live) == sorted(tuple(r.tokens) for r in revived)
        with pytest.raises(ValueError, match="replica snapshots"):
            ReplicatedServer.restore_into(t2, snaps[:1])
    finally:
        t2.close()


def test_trace_files_merge_into_request_trees(tparams, tmp_path):
    """``trace_path`` writes ``.r<d>`` per replica and ``.router`` for the
    router's decisions; a drain's migrate span joins its request's tree
    when ``trace-report`` merges the files."""
    path = str(tmp_path / "trace.jsonl")
    t = tfleet(tparams, 2, trace_path=path)
    ps = prompts_of(12, 4)
    reqs = [t.submit(p, 8) for p in ps]
    for _ in range(3):
        t.step()
    t.drain(0)
    t.spawn_replica()
    t.run_until_idle()
    t.close()
    files = sorted(os.listdir(tmp_path))
    assert files == ["trace.jsonl.r0", "trace.jsonl.r1", "trace.jsonl.router"]
    router = [json.loads(x) for x in open(path + ".router")]
    names = [e["span"] for e in router]
    assert "drain" in names and "spawn" in names and "migrate" in names
    assert all(e["src"] == "router" for e in router)
    events = load_events([str(tmp_path / f) for f in files])
    rep = report_json(events)
    assert rep["traces"] == len(reqs)
    migrated = {e["trace_id"] for e in router if e["span"] == "migrate"}
    assert migrated <= {r.trace.trace_id for r in reqs}


def test_adopt_front_false_queues_behind(tparams):
    """``adopt(front=False)`` queues the adopted request behind fresh
    submissions; the default puts it ahead (JAX ``server.py:3572``)."""
    t = tfleet(tparams, 2)
    try:
        src, dst = t.servers
        ps = prompts_of(13, 3)
        moving = src.submit(ps[0], 4)
        fresh = dst.submit(ps[1], 4)
        st = src.extract(moving)
        dst.adopt(st, moving, front=False)
        assert list(dst._queue) == [fresh, moving]
        other = src.submit(ps[2], 4)
        st2 = src.extract(other)
        dst.adopt(st2, other)
        assert list(dst._queue) == [other, fresh, moving]
        dst.run_until_idle()
        assert moving.tokens == oracle(tparams, ps[0], 4)
    finally:
        t.close()


@pytest.mark.parametrize("name", FLEET_FAMILIES)
def test_fleet_families_match_the_jax_registrations(name):
    from llm_sharding_tpu.runtime import autoscale, disagg  # noqa: F401
    from llm_sharding_tpu_torch.runtime import autoscale as ta, disagg as td  # noqa: F401

    got, want = tmetrics.REGISTRY.get(name), jmetrics.REGISTRY.get(name)
    assert got is not None and want is not None
    assert (got.kind, got.label_names, got.buckets, got.help) == (
        want.kind, want.label_names, want.buckets, want.help)
