"""The port's disaggregated prefill/decode router (``runtime/disagg.py``)
against the JAX package's ``DisaggServer``: both built from one seeded
numpy tree (tiny_llama, 2 layers, f32, block size 8, ``prefix_cache="hbm"``),
each replica on one CPU device, serving the same requests.

Held equal to JAX, exactly (tolerance 0): greedy f32 streams (also equal
to the port's ``generate``), the deltas of
``server_disagg_handoffs_total{outcome}`` and ``server_handoff_bytes_total``
(the same blocks of the same f32 arena shapes stream) under the same
``FaultPlan`` (transient and permanent ``kv_handoff`` faults, a prefill or
decode replica killed by ``replica_step``), the refusals' messages, the
placement planner's routing, the role flip of ``rebalance``, the role load
signals and ``stats()``'s role view. Sampled streams are held to the
port's ``generate(seed=)``, whose draws a served row reproduces. The hand-off
runs synchronously (``async_handoff=False``) where outcomes are compared
step by step, and on the sidecar thread (the default) where only streams
and totals are.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime import placement as jpl
from llm_sharding_tpu.runtime.disagg import DisaggServer as JDisagg
from llm_sharding_tpu.runtime.faults import FaultPlan as JFaultPlan
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.runtime import placement as tpl
from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
from llm_sharding_tpu_torch.runtime.faults import FaultPlan
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

LAYERS = 2
CFG = tcfg.tiny_llama(num_hidden_layers=LAYERS)
CJ = jcfg.tiny_llama(num_hidden_layers=LAYERS)
BS = 8
CAP = 64
OUTCOMES = ("ok", "cold", "retried", "fallback", "no_target", "failed")


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(5), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


def _kw(dp, roles, kw):
    kw = dict(kw)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_blocks", 6 * CAP // BS + 1)
    kw.setdefault("prefix_cache", "hbm")
    kw.setdefault("async_handoff", False)
    if roles is not None:
        kw["roles"] = roles
    elif "prefill_replicas" not in kw:
        kw["roles"] = ["prefill"] + ["decode"] * (dp - 1)
    return dict(capacity=CAP, data_parallel=dp, **kw)


def tdis(tparams, dp=2, roles=None, **kw):
    return DisaggServer(CFG, tparams, devices=["cpu"] * dp, **_kw(dp, roles, kw))


def jdis(tree, dp=2, roles=None, **kw):
    return JDisagg(CJ, jax.tree.map(jnp.asarray, tree), devices=jax.devices()[:dp],
                   cache_dtype=jnp.float32, **_kw(dp, roles, kw))


def pair(tree, tparams, dp=2, roles=None, tplan=None, jplan=None, **kw):
    return (tdis(tparams, dp, roles, fault_plan=tplan, **kw),
            jdis(tree, dp, roles, fault_plan=jplan, **kw))


def oracle(tparams, p, n, **kw):
    res = tgenerate(CFG, tparams, p[None], n, **kw)
    return res.tokens[0, len(p): int(res.lengths[0])].tolist()


def prompt(seed, n):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n).astype(np.int32)


def tally(m):
    out = {k: m.DISAGG_HANDOFFS.labels(outcome=k).value for k in OUTCOMES}
    out["bytes"] = m.HANDOFF_BYTES.value
    return out


def delta(a, b):
    return {k: b[k] - a[k] for k in a}


def check_clean(srv):
    """Allocator + tree invariants with every row finished: the only live
    allocations are each tree's."""
    for s in srv.servers:
        s._alloc.check()
        s._radix.check()
        assert s._alloc.in_use == s._radix.device_blocks
        assert not any(s._row_blocks) and not any(s._row_shared)
        assert not any(s._row_radix)


def completed(srv, role):
    return sum(s.counters.requests_completed for s in srv.servers if srv.role_of(s) == role)


def run_both(t, j, prompts, n, kws=None):
    """Submit the same requests to both, run both; returns (port, JAX)
    requests and the two tally deltas."""
    kws = kws or [{}] * len(prompts)
    b_t, b_j = tally(tmetrics), tally(jmetrics)
    tr = [t.submit(p, n, **k) for p, k in zip(prompts, kws)]
    jr = [j.submit(p, n, **k) for p, k in zip(prompts, kws)]
    t.run_until_idle()
    j.run_until_idle()
    return tr, jr, delta(b_t, tally(tmetrics)), delta(b_j, tally(jmetrics))


VALIDATION = [
    dict(roles=["prefill", "decode"], prefill_replicas=1),
    dict(roles=["prefill", "bogus"]),
    dict(roles=["prefill", "prefill"]),
    dict(roles=["decode", "decode"]),
    dict(roles=["prefill", "decode"], kv_block_size=None, kv_blocks=None),
    dict(roles=["prefill", "decode"], prefix_cache="off"),
    dict(prefill_replicas=2),
    dict(roles=["prefill"]),
]


@pytest.mark.parametrize("kw", VALIDATION, ids=lambda k: ",".join(sorted(k))[:30])
def test_refusals_equal_jax(tree, tparams, kw):
    kw = dict(kw)
    roles = kw.pop("roles", None)
    with pytest.raises(ValueError) as te:
        tdis(tparams, 2, roles, **kw)
    with pytest.raises(ValueError) as je:
        jdis(tree, 2, roles, **kw)
    assert str(te.value) == str(je.value)


def test_handoff_streams_outcomes_and_bytes_equal_jax(tree, tparams, dp=2):
    """Greedy requests through a 1 : 1 split: every request hands off
    (``ok``; ``cold`` where nothing streams), the decode side completes
    them all, the bytes streamed and the streams equal JAX's, the
    invariants hold."""
    t, j = pair(tree, tparams, dp)
    try:
        rng = np.random.default_rng(dp)
        ps = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
              for n in rng.integers(BS + 2, 3 * BS, 6)]
        tr, jr, dt, dj = run_both(t, j, ps, 8)
        # the streamed path is the norm (``cold``: nothing worth streaming)
        assert dt == dj and dt["ok"] >= len(ps) - 1 and dt["bytes"] > 0
        moved = dt["ok"] + dt["cold"]
        for r, rj, p in zip(tr, jr, ps):
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 8)
        assert moved == len(ps) and dt["failed"] == 0
        assert completed(t, "prefill") == 0 and completed(t, "decode") == len(ps)
        assert not t._pending_handoff
        check_clean(t)
    finally:
        t.close()
        j.close()


def test_sampled_requests_hand_off_with_their_generator(tparams):
    """Sampled and filtered requests hand off with their generator state
    (``extract`` settles first): each stream equals the port's
    ``generate(seed=)``, whose draws a served row reproduces."""
    t = tdis(tparams)
    try:
        ps = [prompt(60 + i, BS + 3 + 3 * i) for i in range(3)]
        kws = [dict(temperature=0.9, seed=3), dict(temperature=1.1, seed=7, top_k=5),
               dict(temperature=0.7, seed=1, top_p=0.8)]
        ok0 = tmetrics.DISAGG_HANDOFFS.labels(outcome="ok").value
        reqs = [t.submit(p, 8, **k) for p, k in zip(ps, kws)]
        t.run_until_idle()
        assert tmetrics.DISAGG_HANDOFFS.labels(outcome="ok").value - ok0 == len(ps)
        for r, p, k in zip(reqs, ps, kws):
            assert r.error is None and r.tokens == oracle(tparams, p, 8, **k)
        check_clean(t)
    finally:
        t.close()


def test_handoff_bytes_are_the_streamed_blocks(tparams):
    """``server_handoff_bytes_total`` grows by exactly the streamed blocks
    times the bytes of one block of K and V (f32 arena, no scales)."""
    t = tdis(tparams)
    try:
        p = prompt(3, 3 * BS + 2)
        b0 = tmetrics.HANDOFF_BYTES.value
        r = t.submit(p, 6)
        t.run_until_idle()
        head_dim = CFG.hidden_size // CFG.num_attention_heads
        per_block = 2 * LAYERS * BS * CFG.num_key_value_heads * head_dim * 4
        streamed = (len(p) // BS)  # one-shot admission inserts the aligned prompt
        assert tmetrics.HANDOFF_BYTES.value - b0 == streamed * per_block
        assert r.tokens == oracle(tparams, p, 6)
    finally:
        t.close()


def test_async_sidecar_streams_equal_jax(tree, tparams):
    """The default sidecar hand-off: the same streams and totals as the
    JAX router's sidecar, nothing pending after ``run_until_idle``."""
    t, j = pair(tree, tparams, async_handoff=True)
    try:
        ps = [prompt(40 + i, BS + 3 + 2 * i) for i in range(5)]
        tr, jr, dt, dj = run_both(t, j, ps, 8)
        assert dt == dj and dt["ok"] == 5
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert t.handoffs_pending() == 0 and t._handoff_thread.is_alive()
        assert t.stats()["async_handoff"] is True
    finally:
        t.close()
        j.close()
    assert t._handoff_thread is None


def test_decode_side_zero_prefill(tparams):
    """The decode replica never prefills a handed-off prompt: its
    admission takes the streamed blocks as a radix hit."""
    t = tdis(tparams, prefill_chunk=16)
    try:
        def boom(*a, **k):
            raise AssertionError("decode-role replica entered the chunked-prefill path")

        dec = [s for s in t.servers if t.role_of(s) == "decode"]
        for s in dec:
            s._admit_chunked = boom
        p = prompt(21, 20)  # bucket 32 > prefill_chunk 16: a cold admit would chunk
        r = t.submit(p, 6)
        t.run_until_idle()
        assert r.error is None and r.tokens == oracle(tparams, p, 6)
        aligned = ((len(p) - 1) // BS) * BS
        assert sum(s._radix.hit_tokens for s in dec) >= aligned
        check_clean(t)
    finally:
        t.close()


@pytest.mark.parametrize("site,plan,want", [
    ("transient", ("transient_at", "kv_handoff", 0, 1), dict(retried=2, ok=1)),
    ("permanent", ("permanent", "kv_handoff"), dict(fallback=1)),
])
def test_kv_handoff_faults_equal_jax(tree, tparams, site, plan, want):
    name, *args = plan
    t, j = pair(tree, tparams, tplan=getattr(FaultPlan, name)(*args),
                jplan=getattr(JFaultPlan, name)(*args))
    try:
        p = prompt(51, 2 * BS + 3)
        tr, jr, dt, dj = run_both(t, j, [p], 8)
        assert dt == dj
        for k, v in want.items():
            assert dt[k] == v
        assert tr[0].tokens == jr[0].tokens == oracle(tparams, p, 8)
        assert completed(t, "decode" if site == "transient" else "prefill") == 1
        check_clean(t)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("key,start", [(0, 3), (1, 6)], ids=["prefill_dies", "decode_dies"])
def test_chaos_replica_killed_mid_handoff_equal_jax(tree, tparams, key, start):
    """A prefill replica dying mid-prefill / mid-hand-off, or a decode
    replica right after adopting: supervision migrates the work, every
    stream finishes as JAX's and ``generate``."""
    t, j = pair(tree, tparams, tplan=FaultPlan.permanent("replica_step", key=key, start=start),
                jplan=JFaultPlan.permanent("replica_step", key=key, start=start),
                failure_threshold=1)
    try:
        rng = np.random.default_rng(41 + key)
        ps = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
              for n in rng.integers(BS + 1, 3 * BS, 5)]
        b_t, b_j = tmetrics.REQUESTS_MIGRATED.labels(outcome="ok").value, \
            jmetrics.REQUESTS_MIGRATED.labels(outcome="ok").value
        tr, jr, dt, dj = run_both(t, j, ps, 10)
        assert dt == dj
        assert (tmetrics.REQUESTS_MIGRATED.labels(outcome="ok").value - b_t
                == jmetrics.REQUESTS_MIGRATED.labels(outcome="ok").value - b_j)
        assert len(t.servers) == 1
        for r, rj, p in zip(tr, jr, ps):
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 10)
        check_clean(t)
    finally:
        t.close()
        j.close()


def test_oversize_resume_stays_on_prefill_replica(tree, tparams):
    t, j = pair(tree, tparams)
    try:
        p = prompt(55, 32)  # the resumed prompt buckets to 64 = capacity
        tr, jr, dt, dj = run_both(t, j, [p], 6)
        assert dt == dj and dt["fallback"] == 1
        assert tr[0].tokens == jr[0].tokens == oracle(tparams, p, 6)
        assert completed(t, "prefill") == 1
        check_clean(t)
    finally:
        t.close()
        j.close()


def test_no_target_then_a_decode_replica_returns(tree, tparams):
    """With the decode replica drained, a prefill-complete request counts
    ``no_target`` once and keeps decoding; a spawned decode replica takes
    the next request's hand-off. Deltas equal JAX's."""
    t, j = pair(tree, tparams, min_replicas=0)
    try:
        for srv in (t, j):
            srv.drain(1)
        tr, jr, dt, dj = run_both(t, j, [prompt(61, BS + 5)], 8)
        assert dt == dj and dt["no_target"] == 1 and dt["ok"] == 0
        for srv in (t, j):
            srv.spawn_replica()
        tr2, jr2, dt2, dj2 = run_both(t, j, [prompt(62, BS + 5)], 8)
        assert dt2 == dj2 and dt2["ok"] == 1
        assert [r.tokens for r in tr + tr2] == [r.tokens for r in jr + jr2]
    finally:
        t.close()
        j.close()


def test_planner_routing_live_vs_default(tree, tparams):
    """With a decode-dominant planner a warm but busy replica loses to a
    cold idle one; without one the warm replica wins. Same picks as JAX;
    the routed request feeds ``server_disagg_ttft_error``."""
    def heavy(pkg):
        return pkg.PlacementPlanner(pkg.FittedLatency("linear", (1e-9, 0.0), 0.0, 1.0),
                                    pkg.FittedLatency("linear", (0.5, 0.0), 0.0, 1.0))

    pa = prompt(31, 2 * BS)

    def run(srv):
        warm = srv.servers[1]
        w = warm.submit(pa, 4)
        srv.run_until_idle()
        busy = warm.submit(prompt(32, 4), 40)
        for _ in range(3):
            srv.step()
        assert not busy.done and w.error is None
        req = srv.submit(np.concatenate([pa, prompt(33, 3)]), 4)
        owner = srv._owner[req]
        srv.run_until_idle()
        assert req.error is None
        srv.close()
        return owner is warm, req.tokens

    roles = ["prefill", "unified"]
    got = []
    for planner in (None, "heavy"):
        t = tdis(tparams, roles=roles, cross_fill=False, planner=planner and heavy(tpl))
        j = jdis(tree, roles=roles, cross_fill=False, planner=planner and heavy(jpl))
        got.append((run(t), run(j)))
    assert got[0][0] == got[0][1] and got[0][0][0] is True
    assert got[1][0] == got[1][1] and got[1][0][0] is False
    assert 0.0 <= tmetrics.DISAGG_TTFT_ERROR.value


def test_rebalance_flips_role_through_drain_spawn(tree, tparams):
    heavy = [pkg.PlacementPlanner(pkg.FittedLatency("linear", (1e-9, 0.0), 0.0, 1.0),
                                  pkg.FittedLatency("linear", (0.1, 0.0), 0.0, 1.0))
             for pkg in (tpl, jpl)]
    roles = ["prefill", "prefill", "decode"]
    t = tdis(tparams, 3, roles, planner=heavy[0])
    j = jdis(tree, 3, roles, planner=heavy[1])
    try:
        ps = [prompt(61 + i, BS + 3) for i in range(3)]
        tr, jr, dt, dj = run_both(t, j, ps, 8)
        flips = []
        for srv, m in ((t, tmetrics), (j, jmetrics)):
            d0, s0 = m.REPLICA_DRAINS.value, m.REPLICA_SPAWNS.value
            flips.append((srv.rebalance(), m.REPLICA_DRAINS.value - d0,
                          m.REPLICA_SPAWNS.value - s0, dict(srv.roles), srv.rebalance()))
        assert flips[0] == flips[1]
        assert flips[0][0][0] == "decode" and flips[0][1:3] == (1, 1) and flips[0][4] is None
        tr2, jr2, _, _ = run_both(t, j, ps, 8)
        assert [r.tokens for r in tr2] == [r.tokens for r in tr] == [r.tokens for r in jr2]
        check_clean(t)
        with pytest.raises(ValueError, match="planner"):
            tdis(tparams).rebalance()
    finally:
        t.close()
        j.close()


def test_migrated_requests_reenter_handoff_pipeline(tree, tparams):
    roles = ["prefill", "prefill", "decode"]
    t = tdis(tparams, 3, roles, fault_plan=FaultPlan.permanent("replica_step", key=0, start=2),
             failure_threshold=1)
    j = jdis(tree, 3, roles, fault_plan=JFaultPlan.permanent("replica_step", key=0, start=2),
             failure_threshold=1)
    try:
        ps = [prompt(45 + i, BS + 3) for i in range(4)]
        tr, jr, dt, dj = run_both(t, j, ps, 10)
        assert dt == dj and len(t.servers) == 2
        for r, rj, p in zip(tr, jr, ps):
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 10)
        assert completed(t, "prefill") == 0 and completed(t, "decode") == len(ps)
        check_clean(t)
    finally:
        t.close()
        j.close()


def test_cross_replica_radix_fill(tree, tparams):
    """A miss on the routed replica that another replica's tree holds
    streams the blocks instead of re-prefilling them, as in JAX."""
    t, j = pair(tree, tparams)
    try:
        pa = prompt(71, 2 * BS)
        run_both(t, j, [pa], 4)
        hits = []
        for srv in (t, j):
            pre = [s for s in srv.servers if srv.role_of(s) == "prefill"][0]
            with pre._mutex:
                pre._radix.drop_all()
            hits.append(pre._radix.hit_tokens)
        p2 = np.concatenate([pa, prompt(72, 3)])
        tr, jr, dt, dj = run_both(t, j, [p2], 4)
        assert dt == dj and dt["bytes"] > 0
        assert tr[0].tokens == jr[0].tokens == oracle(tparams, p2, 4)
        pre = [s for s in t.servers if t.role_of(s) == "prefill"][0]
        assert pre._radix.hit_tokens - hits[0] >= 2 * BS
        check_clean(t)
    finally:
        t.close()
        j.close()


def test_role_load_queue_depth_and_stats_equal_jax(tree, tparams):
    t, j = pair(tree, tparams)
    try:
        seen = []
        for srv in (t, j):
            got = [srv.role_load(), srv.prefill_queue_depth()]
            reqs = [srv.submit(prompt(81 + i, BS + 1), 4) for i in range(5)]
            got += [srv.prefill_queue_depth(), srv.role_load(), srv.role_load(extra=3)]
            srv.step()
            got.append(srv.role_load())
            st = srv.stats()
            got += [st["roles"], [e["role"] for e in st["replicas"]], st["planner"]]
            srv.run_until_idle()
            got += [[r.error is None for r in reqs], srv.prefill_queue_depth()]
            seen.append(got)
        assert seen[0] == seen[1]
        assert seen[0][:3] == [0.0, 0, 5] and seen[0][6] == {"0": "prefill", "1": "decode"}
        fam = tmetrics.REGISTRY.get("server_replica_role")
        assert fam.labels(replica="0", role="prefill").value == 1.0
        assert fam.labels(replica="1", role="decode").value == 1.0
        assert fam.labels(replica="1", role="prefill").value == 0.0
    finally:
        t.close()
        j.close()


def test_unified_roles_behave_as_the_base_router(tree, tparams):
    """Every role unified: no hand-off, routing and streams as JAX's."""
    t, j = pair(tree, tparams, roles=["unified", "unified"], prefix_cache="off")
    try:
        ps = [prompt(90 + i, BS + i) for i in range(4)]
        tr, jr, dt, dj = run_both(t, j, ps, 6)
        assert dt == dj and not any(dt.values())
        assert [t._group_of[t._owner[r]] for r in tr] == [j._group_of[j._owner[r]] for r in jr]
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert t.role_load() == j.role_load() == 0.0
    finally:
        t.close()
        j.close()
