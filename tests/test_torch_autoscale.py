"""The port's autoscaler (``runtime/autoscale.py``) against the JAX
package's ``Autoscaler``: under one fake clock the two controllers take
the same decision at every tick (exact), over duck-typed routers whose
load each test scripts and over the real routers of both packages
(tiny_llama, 2 layers, f32, one CPU device per replica), which go
2 → 3 → 2 replicas with every stream finishing as JAX's. Then the port's
``IngressServer.attach_autoscaler`` drives a port ``Autoscaler`` over a
port ``ReplicatedServer`` from the ingress's own tick thread, and a
disaggregated router's role load and paced rebalance feed the controller.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime import autoscale as jas
from llm_sharding_tpu.runtime.replicated import ReplicatedServer as JReplicated
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.runtime import autoscale as tas
from llm_sharding_tpu_torch.runtime import placement as tpl
from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.ingress import IngressServer
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

LAYERS = 2
CFG = tcfg.tiny_llama(num_hidden_layers=LAYERS)
CJ = jcfg.tiny_llama(num_hidden_layers=LAYERS)


class _Req:
    done = False


class _Replica:
    """What the controller reads of a replica, under both packages' names
    for the row list (``_req`` in the port, ``_rows`` in JAX)."""

    def __init__(self, rows=2):
        self._closed = False
        self._queue = []
        self._req = self._rows = [None] * rows

    def set(self, queued, active, rows=2):
        self._queue = [None] * queued
        self._req = self._rows = [_Req()] * active + [None] * (rows - active)


class _Router:
    """A duck-typed ``ReplicatedServer``: 3 groups, actions recorded."""

    def __init__(self, live=1):
        self._groups = [0, 1, 2]
        self.servers = [_Replica() for _ in range(live)]
        self.min_replicas = 1
        self.actions = []

    def spawn_replica(self):
        self.servers.append(_Replica())
        self.actions.append("spawn")

    def drain(self, d):
        if len(self.servers) <= self.min_replicas:
            raise ValueError("below min_replicas")
        self.servers.pop()
        self.actions.append(f"drain{d}")

    def least_loaded_group(self):
        return len(self.servers) - 1


# (advance clock by, per-replica (queued, active)) for each tick: a
# diurnal curve through mid, high, cooldown, low and the floor
SCRIPT = [
    (0.0, (0, 1)), (0.0, (6, 2)), (0.5, (6, 2)), (0.6, (6, 2)), (1.0, (6, 2)),
    (5.0, (6, 2)), (5.0, (0, 0)), (1.0, (0, 0)), (1.1, (0, 0)), (10.0, (0, 0)),
    (2.1, (0, 0)), (10.0, (0, 0)), (2.1, (0, 0)), (0.3, (2, 1)), (0.3, (9, 2)),
    (1.2, (9, 2)), (0.1, (9, 2)),
]


@pytest.mark.parametrize("cfg", [
    dict(min_replicas=1, max_replicas=3, scale_up_load=0.8, scale_down_load=0.3,
         up_after_s=1.0, down_after_s=2.0, cooldown_s=5.0),
    dict(min_replicas=1, max_replicas=2, scale_up_load=0.5, scale_down_load=0.1,
         up_after_s=0.0, down_after_s=0.5, cooldown_s=0.0),
    dict(scale_up_load=1.5, scale_down_load=0.5, up_after_s=0.2, down_after_s=1.0,
         cooldown_s=1.0),
], ids=["hysteresis", "twitchy", "defaults_bounds"])
def test_tick_decisions_equal_jax_under_one_clock(cfg):
    now = [0.0]
    rt, rj = _Router(), _Router()
    st = tas.Autoscaler(rt, clock=lambda: now[0], **cfg)
    sj = jas.Autoscaler(rj, clock=lambda: now[0], **cfg)
    assert (st.min_replicas, st.max_replicas) == (sj.min_replicas, sj.max_replicas)
    decisions = []
    for dt, (q, a) in SCRIPT:
        now[0] += dt
        for r in (rt, rj):
            for s in r.servers:
                s.set(q, a)
        assert st.load() == sj.load()
        d = st.tick()
        assert d == sj.tick()
        assert tmetrics.AUTOSCALE_LOAD.value == jmetrics.AUTOSCALE_LOAD.value
        assert tmetrics.AUTOSCALE_REPLICAS.value == jmetrics.AUTOSCALE_REPLICAS.value
        decisions.append(d)
    assert rt.actions == rj.actions and "spawn" in decisions
    assert (st.spawns, st.drains) == (sj.spawns, sj.drains)


def test_load_signal_and_refusals_equal_jax():
    backlog = [0]
    rt, rj = _Router(live=2), _Router(live=2)
    st = tas.Autoscaler(rt, extra_load=lambda: backlog[0])
    sj = jas.Autoscaler(rj, extra_load=lambda: backlog[0])
    for b, act in ((0, 0), (6, 0), (6, 2)):
        backlog[0] = b
        rt.servers[0].set(0, act)
        rj.servers[0].set(0, act)
        assert st.load() == sj.load()
    assert st.load() == pytest.approx(2.0)
    empty = _Router(live=0)
    assert tas.Autoscaler(_Router(), load_fn=lambda: 0.7).load() == 0.7
    for kw in (dict(scale_up_load=0.2, scale_down_load=0.5), dict(up_after_s=-1.0),
               dict(min_replicas=0), dict(max_replicas=4), dict(min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError) as te:
            tas.Autoscaler(_Router(), **kw)
        with pytest.raises(ValueError) as je:
            jas.Autoscaler(_Router(), **kw)
        assert str(te.value) == str(je.value)
    assert tas.Autoscaler(empty, max_replicas=3).load() == 0.0


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(9), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


def oracle(tparams, p, n):
    res = tgenerate(CFG, tparams, p[None], n)
    return res.tokens[0, len(p): int(res.lengths[0])].tolist()


def test_real_routers_scale_2_3_2_equal_jax(tree, tparams):
    """Both packages' routers at dp 3 (one group drained to start at 2),
    driven by an injected load curve and one fake clock: spawn, then
    drain, at the same ticks; the live streams survive both resizes and
    equal JAX's; the controller counters move alike."""
    kw = dict(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=48, min_replicas=2)
    t = ReplicatedServer(CFG, tparams, data_parallel=3, devices=["cpu"] * 3, **kw)
    j = JReplicated(CJ, jax.tree.map(jnp.asarray, tree), data_parallel=3,
                    devices=jax.devices()[:3], cache_dtype=jnp.float32, **kw)
    try:
        for srv in (t, j):
            srv.drain(2)
        now, load = [0.0], [0.5]
        ctl = dict(min_replicas=2, max_replicas=3, scale_up_load=0.8, scale_down_load=0.3,
                   up_after_s=0.5, down_after_s=1.0, cooldown_s=1.0, clock=lambda: now[0],
                   load_fn=lambda: load[0])
        st, sj = tas.Autoscaler(t, **ctl), jas.Autoscaler(j, **ctl)
        c0 = {m: (m.AUTOSCALE_SPAWNS.value, m.AUTOSCALE_DRAINS.value) for m in (tmetrics, jmetrics)}
        rng = np.random.default_rng(3)
        ps = [rng.integers(1, CFG.vocab_size, 5).astype(np.int32) for _ in range(6)]
        tr = [t.submit(p, 14) for p in ps]
        jr = [j.submit(p, 14) for p in ps]
        curve = [0.5, 1.2, 1.2, 1.2, 1.2, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
        decisions = []
        for lv in curve:
            load[0] = lv
            now[0] += 0.3
            t.step()
            j.step()
            d = st.tick()
            assert d == sj.tick()
            decisions.append(d)
            assert len(t.servers) == len(j.servers)
        assert decisions.count("spawn") == 1 and decisions.count("drain") == 1
        assert decisions.index("spawn") < decisions.index("drain")
        assert len(t.servers) == 2
        t.run_until_idle()
        j.run_until_idle()
        for r, rj, p in zip(tr, jr, ps):
            assert r.error is None and r.tokens == rj.tokens == oracle(tparams, p, 14)
        for m in (tmetrics, jmetrics):
            assert (m.AUTOSCALE_SPAWNS.value - c0[m][0], m.AUTOSCALE_DRAINS.value - c0[m][1]) \
                == (1, 1)
    finally:
        t.close()
        j.close()


def test_ingress_attach_autoscaler_drives_the_port_router(tparams):
    """``IngressServer.attach_autoscaler`` (after ``start()``) starts the
    ingress's tick thread, which spawns a replica onto the freed group when
    the injected load is high and drains it when it falls."""
    rs = ReplicatedServer(CFG, tparams, data_parallel=2, devices=["cpu"] * 2, capacity=64,
                          min_replicas=1)
    ing = None
    try:
        rs.drain(1)
        load = [2.0]
        sc = tas.Autoscaler(rs, min_replicas=1, max_replicas=2, up_after_s=0.0,
                            down_after_s=0.0, cooldown_s=0.0, load_fn=lambda: load[0])
        ing = IngressServer(rs, poll_interval_s=0.0005, autoscale_interval_s=0.005)
        ing.start()
        ing.attach_autoscaler(sc)
        deadline = time.time() + 30
        # the tick thread counts a spawn (drain) just after the router's set
        # changed: wait for both
        while (len(rs.servers) < 2 or sc.spawns < 1) and time.time() < deadline:
            time.sleep(0.01)
        assert len(rs.servers) == 2 and sc.spawns >= 1
        load[0] = 0.0
        while (len(rs.servers) > 1 or sc.drains < 1) and time.time() < deadline:
            time.sleep(0.01)
        assert len(rs.servers) == 1 and sc.drains >= 1
    finally:
        if ing is not None:
            ing.stop()
        rs.close()


def test_disagg_role_load_and_paced_rebalance(tparams):
    """Over a disaggregated router the signal is the worst role pool's
    load (the prefill pool's queue here), and ``rebalance_every_s`` paces
    one planner-driven role flip through the tick."""
    heavy = tpl.PlacementPlanner(tpl.FittedLatency("linear", (1e-9, 0.0), 0.0, 1.0),
                                 tpl.FittedLatency("linear", (0.1, 0.0), 0.0, 1.0))
    ds = DisaggServer(CFG, tparams, data_parallel=3, devices=["cpu"] * 3, capacity=64,
                      kv_block_size=8, kv_blocks=49, prefix_cache="hbm",
                      roles=["prefill", "prefill", "decode"], planner=heavy,
                      async_handoff=False)
    try:
        now = [0.0]
        sc = tas.Autoscaler(ds, min_replicas=3, max_replicas=3, clock=lambda: now[0],
                            rebalance_every_s=1.0)
        reqs = [ds.submit(np.arange(1, 12, dtype=np.int32) + i, 6) for i in range(3)]
        assert sc.load() == ds.role_load() > 0.0
        ds.run_until_idle()
        assert all(r.error is None for r in reqs)
        assert sc.tick() is None and sc.rebalances == 0
        now[0] += 1.0
        sc.tick()
        assert sc.rebalances == 1 and sorted(ds.roles.values()) == ["decode", "decode", "prefill"]
    finally:
        ds.close()
