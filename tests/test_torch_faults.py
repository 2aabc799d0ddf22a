"""The port's fault injection and containment (``runtime/faults.py`` and the
server's resilience layer) against the JAX package on the CPU.

``FaultPlan`` fires exactly as the JAX plan does on the same specs and seed;
``is_transient`` and ``backoff_delays`` agree. The server cases are
``tests/test_resilience.py``'s (``:172-526``) against the port's paged
server: ``tiny_llama`` at 8 layers in float32 (the JAX resilience tests'
config, weights from the same key), block size 4. Every greedy stream that
must survive is held, exactly (f32, same arithmetic), to the JAX
``PipelineServer``'s (paged, ``paged_attn="xla"``, one stage) on the same
prompts, which is the uninterrupted run. After each case the allocator's
``check()`` is clean and no block is held.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime import faults as jfaults
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs.metrics import REGISTRY
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime import faults as tfaults
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.server import (
    DeadlineExceeded, QueueFull, RequestFailed, ServerClosed,
)

CFG = tcfg.tiny_llama(num_hidden_layers=8)
KW = dict(capacity=64, kv_block_size=4, kv_blocks=80)


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=8)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(3), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    return eng, jeng


def prompt(seed, n=5):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n).astype(np.int32)


def jax_streams(jeng, reqs, **kw):
    """The JAX paged server's greedy streams of ``(prompt, max_new)``."""
    srv = jeng.serve(paged_attn="xla", **{**KW, **kw})
    got = [srv.submit(p, m) for p, m in reqs]
    srv.run_until_idle()
    srv.close()
    return [list(r.tokens) for r in got]


def metric(name, **labels):
    fam = REGISTRY.get(name)
    return fam.labels(**labels).value if labels else fam.value


def retries_total():
    return sum(c.value for _, c in REGISTRY.get("server_retries_total").series())


def drained(srv):
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    srv.close()


# ---------------------------------------------------------------- FaultPlan


def fire_seq(plan, site="chunk_dispatch", n=40, key=None):
    seq = []
    for _ in range(n):
        try:
            plan.check(site, key=key)
        except Exception as e:  # noqa: BLE001 — classified by type name
            seq.append(type(e).__name__[0])
        else:
            seq.append(".")
    return "".join(seq)


SPECS = {
    "at+rate": (dict(site="chunk_dispatch", kind="transient", at=(1, 7), rate=0.3), 5),
    "from_call": (dict(site="log_fetch", kind="permanent", from_call=4), 0),
    "max_fires": (dict(site="snapshot_write", kind="transient", from_call=0, max_fires=3), 0),
    "keyed": (dict(site="request_apply", kind="permanent", key=7, at=(0, 2)), 0),
    "rate-only": (dict(site="admit_dispatch", kind="transient", rate=0.5), 11),
}


@pytest.mark.parametrize("case", list(SPECS))
def test_fault_plan_fires_as_the_jax_plan(case):
    """Same spec and seed: the same fire sequence as the JAX plan, on every
    key, repeatable, typed the same, and the same ``stats()``."""
    spec, seed = SPECS[case]
    site = spec["site"]
    keys = (None, 7, 3) if spec.get("key") is not None else (None,)
    for key in keys:
        port = tfaults.FaultPlan([tfaults.FaultSpec(**spec)], seed=seed)
        ref = jfaults.FaultPlan([jfaults.FaultSpec(**spec)], seed=seed)
        got = fire_seq(port, site, key=key)
        assert got == fire_seq(ref, site, key=key)
        assert got == fire_seq(tfaults.FaultPlan([tfaults.FaultSpec(**spec)], seed=seed),
                               site, key=key)
        assert port.stats() == ref.stats()
    if case == "keyed":
        assert "P" in fire_seq(tfaults.FaultPlan([tfaults.FaultSpec(**spec)]), site, key=7)


def test_fault_plan_builders_and_typing():
    plan = tfaults.FaultPlan.permanent("request_apply", key=7)
    plan.check("request_apply", key=3)  # another key: no fire
    for _ in range(2):  # permanent never clears
        with pytest.raises(tfaults.PermanentFault) as ei:
            plan.check("request_apply", key=7)
        assert not ei.value.transient and ei.value.key == 7
    burst = tfaults.FaultPlan.transient_at("log_fetch", 0, 1)
    for _ in range(2):
        with pytest.raises(tfaults.TransientFault):
            burst.check("log_fetch")
    burst.check("log_fetch")
    rates = tfaults.FaultPlan.rates(seed=3, chunk_dispatch=0.2, log_fetch=0.1)
    jrates = jfaults.FaultPlan.rates(seed=3, chunk_dispatch=0.2, log_fetch=0.1)
    for site in ("chunk_dispatch", "log_fetch"):
        assert fire_seq(rates, site) == fire_seq(jrates, site)
    # a plan naming a site the port does not check yet still constructs
    for site in tfaults.SITES:
        tfaults.FaultPlan.permanent(site)
    assert tfaults.SITES == jfaults.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        tfaults.FaultSpec("replica_crash")
    with pytest.raises(ValueError):
        tfaults.FaultSpec("log_fetch", kind="flaky")
    with pytest.raises(ValueError):
        tfaults.FaultSpec("log_fetch", rate=1.5)


def _chain(outer, cause):
    try:
        raise outer from cause
    except RuntimeError as e:
        return e


@pytest.mark.parametrize("case", ["transient", "permanent", "wrapped-transient",
                                  "registered", "unregistered", "wrapped-registered"])
def test_is_transient_matches_jax(case):
    def make(f):
        return {
            "transient": lambda: f.TransientFault("log_fetch", 0),
            "permanent": lambda: f.PermanentFault("log_fetch", 0),
            "wrapped-transient": lambda: _chain(RuntimeError("read failed"),
                                                f.TransientFault("log_fetch", 1)),
            "registered": lambda: OSError("link dropped"),
            "unregistered": lambda: ValueError("bad"),
            "wrapped-registered": lambda: _chain(RuntimeError("read failed"), OSError("x")),
        }[case]()

    for extra in ((), (OSError,)):
        assert tfaults.is_transient(make(tfaults), extra) == jfaults.is_transient(make(jfaults), extra)


def test_sticky_cuda_errors_are_never_transient():
    """A CUDA error poisons the process's context: no registration makes it
    retryable, wrapped or not (a port-only rule)."""
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert not tfaults.is_transient(err, (RuntimeError,))
    assert not tfaults.is_transient(_chain(RuntimeError("read"), err), (RuntimeError,))
    assert tfaults.is_transient(RuntimeError("link dropped"), (RuntimeError,))


@pytest.mark.parametrize("args", [(3, 0.01, 0.02), (0, 0.5, 1.0), (5, 0.1, 1.0), (4, 0.0, 1.0)])
def test_backoff_delays_match_jax(args):
    assert tfaults.backoff_delays(*args) == jfaults.backoff_delays(*args)
    assert tfaults.backoff_delays(3, 0.01, max_s=0.02) == (0.01, 0.02, 0.02)


# ------------------------------------------------- transient and permanent


def test_transient_faults_every_site_token_exact(setup, tmp_path):
    """A transient plan at all five sites retries to completion: the greedy
    streams (one one-shot, one chunked admission) equal the run without
    faults and the JAX server's, the retries are counted, health stays
    SERVING."""
    eng, jeng = setup
    reqs = [(prompt(21), 10), (prompt(22, n=12), 8)]
    want = jax_streams(jeng, reqs, batch_per_slot=2, prefill_chunk=8)
    clean = eng.serve(batch_per_slot=2, prefill_chunk=8, **KW)
    base = [clean.submit(p, m) for p, m in reqs]
    clean.run_until_idle()
    assert [r.tokens for r in base] == want
    drained(clean)
    plan = tfaults.FaultPlan([
        tfaults.FaultSpec("admit_dispatch", "transient", at=(0,)),
        tfaults.FaultSpec("chunk_dispatch", "transient", at=(0, 2, 5)),
        tfaults.FaultSpec("log_fetch", "transient", at=(1, 4)),
        tfaults.FaultSpec("snapshot_write", "transient", at=(0,)),
        tfaults.FaultSpec("request_apply", "transient", at=(2,), key=0),
    ])
    r0 = retries_total()
    srv = eng.serve(batch_per_slot=2, prefill_chunk=8, fault_plan=plan, fault_backoff_s=0.0,
                    snapshot_every_s=1e9, snapshot_path=str(tmp_path / "snap"), **KW)
    srv._last_snapshot_at = -1e12  # one snapshot_write crossing
    got = [srv.submit(p, m) for p, m in reqs]
    srv.run_until_idle()
    assert [r.tokens for r in got] == want
    assert all(r.error is None for r in got) and srv.health == "SERVING"
    assert plan.stats()["total_fires"] == 8
    assert retries_total() - r0 == 8
    assert metric("server_retries_total", site="log_fetch") >= 2
    drained(srv)


def test_permanent_request_fault_contained(setup):
    """A permanent fault keyed to request 0 fails only that request; the
    co-admitted neighbour finishes exactly as the JAX server's stream; the
    freed row admits and completes a new request; health recovers."""
    eng, jeng = setup
    pa, pb, pc = prompt(31), prompt(32), prompt(33, n=4)
    want_b, want_c = jax_streams(jeng, [(pb, 8), (pc, 6)])
    c0 = metric("server_failures_contained_total", site="request_apply")
    srv = eng.serve(batch_per_slot=2, fault_plan=tfaults.FaultPlan.permanent("request_apply", key=0),
                    fault_backoff_s=0.0, **KW)
    victim, neighbor = srv.submit(pa, 8), srv.submit(pb, 8)
    srv.run_until_idle()
    assert victim.done and isinstance(victim.error, tfaults.PermanentFault)
    assert victim.tokens == []  # failed at its first token
    assert neighbor.error is None and neighbor.tokens == want_b
    with pytest.raises(RequestFailed) as ei:
        srv.result(victim)
    assert isinstance(ei.value.__cause__, tfaults.PermanentFault) and ei.value.request is victim
    assert srv.result(srv.submit(pc, 6)) == want_c
    assert srv.health == "SERVING"
    assert srv.counters.requests_failed == 1 and srv.counters.requests_completed == 2
    assert metric("server_failures_contained_total", site="request_apply") == c0 + 1
    drained(srv)


def test_dispatch_fault_past_retries_degrades_then_recovers(setup):
    """A decode dispatch failing past its retry budget fails the row it
    drove (DEGRADED); the next request completes exactly and health
    returns to SERVING."""
    eng, jeng = setup
    pb = prompt(42, n=4)
    (want_b,) = jax_streams(jeng, [(pb, 6)])
    srv = eng.serve(fault_plan=tfaults.FaultPlan([
        tfaults.FaultSpec("chunk_dispatch", "transient", at=(1, 2))]),
        fault_retries=1, fault_backoff_s=0.0, **KW)
    ra = srv.submit(prompt(41), 8)
    srv.run_until_idle()
    assert ra.done and isinstance(ra.error, tfaults.TransientFault)
    assert len(ra.tokens) == 2  # admission's token and one decode step
    assert srv.health == "DEGRADED"
    with pytest.raises(RequestFailed):
        srv.result(ra)
    assert srv.result(srv.submit(pb, 6)) == want_b
    assert srv.health == "SERVING"
    drained(srv)


def test_lost_log_fetch_contained(setup):
    """A token read lost past its retries fails the rows it carried and
    never wedges the server; a new request is then served exactly."""
    eng, jeng = setup
    pb = prompt(52, n=4)
    (want_b,) = jax_streams(jeng, [(pb, 6)])
    f0 = metric("server_failures_contained_total", site="log_fetch")
    srv = eng.serve(fault_plan=tfaults.FaultPlan([
        tfaults.FaultSpec("log_fetch", "permanent", at=(1,))]),
        fault_retries=0, fault_backoff_s=0.0, **KW)
    ra = srv.submit(prompt(51), 8)
    srv.run_until_idle()
    assert ra.done and isinstance(ra.error, tfaults.PermanentFault)
    assert len(ra.tokens) == 1  # the lost read was the first decode step's
    assert srv.result(srv.submit(pb, 6)) == want_b
    assert srv.health == "SERVING"
    assert metric("server_failures_contained_total", site="log_fetch") == f0 + 1
    drained(srv)


def test_admit_fault_past_retries_fails_the_batch(setup):
    """A permanent admission fault fails exactly the batch it admitted; the
    rows stay free and the next admission serves."""
    eng, jeng = setup
    pb = prompt(54, n=6)
    (want_b,) = jax_streams(jeng, [(pb, 5)])
    srv = eng.serve(batch_per_slot=2, fault_plan=tfaults.FaultPlan([
        tfaults.FaultSpec("admit_dispatch", "permanent", at=(0,))]),
        fault_retries=2, fault_backoff_s=0.0, **KW)
    a1, a2 = srv.submit(prompt(53), 5), srv.submit(prompt(55), 5)
    srv.step()
    assert isinstance(a1.error, tfaults.PermanentFault) and isinstance(a2.error, tfaults.PermanentFault)
    assert srv.health == "DEGRADED" and srv._alloc.in_use == 0
    assert srv.result(srv.submit(pb, 5)) == want_b
    assert srv.health == "SERVING"
    drained(srv)


# --------------------------------------- shed paths: queue, deadline, close


def test_queue_full_and_deadline_counters(setup, monkeypatch):
    """Queue-full rejection, the queued-deadline shed and the in-flight
    deadline cancel bump their counters and fail typed; two rows expiring
    together are stopped by one ``serve_cancel_rows`` call, and their
    blocks return."""
    eng, jeng = setup
    (want1,) = jax_streams(jeng, [(prompt(61), 4)])
    srv = eng.serve(batch_per_slot=2, max_queue=2, **KW)
    qf0 = metric("server_rejected_total", reason="queue_full")
    dq0 = metric("server_deadline_expired_total", where="queued")
    di0 = metric("server_deadline_expired_total", where="in_flight")
    r1 = srv.submit(prompt(61), 4)
    r2 = srv.submit(prompt(62), 4, deadline_s=1e-4)
    with pytest.raises(QueueFull):
        srv.submit(prompt(63), 4)
    assert metric("server_rejected_total", reason="queue_full") == qf0 + 1
    time.sleep(0.005)
    srv.run_until_idle()
    assert r1.error is None and r1.tokens == want1
    assert isinstance(r2.error, DeadlineExceeded) and r2.tokens == []
    assert metric("server_deadline_expired_total", where="queued") == dq0 + 1

    r3 = srv.submit(prompt(64), 48, deadline_s=0.5)
    r4 = srv.submit(prompt(65), 48, deadline_s=0.5)
    srv.step()  # admit both, one decode step
    assert r3.row is not None and r4.row is not None and not r3.done and not r4.done
    calls = []
    cancel = tserve.serve_cancel_rows
    monkeypatch.setattr(tserve, "serve_cancel_rows",
                        lambda st, rows: (calls.append(list(rows)), cancel(st, rows)))
    time.sleep(0.55)
    srv.step()  # the sweep catches both rows
    assert len(calls) == 1 and sorted(calls[0]) == [0, 1]
    for r in (r3, r4):
        assert r.done and isinstance(r.error, DeadlineExceeded) and 0 < len(r.tokens) < 48
    assert metric("server_deadline_expired_total", where="in_flight") == di0 + 2
    assert srv._alloc.in_use == 0
    with pytest.raises(ValueError):
        srv.submit(prompt(66), 4, deadline_s=0.0)
    with pytest.raises(ValueError):
        eng.serve(max_queue=0, **KW)
    drained(srv)


def test_default_deadline_applies_to_every_submit(setup):
    eng, _ = setup
    srv = eng.serve(default_deadline_s=1e-4, **KW)
    r = srv.submit(prompt(67), 4)
    time.sleep(0.005)
    srv.run_until_idle()
    assert isinstance(r.error, DeadlineExceeded)
    drained(srv)


def test_close_is_a_real_shutdown(setup):
    """close(): idempotent; the queued request fails with ServerClosed (its
    stream raises RequestFailed), submits are refused and counted, step
    no-ops, snapshot refuses, health is DRAINING."""
    eng, _ = setup
    srv = eng.serve(**KW)
    queued = srv.submit(prompt(71), 4)
    closed0 = metric("server_rejected_total", reason="closed")
    srv.close()
    srv.close()
    assert srv.health == "DRAINING"
    assert queued.done and isinstance(queued.error, ServerClosed)
    with pytest.raises(RequestFailed) as ei:
        list(srv.stream(queued))
    assert isinstance(ei.value.__cause__, ServerClosed)
    with pytest.raises(ServerClosed):
        srv.submit(prompt(72), 4)
    assert metric("server_rejected_total", reason="closed") == closed0 + 1
    assert srv.step() is False
    srv.run_until_idle()
    with pytest.raises(ServerClosed):
        srv.snapshot()
    srv._alloc.check()
    assert srv._alloc.in_use == 0


def test_close_unblocks_a_stream_in_another_thread(setup):
    """A consumer streaming (and pumping) on another thread gets its partial
    tokens, then RequestFailed caused by ServerClosed, when the server is
    closed under it; no block stays held. Once the request holds 3 tokens,
    the consumer's next step waits until ``close`` has run, so the request
    is still in flight when the server closes."""
    eng, _ = setup
    srv = eng.serve(**KW)
    r = srv.submit(prompt(73), 40)
    out, errors = [], []
    closed = threading.Event()
    step = srv.step

    def gated_step():
        if len(r.tokens) >= 3:
            closed.wait(timeout=60)
        return step()

    srv.step = gated_step

    def consume():
        try:
            for t in srv.stream(r):
                out.append(t)
        except RequestFailed as e:
            errors.append(e)

    t = threading.Thread(target=consume)
    t.start()
    deadline = time.time() + 60
    while len(r.tokens) < 3 and time.time() < deadline:
        time.sleep(0.001)
    assert not r.done
    srv.close()
    closed.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(errors) == 1 and isinstance(errors[0].__cause__, ServerClosed)
    assert out == r.tokens and 3 <= len(out) < 40
    srv._alloc.check()
    assert srv._alloc.in_use == 0


def test_health_state_machine_and_gauge(setup):
    """SERVING → DEGRADED (containment) → SERVING (a clean step) → DRAINING
    (close), the one-hot gauge following the worst live server."""
    import gc

    gc.collect()  # servers of earlier cases drop out of the live set
    eng, _ = setup
    gauge = REGISTRY.get("server_health_state")
    srv = eng.serve(fault_plan=tfaults.FaultPlan.permanent("request_apply", key=0),
                    fault_backoff_s=0.0, **KW)
    assert srv.health == "SERVING" and gauge.labels(state="SERVING").value == 1.0
    victim = srv.submit(prompt(97), 6)
    while not victim.done:
        srv.step()
    assert srv.health == "DEGRADED"
    assert gauge.labels(state="DEGRADED").value == 1.0
    assert gauge.labels(state="SERVING").value == 0.0
    ok = srv.submit(prompt(98, n=4), 4)
    srv.run_until_idle()
    assert ok.error is None and srv.health == "SERVING"
    assert gauge.labels(state="SERVING").value == 1.0
    srv.close()
    assert srv.health == "DRAINING"


def test_failed_autosnapshot_keeps_serving(setup, tmp_path):
    """A snapshot writer that always fails is counted, never fatal."""
    eng, jeng = setup
    pa = prompt(95, n=4)
    (want,) = jax_streams(jeng, [(pa, 6)])
    fails0 = metric("server_snapshot_failures_total")
    srv = eng.serve(snapshot_every_s=0.0, snapshot_path=str(tmp_path / "s"),
                    fault_plan=tfaults.FaultPlan.permanent("snapshot_write"),
                    fault_retries=0, fault_backoff_s=0.0, **KW)
    ra = srv.submit(pa, 6)
    srv.run_until_idle()
    assert ra.tokens == want and srv.health == "SERVING"
    assert metric("server_snapshot_failures_total") > fails0
    assert not (tmp_path / "s").exists()
    drained(srv)


def test_load_gauges_follow_the_server(setup):
    """The load sweep's gauges (queue depth, active rows, blocks in use,
    arena bytes) move with this server's state."""
    import gc

    gc.collect()
    eng, _ = setup
    srv = eng.serve(batch_per_slot=1, **KW)
    a, b = srv.submit(prompt(81), 6), srv.submit(prompt(82), 6)
    assert metric("server_queue_depth") >= 2
    srv.step()
    assert metric("server_slots_active") >= 1
    assert metric("server_kv_blocks_in_use") >= srv._alloc.in_use > 0
    assert metric("server_arena_bytes", dtype="bf16") >= srv.arena_bytes()
    srv.run_until_idle()
    assert a.done and b.done
    drained(srv)


class _RealErrorOnce:
    """A plan double raising a real ``OSError`` on the first pass through
    ``site``: registered with ``retryable_exceptions``, it is retried where
    the operation can be issued again (the token read) and contained where
    the program writes in place (a dispatch)."""

    def __init__(self, site):
        self.site, self.fired = site, 0

    def check(self, site, key=None):
        if site == self.site and not self.fired:
            self.fired += 1
            raise OSError(f"link dropped at {site}")


@pytest.mark.parametrize("site", ["log_fetch", "chunk_dispatch", "admit_dispatch"])
def test_registered_real_errors_are_retried_only_where_the_read_can_be_reissued(setup, site):
    eng, jeng = setup
    p = prompt(88)
    (want,) = jax_streams(jeng, [(p, 6)])
    srv = eng.serve(fault_plan=_RealErrorOnce(site), retryable_exceptions=(OSError,),
                    fault_backoff_s=0.0, **KW)
    r0 = metric("server_retries_total", site=site)
    r = srv.submit(p, 6)
    srv.run_until_idle()
    if site == "log_fetch":
        assert r.error is None and r.tokens == want and srv.health == "SERVING"
        assert metric("server_retries_total", site=site) == r0 + 1
    else:
        assert isinstance(r.error, OSError) and srv.health == "DEGRADED"
        assert metric("server_retries_total", site=site) == r0
    drained(srv)


def test_a_dropped_server_with_failed_requests_frees_without_the_collector(setup):
    """A request failed by containment keeps its cause, not the cause's
    traceback, whose frames would hold the server in a cycle: once dropped,
    the server (and its arena) is freed by reference counting alone."""
    import gc
    import weakref

    eng, _ = setup
    srv = eng.serve(fault_plan=tfaults.FaultPlan.permanent("request_apply", key=0),
                    fault_backoff_s=0.0, **KW)
    r = srv.submit(prompt(99), 4)
    srv.run_until_idle()
    assert isinstance(r.error, tfaults.PermanentFault) and r.error.__traceback__ is None
    alive = weakref.ref(srv)
    gc.disable()
    try:
        srv.close()
        del srv
        assert alive() is None
    finally:
        gc.enable()
