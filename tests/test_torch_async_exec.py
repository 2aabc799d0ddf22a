"""The port's step loop on the CPU: row state on the device, ``serve_chunk``,
the logs in flight (``_pending``), ``pipeline_depth`` / ``chunk_cycles`` /
``inflight_steps`` and ``runtime/async_exec.py``, against the JAX package.

``tiny_llama`` at 4 layers in float32, weights from ``jax.random.key(3)``
made with numpy, block size 4. The matrix of ``tests/test_async_exec.py``:
greedy streams of the plain, chunked (``prefill_chunk=8``), radix-hit
(``prefix_cache="hbm"``, a second wave over the first one's prompts) and
speculative (``speculate=2``) workloads at ``inflight_steps`` 2 and 4, at
``pipeline_depth=2`` and at ``chunk_cycles=3`` equal the port's serial run
and the JAX ``PipelineServer`` (paged, ``paged_attn="xla"``, one stage) at
the same knobs, exactly (f32, the same arithmetic). Then the knobs'
validation, the helper threads, a mid-flight snapshot, ``extract``'s
settle (a sampled row at ``pipeline_depth=2`` against ``generate(seed=)``),
a deadline shed through the scheduler's delta, a contained permanent fault
at depth 2, the stepline's exact accounting with the executor's phases,
``serve_chunk`` without a host copy, and the server-level ``top_k`` /
``top_p`` defaults.
"""

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs.metrics import REGISTRY
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.faults import FaultPlan, FaultSpec, PermanentFault
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.server import DeadlineExceeded, PipelineServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


CFG = tcfg.tiny_llama(num_hidden_layers=4)
BS = 4
KW = dict(capacity=64, batch_per_slot=3, kv_block_size=BS, kv_blocks=120)


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=4)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(3), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    return eng, jeng


def prompts(seed, n, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, n)]


def oracle(eng, p, n, **kw):
    res = tgenerate(CFG, eng.params, p, n, **kw)
    return res.tokens[0, len(p) : res.lengths[0]].tolist()


def gauge(name, **labels):
    fam = REGISTRY.get(name)
    return fam.labels(**labels).value if labels else fam.value


def clean(srv):
    srv._alloc.check()
    if srv._radix is not None:
        srv._radix.check()
    else:
        assert srv._alloc.in_use == 0
    srv.close()


# ------------------------------------------------ the token-identity matrix

WORKLOADS = {
    "plain": {},
    "chunked": dict(prefill_chunk=8),
    "radix": dict(prefix_cache="hbm"),
    "spec": dict(speculate=2),
}
KNOBS = {
    "inflight2": dict(inflight_steps=2),
    "inflight4": dict(inflight_steps=4),
    "depth2": dict(pipeline_depth=2),
    "cycles3": dict(chunk_cycles=3),
}


def workload_prompts(workload):
    lo, hi = (9, 14) if workload == "chunked" else (3, 9)
    ps = prompts(100 + len(workload), 5, lo=lo, hi=hi)
    if workload == "radix":
        head = prompts(7, 1, lo=2 * BS, hi=2 * BS + 1)[0]
        ps = [np.concatenate([head, p]) for p in ps]
    return ps


def run_streams(eng, workload, jax_side=False, **knobs):
    """Every prompt submitted at once and run to idle; the radix workload
    runs a second wave over the same prompts, which hits the tree."""
    ps = workload_prompts(workload)
    kw = dict(KW, **WORKLOADS[workload], **knobs)
    if jax_side:
        kw["paged_attn"] = "xla"
    srv = eng.serve(**kw)
    reqs = [srv.submit(p, 10) for p in ps]
    srv.run_until_idle()
    if workload == "radix":
        reqs += [srv.submit(p, 10) for p in ps]
        srv.run_until_idle()
        assert srv.prefix_cache_stats()["hit_tokens"] > 0
    assert all(r.error is None for r in reqs)
    toks = [list(r.tokens) for r in reqs]
    if jax_side:
        srv.close()
    else:
        assert not srv._pending
        clean(srv)
    return toks


_SERIAL: dict = {}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_token_identity_vs_serial_and_jax(setup, workload, knob):
    """Greedy streams at the knob equal the port's serial run and the JAX
    server at the same knob (whose own streams equal its serial run)."""
    eng, jeng = setup
    if workload not in _SERIAL:
        _SERIAL[workload] = run_streams(eng, workload)
    got = run_streams(eng, workload, **KNOBS[knob])
    assert got == _SERIAL[workload]
    assert got == run_streams(jeng, workload, jax_side=True, **KNOBS[knob])


def test_streams_equal_generate_under_depth(setup):
    """Not only self-consistent: every stream at ``inflight_steps=3`` equals
    the port's ``generate`` of its prompt alone."""
    eng = setup[0]
    ps = prompts(23, 4)
    srv = eng.serve(inflight_steps=3, **KW)
    reqs = [srv.submit(p, 12) for p in ps]
    srv.run_until_idle()
    for r, p in zip(reqs, ps):
        assert r.tokens == oracle(eng, p, 12)
    clean(srv)


# ---------------------------------------------------- knobs and threads

@pytest.mark.parametrize("knob,msg", [
    ("pipeline_depth", "pipeline_depth must be >= 1"),
    ("inflight_steps", "inflight_steps must be >= 1, got 0"),
    ("chunk_cycles", "chunk_cycles must be >= 1, got 0"),
])
def test_knobs_validated(setup, knob, msg):
    eng, jeng = setup
    with pytest.raises(ValueError, match=msg):
        eng.serve(**{knob: 0}, **KW)
    if knob != "chunk_cycles":  # the JAX server takes chunk_cycles=0
        with pytest.raises(ValueError, match=msg):
            jeng.serve(**{knob: 0}, **KW)


def test_depth1_has_no_threads_and_keeps_one_log_in_flight(setup):
    """The default is the serial loop with no helper thread; a step leaves
    ``pipeline_depth`` = 1 log in flight, so a token surfaces one step
    after the step that computed it."""
    eng = setup[0]
    srv = eng.serve(**KW)
    assert (srv.pipeline_depth, srv.inflight_steps, srv.chunk_cycles) == (1, 1, 1)
    assert srv._scheduler is None and srv._sidecar is None
    r = srv.submit(prompts(5, 1)[0], 6)
    srv.step()  # admission and the first chunk dispatched; one log left
    assert len(srv._pending) == 1 and r.tokens != []
    n = len(r.tokens)
    srv.step()
    assert len(srv._pending) == 1 and len(r.tokens) == n + 1
    srv.run_until_idle()
    assert not srv._pending and r.done
    clean(srv)


def test_helper_threads_start_and_stop(setup):
    eng = setup[0]
    srv = eng.serve(inflight_steps=2, **KW)
    assert srv._scheduler.is_alive() and srv._sidecar.is_alive()
    assert gauge("server_inflight_steps") == 2.0
    srv.close()
    assert not srv._scheduler.is_alive() and not srv._sidecar.is_alive()


class _GatedEvent:
    """A CUDA event's stand-in for a log that lands when ``gate`` is set."""

    def __init__(self, gate):
        self.gate = gate

    def query(self):
        return self.gate.is_set()

    def synchronize(self):
        self.gate.wait()


def _gate_logs(srv, gate):
    """Every log dispatched from now on lands only once ``gate`` is set."""
    push = srv._push_pending

    def gated(kind, log, meta):
        push(kind, log, meta)
        e = srv._pending[-1]
        e.event, e.done_at = _GatedEvent(gate), None

    srv._push_pending = gated


def test_wait_landed_with_a_timeout_polls_the_event():
    import threading

    from llm_sharding_tpu_torch.runtime.server import _InFlight

    gate = threading.Event()
    e = _InFlight("chunk", torch.zeros((1, 2), dtype=torch.int32), [])
    e.event, e.done_at = _GatedEvent(gate), None
    t0 = time.perf_counter()
    assert e.wait_landed(0.05) is False and e.done_at is None
    assert time.perf_counter() - t0 >= 0.05
    threading.Timer(0.02, gate.set).start()
    assert e.wait_landed(5.0) is True and e.done_at is not None
    assert e.landed() and e.wait_landed(0.0) is True


def test_sidecar_waits_for_a_log_in_flight_and_applies_it(setup):
    """The sidecar meets logs that have not landed (as on the card): it
    waits on the head entry's event outside every lock, stays alive, and
    applies the entries once they land; the stream equals ``generate``."""
    import threading

    eng = setup[0]
    srv = eng.serve(inflight_steps=2, **KW)
    gate = threading.Event()
    _gate_logs(srv, gate)
    p = prompts(6, 1, lo=6, hi=7)[0]
    r = srv.submit(p, 8)
    srv.step()  # the admission's log and the first chunk's, both in flight
    assert len(srv._pending) == 2
    srv._sidecar.notify()
    time.sleep(0.3)
    assert srv._sidecar.is_alive() and srv._sidecar.error is None
    assert srv._sidecar.applied == 0 and len(srv._pending) == 2
    gate.set()
    end = time.perf_counter() + 10.0
    while srv._sidecar.applied < 2 and time.perf_counter() < end:
        time.sleep(0.005)
    assert srv._sidecar.applied >= 2 and r.tokens
    del srv._push_pending
    srv.run_until_idle()
    assert srv._sidecar.is_alive() and srv._sidecar.error is None
    assert r.tokens == oracle(eng, p, 8)
    clean(srv)


def test_a_failed_helper_thread_raises_at_the_next_step(setup):
    """A sidecar that dies is never silent: its exception is kept, and
    every later step raises it; ``close()`` still shuts down."""
    eng = setup[0]
    srv = eng.serve(inflight_steps=2, **KW)
    srv.submit(prompts(8, 1)[0], 8)

    def boom():
        raise ValueError("sidecar boom")

    srv._drain_landed = boom
    srv._sidecar.notify()
    srv._sidecar.join(timeout=10.0)
    assert not srv._sidecar.is_alive()
    assert isinstance(srv._sidecar.error, ValueError)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="serve-exec-sidecar thread failed") as ei:
            srv.step()
        assert ei.value.__cause__ is srv._sidecar.error
    srv.close()
    assert not srv._scheduler.is_alive()


def test_chunk_cycles_commits_cycles_tokens_per_dispatch(setup):
    """One dispatch runs ``chunk_cycles`` decode steps: its log is
    ``[cycles, M]`` and a live row commits a token at each step."""
    eng = setup[0]
    srv = eng.serve(chunk_cycles=3, **KW)
    r = srv.submit(prompts(6, 1)[0], 9)
    srv.step()
    chunk = srv._pending[-1]
    assert chunk.kind == "chunk" and tuple(chunk.log.shape) == (3, srv.rows)
    assert not r.done and bool((chunk.log[:, r.row] >= 0).all())
    srv.run_until_idle()
    assert r.tokens == oracle(eng, prompts(6, 1)[0], 9)
    clean(srv)


# --------------------------------------------------- settled boundaries

def test_mid_flight_snapshot_restore(setup):
    """``snapshot`` with dispatches in flight settles first; the restored
    server keeps the knobs and finishes every stream as the uninterrupted
    run does. A snapshot without the knobs restores with the defaults."""
    eng = setup[0]
    ps = prompts(31, 3)
    srv = eng.serve(inflight_steps=2, chunk_cycles=2, **KW)
    reqs = [srv.submit(p, 12) for p in ps]
    for _ in range(3):
        srv.step()
    assert srv._pending or any(not r.done for r in reqs)
    snap = srv.snapshot()
    assert not srv._pending
    kw = snap["serve_kwargs"]
    assert (kw["inflight_steps"], kw["chunk_cycles"], kw["pipeline_depth"]) == (2, 2, 1)
    ids = [r.id for r in reqs]
    srv.close()
    srv2 = PipelineServer.restore(eng, snap)
    assert (srv2.inflight_steps, srv2.chunk_cycles) == (2, 2)
    revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    srv2.run_until_idle()
    for rid, p in zip(ids, ps):
        assert revived[rid].tokens == oracle(eng, p, 12)
    clean(srv2)
    # a snapshot of an earlier port (no step-loop options): the defaults
    old = dict(snap, serve_kwargs={k: v for k, v in kw.items() if k not in (
        "inflight_steps", "chunk_cycles", "pipeline_depth", "top_k", "top_p")})
    srv3 = PipelineServer.restore(eng, old)
    assert (srv3.inflight_steps, srv3.chunk_cycles, srv3.pipeline_depth) == (1, 1, 1)
    assert srv3._scheduler is None
    srv3.run_until_idle()
    clean(srv3)


def test_extract_settles_a_sampled_row_at_depth_2(setup):
    """``extract`` applies the logs in flight first, so a sampled row's
    generator state matches its applied tokens: adopted elsewhere it
    continues ``generate(seed=)``'s stream. A greedy row at depth 4
    likewise loses nothing."""
    eng = setup[0]
    p, q = prompts(37, 2, lo=5, hi=8)
    src = eng.serve(pipeline_depth=2, **KW)
    dst = eng.serve(**KW)
    rs = src.submit(p, 14, temperature=0.9, seed=11)
    rg = src.submit(q, 14)
    for _ in range(4):
        src.step()
    assert src._pending and not rs.done and not rg.done
    applied = len(rs.tokens)
    for r in (rs, rg):
        dst.adopt(src.extract(r), r)
    assert len(rs.tokens) > applied  # the settle applied the logs in flight
    dst.run_until_idle()
    assert rs.tokens == oracle(eng, p, 14, temperature=0.9, seed=11)
    assert rg.tokens == oracle(eng, q, 14)
    clean(src)
    clean(dst)


# ------------------------------------------------------------ chaos at depth

def test_deadline_shed_through_the_scheduler_delta(setup):
    """At depth 2 the scheduler plans the expiries and the executor applies
    them from the published delta, re-validated at the boundary."""
    eng = setup[0]
    srv = eng.serve(inflight_steps=2, **KW)
    dq0 = gauge("server_deadline_expired_total", where="queued")
    di0 = gauge("server_deadline_expired_total", where="in_flight")
    lag = REGISTRY.get("server_scheduler_lag_seconds")
    lag0 = lag.labels().count
    rq = srv.submit(prompts(41, 1)[0], 4, deadline_s=1e-4)
    time.sleep(0.005)
    srv._scheduler.kick()
    time.sleep(0.1)
    srv.step()
    assert rq.done and isinstance(rq.error, DeadlineExceeded)
    assert gauge("server_deadline_expired_total", where="queued") == dq0 + 1
    ri = srv.submit(prompts(42, 1)[0], 48, deadline_s=0.05)
    srv.step()
    time.sleep(0.06)
    srv._scheduler.kick()
    time.sleep(0.1)
    srv.step()
    assert ri.done and isinstance(ri.error, DeadlineExceeded)
    assert gauge("server_deadline_expired_total", where="in_flight") == di0 + 1
    assert lag.labels().count > lag0
    p = prompts(43, 1)[0]
    assert srv.result(srv.submit(p, 6)) == oracle(eng, p, 6)
    srv.run_until_idle()
    clean(srv)


def test_permanent_fault_contained_at_depth_2(setup):
    """A poisoned request at depth 2 fails alone: its neighbor finishes
    exactly, a new request admits, and the allocator and the tree are
    clean after the containment unwound the dispatches in flight."""
    eng = setup[0]
    srv = eng.serve(inflight_steps=2, prefix_cache="hbm", fault_backoff_s=0.0,
                    fault_plan=FaultPlan.permanent("request_apply", key=0), **KW)
    pa, pb = prompts(51, 2)
    victim = srv.submit(pa, 8)
    neighbor = srv.submit(pb, 8)
    srv.run_until_idle()
    assert victim.done and isinstance(victim.error, PermanentFault)
    assert neighbor.error is None and neighbor.tokens == oracle(eng, pb, 8)
    pc = prompts(52, 1, lo=4, hi=5)[0]
    assert srv.result(srv.submit(pc, 6)) == oracle(eng, pc, 6)
    srv.run_until_idle()
    assert srv.health == "SERVING"
    clean(srv)


def test_lost_chunk_log_fails_its_rows_and_stops_them(setup):
    """A chunk log lost past its retries at depth 2: the rows it carried
    fail and are stopped on the device; the server serves on exactly."""
    eng = setup[0]
    srv = eng.serve(pipeline_depth=2, fault_backoff_s=0.0, fault_retries=0,
                    fault_plan=FaultPlan([FaultSpec("log_fetch", "permanent", at=(3,))]), **KW)
    reqs = [srv.submit(p, 10) for p in prompts(53, 2)]
    srv.run_until_idle()
    assert all(r.done for r in reqs)
    assert any(r.error is not None for r in reqs)
    assert all(bool(srv.state.done[i]) for i in range(srv.rows))
    p = prompts(54, 1)[0]
    assert srv.result(srv.submit(p, 6)) == oracle(eng, p, 6)
    srv.run_until_idle()
    clean(srv)


def test_lost_chunk_log_fails_only_the_rows_it_carried(setup):
    """A chunk log lost after a later admission: the rows the chunk drove
    at its dispatch fail; the request admitted since streams on exactly."""
    eng = setup[0]
    srv = eng.serve(pipeline_depth=2, **KW)
    pa, pb = prompts(55, 2)
    ra = srv.submit(pa, 10)
    srv.step()
    entry = next(e for e in srv._pending if e.kind == "chunk")
    assert entry.meta == [(ra.row, ra)]
    srv._pending.remove(entry)  # the log that will be lost
    rb = srv.submit(pb, 10)
    srv.step()  # admits rb next to ra
    assert rb.row is not None and not rb.done
    srv._contain_lost_log(entry, RuntimeError("lost"))
    assert ra.done and isinstance(ra.error, RuntimeError)
    assert not rb.done and rb.error is None
    srv.run_until_idle()
    assert rb.error is None and rb.tokens == oracle(eng, pb, 10)
    clean(srv)


# ----------------------------------------------------------- observability

@pytest.mark.parametrize("knobs", [dict(inflight_steps=2), dict(pipeline_depth=2)])
def test_stepline_exact_accounting(setup, knobs):
    """Every step's phases, blocked and unattributed time sum to its wall;
    the executor's ``publish`` / ``drain`` phases appear at depth 2 and
    the scheduler's ``plan`` time never enters a record."""
    eng = setup[0]
    srv = eng.serve(prefill_chunk=8, **knobs, **KW)
    for p in prompts(81, 4, lo=3, hi=14):
        srv.submit(p, 10)
    srv.run_until_idle()
    recs = srv.stepline_snapshot()
    seen = set()
    for r in recs:
        host = sum(r["phases"].values())
        assert r["wall_s"] == pytest.approx(host + r["blocked_s"] + r["unattributed_s"],
                                            abs=1e-9)
        assert r["blocked_s"] == 0.0  # the CPU runs each program inside its dispatch
        assert "plan" not in r["phases"]
        seen |= set(r["phases"])
    assert {"dispatch", "fetch", "apply", "admit"} <= seen
    if knobs.get("inflight_steps"):
        assert {"publish", "drain"} <= seen
        srv._scheduler.kick()
        time.sleep(0.1)
        series = REGISTRY.json_snapshot()["server_step_phase_seconds"]["series"]
        assert any(s["labels"].get("phase") == "plan" and s["count"] > 0 for s in series)
    else:
        assert not {"publish", "drain"} & seen
        assert max(r["pending"] for r in recs) >= 1
    clean(srv)


# ---------------------------------------------------------- the programs

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_chunk_copies_nothing_from_the_host(setup, monkeypatch, kv):
    """``serve_chunk`` makes no host→device copy of numpy: with
    ``torch.from_numpy`` patched to raise it runs ``cycles`` steps, and it
    equals ``cycles`` single steps on a copy of the state."""
    eng = setup[0]
    srv = eng.serve(kv_dtype=kv, **KW)
    reqs = [srv.submit(p, 20) for p in prompts(61, 3)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs)
    st = srv.state

    def copy_state():
        import copy
        return copy.deepcopy(st)

    twin = copy_state()

    def refuse(*a, **k):
        raise AssertionError("serve_chunk copied a numpy array to the device")

    monkeypatch.setattr(torch, "from_numpy", refuse)
    log = tserve.serve_chunk(CFG, eng.params, st, 3, "plain")
    singles = [tserve.serve_chunk(CFG, eng.params, twin, 1, "plain") for _ in range(3)]
    monkeypatch.undo()
    assert tuple(log.shape) == (3, srv.rows)
    assert torch.equal(log, torch.cat(singles))
    live = [r.row for r in reqs]
    assert bool((log[:, live] >= 0).all())
    assert bool((log[:, [i for i in range(srv.rows) if i not in live]] == -1).all())
    for f in ("tok", "pos_slots", "write_off", "lengths", "done", "budget", "kpos", "k", "v"):
        assert torch.equal(getattr(st, f), getattr(twin, f)), f
    srv.close()


def test_done_rows_write_nothing(setup):
    """A row done on the device takes no write: the arena, its key
    positions and its state are untouched by a chunk."""
    eng = setup[0]
    srv = eng.serve(**KW)
    r = srv.submit(prompts(62, 1)[0], 20)
    srv.step()
    srv._drain(0)
    st = srv.state
    k0, v0, kpos0 = st.k.clone(), st.v.clone(), st.kpos.clone()
    tserve.serve_cancel_rows(st, [r.row])
    lengths0, pos0 = st.lengths.clone(), st.pos_slots.clone()
    log = tserve.serve_chunk(CFG, eng.params, st, 2, "plain")
    assert bool((log == -1).all())
    assert torch.equal(st.kpos, kpos0) and torch.equal(st.lengths, lengths0)
    assert torch.equal(st.pos_slots, pos0)
    blocks = [b for b in srv._tables[r.row] if b]
    assert torch.equal(st.k[:, blocks], k0[:, blocks]) and torch.equal(st.v[:, blocks], v0[:, blocks])
    srv.close()


# ------------------------------------------------- server-level filters

def test_server_top_k_top_p_defaults(setup):
    """``serve(top_k=, top_p=)`` are the defaults of requests that give
    none: greedy streams equal the JAX server's with the same defaults,
    sampled seeded ones the port's ``generate`` with those filters, and a
    request's own values win. The defaults ride snapshots."""
    eng, jeng = setup
    ps = prompts(71, 3)
    srv = eng.serve(top_k=5, top_p=0.8, **KW)
    assert srv.submit(ps[0], 4).top_k == 5
    own = srv.submit(ps[0], 4, top_k=0, top_p=1.0)
    assert (own.top_k, own.top_p) == (0, 1.0)
    srv.run_until_idle()
    greedy = [srv.submit(p, 8) for p in ps]
    sampled = [srv.submit(p, 8, temperature=0.9, seed=3 + i) for i, p in enumerate(ps)]
    assert all((r.top_k, r.top_p) == (5, 0.8) for r in greedy + sampled)
    srv.run_until_idle()
    jsrv = jeng.serve(top_k=5, top_p=0.8, paged_attn="xla", **KW)
    jreqs = [jsrv.submit(p, 8) for p in ps]
    jsrv.run_until_idle()
    jsrv.close()
    assert [r.tokens for r in greedy] == [list(r.tokens) for r in jreqs]
    for i, (r, p) in enumerate(zip(sampled, ps)):
        assert r.tokens == oracle(eng, p, 8, temperature=0.9, seed=3 + i, top_k=5, top_p=0.8)
    snap = srv.snapshot()
    assert (snap["serve_kwargs"]["top_k"], snap["serve_kwargs"]["top_p"]) == (5, 0.8)
    srv2 = PipelineServer.restore(eng, snap)
    assert (srv2.top_k, srv2.top_p) == (5, 0.8)
    clean(srv2)
    clean(srv)
    with pytest.raises(ValueError, match="top_k must be >= 0"):
        eng.serve(**KW).submit(ps[0], 4, top_k=-1)


def test_concurrent_streams_under_the_async_executor(setup):
    """Stress: more consumer threads than cores stream their own requests
    (each ``stream`` pumps ``step``) while the scheduler and the sidecar
    run, with a short switch interval; every stream equals ``generate``
    and the allocator drains."""
    import os
    import sys
    import threading

    eng = setup[0]
    srv = eng.serve(inflight_steps=4, **dict(KW, batch_per_slot=4))
    ps = prompts(91, 2 * (os.cpu_count() or 4) + 2)
    got, errors = {}, []

    def consume(i, p):
        try:
            got[i] = srv.result(srv.submit(p, 6))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=consume, args=(i, p)) for i, p in enumerate(ps)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    srv.run_until_idle()
    for i, p in enumerate(ps):
        assert got[i] == oracle(eng, p, 6)
    clean(srv)
