"""The port's step profiler (``obs/stepline.py``), its timed-lock sink and
``step-report`` against the JAX package on the CPU.

One scripted ``begin_step`` / ``push`` / ``pop`` / ``blocked`` / ``idle`` /
``end_step`` sequence under one injected fake clock gives equal
``StepRecord.to_dict()`` (apart from ``ts``) and equal ``stats()`` in both
packages; the ring, guard, arm/capture and timed-lock cases of
``tests/test_stepline.py:88-300`` run against the port. The port's
``step_report_json`` / ``render_step_report`` over a capture bundle written
by either package equal the JAX functions' output exactly, and the
``step-report`` CLIs print the same bytes (the JAX golden,
``tests/test_stepline.py:551``). The served cases run the port's CPU
server (``tiny_llama``, 2 layers, f32, block size 4): the accounting
invariant ``sum(phases) + blocked_s + unattributed_s == wall_s`` holds on
every step with unattributed under 5 % of wall (nothing is blocked on the
CPU), and the gauge sweep paces.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference

from llm_sharding_tpu import cli as jcli
from llm_sharding_tpu.analysis import lockorder as jlockorder
from llm_sharding_tpu.obs import report as jreport
from llm_sharding_tpu.obs import stepline as jstepline
from llm_sharding_tpu_torch import cli as tcli
from llm_sharding_tpu_torch.analysis import lockorder
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import report as treport
from llm_sharding_tpu_torch.obs import stepline
from llm_sharding_tpu_torch.obs.metrics import REGISTRY
from llm_sharding_tpu_torch.obs.stepline import PHASES, StepProfiler
from llm_sharding_tpu_torch.runtime.engine import Engine

CFG = tcfg.tiny_llama(num_hidden_layers=2)
KW = dict(capacity=64, batch_per_slot=3, kv_block_size=4, kv_blocks=60, prefill_chunk=8)


class FakeClock:
    """A settable clock: the accounting tests control time exactly."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def check_invariant(rec):
    """wall == phases + blocked + unattributed, exactly by construction."""
    host = sum(rec["phases"].values())
    assert rec["host_s"] == pytest.approx(host, abs=1e-12)
    assert rec["wall_s"] == pytest.approx(host + rec["blocked_s"] + rec["unattributed_s"],
                                          abs=1e-9)


# ------------------------------------------------------ parity under one clock

# each op: ("t", seconds) sets the clock; the rest call the profiler
SCRIPTS = {
    "disjoint": [
        ("begin",), ("t", 1.0), ("push", "admit"), ("t", 2.0), ("pop",), ("t", 2.5),
        ("push", "dispatch"), ("blocked", 0.25), ("t", 4.0), ("pop",), ("t", 5.0),
        ("end", dict(rows=3, tokens=7, queued=2, pending=1)),
    ],
    "nested": [
        ("begin",), ("t", 1.0), ("push", "admit"), ("push", "dispatch"), ("t", 1.5),
        ("push", "table_push"), ("t", 1.75), ("pop",), ("pop",), ("push", "fetch"),
        ("blocked", 0.5), ("t", 2.5), ("pop",), ("push", "apply"), ("t", 2.75), ("pop",),
        ("t", 3.0), ("pop",), ("idle", 0.2), ("t", 3.25), ("end", dict(rows=2, tokens=2)),
    ],
    "unbalanced": [
        ("begin",), ("t", 1.0), ("push", "dispatch"), ("t", 3.0), ("end", {}),
        ("begin",), ("push", "gauge_sweep"), ("t", 3.5), ("pop",), ("end", dict(queued=4)),
    ],
    "armed": [
        ("arm", 2), ("begin",), ("t", 1.0), ("push", "apply"), ("ex", "a"), ("ex", "b"),
        ("t", 1.5), ("pop",), ("idle", 0.25), ("end", dict(tokens=1)), ("begin",),
        ("push", "radix_plan"), ("t", 2.5), ("pop",), ("end", dict(tokens=2)), ("begin",),
        ("push", "admit"), ("t", 3.0), ("pop",), ("end", dict(tokens=3)),
    ],
}


def run_script(mod, script):
    clk = FakeClock()
    p = mod.StepProfiler(ring_size=8, clock=clk.now, name="parity")
    recs = []
    for op, *args in script:
        if op == "t":
            clk.t = args[0]
        elif op == "begin":
            p.begin_step()
        elif op == "push":
            p.push(args[0])
        elif op == "pop":
            p.pop()
        elif op == "blocked":
            p.blocked(args[0])
        elif op == "idle":
            p.idle(args[0])
        elif op == "arm":
            p.arm(args[0])
        elif op == "ex":
            p.note_exemplar(args[0])
        else:
            recs.append(p.end_step(**args[0]).to_dict())
    return p, recs


def no_ts(d):
    return {k: v for k, v in d.items() if k != "ts"}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_step_records_equal_jax_under_one_fake_clock(script):
    port, precs = run_script(stepline, SCRIPTS[script])
    ref, jrecs = run_script(jstepline, SCRIPTS[script])
    assert [no_ts(r) for r in precs] == [no_ts(r) for r in jrecs]
    for r in precs:
        check_invariant(r)
    assert port.stats() == ref.stats()
    assert port.stats(last_n=1) == ref.stats(last_n=1)
    assert [no_ts(r) for r in port.snapshot()] == [no_ts(r) for r in ref.snapshot()]
    bp, bj = port.capture_bundle(), ref.capture_bundle()
    for b in (bp, bj):
        b["steps"] = [no_ts(s) for s in b["steps"]]
    assert bp == bj
    assert port.steps_total == ref.steps_total


def test_phases_and_metric_families_match_jax():
    assert PHASES == jstepline.PHASES
    for name in ("server_step_phase_seconds", "server_step_wall_seconds",
                 "server_host_occupancy", "server_device_idle_frac",
                 "server_lock_wait_seconds"):
        port, ref = REGISTRY.get(name), jstepline.REGISTRY.get(name)
        assert (port.kind, port.help, port.label_names, port.buckets) == (
            ref.kind, ref.help, ref.label_names, ref.buckets), name
    assert lockorder.ORDER == jlockorder.ORDER


# ------------------------------------------------------------ profiler units


def test_ring_bounds_and_overwrite():
    clk = FakeClock()
    p = StepProfiler(ring_size=4, clock=clk.now, name="t-ring")
    for i in range(7):
        clk.t = float(i)
        p.begin_step()
        clk.t = float(i) + 0.5
        p.end_step(tokens=i)
    assert p.steps_total == 7
    snap = p.snapshot()
    assert len(snap) == 4
    assert [r["tokens"] for r in snap] == [3, 4, 5, 6]
    assert p.snapshot(last_n=2)[-1]["tokens"] == 6
    with pytest.raises(ValueError):
        StepProfiler(ring_size=0)


def test_recording_guards():
    p = StepProfiler(name="t-guard")
    p.begin_step()
    with pytest.raises(ValueError):
        p.push("not_a_phase")
    assert p.end_step() is not None
    p.set_enabled(False)
    p.begin_step()
    p.push("admit")
    p.pop()
    assert p.end_step() is None
    assert p.steps_total == 1
    p.set_enabled(True)
    with pytest.raises(ValueError):
        p.observe_offthread("not_a_phase", 0.1)


def test_arm_capture_keeps_segments_and_exemplars():
    clk = FakeClock()
    p = StepProfiler(clock=clk.now, name="t-cap")
    with pytest.raises(ValueError):
        p.arm(0)
    p.arm(2)
    assert p.armed and not p.wait_capture(0)
    for i in range(3):
        p.begin_step()
        clk.t += 1.0
        p.push("apply")
        for j in range(12):
            p.note_exemplar(f"trace-{i}-{j}")
        clk.t += 0.5
        p.pop()
        p.end_step(tokens=i)
    assert not p.armed and p.wait_capture(0)
    bundle = p.capture_bundle()
    assert bundle["steps_captured"] == 2 and bundle["complete"]
    assert bundle["lock_timing"] == lockorder.timing_enabled()
    for s in bundle["steps"]:
        (seg,) = s["segments"]
        assert list(seg) == ["apply", pytest.approx(1.0), pytest.approx(0.5)]
        assert len(s["exemplars"]) == 8
        check_invariant(s)
    tail = p.snapshot()[-1]
    assert "segments" not in tail and "exemplars" not in tail
    json.dumps(bundle)


def test_stats_occupancy_math():
    clk = FakeClock()
    p = StepProfiler(clock=clk.now, name="t-stats")
    for wall, work in ((1.0, 0.25), (3.0, 1.5)):
        p.begin_step()
        p.push("dispatch")
        clk.t += work
        p.pop()
        p.idle(0.1)
        clk.t += wall - work
        p.end_step()
    st = p.stats()
    assert st["host_occupancy"] == pytest.approx(1.75 / 4.0)
    assert st["device_idle_frac"] == pytest.approx(0.2 / 4.0)
    assert st["step_wall_p50_ms"] == pytest.approx(1000.0)
    assert StepProfiler(name="t-empty").stats() == jstepline.StepProfiler(name="t-e").stats()


# ------------------------------------------------- timed locks + wait sink


def test_timed_lock_mode_off_by_default_and_on_demand():
    assert not lockorder.timing_enabled()
    assert not isinstance(lockorder.named_lock("server.mutex"), lockorder._TimedBase)
    lockorder.enable_timing(True)
    try:
        lockorder.reset_wait_totals()
        mu = lockorder.named_lock("server.mutex")
        assert isinstance(mu, lockorder.TimedLock)
        with mu:
            pass
        n, _ = lockorder.wait_totals()["server.mutex"]
        assert n == 1
        mu.acquire()
        t = threading.Thread(target=lambda: (mu.acquire(), mu.release()))
        t.start()
        time.sleep(0.05)
        mu.release()
        t.join(timeout=10)
        assert not t.is_alive()
        n2, wait2 = lockorder.wait_totals()["server.mutex"]
        assert n2 == n + 2 and wait2 >= 0.04
        assert isinstance(lockorder.named_lock("server.mutex", "rlock"), lockorder.TimedRLock)
        cv = lockorder.named_lock("disagg.handoff", "condition")
        assert isinstance(cv, lockorder.TimedCondition)
        with cv:
            cv.notify_all()
    finally:
        lockorder.enable_timing(False)
        lockorder.reset_wait_totals()
    assert lockorder.wait_totals() == {}
    with pytest.raises(ValueError):
        lockorder.named_lock("not.a.lock")
    with pytest.raises(ValueError):
        lockorder.named_lock("server.mutex", "semaphore")


def test_lock_wait_sink_feeds_metric_but_skips_obs_locks():
    def count(lock):
        for s in REGISTRY.json_snapshot()["server_lock_wait_seconds"]["series"]:
            if s["labels"].get("lock") == lock:
                return s["count"]
        return 0

    before = count("server.mutex")
    stepline._lock_wait_sink("server.mutex", 0.002)
    assert count("server.mutex") == before + 1
    obs_before = count("obs.metrics.family")
    stepline._lock_wait_sink("obs.metrics.family", 0.002)
    assert count("obs.metrics.family") == obs_before


# -------------------------------------------------- served (the CPU server)


@pytest.fixture(scope="module")
def eng():
    return Engine(CFG, tllama.init_params(CFG, seed=7, dtype=torch.float32, device="cpu"))


def prompt(seed, n=5):
    return np.random.default_rng(seed).integers(3, CFG.vocab_size, n).astype(np.int32)


@pytest.mark.parametrize("speculate", [0, 3])
def test_served_accounting_invariant_in_band(eng, speculate):
    """Every step's phases + blocked + unattributed sum to wall, the
    unattributed slice stays under 5 %, and nothing is blocked on the CPU
    (no event: the program ran inside dispatch)."""
    kw = dict(KW, prefill_chunk=None, speculate=speculate) if speculate else KW
    srv = eng.serve(prefix_cache="hbm", **kw)
    reqs = [srv.submit(prompt(30 + i, n), 10) for i, n in enumerate((5, 12, 20))]
    srv.run_until_idle()
    recs = srv.stepline_snapshot()
    assert recs
    for r in recs:
        check_invariant(r)
        assert set(r["phases"]) <= set(PHASES)
        assert r["blocked_s"] == 0.0
    wall = sum(r["wall_s"] for r in recs)
    unatt = sum(r["unattributed_s"] for r in recs)
    assert unatt / wall < 0.05, f"unattributed {unatt / wall:.1%} of wall"
    seen = set().union(*(r["phases"] for r in recs))
    assert {"admit", "dispatch", "fetch", "apply", "gauge_sweep", "table_push"} <= seen
    if not speculate:
        assert "radix_plan" in seen
    assert sum(r["tokens"] for r in recs) == sum(len(r.tokens) for r in reqs)
    st = srv.stepline_stats()
    assert st["steps"] == len(recs) == srv.stepline.steps_total
    assert 0.0 < st["host_occupancy"] <= 1.0 and st["step_wall_p50_ms"] > 0.0
    snap = REGISTRY.json_snapshot()
    assert 0.0 < snap["server_host_occupancy"]["series"][0]["value"] <= 1.0
    srv.close()


def test_gauge_sweep_pacing(eng):
    with pytest.raises(ValueError):
        eng.serve(gauge_sweep_every_s=-1.0, **KW)

    def sweeps(srv):
        srv.submit(prompt(41), 12)
        srv.run_until_idle()
        srv.close()
        return sum(1 for r in srv.stepline_snapshot() if "gauge_sweep" in r["phases"])

    assert sweeps(eng.serve(**KW)) >= 3
    assert sweeps(eng.serve(gauge_sweep_every_s=3600.0, **KW)) <= 1


def test_capture_armed_by_the_pump_caller(eng):
    """Arm the window and drive ``step`` yourself: the bundle holds the
    armed steps' segment timelines and the applied rows' exemplars."""
    srv = eng.serve(**KW)
    req = srv.submit(prompt(50), 8)
    srv.stepline.arm(3)
    for _ in range(3):
        srv.step()
    bundle = srv.stepline.capture_bundle()
    assert bundle["complete"] and bundle["steps_captured"] == 3
    for s in bundle["steps"]:
        check_invariant(s)
        for name, off, dur in s["segments"]:
            assert name in PHASES and off >= 0.0 and dur >= 0.0
    assert req.trace.trace_id in bundle["steps"][-1]["exemplars"]
    # no pump: a capture times out incomplete instead of hanging
    assert not srv.stepline_capture(2, wait_s=0.05)["complete"]
    srv.close()


def test_capture_with_a_host_trace_on_the_cpu(eng, tmp_path):
    """``trace_dir`` brackets the window with ``torch.profiler`` (host
    activity only on a CPU server) and writes its Chrome trace."""
    srv = eng.serve(**KW)
    srv.submit(prompt(51), 12)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            if not srv.step():
                time.sleep(0.001)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        bundle = srv.stepline_capture(2, wait_s=30, trace_dir=str(tmp_path / "prof"))
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert bundle["complete"] and bundle["device_trace_dir"] == str(tmp_path / "prof")
    with open(bundle["device_trace"]) as f:
        assert json.load(f)["traceEvents"]
    srv.close()


# ------------------------------------------------------ step-report (both)


def fake_step(ts, wall, phases, blocked=0.0, idle=0.0, rows=1, tokens=2):
    host = sum(phases.values())
    return {
        "ts": ts, "wall_s": wall, "phases": phases, "blocked_s": blocked, "idle_s": idle,
        "unattributed_s": wall - host - blocked, "host_s": host, "occupancy": host / wall,
        "rows": rows, "tokens": tokens, "queued": 0, "pending": 0,
    }


def fake_bundle():
    return {
        "profiler": "server", "steps_requested": 2, "steps_captured": 2, "complete": True,
        "lock_timing": False,
        "steps": [
            fake_step(1.0, 0.1, {"admit": 0.02, "dispatch": 0.05}, blocked=0.01, idle=0.004),
            fake_step(2.0, 0.2, {"dispatch": 0.10, "apply": 0.06}, blocked=0.02),
        ],
    }


def profiler_bundle(mod):
    """A capture bundle written by ``mod``'s own profiler (fake clock)."""
    p, _ = run_script(mod, SCRIPTS["armed"])
    p2, _ = run_script(mod, SCRIPTS["nested"])
    return {"capture": p.capture_bundle(), "debugz": {"recent_steps": [
        {"profiler": "x", "stats": p2.stats(), "steps": p2.snapshot()}]}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_step_report_equals_jax_on_either_packages_bundle(writer, tmp_path):
    data = profiler_bundle(jstepline if writer == "jax" else stepline)
    paths = []
    for name, obj in data.items():
        paths.append(str(tmp_path / f"{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump(obj, f)
    steps_p, steps_j = treport.load_steps(paths), jreport.load_steps(paths)
    assert steps_p == steps_j and steps_p
    assert treport.step_report_json(steps_p) == jreport.step_report_json(steps_j)
    assert treport.render_step_report(steps_p, top=2) == jreport.render_step_report(steps_j, top=2)
    for shape in (data["capture"], data["debugz"], {"r0": data["capture"]}, [], "junk"):
        assert treport.extract_steps(shape) == jreport.extract_steps(shape)


def test_step_report_cli_golden(tmp_path, capsys):
    cap = tmp_path / "cap.json"
    cap.write_text(json.dumps(fake_bundle()))
    (tmp_path / "junk.json").write_text("{not json")
    assert tcli.main(["step-report", str(cap), str(tmp_path / "junk.json")]) == 0
    out = capsys.readouterr().out
    assert "2 step(s), 0.300s wall, 4 token(s)" in out
    for row in ("dispatch", "admit", "apply", "blocked", "unattributed", "device-idle bubble"):
        assert row in out
    assert tcli.main(["step-report", "--json", str(cap)]) == 0
    js = json.loads(capsys.readouterr().out)
    assert js["summary"]["host_occupancy"] == pytest.approx(0.23 / 0.3)
    assert js["phases"][0]["phase"] == "dispatch"
    assert tcli.main(["step-report", str(tmp_path / "missing.json")]) == 2
    assert tcli.main(["step-report", str(tmp_path / "junk.json")]) == 1
    capsys.readouterr()
    # the same bytes as the JAX CLI, on every argument list
    for argv in (["step-report", str(cap)], ["step-report", "--json", "--top", "1", str(cap)],
                 ["step-report", str(tmp_path / "cap.*")]):
        assert tcli.main(argv) == 0
        port = capsys.readouterr().out
        assert jcli.main(argv) == 0
        assert port == capsys.readouterr().out
