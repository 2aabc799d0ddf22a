"""The port's metrics exposition (``obs/http.py`` ``MetricsServer``) and its
lock hierarchy (``analysis/lockorder.py``) against the JAX package on the
CPU.

A ``MetricsServer`` on port 0 beside the port's CPU server (``tiny_llama``,
2 layers, f32, block size 4) answers on every endpoint: ``/metrics``
(Prometheus text, and OpenMetrics with exemplars when asked, as the JAX
server negotiates), ``/statz``, ``/debugz`` (the flight-recorder bundle
with the JAX bundle's keys), ``/profilez`` (an arm-and-capture round trip
against a step pump thread) and ``/healthz`` (200 while SERVING, 503 once
the server is closed). A served request's ``trace_id`` reaches
``/metrics`` as an exemplar. Under the tracked lock mode
(``SHARDLINT_LOCK_ORDER=1``, every lock built tracked) a served workload
scraped from another thread raises no ``LockOrderViolation``, and an
inverted pair does raise.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference

from llm_sharding_tpu.obs import http as jhttp
from llm_sharding_tpu.obs.metrics import Registry as JRegistry
from llm_sharding_tpu_torch.analysis import lockorder
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs.http import MetricsServer, write_ignoring_disconnect
from llm_sharding_tpu_torch.obs.metrics import Registry
from llm_sharding_tpu_torch.obs.stepline import PHASES
from llm_sharding_tpu_torch.runtime.engine import Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = tcfg.tiny_llama(num_hidden_layers=2)
KW = dict(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=60, prefill_chunk=8)


def get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def get_error(port, path):
    with pytest.raises(urllib.error.HTTPError) as ei:
        get(port, path)
    return ei.value.code, ei.value.read()


@pytest.fixture(scope="module")
def eng():
    return Engine(CFG, tllama.init_params(CFG, seed=7, dtype=torch.float32, device="cpu"))


def prompt(seed, n=5):
    return np.random.default_rng(seed).integers(3, CFG.vocab_size, n).astype(np.int32)


class Pump:
    """The step pump a daemon runs, on a thread of its own."""

    def __init__(self, srv):
        self.srv, self.stop = srv, threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self):
        while not self.stop.is_set():
            if not self.srv.step():
                time.sleep(0.001)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def wired(srv) -> MetricsServer:
    ms = MetricsServer(port=0, statz_extra={"counters": srv.counters.snapshot},
                       health_provider=lambda: srv.health)
    ms.set_profilez_provider(lambda steps, wait_s: (
        srv.stepline_capture(steps, wait_s) if steps is not None
        else {"stepline": srv.stepline_stats(), "steps": srv.stepline_snapshot(64)}))
    return ms


def test_every_endpoint_on_a_live_server(eng):
    srv = eng.serve(**KW)
    ms = wired(srv)
    assert ms.host == "127.0.0.1"
    port = ms.start()
    try:
        with Pump(srv):
            reqs = [srv.submit(prompt(60 + i, n), 24) for i, n in enumerate((5, 12))]
            code, ctype, body = get(port, "/profilez?steps=3&wait_s=30")
            bundle = json.loads(body)
            assert code == 200 and ctype == "application/json"
            assert bundle["profiler"] == "server" and bundle["complete"]
            assert bundle["steps_captured"] == 3
            for s in bundle["steps"]:
                assert s["wall_s"] == pytest.approx(
                    sum(s["phases"].values()) + s["blocked_s"] + s["unattributed_s"], abs=1e-9)
                assert all(name in PHASES for name, _, _ in s["segments"])
            assert get(port, "/healthz")[2] == b"ok\n"
            for r in reqs:
                deadline = time.time() + 60
                while not r.done and time.time() < deadline:
                    time.sleep(0.01)
                assert r.done and r.error is None
        code, ctype, text = get(port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        text = text.decode()
        for fam in ("server_step_phase_seconds", "server_host_occupancy",
                    "server_step_wall_seconds", "server_device_idle_frac",
                    "server_requests_completed_total", "server_ttft_seconds"):
            assert f"# TYPE {fam}" in text
        assert 'phase="dispatch"' in text and "trace_id" not in text
        _, ctype, om = get(port, "/metrics", {"Accept": "application/openmetrics-text"})
        assert "openmetrics-text" in ctype and om.decode().endswith("# EOF\n")
        assert any(f'trace_id="{r.trace.trace_id}"' in om.decode() for r in reqs)
        statz = json.loads(get(port, "/statz")[2])
        assert statz["counters"]["requests_completed"] == 2
        assert "server_ttft_seconds" in statz["metrics"]
        view = json.loads(get(port, "/profilez")[2])
        assert view["stepline"]["steps"] >= 3 and "wall_s" in view["steps"][-1]
        assert get_error(port, "/profilez?steps=zero")[0] == 400
        assert get_error(port, "/profilez?steps=2&wait_s=soon")[0] == 400
        assert get_error(port, "/nope")[0] == 404
        srv.close()
        code, body = get_error(port, "/healthz")
        assert (code, body) == (503, b"DRAINING\n")
        dbg = json.loads(get(port, "/debugz")[2])
        assert dbg["health"] == "DRAINING"
        spans = {e["span"] for e in dbg["recent_spans"]}
        assert {"request", "prefill", "decode", "apply"} <= spans
        assert any(p["profiler"] == "server" and p["steps"] for p in dbg["recent_steps"])
    finally:
        ms.stop()
        srv.close()


def test_debugz_bundle_has_the_jax_keys():
    bundles = []
    for ms in (MetricsServer(port=0, registry=Registry(), statz_extra={"c": lambda: 1},
                             health_provider=lambda: "SERVING"),
               jhttp.MetricsServer(port=0, registry=JRegistry(), statz_extra={"c": lambda: 1},
                                   health_provider=lambda: "SERVING")):
        port = ms.start()
        try:
            bundles.append(json.loads(get(port, "/debugz")[2]))
        finally:
            ms.stop()
    assert set(bundles[0]) == set(bundles[1])
    assert bundles[0]["health"] == "SERVING" and bundles[0]["c"] == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_exemplar_negotiation_and_providers_as_jax(pkg):
    ms_cls, reg = (MetricsServer, Registry()) if pkg == "port" else (jhttp.MetricsServer,
                                                                     JRegistry())
    reg.histogram("t_neg_seconds", "test", buckets=(1.0,)).observe(0.5, trace_id="neg-trace")
    states = iter(["SERVING", "DEGRADED"])

    def boom():
        raise RuntimeError("dead provider")

    ms = ms_cls(port=0, registry=reg, statz_extra={"dead": boom},
                health_provider=lambda: next(states))
    port = ms.start()
    try:
        assert b"neg-trace" not in get(port, "/metrics")[2]
        om = get(port, "/metrics", {"Accept": "application/openmetrics-text"})[2].decode()
        assert 'trace_id="neg-trace"' in om
        assert "dead provider" in json.loads(get(port, "/statz")[2])["dead"]["error"]
        assert get(port, "/healthz")[2] == b"ok\n"
        assert get_error(port, "/healthz") == (503, b"DEGRADED\n")
        assert get_error(port, "/profilez?steps=2")[0] == 503  # no provider attached
        assert isinstance(json.loads(get(port, "/profilez")[2])["profilers"], list)
        ms.set_health_provider(None)
        assert get(port, "/healthz")[2] == b"ok\n"
    finally:
        ms.stop()


def test_write_ignoring_disconnect():
    class Gone(io.BytesIO):
        def write(self, data):
            raise BrokenPipeError

    buf = io.BytesIO()
    assert write_ignoring_disconnect(buf, b"x", flush=True) and buf.getvalue() == b"x"
    assert write_ignoring_disconnect(Gone(), b"x") is False


# ------------------------------------------------------------ lock order


def test_inverted_lock_pair_raises():
    lockorder.enable(True)
    try:
        outer = lockorder.named_lock("server.mutex", "rlock")
        inner = lockorder.named_lock("obs.metrics.family")
        with outer:
            with outer:  # the same instance again: fine
                with inner:
                    assert lockorder.held_names() == [
                        "server.mutex", "server.mutex", "obs.metrics.family"]
        with inner:
            with pytest.raises(lockorder.LockOrderViolation, match="server.mutex"):
                outer.acquire()
        assert lockorder.held_names() == []
    finally:
        lockorder.enable(False)
    assert not isinstance(lockorder.named_lock("server.mutex"), lockorder._TrackedBase)


def test_served_workload_under_tracked_locks(tmp_path):
    """Every lock of the process built tracked: a served workload (traced,
    faults injected, a snapshot, a capture) while a ``MetricsServer``
    thread scrapes, with no ``LockOrderViolation``."""
    tracked_served_run(tmp_path, inflight=1)


def test_served_workload_under_tracked_locks_async_executor(tmp_path):
    """The same at ``inflight_steps=2``: the scheduler and sidecar threads
    take their conditions and the server mutex too."""
    tracked_served_run(tmp_path, inflight=2)


def tracked_served_run(tmp_path, inflight: int):
    code = textwrap.dedent(f"""
        import json, threading, time, urllib.request
        import numpy as np, torch
        from llm_sharding_tpu_torch.analysis import lockorder
        from llm_sharding_tpu_torch.models import config, llama
        from llm_sharding_tpu_torch.obs import REGISTRY, MetricsServer
        from llm_sharding_tpu_torch.runtime.engine import Engine
        from llm_sharding_tpu_torch.runtime.faults import FaultPlan
        assert lockorder.enabled()
        assert isinstance(REGISTRY._lock, lockorder._TrackedBase)
        cfg = config.tiny_llama(num_hidden_layers=2)
        eng = Engine(cfg, llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu"))
        plan = FaultPlan.transient_at("chunk_dispatch", 2, 5)
        srv = eng.serve(trace_path={str(tmp_path / "t.jsonl")!r}, fault_plan=plan,
                        fault_backoff_s=0, inflight_steps={inflight}, **{KW!r})
        assert isinstance(srv._mutex, lockorder._TrackedBase)
        assert (srv._sidecar is not None) == ({inflight} > 1)
        ms = MetricsServer(port=0, health_provider=lambda: srv.health)
        ms.set_profilez_provider(lambda s, w: srv.stepline_capture(s, w))
        port = ms.start()
        stop = threading.Event()
        def scrape():
            while not stop.is_set():
                for path in ("/metrics", "/statz", "/debugz", "/healthz", "/profilez"):
                    urllib.request.urlopen(f"http://127.0.0.1:{{port}}{{path}}", timeout=30).read()
        t = threading.Thread(target=scrape)
        t.start()
        rng = np.random.default_rng(0)
        reqs = [srv.submit(rng.integers(3, cfg.vocab_size, n), 12) for n in (5, 12, 20)]
        for _ in range(3):
            srv.step()
        srv.snapshot()
        srv.stepline.arm(2)
        srv.run_until_idle()
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive() and all(r.done and r.error is None for r in reqs)
        srv.close()
        ms.stop()
        print("ok", plan.stats()["total_fires"])
    """)
    env = dict(os.environ, SHARDLINT_LOCK_ORDER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "2"]
