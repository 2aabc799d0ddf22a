"""The port's HTTP/SSE ingress over the port's CPU server against the JAX
ingress over the JAX server, on the same requests (``tiny_llama``, f32):
completions and embeddings are token-exact (tolerance: none), whole and
streamed; both answer the same status code and error type for 400, 401,
429, 503 and 504; a disconnect mid-stream cancels the row and frees its
blocks; the tenant reaches the backend's ``request`` span. A backend that
fails a request, or a pump whose step raises, answers 500. A served run
under the tracked lock mode (``SHARDLINT_LOCK_ORDER=1``) raises no
lock-order violation.
"""

import http.client
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime import fairness as jfair
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.ingress import IngressServer as JIngress
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs.metrics import REGISTRY
from llm_sharding_tpu_torch.obs.trace import FLIGHT_RECORDER
from llm_sharding_tpu_torch.runtime import fairness as tfair
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu.runtime import faults as jfaults
from llm_sharding_tpu_torch.runtime import faults as tfaults
from llm_sharding_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from llm_sharding_tpu_torch.runtime.ingress import IngressServer, start_ingress

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = tcfg.tiny_llama(num_hidden_layers=2)
KW = dict(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=48)


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=2)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(9), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    tb, jb = eng.serve(**KW), jeng.serve(**KW)
    yield eng, jeng, tb, jb
    tb.close()
    jb.close()


def backends(setup):
    """(port ingress class, its backend, fairness module), then the JAX's."""
    _, _, tb, jb = setup
    return [(IngressServer, tb, tfair), (JIngress, jb, jfair)]


def prompt(seed, n=5):
    return [int(t) for t in np.random.default_rng(seed).integers(3, CFG.vocab_size, n)]


def post(port, body, headers=None, path="/v1/completions", method="POST"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), json.loads(data) if data else None
    finally:
        conn.close()


def stream(port, body, headers=None, path="/v1/completions"):
    """A streamed request's SSE events up to ``[DONE]``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
        events = []
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if line.strip():
                events.append(json.loads(line.strip()[len(b"data: "):]))
        return events
    finally:
        conn.close()


def run_both(setup, fn, make_kw=lambda fair: {}):
    """``fn(ingress, backend, fairness_module)`` under a fresh ingress over
    each package's backend (``make_kw(fairness_module)``: the ingress's
    options); the port's result and the JAX's."""
    out = []
    for cls, backend, fair in backends(setup):
        ing = cls(backend, poll_interval_s=0.0005, **make_kw(fair))
        ing.start()
        try:
            out.append(fn(ing, backend, fair))
        finally:
            ing.stop()
    return out


def drained(backend):
    backend._alloc.check()
    assert backend._alloc.in_use == 0


def test_completions_whole_and_streamed_match_jax(setup):
    def fn(ing, backend, _):
        whole = []
        for seed in (1, 2):
            status, headers, body = post(ing.port, {"prompt": prompt(seed), "max_tokens": 8})
            assert status == 200 and headers["X-Request-Id"] == body["id"]
            whole.append((body["choices"][0]["token_ids"], body["choices"][0]["finish_reason"],
                          body["usage"], body["choices"][0]["text"]))
        events = stream(ing.port, {"prompt": prompt(3), "max_tokens": 8})
        toks = [t for ev in events for t in ev["choices"][0]["token_ids"]]
        # tokenizer-less: every delta's text is empty
        assert all(ev["choices"][0]["text"] == "" for ev in events)
        drained(backend)
        return whole, toks, events[-1]["choices"][0]["finish_reason"], events[-1]["usage"]

    got, want = run_both(setup, fn)
    assert got == want
    assert len(got[1]) >= 1


def test_embeddings_whole_and_streamed_match_jax(setup):
    eng, jeng = setup[0], setup[1]
    p = prompt(7, 6)
    emb = eng.embed_prompt(p)[0].numpy().tolist()
    assert np.array_equal(np.asarray(emb, np.float32),
                          np.asarray(jeng.embed_prompt(np.asarray(p))[0], np.float32))

    def fn(ing, backend, _):
        status, _, body = post(ing.port, {"input": emb, "max_tokens": 6}, path="/v1/embeddings")
        assert status == 200
        events = stream(ing.port, {"input": emb, "max_tokens": 6}, path="/v1/embeddings")
        ids = post(ing.port, {"prompt": p, "max_tokens": 6})[2]["choices"][0]["token_ids"]
        bad = post(ing.port, {"input": [1.0, 2.0]}, path="/v1/embeddings")
        return (body["choices"][0]["token_ids"], body["usage"],
                [t for ev in events for t in ev["choices"][0]["token_ids"]], ids,
                bad[0], bad[2]["error"]["type"])

    got, want = run_both(setup, fn)
    assert got == want
    assert got[0] == got[2] == got[3]


def test_bad_requests_and_not_found_match_jax(setup):
    bodies = ({"max_tokens": 4}, {"prompt": [], "max_tokens": 4},
              {"prompt": "text", "max_tokens": 4}, {"prompt": [1, 2], "max_tokens": 0},
              {"prompt": [1, 2], "max_tokens": 10_000})

    def fn(ing, backend, _):
        out = [(s, b["error"]["type"]) for s, _, b in (post(ing.port, x) for x in bodies)]
        out.append(post(ing.port, {"prompt": [1, 2]}, path="/nope")[0])
        out.append(post(ing.port, None, path="/healthz", method="GET")[:3:2])
        return out

    got, want = run_both(setup, fn)
    assert got == want
    assert [s for s, _ in got[:5]] == [400] * 5


def test_auth_rate_limit_and_drain_codes_match_jax(setup):
    """401 for unknown credentials, 429 with ``Retry-After`` past a
    tenant's burst, 503 once draining, with the same error types."""
    def tenants(fair):
        return dict(tenants=[fair.TenantConfig("alice", key="sk-a"),
                             fair.TenantConfig("slow", rate_rps=0.1, burst=2.0)],
                    allow_anonymous=False)

    ok = {"prompt": [1, 2, 3], "max_tokens": 2}

    def fn(ing, backend, _):
        out = []
        for hdr in ({"Authorization": "Bearer sk-a"}, {}, {"Authorization": "Bearer x"},
                    {"X-Tenant": "alice"}):
            s, _, b = post(ing.port, ok, hdr)
            out.append((s, None if s == 200 else b["error"]["type"]))
        for _ in range(4):
            s, h, b = post(ing.port, ok, {"X-Tenant": "slow"})
            out.append((s, None if s == 200 else (b["error"]["type"], int(h["Retry-After"]) >= 1)))
        ing.begin_drain()
        s, h, b = post(ing.port, ok, {"Authorization": "Bearer sk-a"})
        out.append((s, b["error"]["type"], h["Retry-After"]))
        out.append(post(ing.port, None, path="/healthz", method="GET")[::2])
        return out

    got, want = run_both(setup, fn, tenants)
    assert got == want
    assert [s for s, *_ in got[:4]] == [200, 401, 401, 401]


def test_deadline_and_overload_codes_match_jax(setup):
    """``X-Deadline-Ms`` too short for the decode: 504 ``deadline``; a
    full ingress queue: 503 ``overloaded``."""
    def fn(ing, backend, _):
        s, _, b = post(ing.port, {"prompt": prompt(11), "max_tokens": 56},
                       {"X-Deadline-Ms": "20"})
        out = [(s, b["error"]["type"])]
        s, _, b = post(ing.port, {"prompt": [1, 2, 3], "max_tokens": 2},
                       {"X-Deadline-Ms": "60000"})
        out.append(s)
        drained(backend)
        return out

    got, want = run_both(setup, fn)
    assert got == want == [(504, "deadline"), 200]

    # the global cap: the pump paused, two requests queue, the third sheds
    def overload(ing, backend, _):
        import threading

        ing.pause()
        res = []
        ts = [threading.Thread(target=lambda: res.append(post(ing.port, {"prompt": [1, 2],
                                                                         "max_tokens": 2})))
              for _ in range(2)]
        for t in ts:
            t.start()
        while ing.fair.depth() < 2:
            time.sleep(0.005)
        s, h, b = post(ing.port, {"prompt": [1, 2], "max_tokens": 2})
        ing.resume()
        for t in ts:
            t.join(60)
        return s, b["error"]["type"], int(h["Retry-After"]) >= 1, sorted(r[0] for r in res)

    got, want = run_both(setup, overload, lambda fair: dict(max_queue=2))
    assert got == want == (503, "overloaded", True, [200, 200])


def test_fault_sites_match_jax(setup):
    """An ``http_request`` fault sheds with 503 ``ingress_fault``; a
    ``slow_client`` fault mid-stream is a disconnect (the row cancelled),
    in both packages."""
    def fn(ing, backend, _):
        s, h, b = post(ing.port, {"prompt": [1, 2, 3], "max_tokens": 2})
        first = (s, b["error"]["type"], int(h["Retry-After"]) >= 1)
        c0 = backend.counters.requests_cancelled
        conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt(41, 4), "max_tokens": 40, "stream": True}))
        resp = conn.getresponse()
        resp.read()  # the handler stops writing at the injected stall
        conn.close()
        end = time.monotonic() + 30
        while time.monotonic() < end and backend.counters.requests_cancelled == c0:
            time.sleep(0.01)
        return first, resp.status, backend.counters.requests_cancelled - c0

    def plan(fair):
        mod = tfaults if fair is tfair else jfaults
        return dict(fault_plan=mod.FaultPlan([
            mod.FaultSpec("http_request", "permanent", at=(0,)),
            mod.FaultSpec("slow_client", "permanent", at=(1,)),
        ]))

    got, want = run_both(setup, fn, plan)
    assert got == want == ((503, "ingress_fault", True), 200, 1)


def test_disconnect_cancels_the_row_and_frees_its_blocks(setup):
    tb = setup[2]
    ing = IngressServer(tb, poll_interval_s=0.0005)
    ing.start()
    try:
        cancelled0 = tb.counters.requests_cancelled
        conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=60)
        p = prompt(5, 4)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": p, "max_tokens": 48, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        got = []
        while not got:
            line = resp.readline().strip()
            if line:
                got.extend(json.loads(line[len(b"data: "):])["choices"][0]["token_ids"])
        resp.close()
        conn.close()
        end = time.monotonic() + 30
        while time.monotonic() < end and not (
                tb.counters.requests_cancelled > cancelled0 and tb._alloc.in_use == 0):
            time.sleep(0.02)
        assert tb.counters.requests_cancelled == cancelled0 + 1
        drained(tb)
    finally:
        ing.stop()


def test_tenant_reaches_the_request_span(setup):
    tb = setup[2]
    ing = IngressServer(tb, poll_interval_s=0.0005,
                        tenants=[tfair.TenantConfig("acme", key="sk-acme")])
    ing.start()
    try:
        s, h, b = post(ing.port, {"prompt": prompt(21), "max_tokens": 3},
                       {"Authorization": "Bearer sk-acme", "X-Trace-Id": "ab" * 16})
        assert s == 200 and h["X-Trace-Id"] == "ab" * 16
    finally:
        ing.stop()
    rid = int(b["id"][len("cmpl-"):])
    # the handler emits the root ``ingress`` span after the response is out
    end = time.monotonic() + 10
    while True:
        spans = [e for e in FLIGHT_RECORDER.snapshot() if e.get("trace_id") == "ab" * 16]
        if "ingress" in {e["span"] for e in spans} or time.monotonic() > end:
            break
        time.sleep(0.01)
    req = [e for e in spans if e["span"] == "request" and e.get("id") == rid]
    assert req and req[0]["tenant"] == "acme"
    assert {"ingress", "queue"} <= {e["span"] for e in spans}
    fam = REGISTRY.get("server_ingress_requests_total")
    assert fam.labels(tenant="acme", outcome="ok").value >= 1


def test_backend_failure_and_pump_failure_answer_500(setup):
    """A request the backend fails (a permanent dispatch fault) answers
    500 ``failed``; so does every live request when the pump's step
    raises (the step is made to raise once)."""
    eng = setup[0]
    plan = FaultPlan([FaultSpec("chunk_dispatch", "permanent", at=(1,))])
    srv = eng.serve(fault_plan=plan, fault_retries=0, **KW)
    ing = start_ingress(srv, port=0, poll_interval_s=0.0005)
    try:
        s, _, b = post(ing.port, {"prompt": prompt(31), "max_tokens": 12})
        assert (s, b["error"]["type"]) == (500, "failed")
        real = srv.step
        raised = []

        def flaky():
            if not raised and srv._any_active():  # once, with a request in flight
                raised.append(1)
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return real()

        srv.step = flaky
        s, _, b = post(ing.port, {"prompt": prompt(32), "max_tokens": 30})
        assert (s, b["error"]["type"]) == (500, "failed"), b
        s, _, b = post(ing.port, {"prompt": [1, 2, 3], "max_tokens": 2})
        assert s == 200  # the pump survived
    finally:
        ing.stop()
        srv.close()


def test_served_ingress_run_under_tracked_locks():
    """Every lock built tracked: HTTP handlers, the ingress pump and the
    server's step share the server mutex without an order violation."""
    code = textwrap.dedent("""
        import http.client, json, threading
        import torch
        from llm_sharding_tpu_torch.analysis import lockorder
        from llm_sharding_tpu_torch.models import config, llama
        from llm_sharding_tpu_torch.runtime.engine import Engine
        from llm_sharding_tpu_torch.runtime.ingress import IngressServer
        assert lockorder.enabled()
        cfg = config.tiny_llama(num_hidden_layers=2)
        eng = Engine(cfg, llama.init_params(cfg, seed=1, dtype=torch.float32, device="cpu"))
        srv = eng.serve(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=48,
                        inflight_steps=2)
        ing = IngressServer(srv, poll_interval_s=0.0005)
        ing.start()
        codes = []
        def go(i):
            c = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=60)
            c.request("POST", "/v1/completions", json.dumps(
                {"prompt": [3 + i, 4, 5], "max_tokens": 6, "stream": i % 2 == 0}))
            r = c.getresponse(); r.read(); codes.append(r.status); c.close()
        ts = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        [t.start() for t in ts]; [t.join(60) for t in ts]
        ing.stop(); srv.close()
        print("ok", sorted(codes))
    """)
    env = dict(os.environ, SHARDLINT_LOCK_ORDER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "[200,", "200,", "200,", "200,", "200,", "200]"]


def test_dense_backend_streams_equal_submit(setup):
    """The ingress over a dense server: whole and streamed completions and
    an embeddings request equal the same server's ``submit`` streams."""
    eng = setup[0]
    srv = eng.serve(capacity=64, batch_per_slot=2)
    ing = start_ingress(srv, port=0, poll_interval_s=0.0005)
    try:
        p = prompt(51, 7)
        whole = post(ing.port, {"prompt": p, "max_tokens": 9})[2]["choices"][0]["token_ids"]
        events = stream(ing.port, {"prompt": p, "max_tokens": 9})
        emb = eng.embed_prompt(p)[0].numpy().tolist()
        embd = post(ing.port, {"input": emb, "max_tokens": 9},
                    path="/v1/embeddings")[2]["choices"][0]["token_ids"]
    finally:
        ing.stop()
    want = srv.result(srv.submit(np.asarray(p, np.int32), 9))
    srv.close()
    assert whole == [t for ev in events for t in ev["choices"][0]["token_ids"]] == embd == want
