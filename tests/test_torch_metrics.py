"""The port's metrics registry (``llm_sharding_tpu_torch/obs/metrics.py``)
against the JAX package's (``llm_sharding_tpu/obs/metrics.py``): the same
operations fed to a fresh ``Registry`` of each package must read out the
same Prometheus text, OpenMetrics text (exemplar timestamps aside) and JSON
snapshot, exactly; and the registry cases of ``tests/test_obs.py`` hold for
the port's copy. The two packages keep separate process-wide registries, so
the server-level checks compare deltas of the port's own tallies.
"""

import collections
import json
import re
import threading

import pytest

pytest.importorskip("jax")  # the JAX package is the reference

from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime import server as jserver
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.runtime import server as tserver

PACKAGES = {"port": tmetrics, "jax": jmetrics}

# the families the port's server registers, under the JAX package's names
SERVER_FAMILIES = (
    "server_queue_wait_seconds", "server_ttft_seconds", "server_intertoken_seconds",
    "server_request_seconds", "server_request_tok_s", "server_queue_depth",
    "server_slots_active", "server_fetch_failures_total", "server_rejected_total",
    "server_deadline_expired_total", "server_retries_total",
    "server_failures_contained_total", "server_snapshots_total",
    "server_snapshot_failures_total", "server_health_state",
    "server_kv_blocks_total", "server_kv_blocks_in_use", "server_arena_bytes",
    "server_kv_waste_frac", "server_prefix_cache_hit_tokens_total",
    "server_prefix_cache_hit_rate", "server_kv_host_tier_blocks",
    "server_kv_disk_tier_blocks", "server_faults_injected_total",
    "server_inflight_steps", "server_scheduler_lag_seconds",
    *(f"server_{f}_total" for f in (
        "requests_submitted", "requests_completed", "requests_cancelled",
        "requests_failed", "tokens_generated", "admissions", "chunks")),
)
# the attention-path families: decode backend and blocks read, prefill path
# and blocks read, admission buckets, batched cancels
ATTN_FAMILIES = (
    "server_attn_backend", "server_attn_blocks_read_total", "server_prefill_path",
    "server_prefill_blocks_read_total", "server_admit_bucket_total", "server_cancel_batch_rows",
)
SERVER_FAMILIES += ATTN_FAMILIES


def feed(m):
    """One sequence of operations on a fresh registry of module ``m``:
    counters with and without labels, gauges, histograms (default and own
    buckets, labeled, an exemplar, an infinite observation) and a state
    gauge."""
    r = m.Registry()
    c = r.counter("req_total", "requests", labels=("kind",))
    c.labels(kind="a").inc(3)
    c.labels("b").inc()
    c.labels(kind="a").inc(0.5)
    solo = r.counter("solo_total", "unlabeled")
    solo.inc()
    solo.inc(41)
    g = r.gauge("depth", "queue depth")
    g.set(7)
    g.inc(2.5)
    g.dec()
    lg = r.gauge("arena_bytes", "by dtype", labels=("dtype",))
    lg.labels(dtype="int8").set(1 << 30)
    lg.labels(dtype="bf16").set(3)
    h = r.histogram("lat_seconds", "latency")
    for v in (0.0002, 0.003, 0.003, 0.04, 0.7, 2.0, 90.0):
        h.observe(v)
    h.observe(0.02, trace_id="abc")
    rate = r.histogram("tok_s", "rate", buckets=m.DEFAULT_RATE_BUCKETS, labels=("who",))
    for i, v in enumerate((1.5, 30.0, 700.0, 12000.0)):
        rate.labels(who=str(i % 2)).observe(v)
    bad = r.histogram("poisoned_seconds", "an inf observation", buckets=(1.0,))
    bad.observe(float("inf"))
    sg = r.state_gauge("health_state", "health", states=("SERVING", "DEGRADED", "DRAINING"))
    sg.set_state("DEGRADED")
    sg.set_state("SERVING")
    return r


def _no_exemplar_time(text: str) -> str:
    return re.sub(r'(# \{trace_id="[^"]*"\} \S+) \S+', r"\1", text)


def _json_no_time(snap: dict) -> dict:
    for fam in snap.values():
        for s in fam["series"]:
            for ex in s.get("exemplars", {}).values():
                ex.pop("ts")
    return snap


def test_same_feeds_read_out_the_same():
    """Exact equality of every read-out format between the packages."""
    port, ref = feed(tmetrics), feed(jmetrics)
    assert port.prometheus_text() == ref.prometheus_text()
    assert _no_exemplar_time(port.prometheus_text(openmetrics=True)) == _no_exemplar_time(
        ref.prometheus_text(openmetrics=True))
    assert _json_no_time(port.json_snapshot()) == _json_no_time(ref.json_snapshot())
    assert "+Inf" in port.prometheus_text()  # the infinite sum renders, not raises
    json.loads(port.json_text())


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_histogram_buckets_and_quantiles(q):
    """``test_obs.py``'s bucket case: counts, sum and the interpolated
    quantiles, equal to the JAX registry's (exact: same float ops)."""
    out = {}
    for name, m in PACKAGES.items():
        r = m.Registry()
        h = r.histogram("h_seconds", "t", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.05, 0.5, 0.5, 0.5, 0.5, 5.0, 5.0, 5.0, 50.0):
            h.observe(v)
        child = h.labels()
        assert child.counts == [2, 4, 3, 1]
        assert child.count == 10 and child.sum == pytest.approx(67.1)
        assert r.histogram("h2_seconds", buckets=(1.0,)).labels().quantile(0.5) is None
        out[name] = child.quantile(q)
    assert out["port"] == out["jax"] == pytest.approx({0.5: 0.775, 0.9: 10.0, 0.99: 10.0}[q])


def test_registry_thread_safety_exact_sums():
    r = tmetrics.Registry()
    c = r.counter("c_total", labels=("who",))
    h = r.histogram("h_seconds", buckets=(0.5,))
    n_threads, n_iters = 8, 5000

    def work(i):
        child = c.labels(who=str(i % 2))
        for _ in range(n_iters):
            child.inc()
            h.observe(0.25)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sum(child.value for _, child in c.series()) == n_threads * n_iters
    assert h.labels().count == h.labels().counts[0] == n_threads * n_iters


@pytest.mark.parametrize("misuse", [
    lambda r: r.gauge("x_total"),
    lambda r: r.counter("x_total", labels=("b",)),
    lambda r: r.counter("bad name"),
    lambda r: r.counter("ok_total", labels=("bad label",)),
    lambda r: r.histogram("no_buckets", buckets=()),
    lambda r: r.state_gauge("no_states"),
    lambda r: r.get("x_total").inc(),  # a labeled family needs .labels()
    lambda r: r.get("x_total").labels(a="1").inc(-1),  # counters only go up
], ids=["kind", "labels", "name", "label-name", "buckets", "states", "solo", "negative"])
def test_registry_refuses_what_the_jax_registry_refuses(misuse):
    for m in PACKAGES.values():
        r = m.Registry()
        r.counter("x_total", labels=("a",))
        assert r.counter("x_total", labels=("a",)) is r.get("x_total")  # get-or-create
        with pytest.raises(ValueError):
            misuse(r)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_prometheus_text_golden(pkg):
    r = PACKAGES[pkg].Registry()
    c = r.counter("req_total", "requests", labels=("kind",))
    c.labels(kind="a").inc(3)
    r.gauge("depth", "queue depth").set(7)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert r.prometheus_text() == (
        "# HELP depth queue depth\n"
        "# TYPE depth gauge\n"
        "depth 7\n"
        "# HELP lat_seconds latency\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{le="0.1"} 1\n'
        'lat_seconds_bucket{le="1"} 2\n'
        'lat_seconds_bucket{le="+Inf"} 3\n'
        "lat_seconds_sum 5.55\n"
        "lat_seconds_count 3\n"
        "# HELP req_total requests\n"
        "# TYPE req_total counter\n"
        'req_total{kind="a"} 3\n'
    )


def test_json_snapshot_shape():
    snaps = []
    for m in PACKAGES.values():
        r = m.Registry()
        r.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
        snap = r.json_snapshot()["lat_seconds"]["series"][0]
        assert snap["count"] == 1
        assert snap["buckets"] == {"0.1": 1, "1": 1, "+Inf": 1}
        assert snap["p50"] == pytest.approx(0.05)
        json.loads(r.json_text())
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_state_gauge_one_hot():
    r = tmetrics.Registry()
    sg = r.state_gauge("h_state", "health", states=("A", "B", "C"))
    fam = r.get("h_state")
    assert {v[0]: c.value for v, c in fam.series()} == {"A": 0.0, "B": 0.0, "C": 0.0}
    for s in ("B", "C"):
        sg.set_state(s)
        assert sg.state == s
        assert {v[0]: c.value for v, c in fam.series()} == {
            x: float(x == s) for x in ("A", "B", "C")}
    with pytest.raises(ValueError):
        sg.set_state("D")


def test_counters_snapshot_roundtrip_forward_compat():
    """The port's ``Counters`` has the JAX fields and the same
    forward/backward-compatible ``from_snapshot``."""
    C = tserver.Counters
    c = C(requests_submitted=2, tokens_generated=9)
    snap = c.snapshot()
    assert snap == jserver.Counters(requests_submitted=2, tokens_generated=9).snapshot()
    assert C.from_snapshot(snap) == c
    snap["some_future_counter"] = 42
    assert C.from_snapshot(snap) == c
    assert C.from_snapshot({"chunks": 3}) == C(chunks=3)


def test_counters_inc_mirrors_the_port_registry():
    before = tmetrics.REGISTRY.get("server_chunks_total").value
    c = tserver.Counters()
    c.inc("chunks", 2)
    assert c.chunks == 2
    assert tmetrics.REGISTRY.get("server_chunks_total").value == before + 2
    c.chunks += 5  # direct field writes (restore) do not mirror
    assert tmetrics.REGISTRY.get("server_chunks_total").value == before + 2


@pytest.mark.parametrize("name", SERVER_FAMILIES)
def test_server_families_match_the_jax_registrations(name):
    """Each family the port's server and fault plan feed is registered in
    the port's registry with the JAX family's kind, labels and buckets."""
    from llm_sharding_tpu.parallel import serve  # noqa: F401  register families
    from llm_sharding_tpu.runtime import async_exec, faults  # noqa: F401
    from llm_sharding_tpu_torch.runtime import async_exec as tasync  # noqa: F401
    from llm_sharding_tpu_torch.runtime import faults as tfaults  # noqa: F401

    got, want = tmetrics.REGISTRY.get(name), jmetrics.REGISTRY.get(name)
    assert got is not None and want is not None
    assert (got.kind, got.label_names, got.buckets) == (want.kind, want.label_names, want.buckets)


@pytest.mark.parametrize("name", ATTN_FAMILIES)
def test_attention_families_match_the_jax_help(name):
    """The attention-path families carry the JAX help text and label values
    (``ATTN_BACKENDS``, ``PREFILL_PATHS``)."""
    from llm_sharding_tpu.parallel import serve  # noqa: F401  register families

    got, want = tmetrics.REGISTRY.get(name), jmetrics.REGISTRY.get(name)
    assert got.help == want.help
    assert tmetrics.ATTN_BACKENDS == jmetrics.ATTN_BACKENDS
    assert tmetrics.PREFILL_PATHS == jmetrics.PREFILL_PATHS


def _value(name, **labels):
    fam = tmetrics.REGISTRY.get(name)
    return fam.labels(**labels).value if labels else fam.value


def _cancel_hist():
    _, total, count = tmetrics.REGISTRY.get("server_cancel_batch_rows").labels().snap()
    return count, total


@pytest.mark.parametrize("mode", ["paged", "chunked", "dense"])
def test_attention_families_fed_by_a_served_run(mode):
    """A paged, a chunked (paged, prompt above ``prefill_chunk``) and a
    dense run on the CPU, one request cancelled mid-decode in each: the
    server's backend label counts in ``server_attn_backend``, paged decode
    steps add blocks read and dense ones none, a chunked admission flips
    ``server_prefill_path`` one-hot (``xla``: the plain paged path on the
    CPU; ``gather`` dense) and adds ``ceil((off + Sc) / BS)`` blocks per
    chunk, each admission counts its bucket, and the cancel is one batch of
    one row."""
    import numpy as np
    import torch

    from llm_sharding_tpu_torch.models import config as tcfg
    from llm_sharding_tpu_torch.models import llama as tllama
    from llm_sharding_tpu_torch.runtime.engine import Engine

    cfg = tcfg.tiny_llama()
    eng = Engine(cfg, tllama.init_params(cfg, seed=5, dtype=torch.float32, device="cpu"))
    BS, Sc = 4, 8
    kw = dict(capacity=64)
    if mode != "dense":
        kw.update(kv_block_size=BS, kv_blocks=64)
    if mode != "paged":
        kw.update(prefill_chunk=Sc)
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(3, cfg.vocab_size, 20).astype(np.int32)
    short = rng.integers(3, cfg.vocab_size, 5).astype(np.int32)
    srv = eng.serve(**kw)
    prompts = [short, long_prompt] if mode != "paged" else [short, short[:3]]
    buckets = [srv._bucket(len(p)) for p in prompts]
    want_path = {"paged": "xla", "chunked": "xla", "dense": "dense"}[mode]
    assert srv.attn_path == want_path
    blocks0 = _value("server_attn_blocks_read_total")
    pblocks0 = _value("server_prefill_blocks_read_total")
    admit0 = {b: _value("server_admit_bucket_total", bucket=str(b)) for b in set(buckets)}
    cancel0 = _cancel_hist()
    victim = srv.submit(short, 40)
    srv.step()
    srv.step()
    assert not victim.done
    assert srv.cancel(victim)
    reqs = [srv.submit(p, 6) for p in prompts]
    srv.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    tserver._update_load_gauges()
    assert _value("server_attn_backend", backend=want_path) >= 1
    count, total = _cancel_hist()
    assert (count - cancel0[0], total - cancel0[1]) == (1, 1)
    admissions = collections.Counter([srv._bucket(len(short))] + buckets)
    for b, n in admissions.items():
        assert _value("server_admit_bucket_total", bucket=str(b)) - admit0.get(b, 0) >= n
    decode_blocks = _value("server_attn_blocks_read_total") - blocks0
    prefill_blocks = _value("server_prefill_blocks_read_total") - pblocks0
    if mode == "dense":
        assert decode_blocks == 0 and prefill_blocks == 0
    else:
        assert decode_blocks > 0
    if mode == "paged":
        assert prefill_blocks == 0
    if mode == "chunked":
        bucket = srv._bucket(len(long_prompt))
        assert prefill_blocks == sum(-(-(off + Sc) // BS) for off in range(0, bucket, Sc))
    if mode != "paged":
        want = "gather" if mode == "dense" else "xla"
        assert {p: _value("server_prefill_path", path=p) for p in tmetrics.PREFILL_PATHS} == {
            p: float(p == want) for p in tmetrics.PREFILL_PATHS}
    srv.close()
