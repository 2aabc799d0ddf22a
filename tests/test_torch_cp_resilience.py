"""Durability and mobility of the port's context-parallel server at cp 2:
the contracts of ``tests/test_cp_resilience.py`` (tiny_llama, 8 layers,
f32, 2 stages, every shard on the CPU device). Greedy streams are held
against the JAX package (its ``generate`` oracle, or its cp server on a
quantized arena); seeded sampled rows, whose random numbers are the
port's own, against the port's uninterrupted run or ``generate``.

- a cp-2 server auto-snapshots mid-decode (format 2: ``serve_kwargs``
  carry ``cp``), dies, and a server restored from disk finishes every
  request as the uninterrupted run, in f32, int8 and fp8 arenas; restore
  re-projects the host mirror's global ids into every shard's local plane
  and the sharded allocator's partition; a restore onto an engine without
  ``cp × stages`` devices is refused in the JAX words;
- replica failover of a cp-2 ``ReplicatedServer`` mid-decode, each
  replica's grid on its own device group;
- the disagg hand-off from a cp-2 prefill replica streams per-shard blocks
  with no re-prefill on the cp-2 decode replica; a transient
  ``cp_shard_stream`` fault is retried, a permanent one falls back;
- the host tier's demote / restore is byte-exact per owner shard;
- the retired gates are gone from snapshot / extract / adopt and the
  block streams, the remaining ones keep the JAX words, and the cp metric
  families equal the JAX registrations.

Every comparison is exact (tolerance 0).
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.runtime import server as jserver
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs.metrics import (
    CP_STREAM_SHARDS, DISAGG_HANDOFFS, HANDOFF_BYTES, REGISTRY,
)
from llm_sharding_tpu_torch.runtime import server as tserver
from llm_sharding_tpu_torch.runtime.blocks import ShardedBlockAllocator
from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.faults import FaultPlan
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer
from llm_sharding_tpu_torch.runtime.server import PipelineServer, load_snapshot

torch.set_num_threads(1)

L = 8
CJ = jcfg.tiny_llama(num_hidden_layers=L, max_position_embeddings=512)
CFG = tcfg.tiny_llama(num_hidden_layers=L, max_position_embeddings=512)
BS = 8
CAP = 128
CHUNK = 16
STAGES = 2


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(19), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


@pytest.fixture(scope="module")
def eng(tparams):
    return Engine(CFG, tparams, num_stages=STAGES, devices=["cpu"] * (2 * STAGES))


def serve(eng, **kw):
    kw.setdefault("capacity", CAP)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_blocks", 4 * CAP // BS + 1)  # per shard
    kw.setdefault("prefill_chunk", CHUNK)
    return eng.serve(**kw)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(1, CJ.vocab_size, n).astype(np.int32)


def drive(srv, reqs):
    while any(not r.done for r in reqs):
        srv.step()


def joracle(tree, p, n):
    res = jgenerate(CJ, jax.tree.map(jnp.asarray, tree), p, n, cache_dtype=jnp.float32)
    return [int(x) for x in res.tokens[0, len(p) : int(res.lengths[0])]]


def toracle(tparams, p, n, **kw):
    res = tgenerate(CFG, tparams, p, n, **kw)
    return res.tokens[0, len(p) : int(res.lengths[0])].tolist()


def handoff_tally():
    return {k: DISAGG_HANDOFFS.labels(outcome=k).value
            for k in ("ok", "cold", "retried", "fallback", "no_target", "failed")}


def stream_tally():
    return {o: CP_STREAM_SHARDS.labels(outcome=o).value for o in ("ok", "error")}


# ------------------------------------------------ snapshot → kill → restore


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_cp_autosnapshot_kill_restore_token_exact(tree, tparams, eng, tmp_path, kv_dtype):
    """A cp-2 server auto-snapshots after every step; after five it dies,
    and a server restored from the directory finishes both requests (greedy
    and seeded-sampled) as the uninterrupted cp-2 run, the streamed tokens
    replayed without loss or duplication. The uninterrupted greedy stream
    is the JAX oracle's (f32 arena) or the JAX cp-2 server's (int8 / fp8)."""
    snap_dir = str(tmp_path / f"auto-{kv_dtype}")
    srv = serve(eng, cp=2, kv_dtype=kv_dtype, snapshot_every_s=0.0, snapshot_path=snap_dir)
    pa, pb = prompt(61, 7 * BS), prompt(62, 23)
    samp = dict(temperature=0.9, seed=8)
    ra = srv.submit(pa, max_new_tokens=12)
    rb = srv.submit(pb, max_new_tokens=10, **samp)
    for _ in range(5):
        srv.step()
    assert not ra.done and not rb.done
    streamed = {ra.id: list(ra.tokens), rb.id: list(rb.tokens)}
    srv.close()

    snap = load_snapshot(snap_dir)
    assert snap["format"] == tserver.SNAPSHOT_FORMAT
    assert snap["serve_kwargs"]["cp"] == 2 and snap["serve_kwargs"]["kv_dtype"] == kv_dtype
    srv2 = PipelineServer.restore(eng, snap)
    assert srv2.cp == 2 and isinstance(srv2._alloc, ShardedBlockAllocator)
    revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    for rid, toks in streamed.items():
        assert revived[rid].tokens[: len(toks)] == toks
    srv2.run_until_idle()
    full = serve(eng, cp=2, kv_dtype=kv_dtype)
    fa, fb = full.submit(pa, max_new_tokens=12), full.submit(pb, max_new_tokens=10, **samp)
    drive(full, [fa, fb])
    full.close()
    assert revived[ra.id].tokens == fa.tokens and revived[rb.id].tokens == fb.tokens
    if kv_dtype == "bf16":
        assert fa.tokens == joracle(tree, pa, 12)
        assert fb.tokens == toracle(tparams, pb, 10, **samp)
    else:
        jeng = PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=STAGES,
                              cache_dtype=jnp.float32)
        js = serve(jeng, cp=2, kv_dtype=kv_dtype)
        ja = js.submit(pa, max_new_tokens=12)
        drive(js, [ja])
        js.close()
        assert fa.tokens == ja.tokens
    srv2._alloc.check()
    srv2.close()


def test_cp_snapshot_restore_reprojects_tables_and_allocator(tree, eng):
    """The restored server's planes are the projection of its restored
    global mirror, the row spans both shards, the per-shard free lists
    partition the pool, and the stream finishes as the JAX oracle's."""
    p = prompt(63, 5 * BS + 3)
    srv = serve(eng, cp=2)
    r = srv.submit(p, max_new_tokens=8)
    for _ in range(3):
        srv.step()
    snap = srv.snapshot()
    srv.close()
    srv2 = PipelineServer.restore(eng, snap)
    row = next(q.row for q in srv2._req if q is not None)
    assert {srv2._alloc.owner(g) for g in srv2._row_blocks[row]} == {0, 1}
    nb = srv2.kv_blocks
    g = srv2._tables[None]
    sh = np.arange(srv2.cp, dtype=np.int32)[:, None, None]
    np.testing.assert_array_equal(srv2.state.block_tables.numpy(),
                                  np.where(g // nb == sh, g % nb, 0).astype(np.int32))
    srv2._alloc.check()
    revived = {q.id: q for q in srv2._req if q is not None}
    srv2.run_until_idle()
    assert revived[r.id].tokens == joracle(tree, p, 8)
    srv2.close()


def test_cp_mismatched_restore_refused_curated(tparams, eng):
    """A cp-2 snapshot restored onto an engine of 2 devices for 2 stages is
    refused in the JAX server's words, naming the cp × stages grid."""
    srv = serve(eng, cp=2)
    srv.submit(prompt(64, 3 * BS), max_new_tokens=6)
    srv.step()
    snap = srv.snapshot()
    srv.close()
    small = Engine(CFG, tparams, num_stages=STAGES, devices=["cpu"] * STAGES)
    with pytest.raises(ValueError, match=r"cp×stages") as e:
        PipelineServer.restore(small, snap)
    assert "a context-parallel restore needs cp×stages=4 devices" in str(e.value)


# ---------------------------------------------------------- dp failover


def test_cp_replica_failover_mid_decode_token_exact(tree, tparams):
    """A permanent ``replica_step`` fault kills replica 0 mid-decode; every
    live row it owned (greedy and seeded-sampled) finishes on the cp-2
    survivor as the oracle's stream. Each replica's grid is built from its
    own group of the router's devices."""
    plan = FaultPlan.permanent("replica_step", key=0, start=4)
    srv = ReplicatedServer(
        CFG, tparams, data_parallel=2, num_stages=STAGES, cp=2, fault_plan=plan,
        devices=["cpu"] * (2 * 2 * STAGES),
        capacity=CAP, kv_block_size=BS, kv_blocks=4 * CAP // BS + 1, prefill_chunk=CHUNK,
        prefix_cache="hbm",
    )
    assert all(s.cp == 2 for s in srv.servers)
    for d, s in enumerate(srv.servers):
        assert s.mesh.shape == {"cp": 2, "pipe": STAGES}
        assert s.engine._devices == list(srv._groups[d]) and len(srv._groups[d]) == 4
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3 * BS, 7 * BS, 4)]
    kws = [dict(temperature=1.1, seed=7, top_k=5)] + [{}] * 3
    reqs = [srv.submit(p, 12, **kw) for p, kw in zip(prompts, kws)]
    assert len({srv._owner[r] for r in reqs}) == 2
    srv.run_until_idle()
    assert len(srv.servers) == 1  # replica 0 really died
    for r, p, kw in zip(reqs, prompts, kws):
        assert r.error is None, (r.id, r.error)
        want = toracle(tparams, p, 12, **kw) if kw else joracle(tree, p, 12)
        assert r.tokens == want, f"req {r.id} diverged after cp failover"
    for s in srv.servers:
        s._alloc.check()
        s._radix.check()
    srv.close()


# ------------------------------------------------------- disagg hand-off


def make_dsrv(tparams, **kw):
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_blocks", 6 * CAP // BS + 1)
    kw.setdefault("prefix_cache", "hbm")
    kw.setdefault("prefill_chunk", CHUNK)
    return DisaggServer(CFG, tparams, data_parallel=2, num_stages=STAGES, cp=2, capacity=CAP,
                        devices=["cpu"] * (2 * 2 * STAGES), roles=["prefill", "decode"], **kw)


def test_cp_disagg_handoff_streams_per_shard_zero_reprefill(tree, tparams):
    """A hand-off from a cp-2 prefill replica streams its blocks shard by
    shard (``ok``, handed-off bytes and the per-shard stream counter grow)
    and the cp-2 decode replica re-prefills none of the streamed prefix:
    its chunked admissions cover the sub-block tail only."""
    srv = make_dsrv(tparams)
    assert all(s.cp == 2 for s in srv.servers)
    admits = []
    dec = [s for s in srv.servers if srv.role_of(s) == "decode"]
    for s in dec:
        orig = s._admit_chunked

        def trap(rows, prompts, plen, *a, __orig=orig, **kw):
            admits.append((int(np.max(plen)), int(kw.get("prefix_off", 0))))
            return __orig(rows, prompts, plen, *a, **kw)

        s._admit_chunked = trap
    before, hb0, cs0 = handoff_tally(), HANDOFF_BYTES.value, stream_tally()
    prompts = [prompt(71, 4 * BS + 5), prompt(73, 2 * BS + 2)]
    assert prompts[0][0] != prompts[1][0]
    kws = [{}, dict(temperature=0.9, seed=3)]
    reqs = []
    for p, kw in zip(prompts, kws):
        r = srv.submit(p, 8, **kw)
        reqs.append(r)
        while not r.tokens:
            srv.step()
    srv.run_until_idle()
    for r, p, kw in zip(reqs, prompts, kws):
        assert r.error is None, (r.id, r.error)
        want = toracle(tparams, p, 8, **kw) if kw else joracle(tree, p, 8)
        assert r.tokens == want, f"req {r.id}"
    after, cs1 = handoff_tally(), stream_tally()
    assert after["ok"] - before["ok"] == len(reqs), (before, after)
    assert after["cold"] == before["cold"]
    assert HANDOFF_BYTES.value > hb0
    assert admits
    for suffix_len, prefix_off in admits:
        assert prefix_off > 0 and suffix_len <= BS, (suffix_len, prefix_off)
    aligned = sum(((len(p) - 1) // BS) * BS for p in prompts)
    assert sum(s._radix.hit_tokens for s in dec) >= aligned
    assert cs1["ok"] - cs0["ok"] >= 2 * len(reqs)
    assert cs1["error"] == cs0["error"]
    for s in srv.servers:
        s._alloc.check()
        s._radix.check()
    srv.close()


def test_cp_shard_stream_transient_retry_then_ok(tree, tparams):
    """One transient ``cp_shard_stream`` fault on shard 1 defers the
    hand-off one sweep (``retried``, then ``ok``), counted as one shard
    error; the stream is the oracle's."""
    plan = FaultPlan.transient_at("cp_shard_stream", 0, key=1)
    srv = make_dsrv(tparams, fault_plan=plan)
    b, cs0 = handoff_tally(), stream_tally()
    p = prompt(73, 2 * BS + 3)
    r = srv.submit(p, 6)
    srv.run_until_idle()
    a, cs1 = handoff_tally(), stream_tally()
    assert r.error is None and r.tokens == joracle(tree, p, 6)
    assert a["retried"] - b["retried"] == 1, (b, a)
    assert a["ok"] - b["ok"] == 1
    assert cs1["error"] - cs0["error"] == 1
    for s in srv.servers:
        s._alloc.check()
    srv.close()


def test_cp_shard_stream_permanent_falls_back(tree, tparams):
    """A permanent fault on shard 0 exhausts the retries and falls back:
    the request decodes on its prefill replica to the oracle's stream,
    never half-streamed."""
    plan = FaultPlan.permanent("cp_shard_stream", key=0)
    srv = make_dsrv(tparams, fault_plan=plan)
    b = handoff_tally()
    p = prompt(74, 2 * BS + 3)
    r = srv.submit(p, 6)
    srv.run_until_idle()
    a = handoff_tally()
    assert r.error is None and r.tokens == joracle(tree, p, 6)
    assert a["fallback"] - b["fallback"] == 1, (b, a)
    assert a["ok"] - b["ok"] == 0
    pre = [s for s in srv.servers if srv.role_of(s) == "prefill"]
    assert sum(s.counters.requests_completed for s in pre) == 1
    srv.close()


# ------------------------------------------------------------- host tier


def test_cp_host_tier_demote_restore_byte_exact_per_shard(tree, eng):
    """Demoted nodes read their blocks from the owner shards: their host
    copy equals a direct read shard by shard, they record the owners, and a
    later hit restores them to the arena (a host hit) with the oracle's
    stream."""
    srv = serve(eng, cp=2, prefix_cache="host", host_pool_blocks=64)
    shared = prompt(81, 6 * BS)
    p1 = np.concatenate([shared, prompt(82, 9)])
    r1 = srv.submit(p1, max_new_tokens=6)
    drive(srv, [r1])
    assert r1.tokens == joracle(tree, p1, 6)
    cold = [n for n in srv._radix._iter_nodes() if n.on_device() and n.refs == 0]
    assert cold
    pre = {id(n): ([srv._alloc.owner(b) for b in n.blocks],
                   tuple(np.asarray(a) for a in srv._read_arena_blocks(n.blocks)))
           for n in cold}
    assert any(len(set(ow)) == 2 for ow, _ in pre.values())
    assert srv._radix.demote_all() > 0
    host_nodes = [n for n in srv._radix._iter_nodes() if not n.on_device()]
    assert host_nodes
    for n in host_nodes:
        owners, bytes_ = pre[id(n)]
        assert n.host_owners == owners
        for sh in sorted(set(owners)):
            sel = [i for i, o in enumerate(owners) if o == sh]
            for comp, host_comp in zip(bytes_, n.host_kv):
                np.testing.assert_array_equal(comp[:, :, sel], np.asarray(host_comp)[:, :, sel],
                                              err_msg=f"shard {sh} bytes diverged through demote")
    hh0 = srv._radix.host_hit_tokens
    p2 = np.concatenate([shared, prompt(83, 12)])
    r2 = srv.submit(p2, max_new_tokens=6)
    drive(srv, [r2])
    assert r2.tokens == joracle(tree, p2, 6)
    assert srv._radix.host_hit_tokens > hh0, "restore path never exercised"
    srv._radix.check()
    srv._alloc.check()
    srv.close()


# --------------------------------------------------------- the gate audit


def test_retired_cp_gates_are_deleted_not_bypassed():
    """No ``raise NotImplementedError`` in the port's snapshot, extract,
    adopt, block streams or the per-shard probe."""
    for fn in (PipelineServer.snapshot, PipelineServer.extract, PipelineServer.adopt,
               PipelineServer._read_arena_blocks_dispatch, PipelineServer._write_arena_blocks,
               PipelineServer._cp_stream_check):
        for node in ast.walk(ast.parse(textwrap.dedent(inspect.getsource(fn)))):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                name = (exc.func.id if isinstance(exc, ast.Call)
                        and isinstance(exc.func, ast.Name) else getattr(exc, "id", ""))
                assert name != "NotImplementedError", fn.__qualname__


def test_remaining_cp_gates_keep_curated_wording(eng):
    """cp × tp and cp speculation keep the JAX wording, and the speculation
    gate fires typed."""
    src = inspect.getsource(tserver)
    assert "cp × tp serving" in src and "cp-aware speculation" in src
    with pytest.raises(NotImplementedError, match="cp-aware speculation"):
        serve(eng, cp=2, prefill_chunk=None, speculate=2)


@pytest.mark.parametrize("name", ["server_cp_stream_shards_total", "server_cp_shards",
                                  "server_cp_combine_seconds"])
def test_cp_metric_families_equal_jax(eng, name):
    """The three cp families carry the JAX name, kind, labels, buckets and
    help; a cp-2 server sets ``server_cp_shards`` and each of its decode
    dispatches observes ``server_cp_combine_seconds``."""
    assert jserver.CP_SHARDS is not None  # the JAX server module registers its families
    got, want = REGISTRY.get(name), jmetrics.REGISTRY.get(name)
    assert got is not None and want is not None
    assert (got.kind, got.label_names, got.buckets, got.help) == (
        want.kind, want.label_names, want.buckets, want.help)
    if name == "server_cp_stream_shards_total":
        assert got.labels(outcome="ok").value >= 0.0
        return
    hist = REGISTRY.get("server_cp_combine_seconds").labels()
    n0 = hist.count
    srv = serve(eng, cp=2)
    assert REGISTRY.get("server_cp_shards").labels().value == 2.0
    drive(srv, [srv.submit(prompt(90, 11), max_new_tokens=4)])
    assert hist.count > n0
    srv.close()
