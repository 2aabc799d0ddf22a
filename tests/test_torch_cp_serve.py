"""Context-parallel serving of the port (``Engine.serve(cp=N)``) against the
JAX package's cp ``PipelineServer``: the contracts of
``tests/test_cp_serve.py`` at cp 2 and 4, each port stream held against
the JAX server's stream on the same requests (tiny_llama, 8 layers, f32,
2 stages; the port's shards all on the CPU device, the JAX grid over its
virtual CPU devices). Also the port's ``ShardedBlockAllocator`` against
the JAX one over mirrored op sequences, and the plain ``attn_stats`` over
round-robin-striped shard tables against ``attn_stats_xla``.

Tolerances: token streams exactly (0); allocator answers and states
exactly; ``attn_stats`` f32 triples to 2e-5 absolute (two einsum orders).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.runtime import blocks as jblocks
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.stack import CpShards
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.runtime import blocks as tblocks
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.server import NeverFits

torch.set_num_threads(1)

L = 8
CJ = jcfg.tiny_llama(num_hidden_layers=L, max_position_embeddings=512)
CFG = tcfg.tiny_llama(num_hidden_layers=L, max_position_embeddings=512)
BS = 8
CAP = 256
CHUNK = 16
STAGES = 2


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(11), dtype=jnp.float32))


@pytest.fixture(scope="module")
def jeng(tree):
    return PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=STAGES,
                          cache_dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


def engine(tparams, cp: int) -> Engine:
    """The port's 2-stage engine with room for a cp × stages grid."""
    return Engine(CFG, tparams, num_stages=STAGES, devices=["cpu"] * (STAGES * cp))


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
    return [list(r.tokens) for r in reqs]


def both(jeng, tparams, cp, run, **kw):
    """``run(srv)`` on the JAX cp server and the port's: both results."""
    js = serve(jeng, cp=cp, **kw)
    want = run(js)
    js.close()
    ts = serve(engine(tparams, cp), cp=cp, **kw)
    got = run(ts)
    ts._alloc.check()
    if ts._radix is not None:
        ts._radix.check()
    ts.close()
    return got, want


def joracle(tree, p, n):
    res = jgenerate(CJ, jax.tree.map(jnp.asarray, tree), p, n, cache_dtype=jnp.float32)
    return [int(x) for x in res.tokens[0, len(p) : int(res.lengths[0])]]


# ----------------------------------------------------------- token identity


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_cp_token_identity_plain_and_chunked(jeng, tparams, cp):
    """One-shot admission (8 tokens), chunked admission over block seams
    (56 tokens, 4 chunks) and a mid-block prompt end (23): the port's
    streams at cp 1 / 2 / 4 equal the JAX cp server's, on a (cp, pipe)
    grid with the sharded allocator."""
    ps = [prompt(7, 56), prompt(8, 23), prompt(9, 8)]

    def run(srv):
        if cp > 1 and isinstance(srv.engine, Engine):
            assert srv.mesh.shape == {"cp": cp, "pipe": STAGES}
            assert isinstance(srv._alloc, tblocks.ShardedBlockAllocator)
            assert isinstance(srv.state.arenas[0].k, CpShards)
            assert tuple(srv.state.block_tables.shape) == (cp, srv.rows, CAP // BS)
        return drive(srv, [srv.submit(p, max_new_tokens=6) for p in ps])

    got, want = both(jeng, tparams, cp, run)
    assert got == want and all(len(t) == 6 or t[-1] in CFG.eos_token_ids for t in got)


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_radix_hit_admits_chunked_token_identical(jeng, tparams, cp):
    """A radix hit at cp > 1 goes down the chunked path (its blocks live
    on their owner shards) and still counts as a hit of the whole shared
    prefix; the streams equal the JAX server's."""
    shared = prompt(21, 4 * BS)
    p1 = np.concatenate([shared, prompt(22, 9)])
    p2 = np.concatenate([shared, prompt(23, 12)])  # short suffix: chunked anyway

    def run(srv):
        out = drive(srv, [srv.submit(p1, max_new_tokens=6)])
        hit0 = srv._radix.hit_tokens
        chunked = []
        if isinstance(srv.engine, Engine):
            orig = srv._admit_chunked

            def spy(rows, prompts, plen, *a, **kw):
                chunked.append(kw.get("prefix_off", 0))
                return orig(rows, prompts, plen, *a, **kw)

            srv._admit_chunked = spy
        out += drive(srv, [srv.submit(p2, max_new_tokens=6)])
        assert srv._radix.hit_tokens - hit0 == 4 * BS, "radix hit under cp fell back cold"
        if isinstance(srv.engine, Engine):
            assert chunked == [4 * BS]
        return out

    got, want = both(jeng, tparams, cp, run, prefix_cache="hbm")
    assert got == want


def test_cp_sampled_token_identity(tparams):
    """A seeded sampled row at cp 2 draws the port's cp-1 server's tokens
    and ``generate``'s (the port's generator is not JAX's: its draws are
    held against the port's own)."""
    kw = dict(temperature=0.7, seed=123, top_k=20)
    p = prompt(33, 40)
    streams = []
    for cp in (1, 2):
        srv = serve(engine(tparams, cp), cp=cp)
        streams += drive(srv, [srv.submit(p, max_new_tokens=8, **kw)])
        srv.close()
    res = tgenerate(CFG, tparams, p, 8, **kw)
    assert streams[0] == streams[1] == res.tokens[0, len(p) : int(res.lengths[0])].tolist()


# ------------------------------------------------- allocator chaos + audits


def test_cp_allocator_clean_after_cancel_and_deadline(tree, tparams):
    """A cancel mid-decode and a deadline shed return every private block to
    its owner shard's free list; the survivor's stream is the JAX
    oracle's."""
    srv = serve(engine(tparams, 2), cp=2)
    live = srv.submit(prompt(41, 30), max_new_tokens=12)
    doomed = srv.submit(prompt(42, 56), max_new_tokens=64)
    while not doomed.tokens:
        srv.step()
    assert srv.cancel(doomed)
    shed = srv.submit(prompt(43, 24), max_new_tokens=8, deadline_s=1e-6)
    drive(srv, [live])
    assert live.tokens == joracle(tree, prompt(41, 30), 12)
    assert shed.done and shed.error is not None
    assert srv._alloc.in_use == 0
    srv._alloc.check()
    srv.close()


def test_cp1_serves_the_unsharded_layout(tparams):
    """cp 1 is the server of earlier slices: one arena tensor per stage,
    ``[M, T]`` tables, the plain allocator, and no grid."""
    srv = serve(engine(tparams, 1), cp=1)
    assert srv.mesh is None and type(srv._alloc) is tblocks.BlockAllocator
    assert isinstance(srv.state.arenas[0].k, torch.Tensor) and srv.state.cp == 1
    assert tuple(srv.state.block_tables.shape) == (srv.rows, CAP // BS)
    srv.close()


# --------------------------------------------- the point: admissible length


def test_cp2_admits_prompt_exceeding_one_shard_arena(jeng, tparams):
    """At equal per-shard arena a prompt whose KV exceeds one shard's pool
    never fits at cp 1 and admits at cp 2, its blocks on both shards, with
    the JAX cp-2 server's stream."""
    per_shard = 11  # 10 usable blocks per shard = 80 slots at BS 8
    blocks = dict(kv_blocks=per_shard, kv_block_size=BS)
    p = prompt(61, 12 * BS + 4)
    srv1 = serve(engine(tparams, 1), cp=1, **blocks)
    with pytest.raises(NeverFits, match="KV blocks"):
        srv1.submit(p, max_new_tokens=4)
    srv1.close()

    def run(srv):
        assert srv._alloc.capacity_blocks == 2 * (per_shard - 1)
        r = srv.submit(p, max_new_tokens=4)
        while not r.tokens:
            srv.step()
        used = {srv._alloc.owner(g) for row in srv._row_blocks for g in row}
        assert used == {0, 1}
        return drive(srv, [r])

    got, want = both(jeng, tparams, 2, run, **blocks)
    assert got == want


# ------------------------------------------------------------ curated gates


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


def test_cp_unsupported_combinations_are_typed(jeng, tparams, tree):
    """What cp serving refuses, with the JAX server's exception types and
    words: dense, speculation, a prefix cache without ``prefill_chunk``, an
    explicit prefix handle, tensor parallelism (the engine's refusal) and
    a model outside the llama family."""
    teng = engine(tparams, 2)
    cases = [
        (lambda e: e.serve(capacity=CAP, cp=2), "paged"),
        (lambda e: serve(e, cp=2, prefill_chunk=None, speculate=2), "speculate"),
        (lambda e: serve(e, cp=2, prefill_chunk=None, prefix_cache="hbm"), "prefill_chunk"),
    ]
    for fn, word in cases:
        t, j = _refusal(lambda: fn(teng)), _refusal(lambda: fn(jeng))
        assert t == j and word in t[1]
    srvs = [serve(teng, cp=2), serve(jeng, cp=2)]
    t, j = (_refusal(lambda s=s: s.prefill_prefix(prompt(71, 2 * BS))) for s in srvs)
    assert t == j and "prefill_prefix" in t[1] and t[0] is NotImplementedError
    for s in srvs:
        s.close()
    tp_eng = Engine(CFG, tparams, num_stages=1, devices=["cpu"] * 2, tensor_parallel=2)
    jtp = PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=1, tensor_parallel=2,
                         devices=jax.devices()[:2], cache_dtype=jnp.float32)
    t, j = (_refusal(lambda e=e: serve(e, cp=2)) for e in (tp_eng, jtp))
    assert t == j and t[0] is NotImplementedError
    from llm_sharding_tpu_torch.models import gpt2 as tgpt2

    g2 = tcfg.tiny_gpt2(num_hidden_layers=2)
    geng = Engine(g2, tgpt2.init_params(g2, seed=0, device="cpu"), num_stages=1,
                  devices=["cpu"] * 2)
    kind, msg = _refusal(lambda: serve(geng, cp=2))
    assert kind is NotImplementedError and "llama family" in msg


# ------------------------------------------------- the allocator, mirrored


OPS = st.lists(st.tuples(st.sampled_from(["alloc", "alloc_at", "free", "share", "cache"]),
                         st.integers(0, 7), st.integers(0, 40)), min_size=1, max_size=60)


@settings(max_examples=40, deadline=None)
@given(shards=st.sampled_from([2, 3, 4]), per=st.integers(2, 9), ops=OPS)
def test_sharded_allocator_equals_jax(shards, per, ops):
    """Mirrored op sequences on the port's and the JAX
    ``ShardedBlockAllocator``: the same blocks handed out, the same
    refusals, the same owners, free counts and per-shard lists after every
    op, and both audits pass."""
    t = tblocks.ShardedBlockAllocator(shards, per, 4)
    j = jblocks.ShardedBlockAllocator(shards, per, 4)
    held: list = []
    for op, n, col in ops:
        if op in ("alloc", "alloc_at"):
            args = (n,) if op == "alloc" else (col, n)
            outs = []
            for a in (t, j):
                try:
                    outs.append(getattr(a, op)(*args))
                except Exception as e:  # noqa: BLE001 — compared below
                    outs.append((type(e).__name__, str(e)))
            assert outs[0] == outs[1]
            if isinstance(outs[0], list):
                held += outs[0]
        elif held:
            b = held[n % len(held)]
            if op == "free":  # the tree unmarks a block it releases
                for a in (t, j):
                    a.unmark_cached([b])
                    a.free([b])
                held.remove(b)
            elif op == "share":
                t.share([b])
                j.share([b])
                held.append(b)
            else:
                t.mark_cached([b])
                j.mark_cached([b])
        assert t.num_free == j.num_free and t.in_use == j.in_use
        assert t._shard_free == j._shard_free and t._free == j._free
        assert [t.owner(b) for b in held] == [j.owner(b) for b in held]
        assert t.owner_shards(held) == j.owner_shards(held)
    t.check()
    j.check()
    assert t.capacity_blocks == j.capacity_blocks == shards * (per - 1)


def test_sharded_allocator_refusals_equal_jax():
    for args in ((0, 4, 4), (2, 1, 4)):
        t = _refusal(lambda: tblocks.ShardedBlockAllocator(*args))
        j = _refusal(lambda: jblocks.ShardedBlockAllocator(*args))
        assert t == j
    t, j = tblocks.ShardedBlockAllocator(2, 4, 4), jblocks.ShardedBlockAllocator(2, 4, 4)
    for a in (t, j):
        a.alloc_at(0, 6)
    for fn in (lambda a: a.free([4]), lambda a: a.share([0]), lambda a: a.alloc(1),
               lambda a: a.mark_cached([4])):
        assert _refusal_any(lambda: fn(t)) == _refusal_any(lambda: fn(j))


def _refusal_any(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------ attention stats, striped


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("S", [1, 5])
def test_attn_stats_on_striped_tables_equals_jax(cp, S):
    """Each shard's plane of a round-robin-striped table (a one-block row
    sees no key on the later shards) through the plain ``attn_stats`` and
    JAX ``attn_stats_xla``: the same triples, dead rows exactly ``(0,
    -1e30, 0)``; the merged shards equal attention over the whole window."""
    rng = np.random.default_rng(80 + cp * 10 + S)
    Nkv, G, D = 2, 3, 16
    frontiers = (S, 3 * BS + 2, 9 * BS, 2 * BS)
    B, T = len(frontiers), 10
    NBs = -(-B * T // cp) + 2
    k = rng.standard_normal((cp * NBs, BS, Nkv, D)).astype(np.float32)
    v = rng.standard_normal((cp * NBs, BS, Nkv, D)).astype(np.float32)
    nxt = [1] * cp
    gtbl = np.zeros((B, T), np.int32)
    kvpos = np.full((B, T * BS), 2**30, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, f in enumerate(frontiers):
        for j in range(-(-f // BS)):
            s = j % cp
            gtbl[b, j] = s * NBs + nxt[s]
            nxt[s] += 1
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - S, f)
    q = rng.standard_normal((B, S, Nkv * G, D)).astype(np.float32)
    parts = []
    dead = 0
    for s in range(cp):
        local = np.where(gtbl // NBs == s, gtbl % NBs, 0).astype(np.int32)
        ka, va = k[s * NBs : (s + 1) * NBs], v[s * NBs : (s + 1) * NBs]
        got = tpa.attn_stats(*(torch.from_numpy(x) for x in (q, ka, va, local, qpos, kvpos)))
        want = jpa.attn_stats_xla(*(jnp.asarray(x) for x in (q, ka, va, local, qpos, kvpos)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)
        dz = got[2] == 0
        dead += int(dz.sum())
        assert (got[1][dz] == -1e30).all() and (got[0][dz] == 0).all()
        parts.append(got)
    assert dead > 0
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    merged = tpa.combine_attn_stats(acc, m, l)
    whole = tpa.paged_attention_xla(*(torch.from_numpy(x) for x in (q, k, v, gtbl, qpos, kvpos)))
    torch.testing.assert_close(merged, whole, atol=2e-5, rtol=0)
