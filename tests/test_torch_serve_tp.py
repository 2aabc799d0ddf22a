"""The port's continuous-batching server over tensor-parallel stages,
mirroring ``tests/test_serve_tp.py``: the port's pp2×tp2 engine (stages
and shards all on the CPU) against the JAX ``PipelineServer`` on a pp2×tp2
engine over four devices of its CPU mesh (``tests/conftest.py``), one
seeded numpy tree (tiny_llama, 4 layers, f32) fed to both.

Held equal exactly (tolerance 0): the greedy streams of staggered requests
(one joining mid-decode), dense and paged, one-shot and chunked, and of a
prefix handle, against the JAX pp×tp server's; a radix hit, ``speculate=3``
and two pp2×tp2 replicas behind ``ReplicatedServer`` against the JAX
monolith's ``generate`` (the oracle the JAX tests hold them to). A seeded
sampled row equals the port's own ``generate(seed=)``. A snapshot restored
onto the pp2×tp2 engine continues as the uninterrupted run, one restored
onto a tp-1 engine is refused; a request extracted from the tp-2 server
and adopted by a tp-1 one (and back) streams on unchanged. The refusals
(GPT-2 under tp, quantized KV under tp, cp under tp) raise the JAX
classes and words.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models.stack import HeadShards
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer
from llm_sharding_tpu_torch.runtime.server import PipelineServer
from llm_sharding_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

L = 4
CJ = jcfg.tiny_llama(num_hidden_layers=L)
CFG = tcfg.tiny_llama(num_hidden_layers=L)
PAGED = dict(kv_block_size=4, kv_blocks=96)
LENS = (5, 3, 6, 40)
MAX_NEW = (12, 10, 8, 6)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(9), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return params_from_numpy(CFG, tree, device="cpu")


@pytest.fixture(scope="module")
def eng(tparams):
    return Engine(CFG, tparams, num_stages=2, tensor_parallel=2, devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def jeng(tree):
    return PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=2, tensor_parallel=2,
                          devices=jax.devices()[:4], cache_dtype=jnp.float32)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(31)
    return [rng.integers(1, CFG.vocab_size, n).astype(np.int32) for n in LENS]


def oracle(tree, p, n, **kw):
    res = jgenerate(CJ, jax.tree.map(jnp.asarray, tree), p, n, cache_dtype=jnp.float32, **kw)
    return list(res.tokens[0, len(p): int(res.lengths[0])])


def staggered(srv, prompts, sampled=False) -> list:
    """Two requests (the second sampled when asked), three steps, the rest
    joining mid-decode."""
    kw = dict(temperature=0.9, seed=4) if sampled else {}
    reqs = [srv.submit(prompts[0], MAX_NEW[0]), srv.submit(prompts[1], MAX_NEW[1], **kw)]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3)]
    srv.run_until_idle()
    return [list(r.tokens) for r in reqs]


CASES = {
    "dense": dict(capacity=128),
    "paged-oneshot": dict(capacity=128, **PAGED),
    "paged-chunked": dict(capacity=128, prefill_chunk=16, **PAGED),
}


@pytest.fixture(scope="module")
def jax_streams(jeng, prompts):
    out = {}
    for case, kw in CASES.items():
        extra = dict(paged_attn="xla") if "kv_block_size" in kw else {}
        srv = jeng.serve(**kw, **extra)
        out[case] = staggered(srv, prompts)
        srv.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_serve_tp_token_exact(eng, jax_streams, prompts, case):
    """pp2×tp2: staggered greedy requests (one chunked where the case
    chunks) equal the JAX pp×tp server's streams; every stage's KV is two
    shards of one head each."""
    srv = eng.serve(**CASES[case])
    assert srv.tp == 2 and all(isinstance(a.k, HeadShards) for a in srv.state.arenas)
    assert [tuple(p.shape[-2:]) for p in srv.state.arenas[0].k.parts] == [(1, CFG.head_dim_)] * 2
    assert staggered(srv, prompts) == jax_streams[case]
    if srv._alloc is not None:
        srv._alloc.check()
        assert srv._alloc.in_use == 0
    srv.close()


def test_serve_tp_sampled_row_equals_generate(eng, tparams, prompts):
    """A seeded sampled row among greedy ones draws what the port's
    one-device ``generate(seed=)`` draws."""
    srv = eng.serve(capacity=128, **PAGED)
    got = staggered(srv, prompts, sampled=True)
    res = tgenerate(CFG, tparams, prompts[1][None], MAX_NEW[1], temperature=0.9, seed=4)
    assert got[1] == list(res.tokens[0, LENS[1]: int(res.lengths[0])])
    srv.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_tp_prefix_cache(eng, jeng, tree, paged):
    """A prefix handle's KV is joined by head from the shards' caches and
    split again into the rows': the suffix streams equal the JAX pp×tp
    server's."""
    rng = np.random.default_rng(33)
    prefix = rng.integers(1, CFG.vocab_size, 12).astype(np.int32)
    sfx = rng.integers(1, CFG.vocab_size, 5).astype(np.int32)
    kw = dict(capacity=128, **(PAGED if paged else {}))
    outs = []
    for e, extra in ((jeng, dict(paged_attn="xla") if paged else {}), (eng, {})):
        srv = e.serve(**kw, **extra)
        h = srv.prefill_prefix(prefix)
        r = srv.submit(sfx, max_new_tokens=9, prefix=h)
        srv.run_until_idle()
        outs.append(list(r.tokens))
        srv.close()
    assert outs[1] == outs[0] == oracle(tree, np.concatenate([prefix, sfx]), 9)


def test_serve_tp_radix_hit(eng, tree, prompts):
    """A radix-cache hit under tp: the suffix prefills over the shards'
    arenas; after a demotion the host tier's copy (joined by head) is
    split again into the shards on the next hit."""
    srv = eng.serve(capacity=128, prefix_cache="host", **PAGED)
    a = srv.submit(prompts[3], 5)
    srv.run_until_idle()
    shared = np.concatenate([prompts[3][:24], prompts[0]]).astype(np.int32)
    b = srv.submit(shared, 7)
    srv.run_until_idle()
    assert srv.prefix_cache_stats()["hit_tokens"] == 24
    srv._radix.demote_all()
    c = srv.submit(shared, 7)
    srv.run_until_idle()
    assert srv.prefix_cache_stats()["host_hit_tokens"] > 0
    assert list(a.tokens) == oracle(tree, prompts[3], 5)
    assert list(b.tokens) == list(c.tokens) == oracle(tree, shared, 7)
    srv._alloc.check()
    srv._radix.check()
    srv.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_tp_speculative(eng, tree, paged):
    """``speculate=3`` under tp: the verify runs the sharded stages and the
    greedy argmax over the vocab-sharded head; two concurrent rows equal
    the monolith."""
    srv = eng.serve(capacity=64, speculate=3, **(PAGED if paged else {}))
    rng = np.random.default_rng(39)
    pa = rng.integers(1, CFG.vocab_size, 5).astype(np.int32)
    pb = rng.integers(1, CFG.vocab_size, 4).astype(np.int32)
    ra = srv.submit(pa, max_new_tokens=12)
    rb = srv.submit(pb, max_new_tokens=9)
    srv.run_until_idle()
    assert ra.tokens == oracle(tree, pa, 12)
    assert rb.tokens == oracle(tree, pb, 9)
    srv.close()


def test_replicated_tp_serve_token_exact():
    """dp2 × (pp2×tp2) over 8 listed devices: ReplicatedServer forwards
    tensor_parallel; requests land on both replicas, all token-exact."""
    tree = jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(15), dtype=jnp.float32))
    srv = ReplicatedServer(CFG, params_from_numpy(CFG, tree, device="cpu"), data_parallel=2,
                           num_stages=2, tensor_parallel=2, devices=["cpu"] * 8, capacity=64)
    try:
        assert all(e.tensor_parallel == 2 and e.num_stages == 2 for e in srv.engines)
        rng = np.random.default_rng(37)
        prompts = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(3, 7, 4)]
        reqs = [srv.submit(p, 8) for p in prompts]
        srv.run_until_idle()
        for r, p in zip(reqs, prompts):
            assert r.tokens == oracle(tree, p, 8), f"req {r.id}"
        assert all(s.counters.requests_completed > 0 for s in srv.servers)
    finally:
        srv.close()


def test_serve_tp_gpt2_rejected():
    cj, ct = jcfg.tiny_gpt2(), tcfg.tiny_gpt2()
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cj, jax.random.key(0), dtype=jnp.float32))
    teng = Engine(ct, params_from_numpy(ct, tree, device="cpu"), num_stages=2,
                  tensor_parallel=2, devices=["cpu"] * 4)
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=2, tensor_parallel=2,
                          devices=jax.devices()[:4], cache_dtype=jnp.float32)
    with pytest.raises(NotImplementedError) as te:
        teng.serve(capacity=32)
    with pytest.raises(NotImplementedError) as je:
        jeng.serve(capacity=32)
    assert str(te.value) == str(je.value) and "serve×tp" in str(te.value)


def test_serve_tp_quantized_kv_rejected(eng, jeng):
    for kv in ("int8", "fp8"):
        with pytest.raises(NotImplementedError) as te:
            eng.serve(capacity=64, kv_dtype=kv, **PAGED)
        with pytest.raises(NotImplementedError) as je:
            jeng.serve(capacity=64, kv_dtype=kv, **PAGED)
        assert str(te.value) == str(je.value)
    # context-parallel serving on a tensor-parallel engine: JAX's refusal
    with pytest.raises(NotImplementedError) as te:
        eng.serve(capacity=64, cp=2, **PAGED)
    with pytest.raises(NotImplementedError) as je:
        jeng.serve(capacity=64, cp=2, **PAGED)
    assert str(te.value) == str(je.value) and "serve×cp×tp" in str(te.value)


def test_snapshot_restore_and_tp_refusal(eng, tparams, prompts):
    """A mid-decode snapshot of the pp2×tp2 paged server restored onto the
    same engine finishes as the uninterrupted run; a dense one too; an
    engine of another tensor degree refuses either."""
    want = [oracle_port(tparams, p, n) for p, n in zip(prompts, MAX_NEW)]
    for kw in (dict(capacity=128, **PAGED), dict(capacity=128)):
        srv = eng.serve(**kw)
        reqs = [srv.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
        for _ in range(3):
            srv.step()
        assert any(not r.done for r in reqs)
        snap = srv.snapshot()
        assert snap["tensor_parallel"] == 2
        other = Engine(CFG, tparams, num_stages=2, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="tensor_parallel=2, engine runs 1"):
            PipelineServer.restore(other, snap)
        srv2 = PipelineServer.restore(eng, snap)
        revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
        srv2.run_until_idle()
        assert [list(revived.get(r.id, r).tokens) for r in reqs] == want
        srv.close()
        srv2.close()


def oracle_port(tparams, p, n):
    res = tgenerate(CFG, tparams, p[None], n)
    return list(res.tokens[0, len(p): int(res.lengths[0])])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_extract_adopt_between_tp2_and_tp1(eng, tparams, prompts, paged):
    """Live rows move from the tp-2 server to a tp-1 one (the KV joined by
    head on the host), one moves back (split again); every stream ends as
    the uninterrupted run's."""
    kw = dict(capacity=128, batch_per_slot=2, **(PAGED if paged else {}))
    one = Engine(CFG, tparams, num_stages=2, devices=["cpu"] * 2)
    two = eng.serve(**kw)
    single = one.serve(**kw)
    reqs = [two.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    for _ in range(3):
        two.step()
    moving = [r for r in reqs if r.row is not None and not r.done]
    assert moving
    for r in moving:
        single.adopt(two.extract(r), r)
    single.step()
    back = [r for r in moving if not r.done][:1]
    assert back
    for r in back:
        two.adopt(single.extract(r), r)
    two.run_until_idle()
    single.run_until_idle()
    assert [list(r.tokens) for r in reqs] == [oracle_port(tparams, p, n)
                                              for p, n in zip(prompts, MAX_NEW)]
    two.close()
    single.close()
