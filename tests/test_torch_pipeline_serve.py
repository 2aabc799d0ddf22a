"""The port's continuous-batching server through pipeline stages against the
JAX ``PipelineServer`` at the same placement: the port's stages all on the
CPU device, the JAX chain over its CPU mesh, one seeded numpy tree
(tiny_llama, 4 layers, f32) fed to both. A server runs ``num_stages ×
batch_per_slot`` rows on both sides.

Held equal, exactly (tolerance 0): the greedy streams of staggered
requests at 2 stages and at a ragged 3 (``0:1,1:3,3:4``), in the f32
arena ("bf16": the engine's own dtype) and the int8 arena, one-shot and
chunked, a radix-cache hit and ``speculate=2``; a snapshot restored onto a
2-stage engine continues as the uninterrupted run, and one restored onto a
1-stage engine is refused; a request extracted from a 2-stage server and
adopted by a 1-stage one (and back) streams on unchanged; a
``ReplicatedServer`` of two 2-stage replicas serves the JAX fleet's
streams. A seeded sampled row (whose random numbers differ from JAX's)
equals the port's one-stage server's stream.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.parallel.placement import PlacementSpec as JSpec
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.replicated import ReplicatedServer as JReplicated
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.parallel.placement import PlacementSpec
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer
from llm_sharding_tpu_torch.runtime.server import PipelineServer

torch.set_num_threads(1)

L = 4
CJ = jcfg.tiny_llama(num_hidden_layers=L)
CFG = tcfg.tiny_llama(num_hidden_layers=L)
PLACES = {"2": ((0, 2), (2, 4)), "ragged3": ((0, 1), (1, 3), (3, 4))}
LENS = (5, 11, 3, 17, 8)
MAX_NEW = (9, 6, 12, 7, 10)
PAGED = dict(capacity=64, kv_block_size=4, kv_blocks=64)
# (placement, arena, serve options): the JAX run of each is computed once
CASES = {
    "2-bf16-oneshot": ("2", "bf16", {}),
    "2-bf16-chunked": ("2", "bf16", dict(prefill_chunk=4)),
    "2-int8-oneshot": ("2", "int8", {}),
    "2-int8-chunked": ("2", "int8", dict(prefill_chunk=4)),
    "2-bf16-spec": ("2", "bf16", dict(speculate=2)),
    "ragged3-bf16-oneshot": ("ragged3", "bf16", {}),
    "ragged3-int8-chunked": ("ragged3", "int8", dict(prefill_chunk=4)),
}


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(21), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(8)
    return [rng.integers(3, CFG.vocab_size, n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def tengines(tparams):
    return {name: Engine(CFG, tparams, placement=PlacementSpec(st, L), devices=["cpu"] * L)
            for name, st in PLACES.items()}


@pytest.fixture(scope="module")
def jengines(tree):
    full = jax.tree.map(jnp.asarray, tree)
    return {name: PipelineEngine(CJ, full, placement=JSpec(st, L),
                                 devices=jax.devices()[: len(st)], cache_dtype=jnp.float32)
            for name, st in PLACES.items()}


def staggered(srv, prompts) -> list:
    """Two requests, two steps, three more joining mid-decode."""
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(jengines, prompts):
    out = {}
    for case, (place, kv, kw) in CASES.items():
        srv = jengines[place].serve(batch_per_slot=1, kv_dtype=kv, paged_attn="xla",
                                    **PAGED, **kw)
        out[case] = staggered(srv, prompts)
        srv.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_served_streams_equal_jax(tengines, jax_streams, prompts, case):
    place, kv, kw = CASES[case]
    eng = tengines[place]
    srv = eng.serve(batch_per_slot=1, kv_dtype=kv, **PAGED, **kw)
    assert srv.num_stages == len(PLACES[place]) and srv.rows == srv.num_stages
    assert [a.k.shape[0] for a in srv.state.arenas] == [b - a for a, b in PLACES[place]]
    got = staggered(srv, prompts)
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    assert got == jax_streams[case]


def test_radix_hit_and_dense_equal_jax(tengines, jengines, prompts):
    """A second request sharing two blocks of the first one's prompt hits
    the tree (its suffix prefills from column 8 through every stage); and
    the dense server at 2 stages."""
    shared = np.concatenate([prompts[3][:8], prompts[1][:5]]).astype(np.int32)
    outs = []
    for eng, extra in ((jengines["2"], dict(paged_attn="xla")), (tengines["2"], {})):
        srv = eng.serve(batch_per_slot=2, prefix_cache="hbm", **PAGED, **extra)
        a = srv.submit(prompts[3], 6)
        srv.run_until_idle()
        b = srv.submit(shared, 7)
        srv.run_until_idle()
        outs.append((list(a.tokens), list(b.tokens), srv.prefix_cache_stats()["hit_tokens"]))
        dense = eng.serve(batch_per_slot=2, capacity=64)
        outs.append(staggered(dense, prompts))
        srv.close()
        dense.close()
    assert outs[2] == outs[0] and outs[2][2] == 8
    assert outs[3] == outs[1]


def test_snapshot_restore_and_stage_refusal(tengines, tparams, prompts):
    """Mid-decode snapshot of a 2-stage int8 server: restored onto the
    2-stage engine every stream ends as the uninterrupted run's; a 1-stage
    engine refuses it."""
    eng = tengines["2"]
    kw = dict(batch_per_slot=2, kv_dtype="int8", **PAGED)
    base = staggered(eng.serve(**kw), prompts)
    srv = eng.serve(**kw)
    reqs = [srv.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    for _ in range(3):
        srv.step()
    assert any(not r.done for r in reqs)
    snap = srv.snapshot()
    assert snap["num_stages"] == 2
    with pytest.raises(ValueError, match="snapshot was taken over 2 stage"):
        PipelineServer.restore(Engine(CFG, tparams), snap)
    srv2 = PipelineServer.restore(eng, snap)
    revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    srv2.run_until_idle()
    for i, r in enumerate(reqs):
        assert list(revived.get(r.id, r).tokens) == base[i]
    srv.close()
    srv2.close()


def test_extract_adopt_between_two_and_one_stage(tengines, tparams, prompts):
    """Live rows move from a 2-stage server to a 1-stage one, one moves
    back; every stream ends as the uninterrupted one-stage run's."""
    one = Engine(CFG, tparams)
    want = staggered(one.serve(batch_per_slot=2, **PAGED), prompts)
    two = tengines["2"].serve(batch_per_slot=1, **PAGED)
    single = one.serve(batch_per_slot=2, **PAGED)
    reqs = [two.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    for _ in range(3):
        two.step()
    moving = [r for r in reqs if r.row is not None and not r.done]
    assert moving
    for r in moving:
        single.adopt(two.extract(r), r)
    single.step()
    for r in [r for r in moving if not r.done][:1]:  # and back onto the 2-stage server
        two.adopt(single.extract(r), r)
    two.run_until_idle()
    single.run_until_idle()
    assert [list(r.tokens) for r in reqs] == want
    two.close()
    single.close()


def test_replicated_two_stage_replicas_equal_jax(tree, tparams, prompts):
    t = ReplicatedServer(CFG, tparams, data_parallel=2, num_stages=2, devices=["cpu"] * 4,
                         batch_per_slot=1, **PAGED)
    j = JReplicated(CJ, jax.tree.map(jnp.asarray, tree), data_parallel=2, num_stages=2,
                    devices=jax.devices()[:4], cache_dtype=jnp.float32, batch_per_slot=1,
                    paged_attn="xla", **PAGED)
    try:
        outs = []
        for srv in (t, j):
            reqs = [srv.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
            srv.run_until_idle()
            outs.append([list(r.tokens) for r in reqs])
        assert outs[0] == outs[1]
        assert [e.num_stages for e in t.engines] == [2, 2]
    finally:
        t.close()
        j.close()


def test_seeded_rows_equal_the_one_stage_stream(tengines, tparams, prompts):
    """Sampled rows at 2 and 3 stages (their logits gathered onto the first
    stage) draw what the one-stage server draws, greedy rows beside them."""
    def run(eng):
        srv = eng.serve(batch_per_slot=2, **PAGED)
        reqs = [srv.submit(p, n, temperature=t, seed=s, top_k=k)
                for p, n, t, s, k in zip(prompts, MAX_NEW, (0.8, 0.0, 1.2, 0.7, 0.0),
                                         (1, 0, 2, 3, 0), (0, 0, 5, 0, 0))]
        srv.run_until_idle()
        return [list(r.tokens) for r in reqs]

    want = run(Engine(CFG, tparams))
    assert run(tengines["2"]) == want
    assert run(tengines["ragged3"]) == want
