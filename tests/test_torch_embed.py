"""Embedding input and token streaming in the port, against the JAX
package: ``Engine.embed_prompt`` equals the JAX engine's bit for bit
(tolerance: none; bf16 compared as its bits) for a raw llama table in f32
and bf16, an int8 row-quantized table, gemma's multiplier and GPT-2's
position embedding, from one JAX-written store. ``submit_embedding`` of
those states streams what ``submit`` of the ids does, on dense and paged
servers, as the JAX server's does; such a request survives a snapshot and
a migration. ``generate_stream`` yields the JAX ``generate_stream``'s
greedy tokens (f32, token-exact) and, sampled, the port's ``generate``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate_stream as jstream
from llm_sharding_tpu.utils import shard_store as jstore
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.generate import generate_stream as tstream
from llm_sharding_tpu_torch.runtime.server import PipelineServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


STORES = {
    "llama": (lambda: jcfg.tiny_llama(num_hidden_layers=2), "llama", False),
    "int8-head": (lambda: jcfg.tiny_llama(num_hidden_layers=2, tie_word_embeddings=False),
                  "llama", True),
    "gemma": (lambda: jcfg.tiny_gemma(num_hidden_layers=2), "llama", False),
    "gpt2": (lambda: jcfg.tiny_gpt2(num_hidden_layers=2), "gpt2", False),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    out = {}
    for name, (make, fam, quant) in STORES.items():
        cfg = make()
        mod = jgpt2 if fam == "gpt2" else jllama
        params = mod.init_params(cfg, jax.random.key(4), dtype=jnp.float32)
        if quant:
            params = jquant.quantize_params(params, quantize_head=True, bits=8)
        d = str(tmp_path_factory.mktemp(name))
        jstore.save_shards(cfg, params, d)
        out[name] = d
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return np.asarray(a.astype(np.float32)).view(np.uint32)  # bf16 widens exactly


@pytest.mark.parametrize("name,dtype", [
    ("llama", "f32"), ("llama", "bf16"), ("int8-head", "bf16"), ("gemma", "bf16"),
    ("gpt2", "f32"),
])
def test_embed_prompt_matches_jax_bit_for_bit(stores, name, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jeng = PipelineEngine.from_shards(stores[name], num_stages=1, dtype=jd, cache_dtype=jd)
    teng = Engine.from_shards(stores[name], dtype=td, device="cpu")
    ids = np.random.default_rng(2).integers(0, teng.cfg.vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(jeng.embed_prompt(ids))
    got = teng.embed_prompt(ids)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    if name == "gpt2":  # positions continue from ``start``
        tail = teng.embed_prompt(ids[:, 3:], start=3)
        assert torch.equal(tail, got[:, 3:])


@pytest.fixture(scope="module")
def engines(stores):
    jeng = PipelineEngine.from_shards(stores["llama"], num_stages=1, dtype=jnp.float32,
                                      cache_dtype=jnp.float32)
    teng = Engine.from_shards(stores["llama"], dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, teng.cfg.vocab_size, n).astype(np.int32) for n in (6, 11, 4)]
    return teng, jeng, prompts


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_submit_embedding_streams_equal_submit_and_jax(engines, paged):
    teng, jeng, prompts = engines
    kw = dict(capacity=64, batch_per_slot=2)
    if paged:
        kw.update(kv_block_size=4, kv_blocks=48)
    out = []
    for eng in (teng, jeng):
        srv = eng.serve(**kw)
        ids = [srv.submit(p, 9) for p in prompts]
        emb = [srv.submit_embedding(np.asarray(eng.embed_prompt(p))[0], 9) for p in prompts]
        srv.run_until_idle()
        out.append(([r.tokens for r in ids], [r.tokens for r in emb]))
        srv.close()
    (t_ids, t_emb), (j_ids, j_emb) = out
    assert t_emb == t_ids == j_ids == j_emb


def test_submit_embedding_validation_matches_jax(engines):
    teng, jeng, prompts = engines
    H = teng.cfg.hidden_size
    for bad in (np.zeros((2, 3, H), np.float32), np.zeros((3, H + 1), np.float32)):
        msgs = []
        for eng in (teng, jeng):
            with pytest.raises(ValueError) as info:
                eng.serve(capacity=64).submit_embedding(bad, 4)
            msgs.append(str(info.value))
        assert msgs[0].split(",")[0] == msgs[1].split(",")[0]


def test_embedding_request_snapshots_and_migrates(engines):
    """Snapshot with an embedding request in flight, restore, then migrate
    it from the restored dense server to a paged one: its stream equals
    the ids request's."""
    teng, _, prompts = engines
    p = prompts[1]
    ref = teng.serve(capacity=64)
    want = ref.result(ref.submit(p, 14))
    assert len(want) == 14  # runs its budget out, so it is in flight below
    srv = teng.serve(capacity=64, batch_per_slot=2)
    r = srv.submit_embedding(teng.embed_prompt(p)[0], 14, tenant="t1")
    for _ in range(3):
        srv.step()
    srv._drain(0)
    assert not r.done
    snap = srv.snapshot()
    srv2 = PipelineServer.restore(teng, snap)
    r2 = next(x for x in srv2._req if x is not None)
    assert r2.embeds is not None and r2.tenant == "t1" and r2.tokens == r.tokens
    srv2.step()
    st = srv2.extract(r2)
    assert st.embeds is not None and st.prompt.size == 0 and st.tenant == "t1"
    dst = teng.serve(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=48)
    dst.adopt(st, r2)
    dst.run_until_idle()
    assert r2.tokens == want


def test_generate_stream_matches_jax_and_generate(engines, stores):
    teng, _, prompts = engines
    cj, pj = jstore.load_full(stores["llama"], dtype=jnp.float32)
    for p in prompts:
        got = list(tstream(teng.cfg, teng.params, p, 12))
        want = list(jstream(cj, pj, p, 12, cache_dtype=jnp.float32))
        assert got == want
        res = teng.generate_ids(p, 12)
        assert got == res.tokens[0, len(p) : res.lengths[0]].tolist()
    kw = dict(temperature=0.8, top_k=30, top_p=0.9, seed=11)
    got = list(tstream(teng.cfg, teng.params, prompts[0], 10, **kw))
    res = tgenerate(teng.cfg, teng.params, prompts[0], 10, **kw)
    assert got == res.tokens[0, len(prompts[0]) : res.lengths[0]].tolist()
    with pytest.raises(ValueError, match="per-request"):
        list(tstream(teng.cfg, teng.params, np.zeros((2, 3), np.int32), 4))
