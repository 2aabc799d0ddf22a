"""The port's context parallelism (``ops/ring_attention.py``,
``parallel/context.py``) and segmented decode (``runtime/generate.py``:
the capacity ladder, ``decode_from_cache``) against the JAX package on the
CPU: the port's chunks all on the CPU device, the JAX ring over a "seq"
axis of its 8-device CPU mesh (``tests/conftest.py``), one seeded numpy
tree fed to both (tiny_llama and tiny GPT-2, f32).

Tolerances: ``ring_attention`` agrees with JAX's under ``shard_map`` within
2e-6 absolute (both f32 einsums; their summation orders differ), padded
queries included, and a query that sees no key is exactly zero on both;
``context_prefill`` logits (last token and ``full_logits``) and
``context_prefill_cache``'s K/V within 1e-5; the cache's positions and
length exactly. Exact (tolerance 0): greedy tokens of ``context_generate``
at cp 2 and 4 (llama, GPT-2) and of ``decode_from_cache`` against JAX's;
``_segment_capacities`` over a grid; the port's segmented ``generate`` at
capacity 1024 and 4096 against JAX's. A sampled ``context_generate`` and
``decode_from_cache`` equal the port's own ``generate(seed=)``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from jax.sharding import PartitionSpec as P

from llm_sharding_tpu._compat import shard_map
from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import POS_SENTINEL
from llm_sharding_tpu.ops.ring_attention import ring_attention as jring
from llm_sharding_tpu.parallel import context as jctx
from llm_sharding_tpu.parallel.mesh import SEQ_AXIS
from llm_sharding_tpu.runtime import generate as jgen
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.ops.ring_attention import ring_attention
from llm_sharding_tpu_torch.parallel import context as tctx
from llm_sharding_tpu_torch.runtime import generate as tgen
from llm_sharding_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FAMILIES = {"llama": (jcfg.tiny_llama, tcfg.tiny_llama, jllama),
            "gpt2": (jcfg.tiny_gpt2, tcfg.tiny_gpt2, jgpt2)}


def _model(family, L=3, **kw):
    jc, tc, mod = FAMILIES[family]
    cj, ct = jc(num_hidden_layers=L, **kw), tc(num_hidden_layers=L, **kw)
    tree = jax.tree.map(np.asarray, mod.init_params(cj, jax.random.key(3), dtype=jnp.float32))
    return cj, ct, tree, params_from_numpy(ct, tree, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {f: _model(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    p = rng.integers(1, 256, (2, 16)).astype(np.int32)
    plen = np.array([16, 11], np.int32)
    return np.where(np.arange(16)[None] < plen[:, None], p, 0), plen


# ---------------------------------------------------------------- ring


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_equals_jax(n):
    """GQA (4 query heads over 2 KV heads), a padded tail at the sentinel,
    and a query that sees no key: its row is zero on both packages."""
    B, S, Nh, Nkv, D = 2, 16, 4, 2, 8
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (Nh, Nkv, Nkv))
    idx = np.arange(S, dtype=np.int32)
    qpos = np.stack([np.where(idx < 12, idx, POS_SENTINEL), idx]).astype(np.int32)
    kvpos = np.stack([np.where(idx < 12, idx, POS_SENTINEL), idx + 1]).astype(np.int32)
    # row 1, query 0 sees no key: its keys start at position 1
    mesh = jctx.context_mesh(n)
    want = np.asarray(jax.jit(shard_map(
        lambda q, k, v, qp, kp: jring(q, k, v, qp, kp, SEQ_AXIS), mesh=mesh,
        in_specs=(P(None, SEQ_AXIS),) * 5, out_specs=P(None, SEQ_AXIS), check_vma=False,
    ))(q, k, v, qpos, kvpos))
    s = S // n

    def chunks(a):
        return [torch.from_numpy(np.ascontiguousarray(a[:, i * s : (i + 1) * s]))
                for i in range(n)]

    got = torch.cat(ring_attention(chunks(q), chunks(k), chunks(v), chunks(qpos),
                                   chunks(kvpos)), dim=1).numpy()
    assert np.isfinite(got).all()
    assert (got[1, 0] == 0).all() and (want[1, 0] == 0).all()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# ---------------------------------------------------------------- prefill


@pytest.mark.parametrize("full", [False, True], ids=["last", "full_logits"])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_context_prefill_equals_jax(models, prompts, family, full):
    cj, ct, tree, tparams = models[family]
    p, plen = prompts
    want = jctx.context_prefill(cj, jctx.context_mesh(4), jax.tree.map(jnp.asarray, tree), p,
                                plen, full_logits=full)
    got = tctx.context_prefill(ct, ["cpu"] * 4, tparams, p, plen, full_logits=full)
    assert got.shape == want.shape
    if full:  # padded positions attend nothing real: compare the real ones
        for b in range(2):
            np.testing.assert_allclose(got[b, : plen[b]], want[b, : plen[b]], atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_context_prefill_cache_equals_jax(models, prompts):
    """The assembled cache: the monolith's layout, K/V per layer within
    1e-5 of JAX's (the two packages' matmuls round differently), positions
    and length exactly."""
    cj, ct, tree, tparams = models["llama"]
    p, plen = prompts
    jl, jc = jctx.context_prefill_cache(cj, jctx.context_mesh(2),
                                        jax.tree.map(jnp.asarray, tree), p, plen,
                                        cache_dtype=jnp.float32)
    tl, tc = tctx.context_prefill_cache(ct, ["cpu"] * 2, tparams, p, plen)
    assert tc.k.shape == tuple(jc.k.shape) and tc.length == int(jc.length) == 16
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.float().numpy(), jl, atol=1e-5, rtol=0)


def test_context_refusals_equal_jax(models):
    cj, ct, tree, tparams = models["llama"]
    with pytest.raises(ValueError) as je:
        jctx.context_prefill(cj, jctx.context_mesh(4), jax.tree.map(jnp.asarray, tree),
                             np.ones((1, 10), np.int32))
    with pytest.raises(ValueError) as te:
        tctx.context_prefill(ct, ["cpu"] * 4, tparams, np.ones((1, 10), np.int32))
    assert str(te.value) == str(je.value)
    assert tctx.context_mesh(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        tctx.context_mesh(4, ["cpu"] * 2)


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_context_generate_greedy_equals_jax(models, prompts, family, cp):
    cj, ct, tree, tparams = models[family]
    p, plen = prompts
    want = jctx.context_generate(cj, jctx.context_mesh(cp), jax.tree.map(jnp.asarray, tree), p,
                                 10, prompt_len=plen, cache_dtype=jnp.float32)
    got = tctx.context_generate(ct, ["cpu"] * cp, tparams, p, 10, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_context_generate_sampled_equals_port_generate(models, prompts, family):
    cj, ct, tree, tparams = models[family]
    p, plen = prompts
    kw = dict(prompt_len=plen, temperature=0.8, top_k=20, seed=5)
    got = tctx.context_generate(ct, ["cpu"] * 2, tparams, p, 10, **kw)
    want = tgen.generate(ct, tparams, p, 10, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_decode_from_cache_equals_jax_and_keeps_its_cache(models, prompts):
    """A ring prefill decoded twice with ``donate_cache=False``: the same
    tokens both times (the prefill's cache is untouched), equal to the JAX
    ``decode_from_cache`` on its own prefill; a short cache padded up to
    ``capacity``."""
    cj, ct, tree, tparams = models["llama"]
    p, plen = prompts
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jctx.context_prefill_cache(cj, jctx.context_mesh(2), jp, p, plen,
                                        cache_dtype=jnp.float32)
    want = jgen.decode_from_cache(cj, jp, p, jl, jc, 8, prompt_len=plen, capacity=40)
    tl, tc = tctx.context_prefill_cache(ct, ["cpu"] * 2, tparams, p, plen)
    k0 = tc.k.clone()
    runs = [tgen.decode_from_cache(ct, tparams, p, tl, tc, 8, prompt_len=plen, capacity=40,
                                   donate_cache=False) for _ in range(2)]
    torch.testing.assert_close(tc.k, k0, rtol=0, atol=0)
    assert runs[0].cache.capacity == 40 and tc.capacity == 16
    for r in runs:
        np.testing.assert_array_equal(r.tokens, np.asarray(want.tokens))
    same = tgen.decode_from_cache(ct, tparams, p, tl, tc, 8, prompt_len=plen,
                                  donate_cache=False)
    np.testing.assert_array_equal(same.tokens, runs[0].tokens)
    sampled = tgen.decode_from_cache(ct, tparams, p, tl, tc, 8, prompt_len=plen,
                                     temperature=0.7, seed=9)
    ref = tgen.generate(ct, tparams, p, 8, prompt_len=plen, temperature=0.7, seed=9)
    np.testing.assert_array_equal(sampled.tokens, ref.tokens)


# ---------------------------------------------------------------- segments


def test_segment_capacities_equal_jax():
    for need in (1, 17, 255, 256, 257, 1000, 1024, 1025, 5000):
        for cap in (64, 256, 288, 511, 512, 1024, 2048, 4096, 5000, 16384, 65536):
            if cap < need:
                continue
            assert tgen._segment_capacities(need, cap) == jgen._segment_capacities(need, cap), (
                need, cap)
    assert (tgen.MIN_SEGMENT_CAPACITY, tgen.SEGMENT_GROWTH) == (
        jgen.MIN_SEGMENT_CAPACITY, jgen.SEGMENT_GROWTH)


@pytest.mark.parametrize("capacity", [1024, 4096])
def test_segmented_generate_equals_jax(capacity):
    """The port's ``generate`` at a capacity that takes several rungs (256,
    1024 and at 4096 the last): greedy tokens equal JAX's, a batch with
    one row stopping early included, and the cache comes back whole."""
    cj, ct, tree, tparams = _model("llama", L=2, max_position_embeddings=8192)
    rng = np.random.default_rng(2)
    p = rng.integers(1, 256, (2, 200)).astype(np.int32)
    plen = np.array([200, 150], np.int32)
    want = jgen.generate(cj, jax.tree.map(jnp.asarray, tree), p, 80, prompt_len=plen,
                         capacity=capacity, cache_dtype=jnp.float32)
    got = tgen.generate(ct, tparams, p, 80, prompt_len=plen, capacity=capacity)
    assert tgen._segment_capacities(201, capacity)[0] == 256
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert got.cache.capacity == capacity and got.cache.length == 200 + 79
