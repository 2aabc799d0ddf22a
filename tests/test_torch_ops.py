"""Port ops against the JAX package: rms_norm, RoPE (llama3 scaling),
cached_attention, stop ids, greedy and noise-injected sampling.

Inputs come from numpy with a seed and go through both packages; JAX runs
on the CPU (tests/conftest.py). Tolerances are for float32: 1e-6 where
both sides do the same elementwise fp32 arithmetic, 1e-5 where a sum or a
transcendental of a large argument may round differently.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.ops import attention as jattn
from llm_sharding_tpu.ops import norms as jnorms
from llm_sharding_tpu.ops import rope as jrope
from llm_sharding_tpu.ops import sampling as jsamp
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.ops import attention as tattn
from llm_sharding_tpu_torch.ops import norms as tnorms
from llm_sharding_tpu_torch.ops import rope as trope
from llm_sharding_tpu_torch.ops import sampling as tsamp

SENTINEL = 2**30


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    got = tnorms.rms_norm(_t(x), _t(w), 1e-5, offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("preset", ["llama32_3b", "tiny_llama"])
def test_rope_matches_jax(preset):
    """llama32_3b carries llama3 frequency scaling (factor 32)."""
    cj, ct = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    np.testing.assert_array_equal(trope.inv_frequencies(ct), jrope.inv_frequencies(cj))
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 8000, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, ct.head_dim_)).astype(np.float32)
    cj_, sj_ = jrope.rope_cos_sin(jnp.asarray(pos), cj)
    ct_, st_ = trope.rope_cos_sin(_t(pos), ct)
    np.testing.assert_allclose(ct_.numpy(), np.asarray(cj_), atol=1e-5)
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj_), atol=1e-5)
    want = jrope.apply_rope(jnp.asarray(x), cj_, sj_)
    got = trope.apply_rope(_t(x), ct_, st_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("G", [1, 3])
def test_cached_attention_matches_jax(G):
    """GQA groups, right-padded queries and empty (sentinel) cache slots."""
    rng = np.random.default_rng(2)
    B, S, C, Nkv, D = 2, 5, 12, 2, 16
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    qpos = np.tile(np.arange(4, 4 + S, dtype=np.int32), (B, 1))
    qpos[1, 3:] = SENTINEL
    kvpos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    kvpos[0, 9:] = SENTINEL
    want = jattn.cached_attention(*map(jnp.asarray, (q, k, v, qpos, kvpos)))
    got = tattn.cached_attention(*map(_t, (q, k, v, qpos, kvpos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_is_stop_matches_jax():
    cj = dataclasses.replace(jcfg.tiny_llama(), eos_token_ids=(2, 7))
    ct = dataclasses.replace(tcfg.tiny_llama(), eos_token_ids=(2, 7))
    tok = np.array([0, 2, 7, 9], np.int32)
    np.testing.assert_array_equal(
        tsamp.is_stop(ct, _t(tok)).numpy(), np.asarray(jsamp.is_stop(cj, jnp.asarray(tok)))
    )


def test_greedy_matches_jax():
    logits = np.random.default_rng(3).normal(size=(4, 256)).astype(np.float32)
    want = jsamp.sample(jnp.asarray(logits), jax.random.key(0), 0.0, 0)
    got = tsamp.sample(_t(logits), 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.8, 10, 0.8)]
)
def test_sample_with_injected_noise_matches_jax(temperature, top_k, top_p):
    """JAX draws Gumbel noise from its key; handing the port the same noise
    must select the same tokens."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 256)).astype(np.float32) * 3
    key = jax.random.key(11)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    want = jsamp.sample(jnp.asarray(logits), key, temperature, top_k, top_p)
    got = tsamp.sample(_t(logits), temperature, top_k, top_p, noise=_t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_generator_is_reproducible():
    logits = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32))
    a = tsamp.sample(logits, 1.0, generator=torch.Generator().manual_seed(3))
    b = tsamp.sample(logits, 1.0, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
