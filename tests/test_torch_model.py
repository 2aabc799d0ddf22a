"""The port's llama forward and ``generate`` against the JAX package on
``tiny_llama`` and ``tiny_qwen2``, with the same weights carried over by
``params_from_numpy``. float32 logits agree to 1e-4 (matmul summation
order differs between XLA:CPU and PyTorch); greedy tokens are identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.cache import init_cache as tinit_cache
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate


def _models(preset, **kw):
    """The same random weights in both packages (qwen2 biases non-zero)."""
    cj = getattr(jcfg, preset)(**kw)
    ct = getattr(tcfg, preset)(**kw)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(0), dtype=jnp.float32))
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        if name in tree["layers"]:
            tree["layers"][name] = (
                rng.normal(size=tree["layers"][name].shape).astype(np.float32) * 0.1
            )
    return cj, ct, jax.tree.map(jnp.asarray, tree), tllama.params_from_numpy(ct, tree, device="cpu")


@pytest.mark.parametrize("preset", ["tiny_llama", "tiny_qwen2"])
def test_forward_logits_match_jax(preset):
    """Prefill of a right-padded batch, then one decode step."""
    cj, ct, pj, pt = _models(preset)
    rng = np.random.default_rng(2)
    B, S, C = 2, 9, 16
    ids = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 6:] = 2**30
    cache_j = jinit_cache(cj, B, C, dtype=jnp.float32)
    cache_t = tinit_cache(ct, B, C, dtype=torch.float32, device="cpu")
    lj, cache_j = jllama.forward(cj, pj, jnp.asarray(ids), cache_j, jnp.asarray(pos))
    lt, cache_t = tllama.forward(ct, pt, torch.from_numpy(ids), cache_t, torch.from_numpy(pos))
    real = pos < 2**30
    np.testing.assert_allclose(lt.numpy()[real], np.asarray(lj)[real], atol=1e-4)
    nxt = np.array([[3], [7]], np.int32)
    npos = np.array([[S], [6]], np.int32)
    lj, _ = jllama.forward(cj, pj, jnp.asarray(nxt), cache_j, jnp.asarray(npos))
    lt, _ = tllama.forward(ct, pt, torch.from_numpy(nxt), cache_t, torch.from_numpy(npos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("preset", ["tiny_llama", "tiny_qwen2"])
def test_generate_greedy_tokens_match_jax(preset):
    cj, ct, pj, pt = _models(preset)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 11)).astype(np.int32)
    plen = np.array([11, 7])
    want = jgenerate(cj, pj, prompt, 14, prompt_len=plen, cache_dtype=jnp.float32)
    got = tgenerate(ct, pt, prompt, 14, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def test_generate_stops_on_any_eos_like_jax():
    """Multi-EOS stop: two stop ids taken from the greedy continuation."""
    cj, ct, pj, pt = _models("tiny_llama")
    prompt = np.random.default_rng(4).integers(0, 256, (2, 6)).astype(np.int32)
    free = tgenerate(ct, pt, prompt, 12).tokens
    stops = (int(free[0, 9]), int(free[1, 8]))
    cj = dataclasses.replace(cj, eos_token_ids=stops)
    ct = dataclasses.replace(ct, eos_token_ids=stops)
    want = jgenerate(cj, pj, prompt, 12, cache_dtype=jnp.float32)
    got = tgenerate(ct, pt, prompt, 12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert (got.lengths < 18).all()


def test_generate_capacity_check():
    _, ct, _, pt = _models("tiny_llama")
    with pytest.raises(ValueError, match="capacity"):
        tgenerate(ct, pt, np.zeros(10, np.int32), 10, capacity=16)


def test_params_from_numpy_bf16_is_bit_exact():
    cj = jcfg.tiny_llama()
    ct = tcfg.tiny_llama()
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(5)))  # bf16
    pt = tllama.params_from_numpy(ct, tree, device="cpu")
    assert pt["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pt["layers"][2]["wq"].view(torch.int16).numpy().view(np.uint16),
        tree["layers"]["wq"][2].view(np.uint16),
    )


def test_init_params_is_seeded():
    ct = tcfg.tiny_llama(num_hidden_layers=1)
    a = tllama.init_params(ct, seed=3, dtype=torch.float32, device="cpu")
    b = tllama.init_params(ct, generator=torch.Generator().manual_seed(3), dtype=torch.float32,
                           device="cpu")
    torch.testing.assert_close(a["layers"][0]["w_up"], b["layers"][0]["w_up"], rtol=0, atol=0)
    assert set(a["layers"][0]) == set(
        jllama.init_layer_params(jcfg.tiny_llama(), jax.random.key(0), 1)
    )


def test_entry_points_default_to_the_gpu():
    """Without a GPU, an entry point that was not asked for the CPU raises
    instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(tcfg.tiny_llama(num_hidden_layers=1))
