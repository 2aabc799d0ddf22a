"""The port's tensor parallelism (``parallel/tensor.py``, the split block of
``models/llama.py`` / ``models/gpt2.py``, ``Engine(tensor_parallel=)``)
against the JAX package on the CPU: the port's shards all on the CPU
device, the JAX GSPMD model over its 8-device CPU mesh
(``tests/conftest.py``), one seeded numpy tree fed to both.

Held equal to JAX exactly (tolerance 0): the split rules of every llama
and GPT-2 leaf and of a quantized leaf's components; ``qkv_perm_indices``
over a grid; each shard's leaves byte for byte against the JAX shard on
the same mesh position (f32, int8 and int4 weights); the indivisible
refusals' words; greedy tokens of ``generate`` at tp 2 and 4 (llama,
qwen2's biases, gemma-1's norm offset and embedding multiplier, GPT-2's
permuted qkv). Logits after the full forward agree with the JAX GSPMD
forward's within 1e-5 absolute at f32 (the reduce sums partials where
XLA's all-reduce does, so the last bits may differ).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from jax.sharding import PartitionSpec as P

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.parallel import tensor as jtensor
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models.cache import init_cache
from llm_sharding_tpu_torch.models.stack import HeadShards, Shards, reduce_count
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.parallel import tensor as ttensor
from llm_sharding_tpu_torch.parallel.pipeline import (
    build_stages, chain_caches, chain_embed, chain_forward, model_fns,
)
from llm_sharding_tpu_torch.parallel.placement import PlacementSpec
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

TENSOR = jtensor.TENSOR_AXIS
_RULES = {P(None, TENSOR): ttensor.COL, P(TENSOR, None): ttensor.ROW, P(TENSOR): ttensor.COL_B}


def rule(spec) -> str:
    """The port's split rule of a JAX PartitionSpec (no tensor axis: whole)."""
    return _RULES[spec] if TENSOR in tuple(spec) else ttensor.REP

# head counts divisible by 4: tp 2 and 4 both split
FAMILIES = {
    "llama": (lambda **k: jcfg.tiny_llama(num_attention_heads=8, num_key_value_heads=4, **k),
              lambda **k: tcfg.tiny_llama(num_attention_heads=8, num_key_value_heads=4, **k)),
    "qwen2": (lambda **k: jcfg.tiny_qwen2(num_attention_heads=8, num_key_value_heads=4, **k),
              lambda **k: tcfg.tiny_qwen2(num_attention_heads=8, num_key_value_heads=4, **k)),
    "gemma": (lambda **k: jcfg.tiny_gemma(num_attention_heads=8, num_key_value_heads=4, **k),
              lambda **k: tcfg.tiny_gemma(num_attention_heads=8, num_key_value_heads=4, **k)),
    "gpt2": (jcfg.tiny_gpt2, tcfg.tiny_gpt2),
}


def _tree(family: str, bits: int = 0, L: int = 2):
    """A seeded JAX numpy tree of ``family`` (qwen2's biases drawn, not
    zero), maybe quantized to ``bits``."""
    cj = FAMILIES[family][0](num_hidden_layers=L)
    mod = jgpt2 if family == "gpt2" else jllama
    tree = mod.init_params(cj, jax.random.key(7), dtype=jnp.float32)
    if family == "qwen2":
        rng = np.random.default_rng(5)
        layers = dict(tree["layers"])
        for k in ("bq", "bk", "bv"):
            layers[k] = jnp.asarray(rng.normal(0, 0.5, layers[k].shape).astype(np.float32))
        tree = dict(tree, layers=layers)
    if bits:
        tree = jquant.quantize_params(tree, bits=bits)
    return cj, jax.tree.map(np.asarray, tree)


def _port(family: str, tree, L: int = 2):
    ct = FAMILIES[family][1](num_hidden_layers=L)
    return ct, params_from_numpy(ct, tree, device="cpu")


# ---------------------------------------------------------------- rules


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_split_rules_equal_jax(family):
    jspecs = (jtensor.llama_tp_specs if family == "llama" else jtensor.gpt2_tp_specs)(
        stacked=False)
    tspecs = (ttensor.llama_tp_specs if family == "llama" else ttensor.gpt2_tp_specs)()
    assert set(jspecs) == set(tspecs)
    assert {k: rule(v) for k, v in jspecs["layers"].items()} == tspecs["layers"]
    for k in jspecs:
        if k != "layers":
            assert rule(jspecs[k]) == tspecs[k], k


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_leaf_spec_equal_jax(bits):
    w = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w), bits=bits)
    tq = tquant.quantize_tensor(torch.from_numpy(w), bits=bits)
    for spec in (P(None, TENSOR), P(TENSOR, None), P()):
        js = jtensor.quant_leaf_spec(spec, jq)
        ts = ttensor.quant_leaf_spec(rule(spec), tq)
        assert type(ts).__name__ == type(js).__name__
        assert (rule(js.q), rule(js.scale)) == (ts.q, ts.scale)


@pytest.mark.parametrize("h3,tp", [(12, 1), (12, 2), (24, 4), (192, 2), (192, 4), (3 * 768, 12)])
def test_qkv_perm_indices_equal_jax(h3, tp):
    np.testing.assert_array_equal(ttensor.qkv_perm_indices(h3, tp),
                                  jtensor.qkv_perm_indices(h3, tp))


def test_permute_gpt2_layers_equal_jax():
    """The permuted fused qkv (weight, bias, int8 codes and scales) byte for
    byte, and the memo returns the same tensors for the same leaf."""
    cj, tree = _tree("gpt2", bits=8)
    ct, tp_ = _port("gpt2", tree)
    jl = jtensor.permute_gpt2_tp_layers(tree["layers"], 2)
    for i, layer in enumerate(tp_["layers"]):
        got = ttensor.permute_gpt2_tp_layers(layer, 2)
        np.testing.assert_array_equal(got["w_qkv"].q.numpy(), np.asarray(jl["w_qkv"].q)[i])
        np.testing.assert_array_equal(got["w_qkv"].scale.numpy(), np.asarray(jl["w_qkv"].scale)[i])
        np.testing.assert_array_equal(got["b_qkv"].numpy(), np.asarray(jl["b_qkv"])[i])
        again = ttensor.permute_gpt2_tp_layers_cached(layer, 2)
        assert ttensor.permute_gpt2_tp_layers_cached(layer, 2)["w_qkv"] is again["w_qkv"]


# ---------------------------------------------------------------- shards


def _jax_shards(leaf, n):
    """Each mesh position's block of a JAX array, in device order."""
    devs = jax.devices()[:n]
    by_dev = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
    return [by_dev[d] for d in devs]


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_shard_leaves_byte_equal_jax(family, bits):
    """Every leaf of every shard equals the JAX GSPMD shard of the same mesh
    position byte for byte, quantized leaves per component, and is a
    contiguous tensor of its own (the kernels refuse strided operands).
    GPT-2's fused qkv is compared against the JAX shards of the PERMUTED
    layers (what the explicit tensor path splits)."""
    cj, tree = _tree(family, bits)
    ct, tparams = _port(family, tree)
    tp = 2
    jtree = jax.tree.map(jnp.asarray, tree)
    if family == "gpt2":
        jtree = dict(jtree, layers=jtensor.permute_gpt2_tp_layers(jtree["layers"], tp))
    jsh = jtensor.shard_params_tp(cj, jtree, jtensor.tensor_mesh(tp))
    tsh = ttensor.shard_params_tp(ct, tparams, ["cpu"] * tp)
    assert len(tsh) == tp

    def comps(v):
        return list(v) if isinstance(v, (jquant.QTensor, tquant.QTensor)) else [v]

    for key, jleaf in jsh["layers"].items():
        jparts = [_jax_shards(c, tp) for c in comps(jleaf)]
        for j in range(tp):
            for i in range(ct.num_hidden_layers):
                tleaf = tsh[j]["layers"][i][key]
                if isinstance(jleaf, jquant.QTensor):
                    assert type(tleaf).__name__ == type(jleaf).__name__
                for c, jp in zip(comps(tleaf), jparts):
                    assert c.is_contiguous()
                    np.testing.assert_array_equal(c.numpy(), jp[j][i], err_msg=f"{key}[{i}] {j}")
    for key in jsh:
        if key == "layers":
            continue
        for c, jc in zip(comps(tsh[1][key]), comps(jsh[key])):
            np.testing.assert_array_equal(c.numpy(), _jax_shards(jc, tp)[1], err_msg=key)


def test_shard_cache_tp_splits_heads():
    ct = FAMILIES["llama"][1](num_hidden_layers=2)
    cache = init_cache(ct, 2, 8, dtype=torch.float32, device="cpu")
    cache.k.normal_()
    sh = ttensor.shard_cache_tp(cache, ["cpu"] * 4)
    assert isinstance(sh.k, HeadShards) and sh.k.shape == cache.k.shape
    assert [tuple(p.shape) for p in sh.k.parts] == [(2, 2, 8, 1, ct.head_dim_)] * 4
    torch.testing.assert_close(sh.k.full(), cache.k, rtol=0, atol=0)


@pytest.mark.parametrize("heads,kv,inter,tp", [(6, 3, 128, 4), (4, 2, 128, 4), (8, 4, 100, 8),
                                               (8, 4, 128, 3)])
def test_tp_indivisible_rejected(heads, kv, inter, tp):
    kw = dict(num_attention_heads=heads, num_key_value_heads=kv, intermediate_size=inter)
    with pytest.raises(ValueError) as je:
        jtensor.validate_tp(jcfg.tiny_llama(**kw), tp)
    with pytest.raises(ValueError) as te:
        ttensor.validate_tp(tcfg.tiny_llama(**kw), tp)
    assert str(te.value) == str(je.value) and "divisible" in str(te.value)
    with pytest.raises(ValueError, match="divisible"):  # before any weight is touched
        Engine(tcfg.tiny_llama(**kw), {"layers": []}, tensor_parallel=tp, devices=["cpu"] * tp)


# ---------------------------------------------------------------- model


def _port_tp_logits(ct, tparams, ids, tp):
    """The port's full forward over one stage of ``tp`` shards: fp32 logits."""
    stages = build_stages(ct, tparams, PlacementSpec.balanced(ct.num_hidden_layers, 1),
                          ["cpu"] * tp, tp=tp)
    B, S = ids.shape
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    caches = chain_caches(ct, stages, B, S, torch.float32)
    h = chain_forward(ct, stages, chain_embed(ct, stages, torch.from_numpy(ids), pos), caches, pos)
    return model_fns(ct).final_logits(ct, stages[0].head, h).numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma", "gpt2"])
def test_tp_logits_match_jax_gspmd(family, tp):
    cj, tree = _tree(family)
    ct, tparams = _port(family, tree)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cj.vocab_size, (2, 10)).astype(np.int32)
    positions = jnp.broadcast_to(jnp.arange(10), (2, 10))
    mod = jgpt2 if family == "gpt2" else jllama
    mesh = jtensor.tensor_mesh(tp)
    jp = jtensor.shard_params_tp(cj, jax.tree.map(jnp.asarray, tree), mesh)
    jc = jtensor.shard_cache_tp(jinit_cache(cj, 2, 10, dtype=jnp.float32), mesh)
    want, _ = jax.jit(lambda p, i, c, pos: mod.forward(cj, p, i, c, pos))(
        jp, jnp.asarray(ids), jc, positions)
    reduce_count(reset=True)
    got = _port_tp_logits(ct, tparams, ids, tp)
    assert reduce_count() == 2 * ct.num_hidden_layers  # wo/w_proj and w_down/w_out
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma", "gpt2"])
def test_tp_generate_token_exact(family, tp):
    """``Engine(tensor_parallel=)`` generate (greedy, ragged batch) equals
    the JAX package's ``generate`` on its GSPMD-sharded params."""
    L = 3
    cj, tree = _tree(family, L=L)
    ct, tparams = _port(family, tree, L=L)
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cj.vocab_size, (2, 6)).astype(np.int32)
    plen = np.array([6, 4], np.int32)
    jp = jtensor.shard_params_tp(cj, jax.tree.map(jnp.asarray, tree), jtensor.tensor_mesh(tp))
    want = jgenerate(cj, jp, prompts, 9, prompt_len=plen, cache_dtype=jnp.float32)
    eng = Engine(ct, tparams, tensor_parallel=tp, devices=["cpu"] * tp)
    assert eng.num_stages == 1 and eng.stages[0].tp == tp
    assert isinstance(eng.stages[0].layers[0], Shards)
    got = eng.generate_ids(prompts, 9, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def test_tp_int8_generate_token_exact():
    """int8 weights split per component: greedy tokens equal the JAX
    int8 model's under GSPMD tensor parallelism."""
    cj, tree = _tree("llama", bits=8, L=3)
    ct, tparams = _port("llama", tree, L=3)
    prompt = np.array([[5, 9, 13, 2, 7]], np.int32)
    jp = jtensor.shard_params_tp(cj, jax.tree.map(jnp.asarray, tree), jtensor.tensor_mesh(2))
    want = jgenerate(cj, jp, prompt, 8, cache_dtype=jnp.float32)
    got = Engine(ct, tparams, tensor_parallel=2, devices=["cpu"] * 2).generate_ids(prompt, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
