"""The port's hybrid placements (``parallel/mesh.py``, ``pipeline_generate``
over ``(dp, pp, tp)``, ``Engine(data_parallel=, tensor_parallel=)``),
mirroring ``tests/test_hybrid.py`` test for test: the port's replicas,
stages and shards all on the CPU, the JAX package's hybrid programs over
its 8-device CPU mesh (``tests/conftest.py``), one seeded numpy tree fed
to both (tiny_llama at 8 layers, tiny GPT-2 at 4, f32).

Held equal to JAX exactly (tolerance 0): greedy tokens and lengths of
dp×pp, pp×tp, ragged pp×tp and GPT-2 pp×tp against the JAX monolith's
``generate`` (the oracle the JAX tests hold their hybrids to) and, for
dp×pp and pp×tp, against the JAX ``pipeline_generate`` on the same mesh;
the refusals' exception classes and words; the grid's device order and
axis sizes; the default stage count.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from jax.sharding import Mesh

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.parallel import distributed as jdist
from llm_sharding_tpu.parallel import pipeline as jpipe
from llm_sharding_tpu.parallel.mesh import DATA_AXIS, PIPE_AXIS
from llm_sharding_tpu.parallel.placement import PlacementSpec as JSpec
from llm_sharding_tpu.parallel.placement import stack_stage_params
from llm_sharding_tpu.parallel.tensor import TENSOR_AXIS
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.parallel import mesh as tmesh
from llm_sharding_tpu_torch.parallel.pipeline import (
    build_stages, mesh_axis_sizes, pipeline_generate, stage_layer_specs,
)
from llm_sharding_tpu_torch.parallel.placement import PlacementSpec
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

L = 8
CJ = jcfg.tiny_llama(num_hidden_layers=L)
CFG = tcfg.tiny_llama(num_hidden_layers=L)


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(11), dtype=jnp.float32))
    return tree, params_from_numpy(CFG, tree, device="cpu")


def oracle(tree, prompts, n, cfg=CJ, **kw):
    return jgenerate(cfg, jax.tree.map(jnp.asarray, tree), prompts, n, cache_dtype=jnp.float32,
                     **kw)


def chains(cfg, params, spec, dp=1, tp=1):
    """``dp`` replicas of ``spec``'s chain, each stage over ``tp`` shards,
    everything on the CPU."""
    out = [build_stages(cfg, params, spec, ["cpu"] * (spec.num_stages * tp), tp=tp)
           for _ in range(dp)]
    return out if dp > 1 else out[0]


def test_dp_x_pp_token_exact(setup):
    """2 replicas × 4 stages: each replica decodes its rows through its own
    chain; tokens equal the JAX dp×pp program's and the monolith's."""
    tree, params = setup
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, CFG.vocab_size, (4, 5)).astype(np.int32)
    got = pipeline_generate(CFG, chains(CFG, params, PlacementSpec.balanced(L, 4), dp=2),
                            prompts, 7)
    sl, masks = stack_stage_params(JSpec.balanced(L, 4), tree["layers"])
    head = {k: v for k, v in tree.items() if k != "layers"}
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), (DATA_AXIS, PIPE_AXIS))
    want = jpipe.pipeline_generate(CJ, mesh, sl, masks, head, prompts, 7,
                                   cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    for r in range(4):
        np.testing.assert_array_equal(got.tokens[r], oracle(tree, prompts[r], 7).tokens[0])


def test_pp_x_tp_token_exact(setup):
    """4 stages × 2 shards: each stage's layers megatron-split, its KV by
    head; tokens equal the JAX pp×tp program's and the monolith's."""
    tree, params = setup
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, CFG.vocab_size, (1, 6)).astype(np.int32)
    got = pipeline_generate(CFG, chains(CFG, params, PlacementSpec.balanced(L, 4), tp=2),
                            prompt, 8)
    sl, masks = stack_stage_params(JSpec.balanced(L, 4), tree["layers"])
    head = {k: v for k, v in tree.items() if k != "layers"}
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), (PIPE_AXIS, TENSOR_AXIS))
    want = jpipe.pipeline_generate(CJ, mesh, sl, masks, head, prompt, 8,
                                   cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.tokens, oracle(tree, prompt, 8).tokens)


def test_pp_x_tp_ragged(setup):
    tree, params = setup
    spec = PlacementSpec.from_ranges([(0, 4), (4, 5), (5, 8)], L)
    prompt = np.array([[3, 9, 4, 1]], np.int32)
    got = pipeline_generate(CFG, chains(CFG, params, spec, tp=2), prompt, 6)
    np.testing.assert_array_equal(got.tokens, oracle(tree, prompt, 6).tokens)


def test_dp_batch_not_divisible_rejected(setup):
    tree, params = setup
    prompts = np.ones((3, 4), np.int32)
    with pytest.raises(ValueError) as te:
        pipeline_generate(CFG, chains(CFG, params, PlacementSpec.balanced(L, 4), dp=2),
                          prompts, 4)
    sl, masks = stack_stage_params(JSpec.balanced(L, 4), tree["layers"])
    head = {k: v for k, v in tree.items() if k != "layers"}
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), (DATA_AXIS, PIPE_AXIS))
    with pytest.raises(ValueError) as je:
        jpipe.pipeline_generate(CJ, mesh, sl, masks, head, prompts, 4)
    assert str(te.value) == str(je.value) and "divisible" in str(te.value)


def test_engine_dp_x_pp_token_exact(setup):
    """dp×pp from the engine, and the surfaces that do not compose refuse
    with the JAX engine's classes and words."""
    tree, params = setup
    eng = Engine(CFG, params, num_stages=4, data_parallel=2, devices=["cpu"] * 8)
    assert eng.num_stages == 4 and len(eng._replicas) == 2
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, CFG.vocab_size, (4, 5)).astype(np.int32)
    res = eng.generate_ids(prompts, 7)
    for r in range(4):
        np.testing.assert_array_equal(res.tokens[r], oracle(tree, prompts[r], 7).tokens[0])
    jeng = PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=4, data_parallel=2,
                          cache_dtype=jnp.float32)
    for call in (lambda e: e.serve(), lambda e: e.generate_many(prompts, 4)):
        with pytest.raises(NotImplementedError) as te:
            call(eng)
        with pytest.raises(NotImplementedError) as je:
            call(jeng)
        assert str(te.value) == str(je.value)


def test_engine_pp_x_tp_token_exact(setup):
    """pp×tp from the engine; a hot repartition keeps the tensor degree."""
    tree, params = setup
    eng = Engine(CFG, params, num_stages=4, tensor_parallel=2, devices=["cpu"] * 8)
    assert [st.tp for st in eng.stages] == [2] * 4
    prompt = np.array([[3, 9, 4, 1]], np.int32)
    want = oracle(tree, prompt, 8).tokens
    np.testing.assert_array_equal(eng.generate_ids(prompt, 8).tokens, want)
    eng.apply_placement(PlacementSpec.from_ranges([(0, 3), (3, 4), (4, 8)], L))
    assert [(st.start, st.end, st.tp) for st in eng.stages] == [(0, 3, 2), (3, 4, 2), (4, 8, 2)]
    np.testing.assert_array_equal(eng.generate_ids(prompt, 8).tokens, want)
    with pytest.raises(ValueError, match="speculate"):
        eng.generate_ids(prompt, 4, speculate=2)


def test_engine_default_stages_account_for_dp(setup):
    """num_stages defaults to devices / (dp·tp); a count that does not
    divide refuses with the JAX words."""
    tree, params = setup
    assert Engine(CFG, params, data_parallel=2, devices=["cpu"] * 8).num_stages == 4
    assert Engine(CFG, params, data_parallel=2, tensor_parallel=2,
                  devices=["cpu"] * 8).num_stages == 2
    with pytest.raises(ValueError) as te:
        Engine(CFG, params, data_parallel=2, tensor_parallel=2, devices=["cpu"] * 6)
    with pytest.raises(ValueError) as je:
        PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), data_parallel=2, tensor_parallel=2,
                       devices=jax.devices()[:6])
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        Engine(CFG, params, tensor_parallel=0, devices=["cpu"])
    with pytest.raises(ValueError) as je:
        PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), tensor_parallel=0)
    assert str(te.value) == str(je.value)


def test_pp_x_tp_gpt2_token_exact():
    """GPT-2 pp2×tp2: the fused qkv is permuted when the stages are split,
    so callers pass raw layers; tokens equal the JAX pp×tp program's and
    the monolith's."""
    cj, ct = jcfg.tiny_gpt2(num_hidden_layers=4), tcfg.tiny_gpt2(num_hidden_layers=4)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cj, jax.random.key(5), dtype=jnp.float32))
    params = params_from_numpy(ct, tree, device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cj.vocab_size, (2, 5)).astype(np.int32)
    got = pipeline_generate(ct, chains(ct, params, PlacementSpec.balanced(4, 2), tp=2),
                            prompts, 8)
    sl, masks = stack_stage_params(JSpec.balanced(4, 2), tree["layers"])
    head = {k: v for k, v in tree.items() if k != "layers"}
    want = jpipe.pipeline_generate(cj, jdist.hybrid_mesh(pipe=2, tensor=2), sl, masks, head,
                                   prompts, 8, cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    mono = oracle(tree, prompts, 8, cfg=cj)
    np.testing.assert_array_equal(got.tokens, mono.tokens)


# ---------------------------------------------------------------- grids


@pytest.mark.parametrize("sizes", [dict(data=2, pipe=2, tensor=2), dict(pipe=4, tensor=2),
                                   dict(data=2, pipe=4), dict(seq=2, tensor=4)])
def test_hybrid_mesh_order_equal_jax(sizes):
    """The port's grid lists the devices in the JAX hybrid mesh's order
    (tensor innermost), and the axis sizes read back equal."""
    jm = jdist.hybrid_mesh(devices=jax.devices()[:8], **sizes)
    n = int(np.prod(jm.devices.shape))
    tm = tmesh.hybrid_mesh(devices=[torch.device("cpu")] * n, **sizes)
    assert tm.shape == dict(jm.shape) and tm.axis_names == tuple(jm.axis_names)
    # an explicit list is taken verbatim, in order: JAX's ids and the
    # port's positions both count up with the tensor axis innermost
    assert [d.id for d in jm.devices.reshape(-1)] == list(range(n))
    assert tm.device_list() == [torch.device("cpu")] * n
    assert mesh_axis_sizes(tm) == jpipe.mesh_axis_sizes(jm)


def test_pipeline_data_mesh_and_refusal():
    g = tmesh.pipeline_data_mesh(4, 2, devices=["cpu"] * 8)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), (DATA_AXIS, PIPE_AXIS))
    assert g.shape == dict(jm.shape)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        tmesh.hybrid_mesh(data=2, pipe=2, tensor=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_stage_layer_specs_follow_jax(family):
    """Per-leaf rules of a stage: the JAX ``stage_layer_specs`` with its two
    stack axes dropped; tp 1 splits nothing."""
    cj = jcfg.tiny_llama() if family == "llama" else jcfg.tiny_gpt2()
    ct = tcfg.tiny_llama() if family == "llama" else tcfg.tiny_gpt2()
    assert stage_layer_specs(ct, 1) is None
    js = jpipe.stage_layer_specs(cj, 2)
    ts = stage_layer_specs(ct, 2)
    assert set(js) == set(ts)
    names = {(None,) * 3 + (TENSOR_AXIS,): "col", (None, None, TENSOR_AXIS, None): "row",
             (None, None, TENSOR_AXIS): "col_bias"}
    for k, spec in js.items():
        parts = tuple(spec)[1:]
        assert names.get((None,) + parts, "rep") == ts[k], k
