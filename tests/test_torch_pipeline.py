"""The port's pipeline stages (``parallel/placement.py``, ``parallel/head.py``,
``parallel/pipeline.py``, ``parallel/schedule.py``, ``Engine`` with
``num_stages`` / ``placement`` / ``devices``) against the JAX package on
the CPU: the port's stages all on the CPU device, the JAX chain over its
8-device CPU mesh (``tests/conftest.py``), one seeded numpy tree fed to
both (tiny_llama at 4 layers in f32, tiny GPT-2, an int8 table).

Held equal to JAX exactly (tolerance 0): ``PlacementSpec`` results and
error messages; ``shard_head_host``'s arrays byte for byte (a vocab that 3
does not divide included); ``sp_embed`` (the masked lookups sum exactly,
so f32 bits agree) and the assembled argmax, a constructed tie across
shards included; greedy tokens of ``pipeline_generate`` at 2, 3 (ragged)
and 4 stages, of ``interleaved_generate``, of a grouped 4-stage chain on
2 devices, and the deltas of the ``engine_*`` metric families through
construction and ``apply_placement``. The port's sharded-head logits after
the chain agree with the JAX monolithic forward's within 1e-4 absolute.
A seeded sampled row (whose random numbers differ from JAX's) equals the
port's own one-stage ``generate(seed=)``.
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
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.obs import metrics as jmetrics
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.parallel import head as jhead
from llm_sharding_tpu.parallel import placement as jplace
from llm_sharding_tpu.parallel.mesh import pipeline_mesh
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import gpt2 as tgpt2
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import metrics as tmetrics
from llm_sharding_tpu_torch.parallel import head as thead
from llm_sharding_tpu_torch.parallel import placement as tplace
from llm_sharding_tpu_torch.parallel.pipeline import (
    Stage, build_stages, chain_caches, chain_forward, pipeline_generate, stage_devices,
)
from llm_sharding_tpu_torch.parallel.schedule import interleaved_generate
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate

torch.set_num_threads(1)

L = 4
CJ = jcfg.tiny_llama(num_hidden_layers=L, vocab_size=67)
CFG = tcfg.tiny_llama(num_hidden_layers=L, vocab_size=67)
SPECS = {
    2: ((0, 2), (2, 4)),
    3: ((0, 1), (1, 3), (3, 4)),  # ragged
    4: ((0, 1), (1, 2), (2, 3), (3, 4)),
}
MAX_NEW = 8


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(CJ, jax.random.key(11), dtype=jnp.float32))


@pytest.fixture(scope="module")
def tparams(tree):
    return tllama.params_from_numpy(CFG, tree, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    p = rng.integers(1, CFG.vocab_size, (4, 9)).astype(np.int32)
    plen = np.array([9, 6, 7, 3], np.int32)
    return np.where(np.arange(9)[None] < plen[:, None], p, 0), plen


def jengine(tree, stages, **kw):
    spec = jplace.PlacementSpec(stages, L)
    return PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), placement=spec,
                          devices=jax.devices()[: len(stages)], cache_dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def jax_runs(tree, prompts):
    """Each placement's JAX greedy tokens, and the interleaved schedule's,
    computed once for the module."""
    p, plen = prompts
    out = {}
    for n, stages in SPECS.items():
        eng = jengine(tree, stages)
        out[n] = eng.generate_ids(p, MAX_NEW, prompt_len=plen).tokens
        if n == 2:
            out["many"] = eng.generate_many(p, MAX_NEW, prompt_len=plen).tokens
    return out


# ------------------------------------------------------------- placement

PLACEMENT_CASES = [
    ("balanced", (10, 3)), ("balanced", (4, 4)), ("balanced", (4, 5)), ("balanced", (4, 0)),
    ("from_ranges", ([(0, 6), (6, 7), (7, 32)], 32)), ("from_ranges", ([(0, 2), (3, 4)], 4)),
    ("from_ranges", ([(0, 2), (2, 3)], 4)), ("from_ranges", ([(0, 5)], 4)),
    ("from_ranges", ([], 4)), ("from_capabilities", (28, [1.0, 2.0, 1.0])),
    ("from_capabilities", (10, [5.0, 0.1, 0.1])), ("from_capabilities", (3, [1.0] * 4)),
    ("from_capabilities", (8, [1.0, -1.0])), ("from_stage_times", (32, [0.5, 1.0, 2.0, 0.25])),
]


def _outcome(fn, *args):
    try:
        spec = fn(*args)
    except ValueError as e:
        return "error", str(e)
    return spec.stages, spec.num_layers, spec.num_stages, spec.max_layers_per_stage


@pytest.mark.parametrize("name,args", PLACEMENT_CASES, ids=lambda c: str(c)[:30])
def test_placement_spec_equals_jax(name, args):
    t = _outcome(getattr(tplace.PlacementSpec, name), *args)
    j = _outcome(getattr(jplace.PlacementSpec, name), *args)
    assert t == j


@pytest.mark.parametrize("stages,k", [(((0, 1), (1, 2), (2, 3), (3, 4)), 2),
                                      (((0, 1), (1, 3), (3, 4)), 2),
                                      (((0, 3), (3, 4)), 1)])
def test_grouped_equals_jax(stages, k):
    def outcome(mod):
        try:
            return mod.PlacementSpec(stages, 4).grouped(k).stages
        except ValueError as e:
            return str(e)

    assert outcome(tplace) == outcome(jplace)


def test_split_stage_layers_holds_each_range(tparams):
    spec = tplace.PlacementSpec(SPECS[3], L)
    parts = tplace.split_stage_layers(spec, tparams["layers"])
    assert [len(p) for p in parts] == [1, 2, 1]
    assert parts[1][0] is tparams["layers"][1]


# ------------------------------------------------------------------ head

def _head_trees(tree, cfg_j, quant):
    head = {k: v for k, v in tree.items() if k != "layers"}
    if quant:
        head = jax.tree.map(np.asarray, jquant.quantize_params(
            {**jax.tree.map(jnp.asarray, tree)}, quantize_head=True))
        head = {k: v for k, v in head.items() if k != "layers"}
    return head


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_shard_head_host_bytes_equal_jax(tree, S, quant):
    """67 rows: 3 and 4 stages pad the last shard with zero rows."""
    head = _head_trees(tree, CJ, quant)
    j = jhead.shard_head_host(CJ, head, S)
    t_in = tllama.params_from_numpy(CFG, {**head, "layers": tree["layers"]}, device="cpu")
    t = thead.shard_head_host(CFG, {k: v for k, v in t_in.items() if k != "layers"}, S)
    assert set(t) == set(j)
    for k in j:
        jl = jax.tree.leaves(j[k])
        tl = [t[k]] if isinstance(t[k], torch.Tensor) else list(t[k])
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            a, b = np.asarray(a), _as_np(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.tobytes() == b.tobytes()
    assert thead.head_bytes_per_stage(CFG, S) == jhead.head_bytes_per_stage(CJ, S)
    assert thead.head_bytes_replicated(CFG) == jhead.head_bytes_replicated(CJ)


def _jax_sp(fn, head, S, *args):
    mesh = pipeline_mesh(S, jax.devices()[:S])
    sh = jhead.shard_head_host(CJ, head, S)
    body = shard_map(lambda hd, *a: fn(jhead.local_view(hd), *a), mesh=mesh,
                     in_specs=(jhead.head_specs(sh),) + (P(),) * len(args), out_specs=P(),
                     check_vma=False)
    return np.asarray(body(jax.tree.map(jnp.asarray, sh), *map(jnp.asarray, args)))


@pytest.mark.parametrize("S", [2, 3])
def test_sp_embed_equals_jax(tree, tparams, S):
    head = _head_trees(tree, CJ, False)
    ids = np.random.default_rng(S).integers(0, CFG.vocab_size, (3, 5)).astype(np.int32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (3, 5))
    j = _jax_sp(lambda hd, i, p: jhead.sp_embed(CJ, hd, i, p), head, S, ids, pos)
    stages = build_stages(CFG, tparams, tplace.PlacementSpec.balanced(L, S), ["cpu"] * S)
    t = thead.sp_embed(CFG, stages, torch.from_numpy(ids), torch.from_numpy(pos.copy()))
    np.testing.assert_array_equal(t.numpy(), j)  # tolerance 0
    np.testing.assert_array_equal(t.numpy(), tree["embed"][ids])


def test_assembled_argmax_ties_pick_the_lowest_id(tparams):
    """Ties across shards (and within one) resolve to the lowest vocab id,
    in both packages, as the unsharded argmax does."""
    S, Vs = 3, 4
    vals = np.random.default_rng(0).standard_normal((4, S * Vs)).astype(np.float32)
    vals[0, 1] = vals[0, 9] = 9.0  # shards 0 and 2
    vals[1, 6] = vals[1, 10] = 7.0  # shards 1 and 2
    vals[2, 4] = vals[2, 5] = 8.0  # within shard 1
    mesh = pipeline_mesh(S, jax.devices()[:S])
    jf = shard_map(
        lambda v: jhead._assemble_argmax(v, jax.lax.axis_index("pipe") * Vs),
        mesh=mesh, in_specs=(P(None, "pipe"),), out_specs=P(), check_vma=False,
    )
    j = np.asarray(jf(jnp.asarray(vals)))
    stages = [Stage(torch.device("cpu"), 0, 0, [], {}, s * Vs) for s in range(S)]
    shards = [torch.from_numpy(vals[:, s * Vs : (s + 1) * Vs]) for s in range(S)]
    t = thead._assemble_argmax(stages, shards).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, vals.argmax(-1))
    assert list(t[:3]) == [1, 6, 4]


# ----------------------------------------------------- generate, schedules

@pytest.mark.parametrize("n", [2, 3, 4])
def test_pipeline_generate_equals_jax(tparams, prompts, jax_runs, n):
    p, plen = prompts
    stages = build_stages(CFG, tparams, tplace.PlacementSpec(SPECS[n], L), ["cpu"] * n)
    t = pipeline_generate(CFG, stages, p, MAX_NEW, prompt_len=plen)
    np.testing.assert_array_equal(t.tokens, jax_runs[n])
    one = tgenerate(CFG, tparams, p, MAX_NEW, prompt_len=plen)
    np.testing.assert_array_equal(t.tokens, one.tokens)
    np.testing.assert_array_equal(t.lengths, one.lengths)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_head_logits_match_jax_forward(tree, tparams, prompts, n):
    """Prefill logits through the chain and the vocab-sharded head against
    the JAX monolithic forward: 1e-4 absolute."""
    p, plen = prompts
    B, S = p.shape
    pos = np.where(np.arange(S)[None] < plen[:, None], np.arange(S)[None], 2**30).astype(np.int32)
    lj, _ = jllama.forward(CJ, jax.tree.map(jnp.asarray, tree), jnp.asarray(p),
                           jinit_cache(CJ, B, S, dtype=jnp.float32), jnp.asarray(pos))
    stages = build_stages(CFG, tparams, tplace.PlacementSpec(SPECS[n], L), ["cpu"] * n)
    caches = chain_caches(CFG, stages, B, S, torch.float32)
    pos_t = torch.from_numpy(pos)
    h = chain_forward(CFG, stages, thead.sp_embed(CFG, stages, torch.from_numpy(p), pos_t),
                      caches, pos_t)
    lt = thead.sp_logits(CFG, stages, h)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    ids = thead.sp_next_token(CFG, stages, h).numpy()
    np.testing.assert_array_equal(ids, np.asarray(lj).argmax(-1))


def test_interleaved_generate_equals_jax_and_seeded_rows(tparams, prompts, jax_runs):
    p, plen = prompts
    stages = build_stages(CFG, tparams, tplace.PlacementSpec(SPECS[2], L), ["cpu"] * 2)
    t = interleaved_generate(CFG, stages, p, MAX_NEW, prompt_len=plen)
    np.testing.assert_array_equal(t.tokens, jax_runs["many"])
    # a seeded row draws the port's generate(seed=) at batch 1; the greedy
    # rows beside it stay the greedy tokens
    temps, seeds = [0.0, 0.9, 0.0, 1.3], [0, 7, 0, 21]
    s = interleaved_generate(CFG, stages, p, MAX_NEW, prompt_len=plen, temperature=temps,
                             seeds=seeds, top_k=[0, 0, 0, 5], batch_per_slot=2)
    for r in range(4):
        if temps[r] > 0:
            one = tgenerate(CFG, tparams, p[r : r + 1, : plen[r]], MAX_NEW,
                            temperature=temps[r], seed=seeds[r], top_k=[0, 0, 0, 5][r])
            n = int(one.lengths[0])
            np.testing.assert_array_equal(s.tokens[r, plen[r] : plen[r] + n - plen[r]],
                                          one.tokens[0, plen[r] : n])
        else:
            np.testing.assert_array_equal(s.tokens[r], jax_runs["many"][r])
    with pytest.raises(ValueError, match="batch into groups of 2"):
        interleaved_generate(CFG, stages, p, MAX_NEW, batch_per_slot=1)


def test_gpt2_and_int8_head_pipeline_equal_jax():
    """GPT-2 (tied head, pos_embed on the first stage) at 2 stages, and an
    int8-quantized llama (layers and vocab tables) at a ragged 3."""
    cj, ct = jcfg.tiny_gpt2(num_hidden_layers=2, vocab_size=61), None
    ct = tcfg.tiny_gpt2(num_hidden_layers=2, vocab_size=61)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cj, jax.random.key(4), dtype=jnp.float32))
    p = np.random.default_rng(1).integers(1, 61, (2, 6)).astype(np.int32)
    je = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=2,
                        devices=jax.devices()[:2], cache_dtype=jnp.float32)
    te = Engine(ct, tgpt2.params_from_numpy(ct, tree, device="cpu"), num_stages=2,
                devices=["cpu"] * 2)
    assert te.num_stages == 2
    np.testing.assert_array_equal(te.generate_ids(p, 6).tokens, je.generate_ids(p, 6).tokens)

    qtree = jax.tree.map(np.asarray, jquant.quantize_params(
        jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, jllama.init_params(
            CJ, jax.random.key(12), dtype=jnp.float32))), quantize_head=True))
    spec = SPECS[3]
    je = PipelineEngine(CJ, jax.tree.map(jnp.asarray, qtree), placement=jplace.PlacementSpec(
        spec, L), devices=jax.devices()[:3], cache_dtype=jnp.float32)
    te = Engine(CFG, tllama.params_from_numpy(CFG, qtree, device="cpu"),
                placement=tplace.PlacementSpec(spec, L), devices=["cpu"] * 3)
    q = np.random.default_rng(2).integers(1, 67, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(te.generate_ids(q, 6).tokens, je.generate_ids(q, 6).tokens)


# ---------------------------------------------------------------- engine

def test_grouping_four_stages_on_two_devices(tree, tparams, prompts, jax_runs):
    p, plen = prompts
    je = PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=4,
                        devices=jax.devices()[:2], cache_dtype=jnp.float32)
    te = Engine(CFG, tparams, num_stages=4, devices=["cpu"] * 2)
    assert te.placement.stages == je.placement.stages
    assert te.exec_placement.stages == je.exec_placement.stages == ((0, 2), (2, 4))
    assert te.num_stages == 2
    np.testing.assert_array_equal(te.generate_ids(p, MAX_NEW, prompt_len=plen).tokens,
                                  jax_runs[2])
    # the stage devices: a chain longer than the list runs grouped
    assert len(stage_devices(4, ["cpu"] * 2)) == 2 and len(stage_devices(3, ["cpu"] * 2)) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            stage_devices(2)
        else:
            raise RuntimeError("no CUDA device (skipped: a GPU is present)")


def _swap_tally(m):
    h = m.REGISTRY.get("engine_placement_swap_seconds")
    return (m.REGISTRY.get("engine_placement_swaps_total").value, h._solo().snap()[2],
            m.REGISTRY.get("engine_pipeline_stages").value)


def test_apply_placement_and_swap_metrics_equal_jax(tree, tparams, prompts, jax_runs):
    p, plen = prompts
    for name, kind in (("engine_placement_swaps_total", "counter"),
                       ("engine_placement_swap_seconds", "histogram"),
                       ("engine_pipeline_stages", "gauge")):
        tf, jf = tmetrics.REGISTRY.get(name), jmetrics.REGISTRY.get(name)
        assert tf.kind == jf.kind == kind and tf.help == jf.help
        assert (tf.label_names, tf.buckets) == (jf.label_names, jf.buckets)
    t0, j0 = _swap_tally(tmetrics), _swap_tally(jmetrics)
    te = Engine(CFG, tparams, num_stages=2, devices=["cpu"] * 4)
    je = PipelineEngine(CJ, jax.tree.map(jnp.asarray, tree), num_stages=2,
                        devices=jax.devices()[:4], cache_dtype=jnp.float32)
    for spec in (SPECS[3], SPECS[4], SPECS[2]):
        te.apply_placement(tplace.PlacementSpec(spec, L))
        je.apply_placement(jplace.PlacementSpec(spec, L))
        assert te.exec_placement.stages == je.exec_placement.stages
        t1, j1 = _swap_tally(tmetrics), _swap_tally(jmetrics)
        assert (t1[0] - t0[0], t1[1] - t0[1], t1[2]) == (j1[0] - j0[0], j1[1] - j0[1], j1[2])
    np.testing.assert_array_equal(te.generate_ids(p, MAX_NEW, prompt_len=plen).tokens,
                                  jax_runs[2])
    with pytest.raises(ValueError) as a:
        te.apply_placement(tplace.PlacementSpec.balanced(3, 1))
    with pytest.raises(ValueError) as b:
        je.apply_placement(jplace.PlacementSpec.balanced(3, 1))
    assert str(a.value) == str(b.value)
    # an engine loaded straight onto its device has one device: any chain
    # runs there grouped as one stage, on the tensors it was given
    one = Engine(CFG, tparams)
    one.apply_placement(tplace.PlacementSpec.balanced(L, 2))
    assert one.placement.num_stages == 2 and one.exec_placement.stages == ((0, L),)
    assert one.num_stages == 1 and one.params["embed"] is tparams["embed"]
    with pytest.raises(ValueError, match="holds no one-device params"):
        te.params
