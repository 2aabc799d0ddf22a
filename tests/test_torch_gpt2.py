"""The port's GPT-2 (``models/gpt2.py``) against the JAX package's on the
CPU, with the same weights carried over by ``params_from_numpy`` (biases
and LayerNorm gains made non-zero so every term counts).

- ``layer_norm``: f32 within 1e-6; bf16 within one bf16 ulp (2^-7
  relative) of the larger output, since XLA may keep the affine step's
  intermediate in f32 where the port rounds it, as the JAX code is written.
- Forward logits in f32 within 1e-5 absolute, raw and with int8 layers.
- ``forward_layers_paged`` (the plain paged paths, decode and a chunk)
  within 1e-5, the chunk's padding slots carrying the position sentinel
  through ``embed``: JAX clamps that gather index, and so must the port.
- Greedy ``generate`` streams and the paged server's streams, one-shot
  and chunked, token-identical to the JAX package's.
- A GPT-2 store keeps ``pos_embed`` and ``final_norm_bias`` both ways.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models.cache import POS_SENTINEL
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.ops import norms as jnorms
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu.utils import shard_store as jstore
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import gpt2 as tgpt2
from llm_sharding_tpu_torch.models.cache import init_cache as tinit_cache
from llm_sharding_tpu_torch.ops import norms as tnorms
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.utils import shard_store as tstore
from llm_sharding_tpu_torch.utils.convert import tensor_from_numpy

SENTINEL = int(POS_SENTINEL)
LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)


def _tree(cfg, seed=0, bits=None):
    """JAX GPT-2 f32 weights as numpy, with non-zero biases and gains;
    ``bits`` quantizes the layers' matmul weights."""
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for k, v in tree["layers"].items():
        if k.startswith("b_") or k.endswith("_b"):
            tree["layers"][k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif k.endswith("_w"):
            tree["layers"][k] = (1 + rng.normal(size=v.shape) * 0.1).astype(np.float32)
    tree["final_norm_bias"] = (rng.normal(size=tree["final_norm_bias"].shape) * 0.1).astype(np.float32)
    if bits:
        q = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), bits=bits)
        tree = jax.tree.map(np.asarray, q)
    return tree


@pytest.fixture(scope="module")
def models():
    cj, ct = jcfg.tiny_gpt2(), tcfg.tiny_gpt2()
    assert ct.to_json() == cj.to_json()
    tree = _tree(cj)
    return cj, ct, jax.tree.map(jnp.asarray, tree), tgpt2.params_from_numpy(ct, tree, device="cpu")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dt):
    rng = np.random.default_rng(1)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((3, 5, 64), (64,), (64,)))
    x = x * 3 + 1
    jargs = [jnp.asarray(a, getattr(jnp, dt)) for a in (x, w, b)]
    targs = [tensor_from_numpy(np.asarray(a)) for a in jargs]
    want = np.asarray(jnorms.layer_norm(*jargs, 1e-5)).astype(np.float32)
    got = tnorms.layer_norm(*targs, 1e-5)
    assert got.dtype == getattr(torch, dt)
    atol = 1e-6 if dt == "float32" else 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("bits", [None, 8], ids=["raw", "int8"])
def test_forward_logits_match_jax(bits):
    """Prefill of a right-padded batch (sentinel positions), then one
    decode step."""
    cj, ct = jcfg.tiny_gpt2(), tcfg.tiny_gpt2()
    tree = _tree(cj, seed=1, bits=bits)
    pj, pt = jax.tree.map(jnp.asarray, tree), tgpt2.params_from_numpy(ct, tree, device="cpu")
    assert isinstance(pt["layers"][0]["w_qkv"], tquant.QTensor) == bool(bits)
    rng = np.random.default_rng(2)
    B, S, C = 2, 9, 16
    ids = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 6:] = SENTINEL
    lj, cache_j = jgpt2.forward(cj, pj, jnp.asarray(ids), jinit_cache(cj, B, C, dtype=jnp.float32),
                                jnp.asarray(pos))
    lt, cache_t = tgpt2.forward(ct, pt, torch.from_numpy(ids),
                                tinit_cache(ct, B, C, dtype=torch.float32, device="cpu"),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    nxt, npos = np.array([[3], [7]], np.int32), np.array([[S], [6]], np.int32)
    lj, _ = jgpt2.forward(cj, pj, jnp.asarray(nxt), cache_j, jnp.asarray(npos))
    lt, _ = tgpt2.forward(ct, pt, torch.from_numpy(nxt), cache_t, torch.from_numpy(npos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["decode", "chunk"])
def test_forward_layers_paged_matches_jax(models, which):
    """Two rows over a 12-block arena (block size 4): the step's KV lands
    in the rows' blocks and attention reads them back. The chunk's last
    three slots of row 1 are padding (sentinel position), embedded like
    the server does it."""
    cj, ct, pj, pt = models
    rng = np.random.default_rng(3)
    L, NB, BS, Nh, D = cj.num_hidden_layers, 12, 4, cj.num_attention_heads, cj.head_dim_
    B, T = 2, 5
    S = 1 if which == "decode" else 8
    tbl = np.array([[3, 7, 1, 9, 0], [2, 11, 5, 0, 0]], np.int32)
    arena = rng.normal(size=(2, L, NB, BS, Nh, D)).astype(np.float32)
    written = np.array([9, 6])  # columns already holding keys
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    for b, n in enumerate(written):
        kvpos[b, :n] = np.arange(n)
    cols = written[:, None] + np.arange(S)[None]
    pos = cols.astype(np.int32)
    if which == "chunk":
        pos[1, S - 3 :] = SENTINEL
    kvpos[np.arange(B)[:, None], cols] = pos
    ids = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    hj = jgpt2.embed(pj, jnp.asarray(ids), jnp.asarray(pos))
    ht = tgpt2.embed(ct, pt, torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    oj, kj, vj, _, _ = jgpt2.forward_layers_paged(
        cj, pj["layers"], hj, jnp.asarray(arena[0]), jnp.asarray(arena[1]), jnp.asarray(tbl),
        jnp.asarray(cols.astype(np.int32)), jnp.asarray(kvpos), jnp.asarray(pos),
        backend="xla", prefill=which == "chunk",
    )
    kt, vt = torch.from_numpy(arena[0].copy()), torch.from_numpy(arena[1].copy())
    ot = tgpt2.forward_layers_paged(
        ct, pt["layers"], ht, kt, vt, torch.from_numpy(tbl), torch.from_numpy(cols),
        torch.from_numpy(kvpos), torch.from_numpy(pos), prefill=which == "chunk",
    )
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)
    live = tbl != 0  # the trash block takes colliding garbage on both sides
    for got, want in ((kt, kj), (vt, vj)):
        blocks = np.unique(tbl[live])
        np.testing.assert_allclose(got.numpy()[:, blocks], np.asarray(want)[:, blocks],
                                   rtol=0, atol=1e-5)


def test_block_hands_attention_contiguous_queries(models):
    """The fused qkv's thirds are strided views; the CUDA kernels refuse a
    non-contiguous query, so the block must hand over a contiguous one."""
    _, ct, _, pt = models
    seen = []

    def attn_fn(q, k, v):
        seen.append(q.is_contiguous())
        return q

    tgpt2.attn_mlp_block(ct, pt["layers"][0], torch.zeros(2, 3, ct.hidden_size), attn_fn)
    assert seen == [True]


def test_generate_matches_jax(models):
    cj, ct, pj, pt = models
    prompt = np.random.default_rng(4).integers(0, 256, (2, 11)).astype(np.int32)
    plen = np.array([11, 7])
    want = jgenerate(cj, pj, prompt, 14, prompt_len=plen, cache_dtype=jnp.float32)
    got = tgenerate(ct, pt, prompt, 14, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def _staggered(srv, prompts) -> list:
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return reqs


@pytest.mark.parametrize("prefill_chunk", [None, 8], ids=["one_shot", "chunked"])
def test_served_streams_match_jax(models, prefill_chunk):
    """The port's paged server against the JAX ``PipelineServer`` on the
    same weights, and both against the port's ``generate``."""
    cj, ct, pj, pt = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENS]
    kw = dict(capacity=64, kv_block_size=4, kv_blocks=40, prefill_chunk=prefill_chunk)
    jeng = PipelineEngine(cj, pj, num_stages=1, cache_dtype=jnp.float32)
    jsrv = jeng.serve(batch_per_slot=1, paged_attn="xla", **kw)
    want = [list(r.tokens) for r in _staggered(jsrv, prompts)]
    jsrv.close()
    srv = Engine(ct, pt).serve(batch_per_slot=3, **kw)
    got = _staggered(srv, prompts)
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    assert [r.tokens for r in got] == want
    for p, m, toks in zip(prompts, MAX_NEW, want):
        res = tgenerate(ct, pt, p, m)
        assert res.tokens[0, len(p) : res.lengths[0]].tolist() == toks


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_gpt2_store_keeps_pos_embed_and_final_norm_bias(tmp_path, dt):
    """The port's writer keeps the GPT-2 tables (it once wrote only
    ``embed`` and ``final_norm``); the JAX package reads them back, and a
    JAX-written GPT-2 store loads in the port."""
    ct = tcfg.tiny_gpt2(num_hidden_layers=2)
    params = tgpt2.init_params(ct, seed=2, dtype=getattr(torch, dt), device="cpu")
    params["final_norm_bias"] = torch.full_like(params["final_norm_bias"], 0.25)
    tstore.save_shards(ct, params, str(tmp_path / "port"))
    with np.load(tmp_path / "port" / "embedding.npz") as z:
        assert "pos_embed" in z.files
    with np.load(tmp_path / "port" / "final_norm.npz") as z:
        assert "final_norm_bias" in z.files
    cj, got = jstore.load_full(str(tmp_path / "port"), dtype=getattr(jnp, dt))
    assert cj == jcfg.tiny_gpt2(num_hidden_layers=2)
    for k in ("embed", "pos_embed", "final_norm", "final_norm_bias"):
        want = tensor_from_numpy(np.asarray(got[k]))
        assert torch.equal(params[k].float(), want.float()) and params[k].dtype == want.dtype

    jparams = jgpt2.init_params(cj, jax.random.key(3), dtype=getattr(jnp, dt))
    jstore.save_shards(cj, jparams, str(tmp_path / "jax"))
    _, back = tstore.load_full(str(tmp_path / "jax"), dtype=None, device="cpu")
    for k in ("embed", "pos_embed", "final_norm", "final_norm_bias"):
        assert torch.equal(back[k].float(), tensor_from_numpy(np.asarray(jparams[k])).float())
    for i in range(2):
        for k, v in jparams["layers"].items():
            assert torch.equal(back["layers"][i][k].float(),
                               tensor_from_numpy(np.asarray(v[i])).float())
