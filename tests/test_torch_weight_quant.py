"""Quantized weights in the port (int8 ``QTensor``, int4 ``Int4QTensor``)
against the JAX package on the CPU.

- ``quantize_tensor`` gives the same BYTES (codes and scales) as the JAX
  function at bits 8 and 4, bf16 and f32, both contract axes; the int4
  nibble packing is byte-equal too, an odd last axis included.
- ``qmatmul``, ``embed_rows``, ``head_logits``, ``tied_logits`` and
  ``dequantize`` agree with the JAX helpers in f32 to 1e-6 absolute (the
  dot sums in another order).
- A store the JAX package writes from ``quantize_params`` (int8 and int4,
  with and without ``quantize_head``) loads in the port into the same
  arrays, codes int8 and scales in the load dtype, and the port writes
  the same npz entries back; a store the port writes loads in the JAX
  package into the same arrays.
- On ``tiny_llama`` with such weights, forward logits equal the JAX
  package's in f32 (1e-5 absolute) and greedy ``generate`` streams are
  token-identical; the paged server's streams from an int8 store equal
  the JAX ``PipelineServer(paged_attn="xla")``'s, one-shot and chunked.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu.utils import shard_store as jstore
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.cache import init_cache as tinit_cache
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.utils import shard_store as tstore
from llm_sharding_tpu_torch.utils.convert import tensor_from_numpy

STORES = [(8, False), (8, True), (4, False), (4, True)]
STORE_IDS = ["int8", "int8-head", "int4", "int4-head"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(t: torch.Tensor, a) -> None:
    """Same dtype, shape and bytes."""
    want = tensor_from_numpy(np.asarray(a))
    assert t.dtype == want.dtype and tuple(t.shape) == tuple(want.shape)
    assert torch.equal(_bits(t), _bits(want))


def _same_leaf(t, a) -> None:
    if isinstance(a, jquant.QTensor):
        assert isinstance(t, tquant.QTensor)
        assert isinstance(t, tquant.Int4QTensor) == isinstance(a, jquant.Int4QTensor)
        _same(t.q, a.q)
        _same(t.scale, a.scale)
    else:
        assert not isinstance(t, tquant.QTensor)
        _same(t, a)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_store_files(a_dir, b_dir) -> None:
    """Every npz of two stores holds the same entries, in the same order,
    with the same dtypes and bytes."""
    names = sorted(f for f in os.listdir(a_dir) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(b_dir) if f.endswith(".npz"))
    for n in names:
        a, b = _npz(os.path.join(a_dir, n)), _npz(os.path.join(b_dir, n))
        assert list(a) == list(b), n
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (n, k)
            assert a[k].tobytes() == b[k].tobytes(), (n, k)


# ------------------------------------------------------------- quantizer


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_tensor_matches_jax(dt, bits, axis):
    """Byte-equal codes and scales, all-zero channels (the safe
    denominator) included."""
    rng = np.random.default_rng(bits * 10 + axis)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32) * 2
    w[0, :, 5] = 0.0
    w[1, 7, :] = 0.0
    wj = jnp.asarray(w, getattr(jnp, dt))
    qj = jquant.quantize_tensor(wj, contract_axis=axis, bits=bits)
    qt = tquant.quantize_tensor(tensor_from_numpy(np.asarray(wj)), contract_axis=axis, bits=bits)
    _same_leaf(qt, qj)


@pytest.mark.parametrize("last", [6, 7, 1])
def test_int4_packing_matches_jax(last):
    """Low nibble = even index; an odd last axis is padded on disk and cut
    on load."""
    from llm_sharding_tpu_torch.utils.shard_store import _pack_int4, _unpack_int4

    a = np.random.default_rng(last).integers(-8, 8, size=(3, 5, last)).astype(np.int8)
    packed = _pack_int4(a)
    assert packed.tobytes() == jstore._pack_int4(a).tobytes() and packed.dtype == np.int8
    back = _unpack_int4(packed, last)
    np.testing.assert_array_equal(back, jstore._unpack_int4(packed, last))
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_helpers_match_jax(bits):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    table = rng.normal(size=(50, 32)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 3)).astype(np.int32)
    wj, tj = (jquant.quantize_tensor(jnp.asarray(w), bits=bits),
              jquant.quantize_tensor(jnp.asarray(table), contract_axis=-1, bits=bits))
    wt, tt = (tquant.quantize_tensor(torch.from_numpy(w), bits=bits),
              tquant.quantize_tensor(torch.from_numpy(table), contract_axis=-1, bits=bits))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jquant.qmatmul(xj, wj), tquant.qmatmul(xt, wt)),
        (jquant.head_logits(xj, wj), tquant.head_logits(xt, wt)),
        (jquant.tied_logits(xj, tj), tquant.tied_logits(xt, tt)),
        (jquant.embed_rows(tj, jnp.asarray(ids)), tquant.embed_rows(tt, torch.from_numpy(ids))),
        (jquant.dequantize(wj), tquant.dequantize(wt)),
        (jquant.dequantize(tj, -1), tquant.dequantize(tt, -1)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert tquant.out_dim(wt) == 48 and tquant.base(wt) is wt.q
    assert tquant.act_dtype(tt) == torch.float32 and tquant.is_quantized({"wq": wt})


# ------------------------------------------------------------ shard store


def _jax_quantized(cfg, bits, head, dtype=jnp.float32, seed=0):
    params = jllama.init_params(cfg, jax.random.key(seed), dtype=dtype)
    return jquant.quantize_params(params, quantize_head=head, bits=bits)


@pytest.mark.parametrize("bits,head", STORES, ids=STORE_IDS)
def test_jax_quantized_store_loads_in_port(tmp_path, bits, head):
    """Same arrays (codes int8, scales bf16 as written), and the port
    writes the same npz entries back."""
    cfg = jcfg.tiny_llama(num_hidden_layers=2, tie_word_embeddings=False)
    params = _jax_quantized(cfg, bits, head, dtype=jnp.bfloat16)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jstore.save_shards(cfg, params, str(jdir))
    ct, got = tstore.load_full(str(jdir), dtype=None, device="cpu")
    assert ct == tcfg.tiny_llama(num_hidden_layers=2, tie_word_embeddings=False)
    for k in ("embed", "final_norm", "lm_head"):
        _same_leaf(got[k], params[k])
    for i in range(2):
        assert set(got["layers"][i]) == set(params["layers"])
        for k, v in params["layers"].items():
            _same_leaf(got["layers"][i][k], jax.tree.map(lambda a, i=i: a[i], v))
    tstore.save_shards(ct, got, str(tdir))
    _same_store_files(jdir, tdir)


@pytest.mark.parametrize("bits,head", STORES, ids=STORE_IDS)
def test_port_quantized_store_loads_in_jax(tmp_path, bits, head):
    cfg = tcfg.tiny_qwen2(num_hidden_layers=2, tie_word_embeddings=False)
    params = tquant.quantize_params(
        tllama.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu"),
        quantize_head=head, bits=bits,
    )
    tstore.save_shards(cfg, params, str(tmp_path))
    cj, got = jstore.load_full(str(tmp_path), dtype=jnp.bfloat16)
    assert cj == jcfg.tiny_qwen2(num_hidden_layers=2, tie_word_embeddings=False)
    for k in ("embed", "final_norm", "lm_head"):
        _same_leaf(params[k], got[k])
    for i in range(2):
        for k, v in got["layers"].items():
            _same_leaf(params["layers"][i][k], jax.tree.map(lambda a, i=i: a[i], v))


def test_load_keeps_codes_int8_and_casts_scales(tmp_path):
    """Loading with a dtype casts raw tensors and scales, never the codes."""
    cfg = jcfg.tiny_llama(num_hidden_layers=1)
    jstore.save_shards(cfg, _jax_quantized(cfg, 8, True, dtype=jnp.bfloat16), str(tmp_path))
    _, got = tstore.load_full(str(tmp_path), dtype=torch.float32, device="cpu")
    wq, emb = got["layers"][0]["wq"], got["embed"]
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert emb.q.dtype == torch.int8 and emb.scale.dtype == torch.float32
    assert got["layers"][0]["input_norm"].dtype == torch.float32


def test_engine_takes_dtype_and_device_from_a_quantized_table():
    """With ``quantize_head`` the embedding is a QTensor: the engine's
    compute dtype is its scale's, not the int8 codes'."""
    cfg = tcfg.tiny_llama(num_hidden_layers=1)
    params = tquant.quantize_params(
        tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu"), quantize_head=True
    )
    eng = Engine(cfg, params)
    assert eng.cache_dtype == torch.float32 and eng.device == torch.device("cpu")
    srv = eng.serve(capacity=32, kv_block_size=4, kv_blocks=10)
    assert srv.state.k.dtype == torch.float32


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module", params=STORES, ids=STORE_IDS)
def models(request):
    """tiny_llama f32 weights quantized by the JAX package, carried into
    the port."""
    bits, head = request.param
    cfg = jcfg.tiny_llama(tie_word_embeddings=not head)
    pj = _jax_quantized(cfg, bits, head, seed=1)
    tree = jax.tree.map(np.asarray, pj)
    ct = tcfg.tiny_llama(tie_word_embeddings=not head)
    return cfg, ct, pj, tllama.params_from_numpy(ct, tree, device="cpu")


def test_quantized_forward_logits_match_jax(models):
    cj, ct, pj, pt = models
    assert isinstance(pt["layers"][0]["wq"], tquant.QTensor)
    rng = np.random.default_rng(2)
    B, S, C = 2, 9, 16
    ids = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 6:] = 2**30
    lj, cache_j = jllama.forward(cj, pj, jnp.asarray(ids), jinit_cache(cj, B, C, dtype=jnp.float32),
                                 jnp.asarray(pos))
    lt, cache_t = tllama.forward(ct, pt, torch.from_numpy(ids),
                                 tinit_cache(ct, B, C, dtype=torch.float32, device="cpu"),
                                 torch.from_numpy(pos))
    real = pos < 2**30
    np.testing.assert_allclose(lt.numpy()[real], np.asarray(lj)[real], rtol=0, atol=1e-5)
    nxt, npos = np.array([[3], [7]], np.int32), np.array([[S], [6]], np.int32)
    lj, _ = jllama.forward(cj, pj, jnp.asarray(nxt), cache_j, jnp.asarray(npos))
    lt, _ = tllama.forward(ct, pt, torch.from_numpy(nxt), cache_t, torch.from_numpy(npos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)


def test_quantized_generate_matches_jax(models):
    cj, ct, pj, pt = models
    prompt = np.random.default_rng(3).integers(0, 256, (2, 11)).astype(np.int32)
    plen = np.array([11, 7])
    want = jgenerate(cj, pj, prompt, 14, prompt_len=plen, cache_dtype=jnp.float32)
    got = tgenerate(ct, pt, prompt, 14, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


# ------------------------------------------------------------------ serve

LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)


@pytest.fixture(scope="module")
def int8_store(tmp_path_factory):
    """An int8 store (layers and head) the JAX package wrote, loaded by
    both packages in f32."""
    d = str(tmp_path_factory.mktemp("int8_store"))
    cfg = jcfg.tiny_llama()
    jstore.save_shards(cfg, _jax_quantized(cfg, 8, True, seed=2), d)
    jeng = PipelineEngine.from_shards(d, num_stages=1, dtype=jnp.float32, cache_dtype=jnp.float32)
    eng = Engine.from_shards(d, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    return eng, jeng, [rng.integers(0, 256, n).astype(np.int32) for n in LENS]


def _staggered(srv, prompts) -> list:
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return reqs


@pytest.mark.parametrize("prefill_chunk", [None, 8], ids=["one_shot", "chunked"])
def test_int8_store_served_streams_match_jax_server(int8_store, prefill_chunk):
    eng, jeng, prompts = int8_store
    assert isinstance(eng.params["embed"], tquant.QTensor)
    kw = dict(capacity=64, kv_block_size=4, kv_blocks=40, prefill_chunk=prefill_chunk)
    jsrv = jeng.serve(batch_per_slot=1, paged_attn="xla", **kw)
    want = [list(r.tokens) for r in _staggered(jsrv, prompts)]
    jsrv.close()
    srv = eng.serve(batch_per_slot=3, **kw)
    got = _staggered(srv, prompts)
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    assert [r.tokens for r in got] == want
