"""HF import and role-conditional stage loading in the port, against the
JAX package (and against HF's own torch models) on the CPU.

- ``ModelConfig.from_hf_config`` gives the JAX package's config (or its
  error) on every preset's HF dict and on the branch cases: qwen2, gemma,
  llama with and without ``rope_scaling``, gpt2; every preset equals the
  JAX one.
- ``params_from_hf`` gives the JAX package's arrays, byte for byte in
  bf16, on the ``state_dict`` of tiny llama, qwen2, gemma and gpt2 models
  built in-process (no download); and the port's f32 logits agree with
  the HF model's within the JAX package's own HF-test limits (2e-4
  absolute + 2e-3 relative; 3e-4 for GPT-2's longer GELU chain).
- ``python -m llm_sharding_tpu_torch convert`` on a ``save_pretrained``
  directory (safetensors, or torch ``.bin``) writes the same npz entries
  as the JAX package's ``convert``, at ``--dtype bf16|f32|int8|int4``,
  with and without ``--quantize-head``.
- ``load_stage`` over a 3-stage ragged split equals the JAX package's:
  which units each stage loads, the padded layers and ``layer_mask``; a
  padded stage's masked layers leave the hidden state and the KV as they
  were, dense and paged, as in the JAX package.

The HF parts skip without ``transformers``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu import cli as jcli
from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import POS_SENTINEL
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.utils import convert as jconvert
from llm_sharding_tpu.utils import shard_store as jstore
from llm_sharding_tpu_torch import cli as tcli
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import gpt2 as tgpt2
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.cache import init_cache as tinit_cache
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.utils import convert as tconvert
from llm_sharding_tpu_torch.utils import shard_store as tstore
from llm_sharding_tpu_torch.utils.convert import tensor_from_numpy

SENTINEL = int(POS_SENTINEL)
PRESETS = ["llama2_7b", "llama2_13b", "llama3_8b", "llama31_8b", "llama32_3b", "llama2_70b",
           "gpt2_small", "qwen25_7b", "gemma_2b", "gemma_7b", "tiny_qwen2", "tiny_llama",
           "tiny_gemma", "tiny_gpt2"]
_LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2)
HF_DICTS = {
    "llama-plain": dict(_LLAMA, model_type="llama"),
    "llama3-rope": dict(_LLAMA, model_type="llama", rope_scaling={
        "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192}, eos_token_id=[7, 9], tie_word_embeddings=True),
    "llama-rope-default": dict(_LLAMA, model_type="llama", rope_scaling={"type": "default"}),
    "llama-rope-yarn": dict(_LLAMA, model_type="llama", rope_scaling={"rope_type": "yarn"}),
    "llama-act-relu": dict(_LLAMA, model_type="llama", hidden_act="relu"),
    "qwen2": dict(_LLAMA, model_type="qwen2", rms_norm_eps=1e-6),
    "qwen2-sliding": dict(_LLAMA, model_type="qwen2", use_sliding_window=True),
    "gemma": dict(_LLAMA, model_type="gemma", head_dim=32, hidden_act="gelu_pytorch_tanh"),
    "gemma-hidden-activation": dict(_LLAMA, model_type="gemma", head_dim=32,
                                    hidden_activation="gelu", hidden_act=None),
    "gemma2": dict(_LLAMA, model_type="gemma", head_dim=32, final_logit_softcapping=30.0),
    "gpt2": dict(model_type="gpt2", n_embd=64, n_layer=2, n_head=4, n_positions=128),
    "gpt2-defaults": dict(model_type="gpt2"),
    "unknown": dict(model_type="mamba"),
}


def _depth(cfg, n):
    return dataclasses.replace(cfg, num_hidden_layers=n)


def _same(t: torch.Tensor, a) -> None:
    want = tensor_from_numpy(np.asarray(a))
    assert t.dtype == want.dtype and tuple(t.shape) == tuple(want.shape)
    bits = (lambda x: x.view(torch.int16)) if t.dtype == torch.bfloat16 else (lambda x: x)
    assert torch.equal(bits(t), bits(want))


def _same_store_files(a_dir, b_dir) -> None:
    names = sorted(f for f in os.listdir(a_dir) if f.endswith(".npz"))
    assert names and names == sorted(f for f in os.listdir(b_dir) if f.endswith(".npz"))
    for n in names:
        with np.load(os.path.join(a_dir, n)) as a, np.load(os.path.join(b_dir, n)) as b:
            assert a.files == b.files, n
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (n, k)
    with open(os.path.join(a_dir, "config.json")) as fa, open(os.path.join(b_dir, "config.json")) as fb:
        assert json.load(fa) == json.load(fb)


# ----------------------------------------------------------------- config


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_jax(preset):
    assert getattr(tcfg, preset)().to_json() == getattr(jcfg, preset)().to_json()


@pytest.mark.parametrize("case", list(HF_DICTS))
def test_from_hf_config_matches_jax(case):
    hf = HF_DICTS[case]
    try:
        want = jcfg.ModelConfig.from_hf_config(dict(hf))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcfg.ModelConfig.from_hf_config(dict(hf))
        assert str(got.value) == str(e)
        return
    assert tcfg.ModelConfig.from_hf_config(dict(hf)).to_json() == want.to_json()


# ------------------------------------------------------------- HF models


def _hf_model(family: str):
    """A tiny HF model of ``family`` with random weights, no download."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed({"llama": 1, "qwen2": 2, "gemma": 3, "gpt2": 4}[family])
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    if family == "llama":
        hf_cfg = transformers.LlamaConfig(**common, tie_word_embeddings=False, rope_theta=500000.0,
                                          rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                                        "low_freq_factor": 1.0,
                                                        "high_freq_factor": 4.0,
                                                        "original_max_position_embeddings": 64})
        model = transformers.LlamaForCausalLM(hf_cfg)
    elif family == "qwen2":
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**common, rms_norm_eps=1e-6))
    elif family == "gemma":
        model = transformers.GemmaForCausalLM(transformers.GemmaConfig(
            **common, head_dim=32, hidden_act="gelu_pytorch_tanh", rms_norm_eps=1e-6))
    else:
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128, n_inner=128,
            attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0))
    with torch.no_grad():  # non-zero biases so the converter's bias mapping counts
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.1)
    return model.eval()


FAMILIES = ["llama", "qwen2", "gemma", "gpt2"]


@pytest.fixture(scope="module", params=FAMILIES)
def hf(request):
    model = _hf_model(request.param)
    hf_dict = model.config.to_dict()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return request.param, model, hf_dict, sd


def test_params_from_hf_matches_jax(hf):
    _, _, hf_dict, sd = hf
    cj = jcfg.ModelConfig.from_hf_config(hf_dict)
    ct = tcfg.ModelConfig.from_hf_config(hf_dict)
    assert ct.to_json() == cj.to_json()
    want = jconvert.params_from_hf(cj, sd, dtype=jnp.bfloat16)
    got = tconvert.params_from_hf(ct, sd, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "layers":
            _same(got[k], v)
    for i in range(ct.num_hidden_layers):
        assert set(got["layers"][i]) == set(want["layers"])
        for k, v in want["layers"].items():
            _same(got["layers"][i][k], v[i])


def test_logits_match_hf_model(hf):
    family, model, hf_dict, sd = hf
    cfg = tcfg.ModelConfig.from_hf_config(hf_dict)
    params = tconvert.params_from_hf(cfg, sd, dtype=torch.float32, device="cpu")
    fwd = tgpt2.forward if family == "gpt2" else tllama.forward
    ids = np.random.default_rng(6).integers(0, 256, (2, 11)).astype(np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
    pos = torch.arange(11, dtype=torch.int32).expand(2, 11)
    logits, _ = fwd(cfg, params, torch.from_numpy(ids),
                    tinit_cache(cfg, 2, 11, dtype=torch.float32, device="cpu"), pos)
    atol = 3e-4 if family == "gpt2" else 2e-4
    np.testing.assert_allclose(logits.numpy(), ref, atol=atol, rtol=2e-3)


# ------------------------------------------------------------ convert CLI


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``save_pretrained`` directories: tiny untied llama (safetensors),
    qwen2 (torch .bin) and gpt2 (safetensors)."""
    out = {}
    for family, safe in (("llama", True), ("qwen2", False), ("gpt2", True)):
        d = str(tmp_path_factory.mktemp(f"hf_{family}"))
        _hf_model(family).save_pretrained(d, safe_serialization=safe)
        out[family] = d
    return out


CONVERTS = [("llama", ["--dtype", "bf16"]), ("llama", ["--dtype", "f32"]),
            ("llama", ["--dtype", "int8"]), ("llama", ["--dtype", "int4", "--quantize-head"]),
            ("qwen2", ["--dtype", "int8", "--quantize-head"]), ("gpt2", ["--dtype", "int4"]),
            ("gpt2", ["--dtype", "int8", "--quantize-head"])]


@pytest.mark.parametrize("family,flags", CONVERTS, ids=[f"{f}-{'-'.join(a[1:])}" for f, a in CONVERTS])
def test_convert_cli_matches_jax(checkpoints, tmp_path, capsys, family, flags):
    src = checkpoints[family]
    assert jcli.main(["convert", src, str(tmp_path / "jax"), *flags]) == 0
    want_msg = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    assert tcli.main(["convert", src, str(tmp_path / "port"), *flags]) == 0
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == want_msg
    _same_store_files(tmp_path / "jax", tmp_path / "port")
    cfg, params = tstore.load_full(str(tmp_path / "port"), dtype=None, device="cpu")
    quantized = flags[1] in ("int8", "int4")
    assert tquant.is_quantized(params["layers"][0]) == quantized
    assert isinstance(params["embed"], tquant.QTensor) == ("--quantize-head" in flags)


def test_convert_refuses_what_jax_refuses(tmp_path):
    src = tmp_path / "empty_model"
    src.mkdir()
    (src / "config.json").write_text(json.dumps({"model_type": "gpt2", "n_layer": 1}))
    with pytest.raises(FileNotFoundError):
        tcli.main(["convert", str(src), str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="--quantize-head requires --dtype int8 or int4"):
        tcli.main(["convert", str(src), str(tmp_path / "out"), "--quantize-head"])
    with pytest.raises(SystemExit, match="unknown dtype 'int9'"):
        tcli.main(["convert", str(src), str(tmp_path / "out"), "--dtype", "int9"])
    with pytest.raises(ValueError, match="mlp_bias"):
        tconvert.llama_layer_arrays(tcfg.tiny_llama(mlp_bias=True), {}.__getitem__, 0,
                                    torch.float32)


# ------------------------------------------------------- stages and masks

SPLIT = [(0, 1), (1, 3), (3, 4)]  # ragged: stages of 1, 2 and 1 layers


@pytest.fixture(scope="module")
def stage_store(tmp_path_factory):
    """A tied tiny llama store with int8 layers, written by the JAX package."""
    d = str(tmp_path_factory.mktemp("stages"))
    cfg = jcfg.tiny_llama()
    params = jquant.quantize_params(jllama.init_params(cfg, jax.random.key(4), dtype=jnp.float32))
    jstore.save_shards(cfg, params, d)
    return d


@pytest.mark.parametrize("start,end", SPLIT)
@pytest.mark.parametrize("user_facing", [None, True])
def test_load_stage_matches_jax(stage_store, start, end, user_facing):
    want = jstore.load_stage(stage_store, start, end, jnp.float32, user_facing=user_facing, pad_to=2)
    got = tstore.load_stage(stage_store, start, end, torch.float32, user_facing=user_facing,
                            pad_to=2, device="cpu")
    assert set(got) == set(want)
    assert (got["start"], got["end"]) == (start, end)
    np.testing.assert_array_equal(got["layer_mask"].numpy(), np.asarray(want["layer_mask"]))
    for k in set(want) - {"layers", "layer_mask", "start", "end"}:
        _same(got[k], want[k])
    assert len(got["layers"]) == 2
    for i, layer in enumerate(got["layers"]):
        for k, v in want["layers"].items():
            leaf = jax.tree.map(lambda a, i=i: a[i], v)
            if isinstance(leaf, jquant.QTensor):
                assert isinstance(layer[k], tquant.QTensor)
                _same(layer[k].q, leaf.q)
                _same(layer[k].scale, leaf.scale)
            else:
                _same(layer[k], leaf)
    with pytest.raises(ValueError, match="invalid layer range"):
        tstore.load_stage(stage_store, 3, 5, device="cpu")
    with pytest.raises(ValueError, match="pad_to"):
        tstore.load_stage(stage_store, 1, 3, pad_to=1, device="cpu")


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_masked_layers_match_jax(family):
    """Stage [1, 3) padded to 3 layers, its padding layer given real
    weights: the dense forward and the paged forward with ``layer_mask``
    equal the JAX package's, and equal the same layers run unpadded."""
    jm, tm = (jgpt2, tgpt2) if family == "gpt2" else (jllama, tllama)
    cj = jcfg.tiny_gpt2() if family == "gpt2" else jcfg.tiny_llama()
    ct = tcfg.ModelConfig.from_json(cj.to_json())
    tree = jax.tree.map(np.asarray, jm.init_params(cj, jax.random.key(5), dtype=jnp.float32))
    sub = {k: v[1:4] for k, v in tree["layers"].items()}  # two real layers + one padding
    pj = jax.tree.map(jnp.asarray, sub)
    pt = tconvert.params_from_numpy(_depth(ct, 3), {"layers": sub}, device="cpu")["layers"]
    mask = np.array([True, True, False])
    rng = np.random.default_rng(7)
    B, S, C = 2, 5, 8
    h = rng.normal(size=(B, S, cj.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    cfg3_j = _depth(cj, 3)
    hj, cache_j = jm.forward_layers(cfg3_j, pj, jnp.asarray(h), jinit_cache(cfg3_j, B, C, dtype=jnp.float32),
                                    jnp.asarray(pos), jnp.asarray(mask))
    cfg3 = _depth(ct, 3)
    cache_t = tinit_cache(cfg3, B, C, dtype=torch.float32, device="cpu")
    ht, cache_t = tm.forward_layers(cfg3, pt, torch.from_numpy(h), cache_t, torch.from_numpy(pos),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache_t.k.numpy(), np.asarray(cache_j.k), rtol=0, atol=1e-5)
    assert not cache_t.k[2].any() and not cache_t.v[2].any()  # the masked layer wrote nothing
    cfg2 = _depth(ct, 2)
    h2, _ = tm.forward_layers(cfg2, pt[:2], torch.from_numpy(h),
                              tinit_cache(cfg2, B, C, dtype=torch.float32, device="cpu"),
                              torch.from_numpy(pos))
    torch.testing.assert_close(ht, h2, rtol=0, atol=0)

    # paged: one decode step over a 6-block arena, block size 4
    NB, BS, Nkv, D = 6, 4, cj.num_key_value_heads, cj.head_dim_
    arena = rng.normal(size=(2, 3, NB, BS, Nkv, D)).astype(np.float32)
    tbl = np.array([[1, 2], [3, 4]], np.int32)
    kvpos = np.full((B, 8), SENTINEL, np.int32)
    kvpos[:, :5] = np.arange(5)
    cols = np.array([[5], [5]], np.int32)
    dpos = np.array([[5], [5]], np.int32)
    hd = rng.normal(size=(B, 1, cj.hidden_size)).astype(np.float32)
    oj, kj, vj, _, _ = jm.forward_layers_paged(
        cfg3_j, pj, jnp.asarray(hd), jnp.asarray(arena[0]), jnp.asarray(arena[1]), jnp.asarray(tbl),
        jnp.asarray(cols), jnp.asarray(kvpos), jnp.asarray(dpos), jnp.asarray(mask), backend="xla",
    )
    kt, vt = torch.from_numpy(arena[0].copy()), torch.from_numpy(arena[1].copy())
    ot = tm.forward_layers_paged(cfg3, pt, torch.from_numpy(hd), kt, vt, torch.from_numpy(tbl),
                                 torch.from_numpy(cols), torch.from_numpy(kvpos),
                                 torch.from_numpy(dpos), layer_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(kt[2].numpy(), arena[0][2])  # untouched by the masked layer
    np.testing.assert_array_equal(vt[2].numpy(), arena[1][2])
