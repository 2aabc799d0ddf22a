"""gemma-1 in the port against the JAX package on the CPU: head dim 256,
in the three kernels' plain versions and through the whole served path.

- Kernels: the port's plain versions of flash, paged decode (S = 1 and the
  verify shape S = 3) and chunked prefill at D = 256, at gemma-2B's G = 8
  and gemma-7B's G = 1, against the JAX Pallas kernels in interpret mode;
  the two paged kernels also over int8 and fp8 arenas with scales. The
  wrappers reach the plain versions because the tensors lie on the CPU;
  the CUDA kernels at D = 256 are held against the same plain versions on
  the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
  Tolerances: float32 1e-5 (summation order differs), bfloat16 2e-2 (one
  bf16 ulp of outputs of magnitude ~1-2), as ``tests/test_torch_kernels.py``.
- Model: ``tiny_gemma`` at head dim 256 (G = 8, and a G = 1 variant), the
  same weights carried over by ``params_from_numpy``: float32 logits within
  1e-4 of the JAX model's, greedy ``generate`` token-exact against JAX
  ``generate``, and the port's ``PipelineServer`` (paged; one-shot and
  chunked admissions in one workload; bf16, int8 and fp8 arenas)
  token-exact against the JAX ``PipelineServer``.
- Gates: the kernels' input check takes head dim 256 and still refuses
  others.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import POS_SENTINEL
from llm_sharding_tpu.models.cache import init_cache as jinit_cache
from llm_sharding_tpu.ops import flash_attention as jfa
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.cache import init_cache as tinit_cache
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import kernels
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate

SENTINEL = int(POS_SENTINEL)
D = 256
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# (KV heads, query heads per KV head): gemma-2B's MQA and gemma-7B's MHA
GQA = {"G8": (1, 8), "G1": (2, 1)}


def _pair(a, dt):
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a)).to(tdt)


def _ints(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a, np.int32))


def _close(got, want, atol, rows=None):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        g, w = g[rows], w[rows]
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("gqa", list(GQA))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_plain_matches_pallas_interpret(monkeypatch, dt, gqa):
    """A right-padded prompt (sentinel query rows and KV tail) over several
    query and KV blocks; C a multiple of BLOCK_K, so the JAX kernel adds no
    padding columns to the sentinel rows' average (``ROADMAP.md`` §C 3)."""
    monkeypatch.setattr(jfa, "BLOCK_Q", 16)
    monkeypatch.setattr(jfa, "BLOCK_K", 32)
    Nkv, G = GQA[gqa]
    rng = np.random.default_rng(60)
    B, S, C = 2, 24, 64
    qpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    qpos[1, 17:] = SENTINEL
    kvpos = np.full((B, C), SENTINEL, np.int32)
    kvpos[0, :S] = np.arange(S)
    kvpos[1, :17] = np.arange(17)
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jqp, tqp), (jkp, tkp) = _ints(qpos), _ints(kvpos)
    want = jfa.flash_attention(jq, jk, jv, jqp, jkp, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, tqp, tkp)
    _close(got, want, DTYPES[dt][2])


def _arena(rng, NB, BS, Nkv):
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.inf  # the shared trash block holds garbage
    return k, v


def _decode_layout(S):
    """Two rows over a 4-entry table (block size 8): a trash hole inside
    row 0's window, row 1's tail trash-mapped."""
    B, BS, T = 2, 8, 4
    tbl = np.array([[3, 0, 5, 8], [7, 2, 0, 0]], np.int32)
    lengths = [3 * BS + 2, BS + 5]
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    kvpos[0, :BS] = np.arange(BS)
    kvpos[0, 2 * BS : 3 * BS + 2] = np.arange(BS, lengths[0] - BS)
    kvpos[1, : lengths[1]] = np.arange(lengths[1])
    qpos = np.array([[n - S + i for i in range(S)] for n in (lengths[0] - BS, lengths[1])],
                    np.int32)
    return tbl, qpos, kvpos, None


def _prefill_layout(S):
    """A chunk of S queries per row, each row stopped at its written
    frontier (nlive) while later blocks hold stale data; sentinel padding
    rows at the end of row 0's chunk."""
    B, BS, T = 2, 8, 5
    tbl = np.array([[4, 9, 1, 6, 0], [2, 11, 3, 5, 10]], np.int32)
    frontier = [14, 36]
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, f in enumerate(frontier):
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - S, f)
    qpos[0, S - 2 :] = SENTINEL
    nlive = np.array([-(-f // BS) for f in frontier], np.int32)
    return tbl, qpos, kvpos, nlive


@pytest.mark.parametrize("gqa", list(GQA))
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_decode_plain_matches_pallas_interpret(dt, S, gqa):
    """Decode (S = 1) and the verify shape (S = 3), NaN/Inf in trash block 0."""
    Nkv, G = GQA[gqa]
    rng = np.random.default_rng(61)
    k, v = _arena(rng, 10, 8, Nkv)
    tbl, qpos, kvpos, _ = _decode_layout(S)
    q = rng.normal(size=(2, S, Nkv * G, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jt, tt), (jqp, tqp), (jkp, tkp) = _ints(tbl), _ints(qpos), _ints(kvpos)
    want = jpa.paged_attention_tpu(jq, jk, jv, jt, jqp, jkp, interpret=True, blocks_per_step=1)
    got = tpa.paged_attention(tq, tk, tv, tt, tqp, tkp)
    _close(got, want, DTYPES[dt][2])


@pytest.mark.parametrize("gqa", list(GQA))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_prefill_plain_matches_pallas_interpret(monkeypatch, dt, gqa):
    """A 12-token chunk per row; the sentinel rows are left out (the JAX
    kernel bounds them at nlive, the plain version reads the window)."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    Nkv, G = GQA[gqa]
    rng = np.random.default_rng(62)
    k, v = _arena(rng, 12, 8, Nkv)
    tbl, qpos, kvpos, nlive = _prefill_layout(12)
    q = rng.normal(size=(2, 12, Nkv * G, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jt, tt), (jqp, tqp), (jkp, tkp), (jnl, tnl) = map(_ints, (tbl, qpos, kvpos, nlive))
    want = jpa.paged_prefill_tpu(jq, jk, jv, jt, jqp, jkp, interpret=True, nlive=jnl,
                                 blocks_per_step=1)
    got = tpa.paged_prefill(tq, tk, tv, tt, tqp, tkp, nlive=tnl)
    _close(got, want, DTYPES[dt][2], rows=qpos < SENTINEL)


def _np_bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _quantized_arena(rng, jdt, NB, BS, Nkv):
    """Codes and per-(block, KV head) scales of random K/V; trash block 0
    has 0x7F codes (NaN for fp8) and an Inf scale."""
    out = []
    for _ in range(2):
        x = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
        sc = (np.abs(x).max(axis=(1, 3)) / jquant.kv_qmax(jdt)).astype(np.float32)
        codes = np.array(_np_bytes(
            jquant.kv_quantize(jnp.asarray(x), jnp.asarray(sc[:, None, :, None]), jdt)))
        codes[0] = 0x7F
        sc[0] = np.inf
        out += [codes, sc]
    return out


@pytest.mark.parametrize("gqa", list(GQA))
@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
def test_quantized_paged_plain_matches_pallas_interpret(monkeypatch, which, kv, gqa):
    """f32 queries over int8 / fp8 arenas with scales: decode (S = 1),
    verify (S = 3) and a chunk, against the JAX kernels in interpret mode."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    jdt, tdt = KV[kv]
    Nkv, G = GQA[gqa]
    rng = np.random.default_rng(63)
    kc, ks, vc, vs = _quantized_arena(rng, jdt, 12, 8, Nkv)
    S = {"decode": 1, "verify": 3, "prefill": 12}[which]
    tbl, qpos, kvpos, nlive = (_prefill_layout if which == "prefill" else _decode_layout)(S)
    q = rng.normal(size=(2, S, Nkv * G, D)).astype(np.float32)
    jcodes = [jax.lax.bitcast_convert_type(jnp.asarray(c), jdt) for c in (kc, vc)]
    tcodes = [torch.from_numpy(c).view(tdt) for c in (kc, vc)]
    jargs = (jnp.asarray(q), *jcodes, jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvpos))
    targs = (torch.from_numpy(q), *tcodes, torch.from_numpy(tbl), torch.from_numpy(qpos),
             torch.from_numpy(kvpos))
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    if which == "prefill":
        want = jpa.paged_prefill(*jargs, backend="interpret", nlive=jnp.asarray(nlive), **jsc)
        got = tpa.paged_prefill(*targs, nlive=torch.from_numpy(nlive), **tsc)
        rows = qpos < SENTINEL
    else:
        want = jpa.paged_attention(*jargs, backend="interpret", **jsc)
        got = tpa.paged_attention(*targs, **tsc)
        rows = None
    _close(got, want, 1e-5, rows=rows)


@pytest.mark.parametrize("ok", [64, 128, 256])
def test_kernel_gate_takes_head_dim_256(ok):
    """The wrappers' shared check accepts every instantiated head dim and
    refuses any other (96: gemma-7B's 3072 / 32 would be one)."""
    def qkv(d):
        return torch.zeros(1, 4, 8, d), torch.zeros(1, 4, 1, d), torch.zeros(1, 4, 1, d)

    assert kernels.check_attention_inputs(*qkv(ok)) == 0
    for bad in (96, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            kernels.check_attention_inputs(*qkv(bad))


# ------------------------------------------------------------------- model

# tiny gemma at head dim 256: 8 query heads over 1 KV head (gemma-2B's G),
# and a G = 1 variant (gemma-7B's)
MODELS = {"G8": dict(num_attention_heads=8, num_key_value_heads=1),
          "G1": dict(num_attention_heads=4, num_key_value_heads=4)}


@pytest.fixture(scope="module", params=list(MODELS))
def gemma(request):
    kw = dict(head_dim=D, num_hidden_layers=2, **MODELS[request.param])
    cj, ct = jcfg.tiny_gemma(**kw), tcfg.tiny_gemma(**kw)
    assert ct.head_dim_ == D and ct.to_json() == cj.to_json()
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(5), dtype=jnp.float32))
    pj = jax.tree.map(jnp.asarray, tree)
    pt = tllama.params_from_numpy(ct, tree, device="cpu")
    return cj, ct, pj, pt


def test_forward_logits_match_jax(gemma):
    """Prefill of a right-padded batch, then one decode step."""
    cj, ct, pj, pt = gemma
    rng = np.random.default_rng(64)
    B, S, C = 2, 9, 16
    ids = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 6:] = SENTINEL
    cache_j = jinit_cache(cj, B, C, dtype=jnp.float32)
    cache_t = tinit_cache(ct, B, C, dtype=torch.float32, device="cpu")
    lj, cache_j = jllama.forward(cj, pj, jnp.asarray(ids), cache_j, jnp.asarray(pos))
    lt, cache_t = tllama.forward(ct, pt, torch.from_numpy(ids), cache_t, torch.from_numpy(pos))
    real = pos < SENTINEL
    np.testing.assert_allclose(lt.numpy()[real], np.asarray(lj)[real], atol=1e-4)
    nxt, npos = np.array([[3], [7]], np.int32), np.array([[S], [6]], np.int32)
    lj, _ = jllama.forward(cj, pj, jnp.asarray(nxt), cache_j, jnp.asarray(npos))
    lt, _ = tllama.forward(ct, pt, torch.from_numpy(nxt), cache_t, torch.from_numpy(npos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


def test_generate_greedy_tokens_match_jax(gemma):
    cj, ct, pj, pt = gemma
    prompt = np.random.default_rng(65).integers(0, 256, (2, 11)).astype(np.int32)
    plen = np.array([11, 7])
    want = jgenerate(cj, pj, prompt, 12, prompt_len=plen, cache_dtype=jnp.float32)
    got = tgenerate(ct, pt, prompt, 12, prompt_len=plen)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


# prompts 5 and 3 fit the 8-token chunk (one-shot admission); 20 and 30
# are admitted in chunks of 8; the last three join mid-decode
LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)


def _staggered(srv, prompts) -> list:
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return reqs


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_served_streams_match_jax_server(gemma, kv):
    """Staggered submits through ``Engine.serve`` (block size 4, chunk 8)
    against the JAX ``PipelineServer`` (one row, so every request's arena
    history is its own on both sides; the port serves three rows). With
    the engine's own arena both also equal JAX ``generate``."""
    cj, ct, pj, pt = gemma
    rng = np.random.default_rng(66)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENS]
    kw = dict(capacity=64, kv_block_size=4, kv_blocks=40, prefill_chunk=8, kv_dtype=kv)
    jeng = PipelineEngine(cj, pj, num_stages=1, cache_dtype=jnp.float32)
    jsrv = jeng.serve(batch_per_slot=1, paged_attn="xla", **kw)
    want = [list(r.tokens) for r in _staggered(jsrv, prompts)]
    jsrv.close()
    srv = Engine(ct, pt).serve(batch_per_slot=3, **kw)
    reqs = _staggered(srv, prompts)
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    assert [r.done for r in reqs] == [True] * len(reqs)
    assert [list(r.tokens) for r in reqs] == want
    if kv == "bf16":
        for p, m, w in zip(prompts, MAX_NEW, want):
            r = jgenerate(cj, pj, p, m, cache_dtype=jnp.float32)
            assert np.asarray(r.tokens)[0, len(p) : int(r.lengths[0])].tolist() == w
