"""Quantized-KV serving in the port (int8 / fp8-e4m3 arenas with
per-(block, KV head) f32 scales) against the JAX package on the CPU.

- The quantizer, the running-max arena write and the one-shot admission
  scatter write the same BYTES as the JAX package's (fp8 compared as
  ``uint8`` views). The admission case reuses a block whose old scale was
  larger: its scale must be reset to the new content's, not kept.
- The plain versions of the quantized decode and chunked-prefill kernels
  (f32 queries, NaN codes and an Inf scale in trash block 0) are within
  1e-5 of the JAX package's own Pallas kernels run in interpret mode, on
  rows that see a key (summation order differs).
- The served greedy streams of ``Engine.serve(kv_dtype=)`` equal the JAX
  ``PipelineServer``'s on the same ``tiny_llama`` f32 weights, one-shot
  and chunked. Both sides quantize byte for byte alike; a mismatch passes
  only at a near tie, a top-2 logit gap < 1e-3 at the first differing
  token, measured on the port's run (the JAX server exposes no logits)
  and printed.
- Against the port's own unquantized server, quantized rollouts complete
  and match >= 0.5 of the tokens (the floor of the JAX package's
  ``tests/test_kv_quant.py``: tiny random weights are near-tied
  everywhere, the worst case for quantization drift).
"""

import collections

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.models.cache import POS_SENTINEL
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu.parallel import serve as jserve
from llm_sharding_tpu.runtime.blocks import BlockAllocator as JBlockAllocator
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime import server as tserver
from llm_sharding_tpu_torch.runtime.blocks import BlockAllocator
from llm_sharding_tpu_torch.runtime.engine import Engine

SENTINEL = int(POS_SENTINEL)
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)
NEAR_TIE = 1e-3


def _np_bytes(a) -> np.ndarray:
    """The raw bytes of a JAX or torch array (1-byte dtypes as uint8)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _to_torch(a, dtype) -> torch.Tensor:
    """numpy/JAX codes → a fresh torch tensor of ``dtype`` with the same bytes."""
    t = torch.from_numpy(np.array(_np_bytes(a)))
    return t.view(dtype) if dtype in (torch.int8, torch.float8_e4m3fn) else t.to(dtype)


# ------------------------------------------------------------- quantizer


@pytest.mark.parametrize("kv", list(KV))
def test_kv_quantize_matches_jax(kv):
    """Identical codes (ties at .5 steps, clipping, a zero scale) and
    identical dequantized f32 values."""
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(20)
    x = rng.normal(size=(5, 4, 2, 16)).astype(np.float32) * 3
    scale = (np.abs(x).max(axis=(1, 3)) / jquant.kv_qmax(jdt)).astype(np.float32)
    scale[0, 0] = 0.0  # virgin block: zeros quantize to zeros
    x[0, :, 0] = 0.0
    x[1, 0, 1, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) * scale[1, 1]  # half steps
    scale[2] *= 0.5  # values past the code range clip
    sc = scale[:, None, :, None]
    jq = jquant.kv_quantize(jnp.asarray(x), jnp.asarray(sc), jdt)
    tq = tquant.kv_quantize(torch.from_numpy(x), torch.from_numpy(sc), tdt)
    assert tq.dtype == tdt
    np.testing.assert_array_equal(_np_bytes(tq), _np_bytes(jq))
    jd = jquant.kv_dequantize(jq, jnp.asarray(sc), jnp.float32)
    td = tquant.kv_dequantize(tq, torch.from_numpy(sc), torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_kv_dtype_vocabulary():
    assert tquant.KV_DTYPES == jquant.KV_DTYPES
    assert tquant.kv_storage_dtype("bf16", torch.float32) == torch.float32
    assert tquant.kv_storage_dtype("int8") == torch.int8
    assert tquant.kv_storage_dtype("fp8") == torch.float8_e4m3fn
    assert tquant.is_kv_quantized(torch.int8) and not tquant.is_kv_quantized(torch.bfloat16)
    assert (tquant.kv_qmax(torch.int8), tquant.kv_qmax(torch.float8_e4m3fn)) == (127.0, 448.0)
    with pytest.raises(ValueError, match="kv dtype"):
        tquant.kv_storage_dtype("int4")


# ----------------------------------------------------- arena write/scatter

NB, BS, NKV, D = 8, 4, 2, 8


def _write_steps(case: str, rng):
    """A sequence of (table, cols, k_new, v_new, valid) calls of one case."""
    def new(B, S, mag=1.0):
        return (rng.normal(size=(B, S, NKV, D)) * mag).astype(np.float32)

    if case == "fresh":  # one entry per row into virgin blocks
        tbl = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
        return [(tbl, np.array([[0], [5]], np.int32), new(2, 1), new(2, 1), None)]
    if case == "grow":  # a full block, then a 50x entry requantizes it
        tbl = np.array([[5, 6, 0]], np.int32)
        steps = [(tbl, np.array([[c]], np.int32), new(1, 1), new(1, 1), None) for c in range(3)]
        return steps + [(tbl, np.array([[3]], np.int32), new(1, 1, 50.0), new(1, 1, 50.0), None)]
    if case == "one_block":  # several entries of one call land in one block
        tbl = np.array([[2, 7, 0], [1, 3, 0]], np.int32)
        first = (tbl, np.array([[0], [1]], np.int32), new(2, 1), new(2, 1), None)
        cols = np.array([[1, 2, 3, 4], [2, 3, 4, 5]], np.int32)
        return [first, (tbl, cols, new(2, 4, 3.0), new(2, 4, 0.2), None)]
    if case == "valid":  # gated entries neither write nor grow a scale
        tbl = np.array([[4, 1, 0], [6, 2, 0]], np.int32)
        first = (tbl, np.array([[0, 1], [0, 1]], np.int32), new(2, 2), new(2, 2), None)
        huge = new(2, 3, 100.0)
        valid = np.array([[True, False, True], [False, False, True]])
        return [first, (tbl, np.array([[2, 3, 4], [2, 3, 4]], np.int32), huge, huge, valid)]
    if case == "trash":  # columns whose table entry is the trash block
        tbl = np.array([[1, 0, 2], [3, 0, 0]], np.int32)
        cols = np.array([[4, 5, 8], [1, 6, 9]], np.int32)
        return [(tbl, cols, new(2, 3), new(2, 3), None)]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["fresh", "grow", "one_block", "valid", "trash"])
@pytest.mark.parametrize("kv", list(KV))
def test_write_block_kv_quantized_matches_jax(kv, case):
    """Codes and scales byte-identical to the JAX running-max write after
    every call. Trash block 0's codes are left out (colliding entries land
    there in any order); its scale is compared."""
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(21)
    jk = jv = jnp.zeros((NB, BS, NKV, D), jdt)
    jks = jvs = jnp.zeros((NB, NKV), jnp.float32)
    tk, tv = _to_torch(jk, tdt), _to_torch(jv, tdt)
    tks, tvs = torch.zeros((NB, NKV)), torch.zeros((NB, NKV))
    for tbl, cols, kn, vn, valid in _write_steps(case, rng):
        jvalid = None if valid is None else jnp.asarray(valid)
        jk, jv, jks, jvs = jpa.write_block_kv(
            jk, jv, jnp.asarray(tbl), jnp.asarray(cols), jnp.asarray(kn), jnp.asarray(vn),
            valid=jvalid, k_scale=jks, v_scale=jvs,
        )
        out = tpa.write_block_kv(
            tk, tv, torch.from_numpy(tbl), torch.from_numpy(cols), torch.from_numpy(kn),
            torch.from_numpy(vn), valid=None if valid is None else torch.from_numpy(valid),
            k_scale=tks, v_scale=tvs,
        )
        assert out[0] is tk and out[2] is tks  # in place
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(_np_bytes(t)[1:], _np_bytes(j)[1:])
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
        np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    if case == "valid":
        assert float(tks[6].max()) < 1.0  # block 6 saw only gated 100x entries


@pytest.mark.parametrize("kv", list(KV))
def test_admission_scatter_matches_jax(kv):
    """One-shot admission's quantizing scatter against JAX
    ``_scatter_pages_q``: two rows of a 9-column prompt bucket at block
    size 4, over blocks a previous occupant left with codes and a much
    larger scale. Every mapped block's scale is reset (blocks past the
    prompt to 0), so the bytes equal the JAX program's, which the running
    max write would not give."""
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(22)
    T, Sp, n = 5, 9, 2
    tbl = np.array([[3, 1, 6, 2, 0], [4, 7, 5, 0, 0]], np.int32)
    old = rng.normal(size=(NB, BS, NKV, D)).astype(np.float32) * 40
    old_scale = (np.abs(old).max(axis=(1, 3)) / jquant.kv_qmax(jdt)).astype(np.float32)
    jk = jquant.kv_quantize(jnp.asarray(old), jnp.asarray(old_scale[:, None, :, None]), jdt)
    window = rng.normal(size=(n, Sp, NKV, D)).astype(np.float32)
    full = np.zeros((1, n, T * BS, NKV, D), np.float32)
    full[0, :, :Sp] = window
    jq, js = jserve._scatter_pages_q(
        jk[None], jnp.asarray(old_scale)[None], jnp.asarray(tbl), jnp.asarray(full), BS
    )
    tk, ts = _to_torch(jk, tdt), torch.from_numpy(old_scale.copy())
    tserve.scatter_pages_q(tk, ts, torch.from_numpy(tbl), torch.from_numpy(window))
    np.testing.assert_array_equal(_np_bytes(tk), _np_bytes(jq[0]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js[0]))
    mapped = tbl[tbl != 0]
    assert (ts.numpy()[mapped] < old_scale[mapped]).all()
    assert (ts.numpy()[2] == 0).all()  # row 0's block past the 9 prompt columns


# ----------------------------------------------------- quantized attention


def _quantized_arena(rng, jdt, NB_, BS_, Nkv, D_):
    """Codes and per-(block, head) scales of random K/V; trash block 0 has
    garbage codes (NaN for fp8) and an Inf scale."""
    arenas = []
    for _ in range(2):
        x = rng.normal(size=(NB_, BS_, Nkv, D_)).astype(np.float32)
        sc = (np.abs(x).max(axis=(1, 3)) / jquant.kv_qmax(jdt)).astype(np.float32)
        codes = np.array(_np_bytes(jquant.kv_quantize(jnp.asarray(x), jnp.asarray(sc[:, None, :, None]), jdt)))
        codes[0] = 0x7F  # int8 127; fp8 e4m3fn NaN
        sc[0] = np.inf
        arenas += [codes, sc]
    return arenas


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_quantized_paged_attention_matches_pallas_interpret(monkeypatch, which, kv):
    """The port's quantized paged ops on CPU tensors (their plain versions)
    against the JAX Pallas kernels in interpret mode with scales."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    jdt, tdt = KV[kv]
    rng = np.random.default_rng(23)
    B, BS_, T, Nkv, G, D_, NB_ = 2, 8, 5, 2, 2, 16, 12
    kc, ks, vc, vs = _quantized_arena(rng, jdt, NB_, BS_, Nkv, D_)
    tbl = np.array([[4, 9, 1, 6, 0], [2, 11, 3, 5, 10]], np.int32)
    frontier = [14, 36]
    S = 1 if which == "decode" else 12
    kvpos = np.full((B, T * BS_), SENTINEL, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, f in enumerate(frontier):
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - S, f)
    nlive = np.array([-(-f // BS_) for f in frontier], np.int32)
    q = rng.normal(size=(B, S, Nkv * G, D_)).astype(np.float32)
    codes = [jax.lax.bitcast_convert_type(jnp.asarray(c), jdt) for c in (kc, vc)]
    jargs = (jnp.asarray(q), *codes,
             jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvpos))
    targs = (torch.from_numpy(q), _to_torch(kc, tdt), _to_torch(vc, tdt),
             torch.from_numpy(tbl), torch.from_numpy(qpos), torch.from_numpy(kvpos))
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    if which == "decode":
        want = jpa.paged_attention(*jargs, backend="interpret", **jsc)
        got = tpa.paged_attention(*targs, **tsc)
    else:
        want = jpa.paged_prefill(*jargs, backend="interpret", nlive=jnp.asarray(nlive), **jsc)
        got = tpa.paged_prefill(*targs, nlive=torch.from_numpy(nlive), **tsc)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_backend_selection_on_cpu():
    """``plain`` and ``auto`` run the plain version on CPU tensors; an
    explicit ``kernel`` there raises, as does an unknown backend."""
    rng = np.random.default_rng(24)
    kc, ks, vc, vs = _quantized_arena(rng, jnp.int8, 3, 4, 1, 64)
    q = torch.from_numpy(rng.normal(size=(1, 1, 2, 64)).astype(np.float32))
    args = (q, _to_torch(kc, torch.int8), _to_torch(vc, torch.int8),
            torch.tensor([[1, 2]], dtype=torch.int32), torch.tensor([[7]], dtype=torch.int32),
            torch.arange(8, dtype=torch.int32)[None])
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = tpa.paged_attention_xla(*args, **sc)
    for backend in ("auto", "plain"):
        for fn in (tpa.paged_attention, tpa.paged_prefill):
            torch.testing.assert_close(fn(*args, backend=backend, **sc), want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tpa.paged_attention(*args, backend="kernel", **sc)
    with pytest.raises(ValueError, match="backend"):
        tpa.paged_prefill(*args, backend="xla", **sc)


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def setup():
    cj, ct = jcfg.tiny_llama(), tcfg.tiny_llama()
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(1), dtype=jnp.float32))
    eng = Engine(ct, tllama.params_from_numpy(ct, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENS]
    return eng, jeng, prompts


def _staggered(srv, prompts) -> list:
    """Two requests, two steps, three more joining mid-decode."""
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return reqs


def _record_gaps(monkeypatch, srv) -> dict:
    """Top-2 logit gap of every token the port's server samples, per request."""
    gaps = collections.defaultdict(list)
    sample = tserve._sample_rows

    def recording(state, rows, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        # a decode chunk samples every row (``rows`` is a range): only the
        # rows live on the device commit
        live = ~state.done if isinstance(rows, range) else None
        for i, r in enumerate(rows):
            if live is not None and (not live[r] or srv._req[r] is None):
                continue
            gaps[srv._req[r].id].append(float(top[i, 0] - top[i, 1]))
        return sample(state, rows, logits)

    monkeypatch.setattr(tserve, "_sample_rows", recording)
    return gaps


@pytest.mark.parametrize("prefill_chunk", [None, 8], ids=["one_shot", "chunked"])
@pytest.mark.parametrize("kv", list(KV))
def test_served_streams_match_jax_server(setup, monkeypatch, kv, prefill_chunk):
    """Staggered submits through ``Engine.serve(kv_dtype=)`` against the
    JAX ``PipelineServer(kv_dtype=, paged_attn="xla")`` (one row, so every
    request's arena history is its own on both sides)."""
    eng, jeng, prompts = setup
    kw = dict(capacity=64, kv_block_size=4, kv_blocks=40, prefill_chunk=prefill_chunk,
              kv_dtype=kv)
    jsrv = jeng.serve(batch_per_slot=1, paged_attn="xla", **kw)
    jreqs = _staggered(jsrv, prompts)
    jsrv.close()
    srv = eng.serve(batch_per_slot=3, **kw)
    assert srv.state.k.dtype == KV[kv][1] and srv.state.k_scale.dtype == torch.float32
    gaps = _record_gaps(monkeypatch, srv)
    reqs = _staggered(srv, prompts)
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    for r, jr in zip(reqs, jreqs):
        want = list(jr.tokens)
        assert r.done and len(r.tokens) == len(want)
        if r.tokens == want:
            continue
        step = next(j for j, (a, b) in enumerate(zip(r.tokens, want)) if a != b)
        print(f"request {r.id}: first mismatch at token {step}, top-2 gap {gaps[r.id][step]:.3g}")
        assert gaps[r.id][step] < NEAR_TIE


def _match_frac(a, b) -> float:
    return float(np.mean([np.mean([x == y for x, y in zip(ta, tb)]) for ta, tb in zip(a, b)]))


@pytest.mark.parametrize("kv", list(KV))
def test_quantized_server_tracks_unquantized(setup, kv):
    """Full rollouts, and >= half the tokens of the port's own f32-arena
    server (an f32 engine's "bf16" arena stays f32, without scales)."""
    eng, _, prompts = setup
    kw = dict(capacity=64, batch_per_slot=3, kv_block_size=4, kv_blocks=60, prefill_chunk=8)
    base_srv = eng.serve(**kw)
    assert base_srv.state.k.dtype == torch.float32 and base_srv.state.k_scale is None
    base = [r.tokens for r in _staggered(base_srv, prompts)]
    quant = [r.tokens for r in _staggered(eng.serve(kv_dtype=kv, **kw), prompts)]
    for t, m in zip(quant, MAX_NEW):
        assert len(t) == m or t[-1] in eng.cfg.eos_token_ids
    frac = _match_frac(base, quant)
    print(f"{kv} token match vs the f32 arena: {frac:.3f}")
    assert frac >= 0.5


def test_kv_dtype_and_paged_attn_validation(setup, monkeypatch):
    eng = setup[0]
    kw = dict(capacity=64, kv_block_size=4, kv_blocks=20)
    with pytest.raises(ValueError, match=r"kv_dtype must be one of \('bf16', 'int8', 'fp8'\)"):
        eng.serve(kv_dtype="int4", **kw)
    with pytest.raises(ValueError, match="paged_attn must be auto, kernel or plain"):
        eng.serve(paged_attn="xla", **kw)
    with pytest.raises(ValueError, match="paged_attn='kernel' requires a CUDA device"):
        eng.serve(paged_attn="kernel", kv_dtype="int8", **kw)
    assert eng.serve(paged_attn="auto", **kw).attn_backend == "plain"
    monkeypatch.setattr(tserver, "fp8_kv_supported", lambda device: False)
    with pytest.raises(ValueError, match="kv_dtype='fp8'.*use kv_dtype='int8'"):
        eng.serve(kv_dtype="fp8", **kw)


def test_bytes_per_block_matches_jax(setup):
    """``bytes_per_block``/``arena_bytes`` equal the JAX allocator's, and at
    equal bytes an int8 arena admits >= 1.9x the blocks of a bf16 one."""
    ja, ta = JBlockAllocator(48, 64), BlockAllocator(48, 64)
    kw = dict(num_layers=28, num_kv_heads=8, head_dim=128)
    pairs = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32),
             (jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]
    for jdt, tdt in pairs:
        assert ta.bytes_per_block(kv_dtype=tdt, **kw) == ja.bytes_per_block(kv_dtype=jdt, **kw)
        assert ta.arena_bytes(kv_dtype=tdt, **kw) == ja.arena_bytes(kv_dtype=jdt, **kw)
    b16 = ta.bytes_per_block(kv_dtype=torch.bfloat16, **kw)
    b8 = ta.bytes_per_block(kv_dtype=torch.int8, **kw)
    assert (1000 * b16) // b8 >= 1.9 * 1000
    eng = setup[0]
    srv = eng.serve(capacity=64, kv_block_size=4, kv_blocks=20, kv_dtype="int8")
    cfg = eng.cfg
    codes = 2 * srv.state.k.numel()
    scales = 2 * srv.state.k_scale.numel() * 4
    assert srv.arena_bytes() == codes + scales
    assert cfg.num_hidden_layers * 20 * cfg.num_key_value_heads == srv.state.k_scale.numel()
