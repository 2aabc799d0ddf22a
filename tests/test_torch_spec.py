"""Speculative decoding in the port (``runtime/spec.py``,
``parallel/serve.serve_verify``, the speculative ``PipelineServer``,
``generate(speculate=)``) and stop strings, against the JAX package on the
CPU: the cases of ``tests/test_spec.py`` and ``tests/test_radix.py:485``.

``tiny_llama`` at 4 layers (and tiny GPT-2 at 4) in float32, weights from
``jax.random.key(3)`` carried over by ``params_from_numpy``. Greedy
streams are held to the JAX package's exactly: speculative ``generate``
to JAX ``spec_generate`` and to the port's own ``generate``; the
speculative server to the JAX speculative ``PipelineServer`` (paged,
``paged_attn="xla"``, one stage) in bf16 (here the engine's f32), int8 and
fp8 arenas. The device math (``rejection_commit``, ``cap_commits``,
``_leading_true_count``, the per-row filter) gives identical integers on
identical numpy inputs, with the same injected uniforms and Gumbel noise:
torch cannot reproduce JAX's random draws, so sampled streams are held to
themselves (same seed, same stream), never to JAX's. The plain versions of
the two kernels a verify runs (decode at S = K + 1, flash at S = K + 1
over a cache with sentinel scratch columns) are held to the Pallas kernels
in interpret mode (f32 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import gpt2 as jgpt2
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.ops import flash_attention as jfa
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.ops import sampling as jsampling
from llm_sharding_tpu.runtime import spec as jspec
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import gpt2 as tgpt2
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.ops import sampling as tsampling
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime import spec as tspec
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.server import PipelineServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


CFG = tcfg.tiny_llama(num_hidden_layers=4)
KVS = ["bf16", "int8", "fp8"]
# block size 4 and a 64-token capacity: a verify's K + 1 entries cross
# blocks, and the last steps' overflow columns map trash block 0
SKW = dict(capacity=64, kv_block_size=4, kv_blocks=60)
SENTINEL = 2**30


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=4)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(3), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    return eng, jeng, cj, tree


def prompt(seed, n=5, rep=1):
    p = np.random.default_rng(seed).integers(1, CFG.vocab_size, n).astype(np.int32)
    return np.tile(p, rep)


# repetitive prompts, so the drafter proposes and some drafts accept, and
# one with no recurring suffix
PROMPTS = [prompt(20, 3, 3), prompt(21, 4, 3), prompt(22, 7), prompt(23, 3, 4)]


def tokens_of(res, i, n):
    return res.tokens[i, n : res.lengths[i]].tolist()


class FakeTok:
    """Renders id i as "<i>": a stop string names one token exactly."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{int(i)}>" for i in ids)


# ------------------------------------------------------------ host pieces


NGRAM_CASES = [  # (ids, k, n, want): tests/test_spec.py:44-78
    ([7, 8, 9, 1, 2, 3, 7, 8], 3, 3, [9, 1, 2]),
    ([5, 6, 1, 0, 5, 6, 4, 2, 5, 6], 1, 2, [4]),
    ([3, 8, 2, 3, 9, 5, 2, 3], 1, 3, [9]),
    (list(range(10)), 4, 3, []),
    ([1, 2, 1, 2], 0, 3, []),
    ([5], 4, 3, []),
    ([4, 5, 9, 4, 5], 8, 2, [9, 4, 5]),
]


@pytest.mark.parametrize("ids,k,n,want", NGRAM_CASES)
def test_ngram_draft_cases_match_jax(ids, k, n, want):
    got = tspec.ngram_draft(np.asarray(ids), k, n)
    assert got.dtype == np.int32 and got.tolist() == want
    assert jspec.ngram_draft(np.asarray(ids), k, n).tolist() == want


@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_seeded_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ids = rng.integers(0, 6, rng.integers(1, 40))
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        np.testing.assert_array_equal(tspec.ngram_draft(ids, k, n), jspec.ngram_draft(ids, k, n))


def test_adaptive_k_matches_jax():
    """The backoff sequence of tests/test_spec.py:84, then seeded updates."""
    t, j = tspec.AdaptiveK(8), jspec.AdaptiveK(8)
    seq = [(8, 0), (4, 0), (2, 0), (1, 0)] + [(None, None)] * 10 + [(0, 0)]
    for d, a in seq:
        d = t.k if d is None else d
        a = t.k if a is None else a
        t.update(d, a)
        j.update(d, a)
        assert t.k == j.k
    assert t.k == 8
    rng = np.random.default_rng(1)
    for _ in range(200):
        d = int(rng.integers(0, 9))
        a = int(rng.integers(0, d + 1))
        t.update(d, a)
        j.update(d, a)
        assert (t.k, t.k_max) == (j.k, j.k_max)


def test_count_accepted_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(100):
        draft = rng.integers(0, 3, 4)
        committed = rng.integers(0, 3, rng.integers(0, 6)).tolist()
        d = int(rng.integers(0, 5))
        assert tspec.count_accepted(committed, draft, d) == jspec.count_accepted(committed, draft, d)


# ------------------------------------------------------------ device math


def _draws(rng, B, K, V):
    scaled = rng.normal(size=(B, K + 1, V)).astype(np.float32) * 2
    scaled[0, :, : V // 2] = -np.inf  # a filtered row
    draft = rng.integers(0, V, (B, K)).astype(np.int32)
    # draft the target's mode now and then, so some drafts accept
    draft[1] = np.argmax(scaled[1, :K], axis=-1)
    valid = np.arange(K)[None, :] < rng.integers(0, K + 1, B)[:, None]
    u = rng.uniform(size=(B, K)).astype(np.float32)
    g = rng.gumbel(size=(B, K + 1, V)).astype(np.float32)
    return scaled, draft, valid, u, g


@pytest.mark.parametrize("seed", range(4))
def test_rejection_commit_matches_jax_on_injected_draws(seed):
    rng = np.random.default_rng(seed)
    scaled, draft, valid, u, g = _draws(rng, 6, 4, 16)
    ja, jc = jspec.rejection_commit(*map(jnp.asarray, (scaled, draft, valid, u, g)))
    ta, tc = tspec.rejection_commit(*map(torch.from_numpy, (scaled, draft, valid, u, g)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_leading_true_count_matches_jax():
    flags = np.random.default_rng(5).uniform(size=(50, 6)) < 0.7
    np.testing.assert_array_equal(
        tspec._leading_true_count(torch.from_numpy(flags)).numpy(),
        np.asarray(jspec._leading_true_count(jnp.asarray(flags))),
    )


@pytest.mark.parametrize("seed", range(4))
def test_cap_commits_matches_jax(seed):
    """Stop ids inside, at the end of and past a run; budgets below, at and
    above the run; done rows."""
    rng = np.random.default_rng(seed)
    B, K1 = 24, 5
    cfg = dataclasses.replace(CFG, eos_token_ids=(2, 7))
    commit = rng.integers(0, 9, (B, K1)).astype(np.int32)
    a = rng.integers(0, K1, B).astype(np.int32)
    budget = rng.integers(0, 7, B).astype(np.int32)
    done = rng.uniform(size=B) < 0.2
    jout = jspec.cap_commits(cfg, *map(jnp.asarray, (commit, a, budget, done)))
    tout = tspec.cap_commits(cfg, *map(torch.from_numpy, (commit, a, budget, done)))
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_top_p_threshold_per_row_presorted_matches_jax():
    """The per-row, presorted form ``serve_verify`` uses; the scalar form
    the existing callers use is unchanged (its own parity test is in
    tests/test_torch_ops.py)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    x[1, :5] = -np.inf
    desc = -np.sort(-x, axis=-1)
    top_p = rng.uniform(0.05, 1.0, 8).astype(np.float32)
    want = jsampling.top_p_threshold(jnp.asarray(desc), jnp.asarray(top_p), presorted=True)
    got = tsampling.top_p_threshold(torch.from_numpy(desc), torch.from_numpy(top_p), presorted=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scalar = tsampling.top_p_threshold(torch.from_numpy(x), 0.7)
    np.testing.assert_array_equal(scalar.numpy(),
                                  np.asarray(jsampling.top_p_threshold(jnp.asarray(x), 0.7)))


def test_filter_rows_matches_serve_verify_inline():
    """``filter_rows`` against the JAX ``serve_verify``'s inline per-row
    top-k / top-p (``parallel/serve.py:1669-1684``), written out in JAX."""
    rng = np.random.default_rng(7)
    R, P, V = 5, 4, 24
    scaled = rng.normal(size=(R, P, V)).astype(np.float32)
    topk = np.array([0, 3, 0, 5, 1], np.int32)
    topp = np.array([1.0, 1.0, 0.6, 0.8, 0.3], np.float32)
    js, jk, jp = jnp.asarray(scaled), jnp.asarray(topk), jnp.asarray(topp)
    desc = -jnp.sort(-js, axis=-1)
    kth = jnp.take_along_axis(desc, jnp.clip(jk - 1, 0, V - 1)[:, None, None], axis=-1)
    kth = jnp.where((jk > 0)[:, None, None], kth, -jnp.inf)
    desc_k = jnp.where(desc < kth, -jnp.inf, desc)
    pth = jsampling.top_p_threshold(desc_k.reshape(R * P, V), jnp.repeat(jp, P),
                                    presorted=True).reshape(R, P, 1)
    pth = jnp.where((jp < 1.0)[:, None, None], pth, -jnp.inf)
    want = jnp.where(js < jnp.maximum(kth, pth), -jnp.inf, js)
    got = tsampling.filter_rows(torch.from_numpy(scaled), torch.from_numpy(topk),
                                torch.from_numpy(topp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- the kernels at verify shapes


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("K", [1, 4])
def test_decode_plain_at_verify_shape_matches_pallas_interpret(G, K):
    """Kernel 1's plain version at S = K + 1 causal queries per row (the
    paged verify), the in-flight entries visible through ``kv_pos``, a
    trash hole and NaN/Inf in trash block 0, against the Pallas kernel in
    interpret mode (f32, 1e-5)."""
    rng = np.random.default_rng(11 + K)
    B, BS, T, Nkv, D, NB = 2, 4, 8, 2, 16, 14
    S = K + 1
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.inf
    tbl = np.array([[3, 5, 0, 8, 9, 10, 0, 0], [7, 2, 4, 6, 11, 12, 13, 0]], np.int32)
    starts = [13, 17]  # write columns of each row's pending token
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, w in enumerate(starts):
        kvpos[b, : w + S] = np.arange(w + S)
        qpos[b] = w + np.arange(S)
    kvpos[0, 8:12] = SENTINEL  # the trash-mapped hole
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v, tbl, qpos, kvpos)]
    t = [torch.from_numpy(a) for a in (q, k, v, tbl, qpos, kvpos)]
    want = jpa.paged_attention_tpu(*j, interpret=True, blocks_per_step=1)
    got = tpa.paged_attention(*t)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("K", [2, 4])
def test_flash_plain_at_verify_shape_matches_pallas_interpret(monkeypatch, K):
    """Kernel 3's plain version at spec ``generate``'s verify: S = K + 1
    queries at each row's own positions over a dense cache of capacity + K
    + 1 columns, the last K + 1 the scratch columns holding the in-flight
    entries, sentinel columns between (a right-padded row), against the
    Pallas kernel in interpret mode (f32, 1e-5)."""
    monkeypatch.setattr(jfa, "BLOCK_Q", 8)
    monkeypatch.setattr(jfa, "BLOCK_K", 16)
    rng = np.random.default_rng(30 + K)
    B, cap, Nh, Nkv, D = 2, 40, 4, 2, 16
    S, C = K + 1, cap + K + 1
    pos0 = np.array([21, 9])
    kvpos = np.full((B, C), SENTINEL, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, p in enumerate(pos0):
        kvpos[b, :p] = np.arange(p)
        kvpos[b, cap:] = p + np.arange(S)
        qpos[b] = p + np.arange(S)
    q = rng.normal(size=(B, S, Nh, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v, qpos, kvpos)), interpret=True)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v, qpos, kvpos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------- speculative generate


def _gen_both(setup, p, n, cfg=None, **kw):
    eng, _, cj, tree = setup
    tcfg_ = cfg or CFG
    jcfg_ = cj if cfg is None else dataclasses.replace(cj, eos_token_ids=cfg.eos_token_ids)
    jparams = jax.tree.map(jnp.asarray, tree)
    return (tgenerate(tcfg_, eng.params, p, n, **kw),
            jgenerate(jcfg_, jparams, p, n, cache_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("K,burst", [(2, 1), (2, 4), (4, 1), (4, 4)])
def test_spec_generate_equals_jax_and_generate(setup, K, burst):
    eng = setup[0]
    p = PROMPTS[0]
    base = tgenerate(CFG, eng.params, p, 24)
    got, want = _gen_both(setup, p, 24, speculate=K, spec_burst=burst)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens, base.tokens)
    np.testing.assert_array_equal(got.lengths, base.lengths)
    assert got.cache.capacity == base.cache.capacity


def test_spec_generate_cache_keeps_only_committed_positions(setup):
    """The returned cache (scratch stripped) equals the JAX ``spec_generate``'s:
    key positions exactly (each row's committed prefix at position-aligned
    columns, the sentinel after: rejected drafts and the scratch rewound),
    the kept keys to 1e-5."""
    eng, _, cj, tree = setup
    rng = np.random.default_rng(3)
    pr = np.zeros((2, 9), np.int32)
    lens = np.array([9, 6], np.int32)
    for i, n in enumerate(lens):
        pr[i, :n] = np.tile(rng.integers(1, CFG.vocab_size, 3), 3)[:n]
    got, want = _gen_both(setup, pr, 14, prompt_len=lens, speculate=3)
    jpos = np.asarray(want.cache.pos)
    np.testing.assert_array_equal(got.cache.pos.numpy(), jpos)
    for b in range(2):
        n = int(got.lengths[b]) - 1  # the last token's KV is never written
        np.testing.assert_array_equal(jpos[b, :n], np.arange(n))
        assert (jpos[b, n:] == SENTINEL).all()
        np.testing.assert_allclose(got.cache.k[:, b, :n].numpy(),
                                   np.asarray(want.cache.k)[:, b, :n], atol=1e-5)


def test_spec_generate_batched_right_padded(setup):
    rng = np.random.default_rng(2)
    pr = np.zeros((3, 8), np.int32)
    lens = np.array([5, 8, 3], np.int32)
    for i, n in enumerate(lens):
        pr[i, :n] = rng.integers(1, CFG.vocab_size, n)
    base = tgenerate(CFG, setup[0].params, pr, 16, prompt_len=lens)
    got, want = _gen_both(setup, pr, 16, prompt_len=lens, speculate=3)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, base.tokens)
    np.testing.assert_array_equal(got.lengths, base.lengths)


def test_spec_generate_stop_inside_accepted_run(setup):
    """A stop id inside a verified run truncates where the sequential loop
    stops (stop kept, nothing after)."""
    p = PROMPTS[1]
    full = tokens_of(tgenerate(CFG, setup[0].params, p, 24), 0, len(p))
    cfg = dataclasses.replace(CFG, eos_token_ids=(int(full[len(full) // 2]),))
    base = tgenerate(cfg, setup[0].params, p, 24)
    got, want = _gen_both(setup, p, 24, cfg=cfg, speculate=4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, base.tokens)
    np.testing.assert_array_equal(got.lengths, base.lengths)
    assert int(got.lengths[0]) < len(p) + 24


def test_spec_generate_zero_acceptance(setup):
    """[9, 9] recurs with a different continuation each time: drafts exist
    and essentially never match (tests/test_spec.py:153)."""
    p = np.array([9, 9, 1, 9, 9, 2, 9, 9, 3, 9, 9], np.int32)
    base = tgenerate(CFG, setup[0].params, p, 20)
    got, want = _gen_both(setup, p, 20, speculate=4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, base.tokens)


@pytest.mark.parametrize("K", [2, 4])
def test_spec_generate_gpt2_equals_jax(K):
    cj = jcfg.tiny_gpt2(num_hidden_layers=4)
    cfg = tcfg.tiny_gpt2(num_hidden_layers=4)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cj, jax.random.key(2), dtype=jnp.float32))
    params = tgpt2.params_from_numpy(cfg, tree, device="cpu")
    p = np.tile(np.random.default_rng(1).integers(1, cfg.vocab_size, 3).astype(np.int32), 2)
    base = tgenerate(cfg, params, p, 20)
    got = tgenerate(cfg, params, p, 20, speculate=K)
    want = jgenerate(cj, jax.tree.map(jnp.asarray, tree), p, 20, cache_dtype=jnp.float32,
                     speculate=K)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, base.tokens)
    np.testing.assert_array_equal(got.lengths, base.lengths)


def test_speculate_zero_is_the_generate_loop(setup):
    """``speculate=0`` runs exactly the non-speculative loop: the same
    tokens, lengths and cache (capacity, contents, write offset)."""
    params = setup[0].params
    p = PROMPTS[2]
    a = tgenerate(CFG, params, p, 10)
    b = tgenerate(CFG, params, p, 10, speculate=0)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.cache.length == b.cache.length
    assert torch.equal(a.cache.k, b.cache.k) and torch.equal(a.cache.pos, b.cache.pos)


def test_spec_generate_sampled_reproducible_and_filtered(setup):
    """Sampled speculation is reproducible by seed; top_k=1 forces the
    greedy choice at every position (tests/test_spec.py:262)."""
    params = setup[0].params
    p = PROMPTS[0]
    greedy = tokens_of(tgenerate(CFG, params, p, 12), 0, len(p))
    for s in range(3):
        a = tgenerate(CFG, params, p, 12, temperature=0.9, seed=s, speculate=3)
        b = tgenerate(CFG, params, p, 12, temperature=0.9, seed=s, speculate=3)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        k1 = tgenerate(CFG, params, p, 12, temperature=1.2, top_k=1, seed=s, speculate=3)
        assert tokens_of(k1, 0, len(p)) == greedy


def test_spec_generate_validation(setup):
    params = setup[0].params
    with pytest.raises(ValueError, match="speculate"):
        tspec.spec_generate(CFG, params, np.array([1, 2], np.int32), 4, speculate=0)
    with pytest.raises(ValueError, match="capacity"):
        tgenerate(CFG, params, np.array([1, 2], np.int32), 8, capacity=4, speculate=2)


# ------------------------------------------------------ speculative server

_JAX_RUNS: dict = {}


def _run(srv, prompts, max_new, late=False, **submit):
    """Submit (half now, two steps, the rest when ``late``), run to idle."""
    first = prompts[: (len(prompts) + 1) // 2] if late else prompts
    reqs = [srv.submit(p, max_new, **submit) for p in first]
    if late:
        srv.step()
        srv.step()
        reqs += [srv.submit(p, max_new, **submit) for p in prompts[len(first):]]
    srv.run_until_idle()
    return reqs


def jax_streams(jeng, prompts, max_new, kv="bf16", late=False, K=3, **kw):
    """The JAX speculative server's greedy streams, and its spec_* counter
    deltas."""
    key = (kv, late, K, max_new, tuple(p.tobytes() for p in prompts), tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        d0, a0 = jspec.M_SPEC_DRAFTED.value, jspec.M_SPEC_ACCEPTED.value
        srv = jeng.serve(paged_attn="xla", kv_dtype=kv, batch_per_slot=2, speculate=K,
                         **SKW, **kw)
        reqs = _run(srv, prompts, max_new, late)
        assert all(r.error is None for r in reqs)
        _JAX_RUNS[key] = ([list(r.tokens) for r in reqs],
                          (jspec.M_SPEC_DRAFTED.value - d0, jspec.M_SPEC_ACCEPTED.value - a0))
        srv.close()
    return _JAX_RUNS[key]


def port_server(eng, kv="bf16", K=3, **kw):
    return eng.serve(kv_dtype=kv, batch_per_slot=2, speculate=K, **SKW, **kw)


def check_clean(srv):
    srv._alloc.check()
    assert srv._alloc.in_use == (srv._radix.device_blocks if srv._radix is not None else 0)


@pytest.mark.parametrize("kv", KVS)
def test_spec_server_streams_equal_jax(setup, kv):
    """Four requests over two rows of one batch, two of them joining late:
    every greedy stream equals the JAX speculative server's, and the
    spec_drafted_total / spec_accepted_total deltas equal the JAX
    registry's on the same workload."""
    eng, jeng = setup[:2]
    want, (jd, ja) = jax_streams(jeng, PROMPTS, 14, kv, late=True)
    d0, a0 = tspec.M_SPEC_DRAFTED.value, tspec.M_SPEC_ACCEPTED.value
    srv = port_server(eng, kv)
    reqs = _run(srv, PROMPTS, 14, late=True)
    assert [r.tokens for r in reqs] == want
    assert (tspec.M_SPEC_DRAFTED.value - d0, tspec.M_SPEC_ACCEPTED.value - a0) == (jd, ja)
    assert jd > 0 and ja > 0  # speculation ran and won
    check_clean(srv)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_verify_rewinds_rejected_positions(setup, monkeypatch, kv):
    """After every verify a live row's key positions are its committed
    prefix only: the prompt at columns [0, plen), the bucket padding and
    every column from the pending token's on (rejected drafts, trash-mapped
    overflow) at the sentinel. Rollback is this rewind, never a copy."""
    eng = setup[0]
    srv = port_server(eng, kv)
    st = srv.state
    checked = []
    verify = tserve.serve_verify

    def checking(cfg, params, state, rows, draft, draft_len, backend="auto"):
        log = verify(cfg, params, state, rows, draft, draft_len, backend)
        kpos = state.kpos.numpy()
        c = (log >= 0).sum(dim=1).numpy()
        for i, r in enumerate(rows):
            req = srv._req[r]
            # the verify advanced the row's write column on the device
            plen, w = req.prompt_len, int(state.write_off[r])
            want = np.full(kpos.shape[1], SENTINEL, np.int64)
            want[:plen] = np.arange(plen)
            bucket = srv._bucket(plen)
            want[bucket:w] = plen + np.arange(w - bucket)
            np.testing.assert_array_equal(kpos[r], want)
            checked.append(int(c[i]))
        return log

    monkeypatch.setattr(tserve, "serve_verify", checking)
    _run(srv, PROMPTS, 14)
    assert len(checked) > 10 and max(checked) > 1 and min(checked) >= 1
    check_clean(srv)


def test_spec_server_equals_generate_and_nonspec_server(setup):
    """Greedy speculative streams equal the port's ``generate`` and its
    non-speculative server (``speculate=0``: the decode step)."""
    eng = setup[0]
    srv = port_server(eng, K=4)
    reqs = _run(srv, PROMPTS, 14)
    plain = eng.serve(batch_per_slot=2, **SKW)
    preqs = _run(plain, PROMPTS, 14)
    for p, r, q in zip(PROMPTS, reqs, preqs):
        want = tokens_of(tgenerate(CFG, eng.params, p, 14), 0, len(p))
        assert r.tokens == want == q.tokens
    check_clean(srv)


@pytest.mark.parametrize("kv", KVS)
def test_spec_server_prefix_handle_equals_jax(setup, kv):
    """A ``PrefixHandle`` under speculation: the drafter sees the suffix and
    the generation, the verify writes at the prefix-shifted columns."""
    eng, jeng = setup[:2]
    prefix, sfx = prompt(13, 12), prompt(14, 3, 2)
    jsrv = jeng.serve(paged_attn="xla", kv_dtype=kv, batch_per_slot=2, speculate=3, **SKW)
    jh = jsrv.prefill_prefix(prefix)
    jr = jsrv.submit(sfx, 10, prefix=jh)
    jsrv.run_until_idle()
    srv = port_server(eng, kv)
    h = srv.prefill_prefix(prefix)
    r = srv.submit(sfx, 10, prefix=h)
    srv.run_until_idle()
    assert r.error is None and r.tokens == list(jr.tokens)
    srv.release_prefix(h)
    check_clean(srv)


def test_spec_server_radix_hit_equals_jax(setup):
    """The radix cache (hbm) under speculation (tests/test_radix.py:485):
    the second request hits the first one's prompt blocks."""
    eng, jeng = setup[:2]
    p1 = prompt(8, 10)
    p2 = np.concatenate([p1, prompt(9, 3)])
    outs = []
    for srv in (jeng.serve(paged_attn="xla", batch_per_slot=2, speculate=2, prefix_cache="hbm",
                           **SKW),
                port_server(eng, K=2, prefix_cache="hbm")):
        r1 = srv.submit(p1, 6)
        srv.run_until_idle()
        r2 = srv.submit(p2, 6)
        srv.run_until_idle()
        assert srv.prefix_cache_stats()["hit_tokens"] == 8
        outs.append((list(r1.tokens), list(r2.tokens)))
    assert outs[0] == outs[1]
    assert outs[1][1] == tokens_of(tgenerate(CFG, eng.params, p2, 6), 0, len(p2))
    check_clean(srv)


def test_spec_server_cancel_then_exact_followup(setup):
    eng, jeng = setup[:2]
    p = PROMPTS[1]
    srv = port_server(eng, K=2)
    rc = srv.submit(p, 40)
    srv.step()
    srv.step()
    assert not rc.done and srv.cancel(rc) and rc.done
    rn = srv.submit(p, 8)
    srv.run_until_idle()
    assert rn.tokens == jax_streams(jeng, [p], 8, K=2)[0][0]
    check_clean(srv)


def _verify_logs(monkeypatch) -> list:
    """Record every verify's rows and commit log."""
    logs = []
    commit = tserve.commit_verify

    def recording(cfg, state, rows, log):
        logs.append((list(rows), log.copy()))
        commit(cfg, state, rows, log)

    monkeypatch.setattr(tserve, "commit_verify", recording)
    return logs


@pytest.mark.parametrize("kv", KVS)
def test_spec_server_stop_string_mid_run_equals_jax(setup, monkeypatch, kv):
    """A stop string that first completes at a token inside a multi-token
    verify run, not at its end, cuts the run there (``_apply_spec`` replays
    it token by token). The tiny model's accepted drafts repeat tokens it
    generated before, so the stop spans up to four tokens (a fake
    tokenizer renders id i as "<i>", as tests/test_spec.py:348). The same
    tokens as the JAX server's."""
    eng, jeng = setup[:2]
    p = PROMPTS[1]
    srv = port_server(eng, kv)
    logs = _verify_logs(monkeypatch)
    full = srv.result(srv.submit(p, 24))
    runs = [log[0][log[0] >= 0].tolist() for _, log in logs]
    text = FakeTok().decode
    stop, at = None, 1  # full[0] came from the admission
    for run in runs:
        for i in range(at, at + len(run) - 1):
            for m in range(1, 5):
                cand = text(full[max(i - m + 1, 0) : i + 1])
                if cand not in text(full[:i]):
                    stop, cut = cand, i + 1
                    break
            if stop is not None:
                break
        if stop is not None:
            break
        at += len(run)
    assert stop is not None, "no multi-token run to stop inside"
    for e in (eng, jeng):
        e.tokenizer = FakeTok()
    try:
        jsrv = jeng.serve(paged_attn="xla", kv_dtype=kv, batch_per_slot=2, speculate=3, **SKW)
        jr = jsrv.submit(p, 24, stop=[stop])
        jsrv.run_until_idle()
        srv = port_server(eng, kv)
        r = srv.submit(p, 24, stop=[stop])
        srv.run_until_idle()
        assert r.done and r.error is None
        check_clean(srv)
    finally:
        eng.tokenizer = None
        jeng.tokenizer = None
    assert r.tokens == full[:cut] == list(jr.tokens)
    assert cut < len(full)


def test_stop_strings_non_spec_server(setup):
    """Stop strings on the non-speculative server too: a hit at admission
    (the first token) and one in decode."""
    eng = setup[0]
    p = PROMPTS[2]
    full = tokens_of(tgenerate(CFG, eng.params, p, 12), 0, len(p))
    eng.tokenizer = FakeTok()
    try:
        srv = eng.serve(batch_per_slot=2, **SKW)
        first = srv.submit(p, 12, stop=[f"<{full[0]}>"])
        later = srv.submit(p, 12, stop=[f"<{full[5]}>"])
        srv.run_until_idle()
    finally:
        eng.tokenizer = None
    assert first.tokens == full[:1]
    assert later.tokens == full[: full.index(full[5]) + 1]
    check_clean(srv)


@pytest.mark.parametrize("kv", KVS)
def test_spec_server_snapshot_restore_equals_uninterrupted(setup, kv):
    """A speculative server snapshotted mid-decode restores (speculate and
    spec_ngram ride the snapshot) and finishes every stream as the
    uninterrupted run and the JAX server do."""
    eng, jeng = setup[:2]
    prompts = PROMPTS[:3]
    want = jax_streams(jeng, prompts, 16, kv)[0]
    srv = port_server(eng, kv)
    reqs = [srv.submit(p, 16) for p in prompts]
    for _ in range(3):
        srv.step()
    live = [r for r in reqs if not r.done and r.row is not None]
    assert live, "premise: requests in flight at the snapshot"
    snap = srv.snapshot()
    assert snap["serve_kwargs"]["speculate"] == 3
    srv.close()
    srv2 = PipelineServer.restore(eng, snap)
    assert srv2.speculate == 3 and srv2.spec_ngram == 3
    by_id = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    assert all(by_id[r.id].spec_k is not None for r in live)
    srv2.run_until_idle()
    got = [by_id[r.id].tokens if r.id in by_id else r.tokens for r in reqs]
    assert got == want
    check_clean(srv2)


def test_spec_server_stop_rides_snapshot(setup):
    eng = setup[0]
    p = PROMPTS[0]
    eng.tokenizer = FakeTok()
    try:
        srv = port_server(eng)
        r = srv.submit(p, 20, stop=["<999>"])
        srv.step()
        snap = srv.snapshot()
        assert snap["rows"][r.row]["stop"] == ["<999>"]
        srv2 = PipelineServer.restore(eng, snap)
        assert srv2._req[r.row].stop == ("<999>",)
        eng.tokenizer = None
        with pytest.raises(ValueError, match="tokenizer"):
            PipelineServer.restore(eng, snap)
    finally:
        eng.tokenizer = None


def test_spec_server_extract_adopt_equals_jax(setup):
    """Two live rows extracted from one speculative server and adopted by
    another (a new ``AdaptiveK`` each); the same request objects finish
    with the JAX server's streams."""
    eng, jeng = setup[:2]
    prompts = PROMPTS[:2]
    want = jax_streams(jeng, prompts, 16)[0]
    a, b = port_server(eng), port_server(eng)
    reqs = [a.submit(p, 16) for p in prompts]
    a.step()
    a.step()
    assert all(not r.done for r in reqs), "premise: both rows in flight"
    for r in reqs:
        st = a.extract(r)
        assert st.stop == ()
        b.adopt(st, r)
        assert r.spec_k is not None and r.spec_k.k == 3
    b.run_until_idle()
    assert [r.tokens for r in reqs] == want
    check_clean(a)
    check_clean(b)


def test_spec_server_sampled_rows_reproducible_beside_greedy(setup):
    """A sampled row (rejection acceptance, its own generator) reproduces
    its stream under the same seed, within budget, and a greedy row beside
    it stays exact."""
    eng = setup[0]
    pg, ps = PROMPTS[0], PROMPTS[1]
    runs = []
    for _ in range(2):
        srv = port_server(eng)
        rg = srv.submit(pg, 12)
        rs = srv.submit(ps, 12, temperature=0.9, seed=7, top_k=20, top_p=0.9)
        srv.run_until_idle()
        runs.append(list(rs.tokens))
        assert rg.tokens == tokens_of(tgenerate(CFG, eng.params, pg, 12), 0, len(pg))
        assert len(rs.tokens) == 12 or rs.tokens[-1] in CFG.eos_token_ids
        check_clean(srv)
    assert runs[0] == runs[1]


def test_spec_server_validation_matches_jax(setup):
    eng, jeng = setup[:2]
    for e, kw in ((eng, SKW), (jeng, dict(SKW, paged_attn="xla"))):
        with pytest.raises(ValueError, match="prefill_chunk"):
            e.serve(speculate=2, prefill_chunk=16, **kw)
        with pytest.raises(ValueError, match="speculate"):
            e.serve(speculate=-1, **kw)
        srv = e.serve(**kw)
        with pytest.raises(ValueError, match="tokenizer"):
            srv.submit(PROMPTS[0], 4, stop=["x"])
        e.tokenizer = FakeTok()
        try:
            with pytest.raises(ValueError, match="non-empty strings"):
                srv.submit(PROMPTS[0], 4, stop=[""])
        finally:
            e.tokenizer = None


def test_speculate_zero_server_is_unchanged(setup):
    """``speculate=0`` (the default) keeps the arena window, the decode
    step and the streams of a server built without the option."""
    eng = setup[0]
    a = eng.serve(batch_per_slot=2, **SKW)
    b = eng.serve(batch_per_slot=2, speculate=0, **SKW)
    assert a.state.kpos.shape == b.state.kpos.shape == (2, SKW["capacity"])
    assert a.state.block_tables.shape == b.state.block_tables.shape
    assert [r.tokens for r in _run(a, PROMPTS, 10)] == [r.tokens for r in _run(b, PROMPTS, 10)]
    spec = port_server(eng, K=3)
    assert spec.state.kpos.shape == (2, SKW["capacity"] + 4)
