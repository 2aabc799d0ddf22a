"""Dense serving in the port (``Engine.serve()`` without KV arguments, the
JAX ``serve`` default) against the JAX package's dense ``PipelineServer``
on ``tiny_llama`` in float32: greedy streams are token-exact (tolerance:
none) for one-shot, chunked and speculative admission, a late join and a
cancel. A dense snapshot restores token-exactly, ``extract`` / ``adopt``
move a request between dense servers and into a paged one, a dense
snapshot refuses a paged server and a paged one a dense server, with the
JAX messages. Sampled streams equal the port's ``generate`` at the same
seed, as in the earlier parity files. ``serve_chunk`` keeps its fixed
shape and copies nothing from the host in dense mode too.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu.runtime.server import PipelineServer as JServer
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.server import PipelineServer

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


CFG = tcfg.tiny_llama(num_hidden_layers=2)
LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)
KW = dict(capacity=64, batch_per_slot=3)


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=2)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(5), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, CFG.vocab_size, n).astype(np.int32) for n in LENS]
    # repetitive prompts: the drafter proposes and some drafts are accepted
    spec = [np.tile(rng.integers(3, CFG.vocab_size, k).astype(np.int32), r)
            for k, r in ((3, 3), (4, 3), (7, 1))]
    return eng, jeng, cj, tree, prompts, spec


def oracle(setup, p, n):
    _, _, cj, tree, _, _ = setup
    r = jgenerate(cj, jax.tree.map(jnp.asarray, tree), p, n, cache_dtype=jnp.float32)
    return np.asarray(r.tokens)[0, len(p) : int(r.lengths[0])].tolist()


def _running(setup, n):
    """``n`` prompts whose greedy streams run a 20-token budget out (on
    random weights a request may reach EOS within a few tokens)."""
    out = [p for p in setup[4] if len(oracle(setup, p, 20)) == 20]
    assert len(out) >= n
    return out[:n]


def _late_join(srv, prompts):
    """Two requests, two steps, then three more."""
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=8)], ids=["one_shot", "chunked"])
def test_late_join_streams_match_jax_dense_server(setup, kw):
    eng, jeng, *_ , prompts, _ = setup
    srv = eng.serve(**KW, **kw)
    assert srv.state.dense and tuple(srv.state.k.shape) == (2, 3, 64, CFG.num_key_value_heads,
                                                           CFG.head_dim_)
    got = _late_join(srv, prompts)
    want = _late_join(jeng.serve(**KW, **kw), prompts)
    assert got == want
    assert got == [oracle(setup, p, m) for p, m in zip(prompts, MAX_NEW)]
    srv.close()


def test_speculative_streams_match_jax_dense_server(setup):
    """``speculate=3`` through the dense ``serve_verify`` (flash at S = K +
    1 over the rows' caches); the spec counters agree too."""
    eng, jeng, *_, spec = setup
    srv = eng.serve(speculate=3, **KW)
    jsrv = jeng.serve(speculate=3, **KW)
    got = [srv.submit(p, 14) for p in spec]
    want = [jsrv.submit(p, 14) for p in spec]
    srv.run_until_idle()
    jsrv.run_until_idle()
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.tokens for r in got] == [oracle(setup, p, 14) for p in spec]
    assert srv.state.k.shape[2] == 64 + 4  # K + 1 columns over the capacity
    srv.close()


def test_cancel_matches_jax_dense_server(setup):
    """The cancelled request is one that runs to its budget (so it is in
    flight after three steps on random weights); the others stream as on
    the JAX server."""
    eng, jeng, *_, prompts, _ = setup
    idx = (0, 1, 2, 3, 4)
    victim = next(i for i in idx if len(oracle(setup, prompts[i], 12)) == 12)

    def run(srv):
        reqs = {i: srv.submit(prompts[i], 12) for i in idx[:3] + (victim,)}
        for _ in range(3):
            srv.step()
        assert not reqs[victim].done
        assert srv.cancel(reqs[victim])
        srv.run_until_idle()
        return {i: r.tokens for i, r in reqs.items() if i != victim}

    assert run(eng.serve(**KW)) == run(jeng.serve(**KW))


def test_sampled_dense_rows_match_port_generate(setup):
    eng, *_, prompts, _ = setup
    srv = eng.serve(**KW)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=5)
    reqs = [srv.submit(prompts[i], 10, **kw) for i in (0, 3)]
    srv.run_until_idle()
    for r, i in zip(reqs, (0, 3)):
        want = tgenerate(eng.cfg, eng.params, prompts[i], 10, **kw)
        assert r.tokens == want.tokens[0, LENS[i] : want.lengths[0]].tolist()


def test_dense_prefix_handle_matches_whole_prompt(setup):
    """A dense server's ``PrefixHandle`` owns no blocks; the suffix streams
    what the whole prompt does."""
    eng, *_, prompts, _ = setup
    srv = eng.serve(**KW)
    pre, suf = prompts[1][:12], prompts[1][12:]
    h = srv.prefill_prefix(pre)
    assert h.blocks is None
    r = srv.submit(suf, 9, prefix=h)
    srv.run_until_idle()
    assert r.tokens == oracle(setup, prompts[1], 9)
    srv.release_prefix(h)  # a no-op on a dense handle


@pytest.mark.parametrize("where", ["memory", "disk"])
def test_dense_snapshot_restores_token_exact(setup, tmp_path, where):
    eng, *_, prompts, _ = setup
    srv = eng.serve(**KW)
    reqs = [srv.submit(prompts[i], 14, tenant="acme") for i in (0, 1, 2, 3)]
    for _ in range(4):
        srv.step()
    srv._drain(0)
    assert any(not r.done and r.row is not None for r in reqs)
    snap = srv.snapshot()
    assert snap["paged"] is None and list(snap["arena"]) == ["rows", "k", "v"]
    if where == "disk":
        from llm_sharding_tpu_torch.runtime.server import load_snapshot, save_snapshot

        save_snapshot(snap, str(tmp_path / "snap"))
        snap = load_snapshot(str(tmp_path / "snap"))
    srv2 = PipelineServer.restore(eng, snap)
    byid = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    srv2.run_until_idle()
    for i, r in zip((0, 1, 2, 3), reqs):
        got = r if r.done else byid[r.id]  # a request done before the snapshot stays here
        assert got.tokens == oracle(setup, prompts[i], 14)
        assert got.tenant == "acme"


def test_snapshot_mode_refusals_match_jax(setup):
    """A dense snapshot refuses a paged server, a paged one a dense server:
    the same curated messages as the JAX server's."""
    eng, jeng, *_ = setup
    for e, cls in ((eng, PipelineServer), (jeng, JServer)):
        snap = e.serve(**KW).snapshot()
        snap["serve_kwargs"].update(kv_block_size=8, kv_blocks=24)
        with pytest.raises(ValueError, match="dense-mode snapshot cannot restore into a paged"):
            cls.restore(e, snap)
        snap = e.serve(kv_block_size=8, kv_blocks=24, **KW).snapshot()
        snap["serve_kwargs"].update(kv_block_size=None, kv_blocks=None)
        with pytest.raises(ValueError, match="paged-mode snapshot cannot restore into a dense"):
            cls.restore(e, snap)


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(paged_attn="kernel"),
                                dict(prefix_cache="hbm")], ids=["kv-dtype", "paged-attn", "prefix"])
def test_dense_refusals_match_jax(setup, kw):
    eng, jeng, *_ = setup
    msgs = []
    for e in (eng, jeng):
        with pytest.raises(ValueError) as info:
            e.serve(**KW, **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("to_paged", [False, True], ids=["dense", "paged"])
def test_extract_adopt_from_a_dense_server(setup, to_paged):
    eng, *_, prompts, _ = setup
    src = eng.serve(**KW)
    dst = eng.serve(kv_block_size=8, kv_blocks=40, **KW) if to_paged else eng.serve(**KW)
    reqs = [src.submit(prompts[i], 14) for i in (0, 2)]
    for _ in range(3):
        src.step()
    moving = reqs[0]
    assert not moving.done
    st = src.extract(moving)
    dst.adopt(st, moving)
    src.run_until_idle()
    dst.run_until_idle()
    assert moving.tokens == oracle(setup, prompts[0], 14)
    assert reqs[1].tokens == oracle(setup, prompts[2], 14)


def test_dense_serve_chunk_copies_nothing_from_the_host(setup, monkeypatch):
    """``serve_chunk`` on a dense state runs ``cycles`` steps with
    ``torch.from_numpy`` patched to raise, equal to ``cycles`` single steps
    on a copy; the free row commits nothing."""
    eng, *_, prompts, _ = setup
    srv = eng.serve(**KW)
    reqs = [srv.submit(p, 20) for p in _running(setup, 2)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs)
    st = srv.state
    twin = copy.deepcopy(st)

    def refuse(*a, **k):
        raise AssertionError("serve_chunk copied a numpy array to the device")

    monkeypatch.setattr(torch, "from_numpy", refuse)
    log = tserve.serve_chunk(CFG, eng.params, st, 3)
    singles = [tserve.serve_chunk(CFG, eng.params, twin, 1) for _ in range(3)]
    monkeypatch.undo()
    assert torch.equal(log, torch.cat(singles))
    assert bool((log[:, [r.row for r in reqs]] >= 0).all()) and bool((log[:, 2] == -1).all())
    for f in ("tok", "pos_slots", "write_off", "lengths", "done", "kpos", "k", "v"):
        assert torch.equal(getattr(st, f), getattr(twin, f)), f
    srv.close()


def test_dense_done_rows_write_nothing(setup):
    """A done row's cache row and key positions are untouched by a chunk
    (its write is a select of the bytes it read)."""
    eng = setup[0]
    srv = eng.serve(**KW)
    r = srv.submit(_running(setup, 1)[0], 20)
    srv.step()
    srv._drain(0)
    assert not r.done
    st = srv.state
    k0, v0, kpos0 = st.k.clone(), st.v.clone(), st.kpos.clone()
    tserve.serve_cancel_rows(st, [r.row])
    log = tserve.serve_chunk(CFG, eng.params, st, 2)
    assert bool((log == -1).all())
    assert torch.equal(st.k, k0) and torch.equal(st.v, v0) and torch.equal(st.kpos, kpos0)
    srv.close()
