"""The port's prefix reuse (the automatic radix cache in its hbm, host and
disk tiers, and explicit ``PrefixHandle``s) against the JAX package's
``PipelineServer`` on the CPU, ``tiny_llama`` at 8 layers in float32, block
size 8, ``prefill_chunk=16`` (a suffix bucket above 16 admits chunked).

Every case runs the same submits, in the same waves (submit, then run to
idle), through the port's server and the JAX one (``paged_attn="xla"``, one
stage), and through the port's server with ``prefix_cache="off"``:

- the streams equal the JAX server's; ``prefix_cache_stats()`` equals the
  JAX tree's after every wave (so the hits, evictions and tier moves
  happened alike);
- the streams equal the cache-off server's: with an f32 arena exactly; with
  an int8 or fp8 arena a hit reads the prefix back from codes where a cold
  admission recomputed it in f32, so a stream may first differ only at a
  near tie, a top-2 logit gap < 1e-3 in the cache-off run's own sampling
  (the same rule holds port against JAX for the quantized arenas, as in
  ``tests/test_torch_kv_quant.py``; the gap is printed);
- the allocator's and the tree's invariants hold after every wave.

Also here: the shared prefix blocks' codes and scales are unchanged by a
chunked radix hit (the fault the first chunk's scale reset would cause),
the serve programs' prefix columns, the JAX server's validation messages,
a cancel/close chaos case, and the plain versions of the flash and
chunked-prefill kernels at the shapes a hit gives them, against the JAX
package's Pallas kernels in interpret mode (f32 1e-5, bf16 2e-2).
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
from llm_sharding_tpu.ops import flash_attention as jfa
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.parallel import serve as tserve
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.server import RequestFailed

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


SENTINEL = int(POS_SENTINEL)
BS = 8
CAP = 128
CHUNK = 16
NEAR_TIE = 1e-3
KVS = ["bf16", "int8", "fp8"]


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=8)
    ct = tcfg.tiny_llama(num_hidden_layers=8)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(11), dtype=jnp.float32))
    eng = Engine(ct, tllama.params_from_numpy(ct, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    return eng, jeng


def prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 256, n).astype(np.int32)


def serve_kw(cache="hbm", kv="bf16", frac=1.0, rows=1, tmp=None, **kw):
    out = dict(capacity=CAP, batch_per_slot=rows, kv_block_size=BS,
               kv_blocks=max(4, int(4 * CAP * frac) // BS + 1), prefill_chunk=CHUNK,
               kv_dtype=kv, prefix_cache=cache)
    if cache == "disk":
        out["disk_pool_dir"] = str(tmp)
    out.update(kw)
    return out


class Gaps:
    """Top-2 logit gap of every token a port server samples, per request."""

    def __init__(self, monkeypatch):
        self.srv = None
        self.by_id = collections.defaultdict(list)
        sample = tserve._sample_rows

        def recording(state, rows, logits):
            top = torch.topk(logits.float(), 2, dim=-1).values
            # a decode chunk samples every row (``rows`` is a range): only
            # the rows live on the device commit
            live = ~state.done if isinstance(rows, range) else None
            for i, r in enumerate(rows):
                if live is not None and (not live[r] or self.srv._req[r] is None):
                    continue
                self.by_id[(id(self.srv), self.srv._req[r].id)].append(
                    float(top[i, 0] - top[i, 1]))
            return sample(state, rows, logits)

        monkeypatch.setattr(tserve, "_sample_rows", recording)

    def of(self, srv, req):
        return self.by_id[(id(srv), req.id)]


def check_clean(srv):
    """Both invariants, and the tree's blocks are the only ones held."""
    srv._alloc.check()
    if srv._radix is not None:
        srv._radix.check()
        assert srv._alloc.in_use == srv._radix.device_blocks
    assert not any(srv._row_blocks) and not any(srv._row_shared)
    assert not any(srv._row_radix)


def drive(srv, waves, gaps=None, between=None):
    """Each wave's ``(prompt, max_new)`` submitted together, then the server
    run to idle. Returns the requests per wave and the stats after each."""
    if gaps is not None:
        gaps.srv = srv
    reqs, stats = [], []
    for i, wave in enumerate(waves):
        reqs.append([srv.submit(p, m) for p, m in wave])
        srv.run_until_idle()
        stats.append(srv.prefix_cache_stats())
        if between is not None:
            between(i, srv)
        srv._alloc.check()
        if srv._radix is not None:
            srv._radix.check()
    return reqs, stats


def same_stream(got, want, gaps, tag, exact):
    """``got`` equals ``want``, or (``exact`` False) first differs where
    ``gaps`` (the sampling run's top-2 gaps) says the step was a near tie."""
    assert len(got) == len(want), tag
    if got == want:
        return
    assert not exact, f"{tag}: {got} != {want}"
    step = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    print(f"{tag}: first mismatch at token {step}, top-2 gap {gaps[step]:.3g}")
    assert gaps[step] < NEAR_TIE, tag


def compare(setup, monkeypatch, waves, tmp_path=None, between=None, **kw):
    """``waves`` through the port (cache on), the JAX server (cache on) and
    the port (cache off); holds them to the module's rules. Returns the
    port's and the JAX server's requests and stats."""
    eng, jeng = setup
    gaps = Gaps(monkeypatch)
    kv = kw.get("kv", "bf16")
    exact = kv == "bf16"

    def kw_for(side):
        k = dict(kw)
        if k.get("cache") == "disk":
            k["tmp"] = tmp_path / side
            k["tmp"].mkdir()
        return serve_kw(**k)

    srv = eng.serve(**kw_for("port"))
    reqs, stats = drive(srv, waves, gaps, between)
    jsrv = jeng.serve(paged_attn="xla", **kw_for("jax"))
    jreqs, jstats = drive(jsrv, waves, None, between)
    off = eng.serve(**serve_kw(**{**kw, "cache": "off"}))
    oreqs, _ = drive(off, waves, gaps)
    for w, (wave, jwave, owave) in enumerate(zip(reqs, jreqs, oreqs)):
        assert stats[w] == jstats[w], f"wave {w}: port {stats[w]} != jax {jstats[w]}"
        for r, jr, o in zip(wave, jwave, owave):
            assert r.done and r.error is None
            same_stream(r.tokens, list(jr.tokens), gaps.of(srv, r), f"wave {w} vs jax", exact)
            same_stream(r.tokens, o.tokens, gaps.of(off, o), f"wave {w} vs cache off", exact)
    check_clean(srv)
    check_clean(off)
    jsrv.close()
    return srv, reqs, stats, jsrv


# ---------------------------------------------------- streams and stats


@pytest.mark.parametrize("kv", KVS)
def test_warm_hits_one_shot_and_chunked_match_jax(setup, monkeypatch, kv):
    """A cold chunked admission of a 27-token prompt caches 3 blocks; then
    a hit whose 8-token suffix admits one-shot (flash at S < C from
    position 24), and one whose 33-token suffix admits chunked at
    ``prefix_off`` 24."""
    p1 = prompt(0, 3 * BS + 3)
    waves = [[(p1, 6)], [(np.concatenate([p1[:3 * BS], prompt(1, 8)]), 6)],
             [(np.concatenate([p1[:3 * BS], prompt(2, 33)]), 6)]]
    srv, _, stats, _ = compare(setup, monkeypatch, waves, kv=kv)
    assert [s["hit_tokens"] for s in stats] == [0, 3 * BS, 6 * BS]


def test_multi_turn_reuse_grows(setup, monkeypatch):
    """Each turn's prompt is the last prompt, its completion and 3 new
    tokens: the hits deepen turn by turn (one-shot, then chunked once the
    new turn's suffix outgrows a chunk)."""
    eng, _ = setup
    hist = prompt(3, 2 * BS + 1)
    waves = []
    ref = eng.serve(**serve_kw(cache="off"))
    for turn in range(4):
        waves.append([(hist, 5)])
        r = ref.submit(hist, 5)
        ref.run_until_idle()
        hist = np.concatenate([hist, np.asarray(r.tokens, np.int32), prompt(10 + turn, 3 + 6 * turn)])
    _, _, stats, _ = compare(setup, monkeypatch, waves)
    hits = [s["hit_tokens"] for s in stats]
    assert hits[0] == 0 and hits[1] > 0 and hits[2] > hits[1] and hits[3] > hits[2]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_coadmission_of_the_same_prefix(setup, monkeypatch, kv):
    """Two queued requests over one cached 2-block prompt co-admit into
    one batch (same matched prefix, same suffix bucket) and both hit; a
    third with another suffix bucket waits for the next admission."""
    sys_p = prompt(4, 2 * BS)
    pa = np.concatenate([sys_p, prompt(5, 3)])
    pb = np.concatenate([sys_p, prompt(6, 4)])
    eng, _ = setup
    probe = eng.serve(**serve_kw(rows=2, kv=kv))
    probe.submit(sys_p, 4)
    probe.run_until_idle()
    ra, rb = probe.submit(pa, 5), probe.submit(pb, 5)
    probe.step()
    assert ra.row is not None and rb.row is not None  # one admission, two rows
    assert probe._row_radix[ra.row] is probe._row_radix[rb.row]
    probe.run_until_idle()
    waves = [[(sys_p, 4)], [(pa, 5), (pb, 5)]]
    _, _, stats, _ = compare(setup, monkeypatch, waves, rows=2, kv=kv)
    assert stats[1]["hit_tokens"] == 4 * BS


def test_eviction_under_pressure_admits_everything(setup, monkeypatch):
    """An arena of ~1.2 requests: every admission after the first evicts
    cold tree entries, and every request is admitted and exact."""
    waves = [[(prompt(20 + i, 2 * BS + 1 + i), 8)] for i in range(5)]
    _, _, stats, _ = compare(setup, monkeypatch, waves, frac=0.1)
    assert stats[-1]["evictions_dropped"] > 0


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("cache", ["host", "disk"])
def test_tiers_round_trip_byte_exact(setup, monkeypatch, tmp_path, cache, kv):
    """Warm a 3-block prefix, demote every node (to disk with the disk
    tier), stream it back: the arena bytes, codes and scales of a
    quantized arena, equal those before the demotion. Then a one-shot and
    a chunked hit on the streamed-back prefix, and after another demotion a
    hit served straight from the lower tier."""
    p1 = prompt(40, 3 * BS + 1)  # admitted chunked: its last token is not cached
    seen = {}

    def between(i, srv):
        if i != 0 and i != 2:
            return
        node = srv._radix.root.children[int(p1[0])]
        blocks = list(node.blocks)
        before = srv._read_arena_blocks(blocks)
        assert srv._radix.demote_all(to_disk=cache == "disk") > 0
        assert srv._radix.device_blocks == 0 and srv._alloc.in_use == 0
        if i == 2:
            return  # the next wave's hit streams it back
        ref = srv._radix.take(p1, 3 * BS)
        assert ref is not None and ref.n == 3 * BS
        after = srv._read_arena_blocks(list(ref.blocks))
        srv._radix.release(ref)
        assert len(before) == (2 if kv == "bf16" else 4)
        for a, b in zip(before, after):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        seen[type(srv).__module__] = before

    waves = [[(p1, 5)], [(np.concatenate([p1, prompt(41, 3)]), 5)],
             [(np.concatenate([p1, prompt(42, 20)]), 5)],
             [(np.concatenate([p1, prompt(43, 5)]), 5)]]
    _, _, stats, _ = compare(setup, monkeypatch, waves, tmp_path, between, cache=cache, kv=kv)
    tier_hits = "disk_hit_tokens" if cache == "disk" else "host_hit_tokens"
    assert stats[-1][tier_hits] == 2 * 3 * BS
    assert stats[-1]["hit_tokens"] == 3 * 3 * BS
    # the host copies have the JAX package's layout, [1, L, nb, BS, Nkv, D]
    # (scales [1, L, nb, Nkv]), and its dtypes as raw views
    port, jax_ = (seen[m] for m in sorted(seen, key=lambda m: "torch" not in m))
    assert [a.shape for a in port] == [a.shape for a in jax_]
    assert [a.dtype.itemsize for a in port] == [a.dtype.itemsize for a in jax_]


def test_disk_pool_is_adopted_by_a_fresh_server(setup, tmp_path):
    """A second server over the same disk pool adopts its entries and
    serves a hit from them, exactly."""
    eng, _ = setup
    kw = serve_kw(cache="disk", tmp=tmp_path)
    srv = eng.serve(**kw)
    p1 = prompt(50, 3 * BS + 1)
    srv.submit(p1, 4)
    srv.run_until_idle()
    srv._radix.demote_all(to_disk=True)
    assert srv._radix.disk_blocks == 3
    srv.close()
    srv2 = eng.serve(**kw)
    assert srv2._radix.disk_blocks == 3 and srv2.radix_match_tokens(p1) == 3 * BS
    p2 = np.concatenate([p1, prompt(51, 4)])
    r = srv2.submit(p2, 6)
    srv2.run_until_idle()
    off = eng.serve(**serve_kw(cache="off"))
    o = off.submit(p2, 6)
    off.run_until_idle()
    assert r.tokens == o.tokens
    assert srv2.prefix_cache_stats()["disk_hit_tokens"] == 3 * BS
    check_clean(srv2)


# ---------------------------------------------------- explicit handles


def test_prefix_handle_bypasses_tree_and_matches_jax(setup):
    """A padded 12-token prefix (bucket 16): two suffix requests co-admit
    with it and equal the JAX server's handle streams and the cache-off
    server's full-prompt streams; the tree is neither consulted nor fed;
    ``out`` holds the suffix at [0, len) and the generated run from the
    prefix-inclusive column."""
    eng, jeng = setup
    pfx = prompt(6, 12)
    sfx = [prompt(7, 5), prompt(8, 3)]
    got = {}
    for side, e in (("port", eng), ("jax", jeng)):
        srv = e.serve(**serve_kw(rows=2), **({"paged_attn": "xla"} if side == "jax" else {}))
        h = srv.prefill_prefix(pfx)
        assert h.n == 12 and h.spx == 16
        reqs = [srv.submit(s, 6, prefix=h) for s in sfx]
        srv.step()
        rows = [r.row for r in reqs]
        srv.run_until_idle()
        got[side] = [list(r.tokens) for r in reqs]
        st = srv.prefix_cache_stats()
        assert st["eligible_tokens"] == 0 and st["device_blocks"] == 0
        if side == "port":
            out = srv.state.out[rows[0]]
            total = h.n + len(sfx[0])
            np.testing.assert_array_equal(out[: len(sfx[0])], sfx[0])
            assert list(out[total : total + len(reqs[0].tokens)]) == reqs[0].tokens
            assert not np.any(out[len(sfx[0]) : total])
        srv.release_prefix(h)
        srv.release_prefix(h)  # a double release is a no-op
        srv._alloc.check()
        assert srv._alloc.in_use == 0
    assert got["port"] == got["jax"]
    off = eng.serve(**serve_kw(cache="off"))
    for s, toks in zip(sfx, got["port"]):
        r = off.submit(np.concatenate([pfx, s]), 6)
        off.run_until_idle()
        assert r.tokens == toks


def test_prefix_handle_validation_matches_jax(setup):
    """The JAX server's messages: empty suffix, layout past capacity, a
    handle of another server, a released handle (at submit, and for one
    released while its request was queued)."""
    eng, jeng = setup
    msgs = {}
    for side, e in (("port", eng), ("jax", jeng)):
        kw = {"paged_attn": "xla"} if side == "jax" else {}
        srv, other = e.serve(**serve_kw(), **kw), e.serve(**serve_kw(), **kw)
        h, foreign = srv.prefill_prefix(prompt(9, 10)), other.prefill_prefix(prompt(9, 10))
        out = []
        for args in ((np.zeros(0, np.int32), 4, h), (np.ones(8, np.int32), 120, h),
                     (np.ones(4, np.int32), 4, foreign)):
            with pytest.raises(ValueError) as e1:
                srv.submit(args[0], args[1], prefix=args[2])
            out.append(str(e1.value))
        with pytest.raises(ValueError) as e2:
            srv.prefill_prefix(np.zeros(0, np.int32))
        out.append(str(e2.value))
        with pytest.raises(ValueError) as e3:
            srv.release_prefix(foreign)
        out.append(str(e3.value))
        queued = srv.submit(np.ones(4, np.int32), 4, prefix=h)
        srv.release_prefix(h)
        with pytest.raises(ValueError) as e4:
            srv.submit(np.ones(4, np.int32), 4, prefix=h)
        out.append(str(e4.value))
        srv.run_until_idle()
        with pytest.raises(RequestFailed if side == "port" else Exception):
            srv.result(queued)
        out.append(str(queued.error))
        srv._alloc.check()
        assert srv._alloc.in_use == 0
        msgs[side] = out
    assert msgs["port"] == msgs["jax"]


def test_prefix_cache_option_validation_matches_jax(setup, tmp_path):
    """Each refused option combination raises the JAX server's message."""
    eng, jeng = setup
    base = dict(capacity=CAP, kv_block_size=BS, kv_blocks=64)
    bad = [dict(prefix_cache="lru"), dict(prefix_cache="hbm", host_pool_blocks=8),
           dict(prefix_cache="host", host_pool_blocks=-1),
           dict(prefix_cache="host", disk_pool_dir=str(tmp_path)),
           dict(prefix_cache="hbm", disk_pool_blocks=4), dict(prefix_cache="disk"),
           dict(prefix_cache="disk", disk_pool_dir=str(tmp_path), disk_pool_blocks=-2)]
    for kw in bad:
        with pytest.raises(ValueError) as ej:
            jeng.serve(**base, **kw)
        with pytest.raises(ValueError) as et:
            eng.serve(**base, **kw)
        assert str(et.value) == str(ej.value)
    srv = eng.serve(**base, prefix_cache="disk", disk_pool_dir=str(tmp_path))
    assert (srv.host_pool_blocks, srv.disk_pool_blocks) == (64, 64)
    assert eng.serve(**base, prefix_cache="off").prefix_cache_stats() is None
    assert eng.serve(**base).radix_match_tokens(prompt(1, 20)) == 0


# ------------------------------------------------ scales of shared blocks


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_chunked_hit_leaves_shared_blocks_unchanged(setup, kv):
    """A chunked radix hit maps the cached prefix blocks read-only: their
    codes and per-(block, KV head) scales are byte-identical before and
    after, and the hit's stream equals the JAX server's. A first chunk that
    reset the scales of every block its table names (not only its private
    ones) would zero the shared scales: the prefix's codes then dequantize
    to 0 under every row mapping them."""
    eng, jeng = setup
    p = prompt(90, 4 * BS + 3)
    p2 = np.concatenate([p[: 4 * BS], prompt(91, 20)])  # suffix bucket 32: chunked
    streams = {}
    for side, e in (("port", eng), ("jax", jeng)):
        srv = e.serve(**serve_kw(kv=kv), **({"paged_attn": "xla"} if side == "jax" else {}))
        srv.submit(p, 6)
        srv.run_until_idle()
        ref = srv._radix.take(p, 4 * BS)
        blocks = list(ref.blocks)
        before = [np.array(a) for a in srv._read_arena_blocks(blocks)]
        srv._radix.release(ref)
        r2 = srv.submit(p2, 6)
        srv.run_until_idle()
        assert srv.prefix_cache_stats()["hit_tokens"] == 4 * BS
        after = srv._read_arena_blocks(blocks)
        assert len(before) == 4
        for i, (b, a) in enumerate(zip(before, after)):
            assert np.array_equal(b, np.asarray(a)), f"{side}: shared component {i} changed"
        assert before[2].min() > 0  # live scales, not a wiped block
        streams[side] = list(r2.tokens)
    assert streams["port"] == streams["jax"]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_prefix_chunk_keeps_prefix_positions_scales_and_nlive(setup, kv, monkeypatch):
    """The serve program directly: rows whose first 2 table entries are
    shared blocks holding a prefix, first chunk at ``prefix_off`` 16. The
    shared blocks' scales and codes stay, the prefix columns keep
    positions 0-15, the private blocks' stale scales are reset, and the
    chunked-prefill call gets ``nlive`` covering prefix + chunk."""
    eng, _ = setup
    cfg = eng.cfg
    srv = eng.serve(**serve_kw(kv=kv, rows=2))
    st = srv.state
    gen = torch.Generator().manual_seed(5)
    st.k_scale.copy_(torch.rand(st.k_scale.shape, generator=gen) + 0.5)
    st.v_scale.copy_(torch.rand(st.v_scale.shape, generator=gen) + 0.5)
    st.k.view(torch.uint8).copy_(torch.randint(0, 100, st.k.shape, generator=gen, dtype=torch.uint8))
    tbl = np.zeros(st.block_tables.shape, np.int32)
    tbl[:, :2] = [5, 6]  # shared
    tbl[0, 2:6], tbl[1, 2:6] = [7, 8, 9, 10], [11, 12, 13, 14]
    st.block_tables.copy_(torch.from_numpy(tbl))
    ks0, k0 = st.k_scale.clone(), st.k.view(torch.uint8).clone()
    seen = {}
    model_fns = tserve.model_fns
    real = model_fns(cfg).stage_paged

    def spy(*a, **kw):
        seen["nlive"] = kw["nlive"].tolist()
        seen["kv_pos"] = a[7].clone()
        return real(*a, **kw)

    monkeypatch.setattr(tserve, "model_fns", lambda c: model_fns(c)._replace(stage_paged=spy))
    toks = np.ones((2, CHUNK), np.int32)
    pos = (16 + np.arange(CHUNK, dtype=np.int32))[None].repeat(2, 0)
    tserve.serve_prefill_chunk(cfg, eng.params, st, [0, 1], toks, pos, 0, True, prefix_off=16)
    assert seen["nlive"] == [-(-(16 + CHUNK) // BS)] * 2
    np.testing.assert_array_equal(seen["kv_pos"][:, :16].numpy(), np.arange(16)[None].repeat(2, 0))
    assert (seen["kv_pos"][:, 16 + CHUNK :] == SENTINEL).all()
    assert torch.equal(st.k_scale[:, [5, 6]], ks0[:, [5, 6]])
    assert torch.equal(st.k.view(torch.uint8)[:, [5, 6]], k0[:, [5, 6]])
    assert (st.k_scale[:, [9, 10, 13, 14]] == 0).all()  # private, past the chunk: reset
    assert st.write_off[0] == 16 + CHUNK


# ---------------------------------------------------------------- chaos


def test_cancel_then_close_leaves_everything_clean(setup):
    """Cancel mid-decode (the prompt is cached), cancel a queued request
    holding a staged radix pin, close with rows live and requests queued:
    the allocator and the tree stay consistent, the pins all drop, and
    what the tree holds is all that is held."""
    eng, _ = setup
    srv = eng.serve(**serve_kw(cache="host", rows=2, frac=0.3))
    p0 = prompt(30, 2 * BS)
    r0 = srv.submit(p0, 24)
    for _ in range(3):
        srv.step()
    assert srv.cancel(r0) and not srv.cancel(r0)
    assert srv.prefix_cache_stats()["device_blocks"] == 2
    live = srv.submit(np.concatenate([p0, prompt(31, 3)]), 40)
    live2 = srv.submit(prompt(32, 3 * BS), 40)
    srv.step()
    waiting = srv.submit(np.concatenate([p0, prompt(33, 9)]), 5)
    srv.step()  # stages the queued request's match: a pin
    assert waiting.staged_radix is not None
    assert srv.cancel(waiting)
    assert waiting.staged_radix is None
    queued = [srv.submit(np.concatenate([p0, prompt(34 + i, 4)]), 5) for i in range(2)]
    srv.step()
    srv.close()
    for r in (live, live2, *queued):
        with pytest.raises(RequestFailed):
            srv.result(r)
    check_clean(srv)
    assert all(n.refs == 0 for n in srv._radix._iter_nodes())


# ------------------------------------- the new kernel shapes, plain path


DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dt):
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a)).to(tdt)


def _ints(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a, np.int32))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_plain_past_a_prefix_matches_pallas_interpret(monkeypatch, dt):
    """A one-shot radix hit's flash: S = 16 suffix queries (the second row
    bucket-padded, 11 real) at positions 32-47 over C = 48 keys, the first
    32 the prefix, G = 3."""
    monkeypatch.setattr(jfa, "BLOCK_Q", 8)
    monkeypatch.setattr(jfa, "BLOCK_K", 16)
    rng = np.random.default_rng(60)
    B, S, P, Nh, Nkv, D = 2, 16, 32, 6, 2, 16
    C = P + S
    qpos = np.tile(P + np.arange(S, dtype=np.int32), (B, 1))
    qpos[1, 11:] = SENTINEL
    kvpos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    kvpos[1, P + 11 :] = SENTINEL
    q = rng.normal(size=(B, S, Nh, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jqp, tqp), (jkp, tkp) = _ints(qpos), _ints(kvpos)
    want = jfa.flash_attention(jq, jk, jv, jqp, jkp, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, tqp, tkp)
    rows = qpos < SENTINEL
    np.testing.assert_allclose(got.float().numpy()[rows], np.asarray(want, np.float32)[rows],
                               atol=DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_prefill_plain_over_shared_prefix_matches_pallas_interpret(monkeypatch, dt):
    """A chunked radix hit's first chunk: two rows whose first two table
    entries are the same shared blocks (a 16-token prefix), 12 queries at
    columns and positions 16-27, ``nlive`` counting the prefix; stale
    blocks past the frontier and NaN/Inf in trash block 0."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    rng = np.random.default_rng(61)
    B, Sc, BS_, T, Nkv, G, D, NB = 2, 12, 8, 6, 2, 2, 16, 12
    k = rng.normal(size=(NB, BS_, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS_, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.inf
    tbl = np.array([[4, 9, 1, 6, 3, 0], [4, 9, 2, 11, 5, 10]], np.int32)
    P = 16
    kvpos = np.full((B, T * BS_), SENTINEL, np.int32)
    kvpos[:, : P + Sc] = np.arange(P + Sc)
    qpos = np.tile(P + np.arange(Sc, dtype=np.int32), (B, 1))
    qpos[1, 9:] = SENTINEL
    kvpos[1, P + 9 : P + Sc] = SENTINEL
    nlive = np.full(B, -(-(P + Sc) // BS_), np.int32)
    q = rng.normal(size=(B, Sc, Nkv * G, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jt, tt), (jqp, tqp), (jkp, tkp), (jnl, tnl) = map(_ints, (tbl, qpos, kvpos, nlive))
    want = jpa.paged_prefill_tpu(jq, jk, jv, jt, jqp, jkp, interpret=True, nlive=jnl,
                                 blocks_per_step=1)
    got = tpa.paged_prefill(tq, tk, tv, tt, tqp, tkp, nlive=tnl)
    rows = qpos < SENTINEL
    np.testing.assert_allclose(got.float().numpy()[rows], np.asarray(want, np.float32)[rows],
                               atol=DTYPES[dt][2])


def test_dropped_server_frees_its_arena_without_the_collector(setup, tmp_path):
    """The tree's device callbacks hold the server's state, not the server:
    with the cache on in every tier, a dropped server (and its arena) goes
    as soon as its last reference does, not at the next garbage
    collection."""
    import gc
    import weakref

    eng, _ = setup
    gc.disable()
    try:
        for cache in ("off", "hbm", "host", "disk"):
            srv = eng.serve(**serve_kw(cache=cache, tmp=tmp_path / cache))
            srv.submit(prompt(70, 2 * BS + 1), 3)
            srv.run_until_idle()
            h = srv.prefill_prefix(prompt(71, 9))
            arena, state = weakref.ref(srv.state.k), weakref.ref(srv.state)
            del srv
            assert state() is None and arena() is None, cache
            assert h.owner() is None
    finally:
        gc.enable()
