"""The launch plans of the redesigned paged kernels on the CPU.

- Decode (``plan_decode`` / ``decode_pieces``), over drawn batch sizes,
  lengths, table widths, block sizes 8-128, SM counts, S and G: the grid
  and the scratch depend on shapes alone; the pieces cover each row's live
  columns (its ``nlive`` blocks) exactly once, in runs that start on a
  tile; no piece is empty; a row's runs carry consecutive slots and one
  ``nparts``; every piece's share is within one tile of the others'. The
  tensor-core chunked prefill (``plan_prefill_splits`` /
  ``prefill_run_cols``): the split count from shapes alone, each row's
  runs covering its live columns once.
- The kernels' split form, with plain arithmetic: each run's ``(acc, m,
  l)`` over its columns (trash block 0 read as a zero key, as the kernels
  and the TPU kernels read it), merged in run order by
  ``combine_attn_stats``, equals the JAX package's ``paged_attention_tpu``
  and ``paged_prefill_tpu`` in interpret mode on the same seeded numpy
  inputs, f32 queries, every KV mode (f32 arena, int8 and fp8 codes), with
  trash inside the window at visible positions and a row that sees no key
  (left out of the comparison: garbage on every path, and finite here).
  Tolerance 1e-5 relative to the row's largest output (summation order).
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models.cache import POS_SENTINEL  # models first: ops <-> models cycle
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu_torch.ops import paged_attention as tpa

SENTINEL = int(POS_SENTINEL)
BLOCK_SIZES = (8, 16, 32, 64, 128)


def _check_cover(live, runs_of):
    """Each key of ``runs_of`` (a row or an item) is covered exactly once
    over its live columns, its runs in consecutive slots of one nparts."""
    for key, runs in runs_of.items():
        n = live[key]
        cover = np.zeros(n, np.int64)
        nparts = {r[-1] for r in runs}
        assert len(nparts) == 1 and len(runs) == nparts.pop()
        for c0, c1, *_ in runs:
            cover[c0:c1] += 1
        assert (cover == 1).all()


@settings(max_examples=150, deadline=None)
@given(
    lens=st.lists(st.integers(0, 5000), min_size=1, max_size=20),
    T=st.integers(1, 80), BS=st.sampled_from(BLOCK_SIZES), sms=st.integers(1, 264),
    S=st.integers(1, 6), G=st.sampled_from((1, 3, 8)), Nkv=st.sampled_from((1, 2, 8, 32)),
    bf16=st.booleans(),
)
def test_decode_plan_covers_each_live_column_once(lens, T, BS, sms, S, G, Nkv, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    B, W = len(lens), T * BS
    plan = tpa.plan_decode(B, S, G * Nkv, Nkv, T, BS, dtype, sms)
    # shapes alone: another batch of lengths gets the same launch
    assert plan == tpa.plan_decode(B, S, G * Nkv, Nkv, T, BS, dtype, sms)
    GS = G * S
    assert plan.groups * plan.rows >= GS and plan.rows == min(GS, tpa.decode_row_group(GS, dtype))
    assert plan.pieces == max(1, sms // (Nkv * plan.groups))
    tk = plan.tile_cols
    nlive = [-(-n // BS) for n in lens]  # the blocks covering each written frontier
    live = tpa.decode_live_cols(B, T, BS, nlive)
    assert live == [min(T, n) * BS for n in nlive] and tpa.decode_live_cols(B, T, BS) == [W] * B
    assert plan.min_tiles == max(1, -(-plan.rows // 8))
    pieces = tpa.decode_pieces(live, tk, plan.pieces, plan.min_tiles)
    assert len(pieces) == plan.pieces
    by_row, shares = {}, []
    for runs in pieces:
        tiles = 0
        for b, c0, c1, slot, nparts in runs:
            assert c0 % tk == 0 and c0 < c1 <= live[b] and 0 <= slot < nparts <= plan.slots
            by_row.setdefault(b, []).append((c0, c1, slot, nparts))
            tiles += -(-c1 // tk) - c0 // tk
        shares.append(tiles)
    for b, runs in by_row.items():
        assert [r[2] for r in runs] == list(range(len(runs)))
    _check_cover(live, {b: by_row.get(b, [(0, 0, 0, 1)]) for b in range(B)})
    busy = [n for n in shares if n]
    N = sum(-(-n // tk) for n in live)
    assert len(busy) == min(plan.pieces, -(-N // plan.min_tiles))
    assert not busy or (max(busy) - min(busy) <= 1 and min(busy) == N // len(busy))


@settings(max_examples=150, deadline=None)
@given(
    fronts=st.lists(st.integers(0, 4096), min_size=1, max_size=10),
    Sc=st.sampled_from((8, 100, 128, 256, 512)), Nh=st.sampled_from((1, 4, 8, 24)),
    BS=st.sampled_from((16, 32, 64, 128)), sms=st.integers(1, 264),
)
def test_prefill_plan_covers_each_live_column_once(fronts, Sc, Nh, BS, sms):
    """The tensor-core prefill's split count depends on shapes alone (the
    table's width); each row's runs, sized from its own ``nlive``, start on
    a tile and cover its live columns exactly once."""
    B = len(fronts)
    T = -(-max(fronts + [1]) // BS)
    run, nsplit = tpa.plan_prefill_splits(B, Sc, Nh, T * BS, BS, sms)
    assert (run, nsplit) == tpa.plan_prefill_splits(B, Sc, Nh, T * BS, BS, sms)
    assert 1 <= nsplit <= tpa.PREFILL_MAX_SPLITS
    tc = tpa.PREFILL_TILE_COLS
    for f in fronts:
        live = -(-f // BS) * BS  # nlive blocks, as the server passes them
        r = tpa.prefill_run_cols(live, nsplit, BS)
        cover = np.zeros(live, np.int64)
        for i in range(nsplit):
            lo, hi = min(live, i * r), min(live, (i + 1) * r)
            assert lo == hi or lo % tc == 0
            cover[lo:hi] += 1
        assert (cover == 1).all()


# ------------------------------------------ the split form against the TPU kernels

def _arena(rng, mode, NB, BS, Nkv, D):
    """f32 K/V arenas (trash block 0 NaN), or int8 / fp8 codes with
    per-(block, KV head) scales (trash codes 0x7F, scale Inf), as numpy
    arrays for JAX and torch tensors for the port."""
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    if mode == "f32":
        k[0], v[0] = np.nan, np.nan
        return (jnp.asarray(k), jnp.asarray(v), {}), (torch.from_numpy(k), torch.from_numpy(v), {})
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[mode]
    tdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    out = []
    for x in (k, v):
        sc = (np.abs(x).max(axis=(1, 3)) / float(jquant.kv_qmax(jdt))).astype(np.float32)
        codes = np.asarray(jquant.kv_quantize(jnp.asarray(x), jnp.asarray(sc[:, None, :, None]), jdt))
        raw = codes.view(np.uint8).copy()
        raw[0] = 0x7F
        sc[0] = np.inf
        out += [raw, sc]
    kr, ks, vr, vs = out
    npdt = np.int8 if mode == "int8" else ml_dtypes.float8_e4m3fn
    jside = (jnp.asarray(kr.view(npdt)), jnp.asarray(vr.view(npdt)),
             dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    tside = (torch.from_numpy(kr).view(tdt), torch.from_numpy(vr).view(tdt),
             dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    return jside, tside


def _run_stats(q, k, v, tbl, qpos, kvpos, c0, c1, sc):
    """``(acc, m, l)`` of one row's queries ``q [S, Nh, D]`` over its
    columns ``[c0, c1)``: the window gathered with trash block 0 as zeros
    (a zero key scores 0 where its position is visible), masked by position
    only; a masked key adds exactly zero, so a run that sees nothing is
    ``(0, -1e30, 0)``."""
    S, Nh, D = q.shape
    kw, vw = tpa.gather_block_kv(k, v, tbl[None], out_dtype=torch.float32, **sc)
    kw, vw = kw[0, c0:c1].float(), vw[0, c0:c1].float()  # [C, Nkv, D]
    G = Nh // kw.shape[1]
    qg = q.reshape(S, -1, G, D).float()
    s = torch.einsum("skgd,ckd->kgsc", qg, kw) * D ** -0.5
    mask = (kvpos[c0:c1][None, :] <= qpos[:, None])[None, None]
    s = torch.where(mask, s, torch.full((), -1e30))
    m = s.amax(dim=-1) if c1 > c0 else torch.full(s.shape[:-1], -1e30)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros(()))
    acc = torch.einsum("kgsc,ckd->skgd", p, vw).reshape(S, Nh, D)

    def to_sn(x):
        return x.permute(2, 0, 1).reshape(S, Nh)

    return acc, to_sn(m), to_sn(p.sum(dim=-1))


def _merge(parts):
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    return tpa.combine_attn_stats(acc, m, l)


def _paged_case(rng, mode, S, BS=4, T=10, Nkv=2, G=2, D=16):
    """Three rows over one arena: row 0 with 37 keys and trash block 0 in
    its window at visible positions 8-11; row 1 with 9 keys; row 2 whose
    queries sit before every key (it sees none)."""
    NB = 3 * T + 1
    jside, tside = _arena(rng, mode, NB, BS, Nkv, D)
    perm = rng.permutation(NB - 1) + 1
    tbl = perm[: 3 * T].reshape(3, T).astype(np.int32)
    tbl[0, 2] = 0
    kvpos = np.full((3, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((3, S), np.int32)
    for b, n in enumerate((37, 9, 20)):
        kvpos[b, :n] = np.arange(n)
        qpos[b] = np.arange(n - S, n)
    kvpos[2, :20] += 100  # row 2's keys lie after its queries
    q = rng.normal(size=(3, S, Nkv * G, D)).astype(np.float32)
    return q, tbl, qpos, kvpos, jside, tside


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
def test_decode_split_form_equals_the_tpu_kernel(mode, S):
    rng = np.random.default_rng(60 + S)
    q, tbl, qpos, kvpos, (jk, jv, jsc), (tk, tv, tsc) = _paged_case(rng, mode, S)
    want = np.asarray(jpa.paged_attention_tpu(
        jnp.asarray(q), jk, jv, jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvpos),
        interpret=True, blocks_per_step=1, **jsc))
    T, BS = tbl.shape[1], tk.shape[1]
    # the written frontiers (row 2 holds 20 keys it cannot see)
    live = tpa.decode_live_cols(3, T, BS, [-(-n // BS) for n in (37, 9, 20)])
    tq = torch.from_numpy(q)
    parts = {}
    # tiles of one block and four pieces, so rows split across pieces
    for runs in tpa.decode_pieces(live, BS, 4):
        for b, c0, c1, slot, nparts in runs:
            parts.setdefault(b, []).append(_run_stats(
                tq[b], tk, tv, torch.from_numpy(tbl[b]), torch.from_numpy(qpos[b]),
                torch.from_numpy(kvpos[b]), c0, c1, tsc))
    assert len(parts[0]) > 1  # row 0 is merged from several runs
    got = torch.stack([_merge(parts[b]) for b in range(3)]).numpy()
    assert np.isfinite(got).all()
    for b in (0, 1):
        scale = np.abs(want[b]).max()
        np.testing.assert_allclose(got[b], want[b], atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
def test_prefill_split_form_equals_the_tpu_kernel(monkeypatch, mode):
    """Two rows of a 6-query chunk, block size 4, frontiers 37 and 9 with
    ``nlive`` clamping the walk, trash at visible positions in row 0's
    window, each row's live columns cut into three runs of
    ``prefill_run_cols`` (tiles of 8 columns: the plan's constant shrunk to
    the case) and merged in run order."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    monkeypatch.setattr(tpa, "PREFILL_TILE_COLS", 8)
    rng = np.random.default_rng(70)
    Sc, BS, T, nsplit = 6, 4, 10, 3
    q, tbl, _, kvpos, (jk, jv, jsc), (tk, tv, tsc) = _paged_case(rng, mode, 1, BS, T)
    q, tbl, kvpos = q[:2], tbl[:2], kvpos[:2]
    q = rng.normal(size=(2, Sc) + q.shape[2:]).astype(np.float32)
    qpos = np.stack([np.arange(f - Sc, f) for f in (37, 9)]).astype(np.int32)
    nlive = np.array([-(-f // BS) for f in (37, 9)], np.int32)
    want = np.asarray(jpa.paged_prefill_tpu(
        jnp.asarray(q), jk, jv, jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvpos),
        interpret=True, nlive=jnp.asarray(nlive), blocks_per_step=1, **jsc))
    tq = torch.from_numpy(q)
    got = np.zeros_like(want)
    for b in range(2):
        live = int(nlive[b]) * BS
        r = tpa.prefill_run_cols(live, nsplit, BS)
        runs = [_run_stats(tq[b], tk, tv, torch.from_numpy(tbl[b]), torch.from_numpy(qpos[b]),
                           torch.from_numpy(kvpos[b]), min(live, i * r), min(live, (i + 1) * r),
                           tsc) for i in range(nsplit)]
        assert sum(1 for i in range(nsplit) if min(live, i * r) < min(live, (i + 1) * r)) > 1
        got[b] = _merge(runs).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
