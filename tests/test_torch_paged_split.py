"""Split-KV decode on the CPU: the plain merge the decode kernel's second
pass implements, against the JAX package.

- ``attn_stats`` (the port of ``attn_stats_xla``) gives the JAX function's
  ``(acc, m, l)`` on the same numpy-seeded inputs: f32, bf16 and an int8
  arena, S = 1 and S = 3. Tolerance: f32 1e-5 (summation order); bf16
  operands are exact in f32 on both sides, but a probability that lands on
  a bf16 rounding boundary may round the other way before the PV product,
  so acc is held to 1e-2 of its row's largest entry (about one bf16 ulp of
  a probability times the summed values), m and l to 1e-5.
- ``combine_attn_stats`` over a leading split axis equals the JAX
  ``combine_attn_stats`` run under ``jax.vmap(..., axis_name=...)`` on the
  same stacked triples, dead splits and a row no split sees included.
- Stats over the decode kernel's partition (``decode_pieces``), merged,
  equal ``paged_attention_xla`` (f32, 1e-5): columns written ahead lie
  past the row's live end, one row's keys all fall in one piece, NaN in
  trash block 0.
- ``plan_decode`` depends on shapes alone and its pieces cover every live
  column exactly once.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models.cache import POS_SENTINEL  # models first: ops <-> models cycle
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu.ops import quant as jquant
from llm_sharding_tpu_torch.ops import paged_attention as tpa

SENTINEL = int(POS_SENTINEL)


def _case(rng, S, NB=12, BS=4, T=5, Nkv=2, G=2, D=16):
    """Two rows over a shared arena, trash block 0 holding NaN (both
    tables map it past their written keys)."""
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.nan
    tbl = np.array([[3, 7, 1, 0, 0], [2, 9, 5, 11, 0]], np.int32)[:, :T]
    kvpos = np.full((2, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((2, S), np.int32)
    for b, n in enumerate((10, 15)):
        kvpos[b, :n] = np.arange(n)
        qpos[b] = np.arange(n - S, n)
    q = rng.normal(size=(2, S, Nkv * G, D)).astype(np.float32)
    return q, k, v, tbl, qpos, kvpos


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_attn_stats_matches_jax(mode, S):
    rng = np.random.default_rng(31 + S)
    q, k, v, tbl, qpos, kvpos = _case(rng, S)
    jsc, tsc = {}, {}
    if mode == "int8":
        arenas = []
        for x in (k, v):
            x = np.nan_to_num(x, nan=0.0)
            sc = (np.abs(x).max(axis=(1, 3)) / jquant.kv_qmax(jnp.int8)).astype(np.float32)
            codes = np.asarray(
                jquant.kv_quantize(jnp.asarray(x), jnp.asarray(sc[:, None, :, None]), jnp.int8))
            codes = codes.copy()
            codes[0] = 127
            sc[0] = np.inf
            arenas += [codes, sc]
        k, ks, v, vs = arenas
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32, torch.float32)
    jq = jnp.asarray(q).astype(jdt)
    tq = torch.from_numpy(q).to(tdt)
    if mode == "bf16":
        jk, jv = jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    want = jpa.attn_stats_xla(jq, jk, jv, jnp.asarray(tbl), jnp.asarray(qpos),
                              jnp.asarray(kvpos), **jsc)
    got = tpa.attn_stats(tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(qpos),
                         torch.from_numpy(kvpos), **tsc)
    acc_w, m_w, l_w = (np.asarray(x, np.float32) for x in want)
    acc_g, m_g, l_g = (x.numpy() for x in got)
    assert np.isfinite(acc_g).all() and acc_g.dtype == np.float32
    np.testing.assert_allclose(m_g, m_w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l_g, l_w, atol=1e-5, rtol=1e-5)
    row = np.abs(acc_w).max(axis=-1, keepdims=True)
    tol = 1e-2 if mode == "bf16" else 1e-5
    assert (np.abs(acc_g - acc_w) <= tol * np.maximum(row, 1.0)).all()


def test_combine_matches_jax_over_an_axis():
    rng = np.random.default_rng(33)
    P, B, S, Nh, D = 4, 2, 3, 4, 8
    acc = rng.normal(size=(P, B, S, Nh, D)).astype(np.float32)
    m = rng.normal(size=(P, B, S, Nh)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, size=(P, B, S, Nh)).astype(np.float32)
    # split 2 sees nothing anywhere; row (b=1, s=2) is seen by no split
    acc[2], m[2], l[2] = 0.0, -1e30, 0.0
    acc[:, 1, 2], m[:, 1, 2], l[:, 1, 2] = 0.0, -1e30, 0.0
    combine = jax.vmap(lambda a, mm, ll: jpa.combine_attn_stats(a, mm, ll, "split"),
                       axis_name="split")
    want = np.asarray(combine(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l))[0])
    got = tpa.combine_attn_stats(torch.from_numpy(acc), torch.from_numpy(m),
                                 torch.from_numpy(l)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert (got[1, 2] == 0).all()


def test_partition_merge_equals_paged_attention():
    """Stats over the decode kernel's pieces (``decode_pieces`` over each
    row's ``nlive`` blocks, tiles of one block so a small table splits four
    ways), merged per row in slot order, equal single-pass attention."""
    rng = np.random.default_rng(34)
    B, S, Nkv, G, D, BS, T, NB = 2, 3, 2, 2, 16, 4, 8, 17
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.inf
    tbl = np.zeros((B, T), np.int32)
    tbl[0] = 1 + np.arange(T)
    tbl[1, :2] = [12, 9]  # row 1 maps two blocks, the rest is trash
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    kvpos[0, :24] = np.arange(24)
    kvpos[0, 24:] = 100 + np.arange(8)  # written ahead: past row 0's live columns
    kvpos[1, :6] = np.arange(6)
    qpos = np.array([[21, 22, 23], [3, 4, 5]], np.int32)
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    # the blocks covering each row's written frontier (24 and 6 keys)
    live = tpa.decode_live_cols(B, T, BS, [6, 2])
    assert live == [24, 8]  # the kernel never visits columns 24-31 of row 0
    pieces = tpa.decode_pieces(live, BS, 4)
    assert [[(b, c0, c1) for b, c0, c1, _, _ in runs] for runs in pieces] == [
        [(0, 0, 8)], [(0, 8, 16)], [(0, 16, 24)], [(1, 0, 8)]]
    t = {n: torch.from_numpy(x) for n, x in
         dict(q=q, k=k, v=v, tbl=tbl, qpos=qpos, kvpos=kvpos).items()}
    col = torch.arange(T * BS)
    got = []
    for b in range(B):
        runs = sorted((r for runs in pieces for r in runs if r[0] == b), key=lambda r: r[3])
        stats = []
        for _, c0, c1, slot, nparts in runs:
            assert nparts == len(runs)
            inside = (col >= c0) & (col < c1)
            kvp = torch.where(inside[None], t["kvpos"][b : b + 1],
                              torch.tensor(SENTINEL, dtype=torch.int32))
            stats.append(tpa.attn_stats(t["q"][b : b + 1], t["k"], t["v"], t["tbl"][b : b + 1],
                                        t["qpos"][b : b + 1], kvp))
        acc, m, l = (torch.stack(x) for x in zip(*stats))
        got.append(tpa.combine_attn_stats(acc, m, l))
    got = torch.cat(got)
    want = tpa.paged_attention_xla(t["q"], t["k"], t["v"], t["tbl"], t["qpos"], t["kvpos"])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sm_count", [1, 16, 132])
@pytest.mark.parametrize("B,Nkv,T,BS", [(1, 8, 64, 64), (8, 8, 64, 64), (3, 2, 7, 16),
                                         (64, 8, 200, 16), (2, 1, 1, 8), (1, 8, 40, 4096)])
def test_plan_splits_covers_each_column_once(B, Nkv, T, BS, sm_count):
    """The decode plan depends on shapes alone (one CTA per SM over the KV
    heads); its pieces cover every live column of every row exactly once,
    each row in at most ``slots`` runs, whatever the lengths."""
    plan = tpa.plan_decode(B, 1, 3 * Nkv, Nkv, T, BS, torch.bfloat16, sm_count)
    assert plan == tpa.plan_decode(B, 1, 3 * Nkv, Nkv, T, BS, torch.bfloat16, sm_count)
    assert plan.pieces == max(1, sm_count // Nkv) and plan.groups == 1 and plan.rows == 3
    W = T * BS
    rng = np.random.default_rng(B * 131 + T)
    for live in ([W] * B, [int(x) for x in rng.integers(0, W + 1, B)]):
        cover = [np.zeros(n, np.int64) for n in live]
        for runs in tpa.decode_pieces(live, plan.tile_cols, plan.pieces, plan.min_tiles):
            for b, c0, c1, slot, nparts in runs:
                assert nparts <= plan.slots and c0 % plan.tile_cols == 0
                cover[b][c0:c1] += 1
        assert all((c == 1).all() for c in cover)
