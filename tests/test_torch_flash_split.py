"""The flash kernel's routes, launch plan and split form on the CPU.

- ``flash_route`` sends f32 queries to the 3xTF32 route, bf16 queries with
  ``G * S <= 64`` folded rows over a cache of more than ``flash_min_tiles``
  tiles to the folded route and the rest to the per-head route, from
  shapes alone.
- ``plan_flash`` against its contract, at the card's shapes: the grid is a
  function of shapes (the same plan serves any positions); a split's CTAs
  fit one wave of the SMs; no split once the row tiles fill them; and
  ``flash_unit_pieces`` (each CTA's run, as the kernel computes it from the
  positions) covers every visible tile of every row tile exactly once, in
  runs whose lengths differ by at most one tile, and a
  row tile's visible tiles include every tile holding a key one of its rows
  sees.
- The kernel's split form, run by run: ``attn_stats`` over each run's
  columns for the rows the run holds, merged per output row in run order by
  ``combine_attn_stats``, equals the JAX package's flash kernel in interpret
  mode on every row, sentinel rows included, at the verify, prefix,
  dense-admission and profiler shapes (narrow: 2 KV heads, G 1 and 3, head
  dims 64 and 256). Tolerance 1e-5 in f32 (summation order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models.cache import POS_SENTINEL  # models first: ops <-> models cycle
from llm_sharding_tpu.ops import flash_attention as jfa
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import paged_attention as tpa

SENTINEL = int(POS_SENTINEL)
H100_SMS = 132
NEVER = np.iinfo(np.int32).max  # the position of a padding column: seen by no query


@pytest.mark.parametrize(
    "dtype,S,C,Nh,Nkv,D,want",
    [
        (torch.bfloat16, 5, 2053, 24, 8, 128, "fold"),  # 3B verify: 15 folded rows
        (torch.bfloat16, 5, 2053, 8, 1, 256, "fold"),  # gemma-2B verify: 40
        (torch.bfloat16, 64, 600, 2, 2, 64, "fold"),  # exactly one warpgroup
        (torch.bfloat16, 65, 600, 2, 2, 64, "heads"),
        (torch.bfloat16, 22, 600, 24, 8, 128, "heads"),  # 66 folded rows
        (torch.bfloat16, 8, 8, 24, 8, 128, "heads"),  # the profiler's S = 8: one tile
        (torch.bfloat16, 5, 512, 24, 8, 128, "heads"),  # 8 tiles: too few to fold
        (torch.bfloat16, 5, 513, 24, 8, 128, "fold"),
        (torch.bfloat16, 5, 257, 8, 1, 256, "fold"),  # 4 tiles at head dim 256
        (torch.bfloat16, 2048, 2048, 24, 8, 128, "heads"),
        (torch.float32, 5, 2053, 24, 8, 128, "f32"),
        (torch.float32, 2048, 2048, 24, 8, 128, "f32"),
    ],
)
def test_flash_route_rule(dtype, S, C, Nh, Nkv, D, want):
    assert tfa.flash_route(dtype, S, C, Nh, Nkv, D) == want


def _unit_rows(plan, S, G, u, r):
    """(s, head) output entries of row tile r of unit u."""
    if plan.route == "heads":
        return [(s, u) for s in range(r * plan.rows, min(S, (r + 1) * plan.rows))]
    if plan.route == "fold":
        return [(s, u * G + g) for s in range(S) for g in range(G)]
    fr = range(r * plan.rows, min(G * S, (r + 1) * plan.rows))
    return [(f % S, u * G + f // S) for f in fr]


def _positions(kind, B, S, C, rng):
    """q / kv positions of a kind of call (numpy int32 [B, S], [B, C])."""
    qpos = np.zeros((B, S), np.int32)
    kvpos = np.full((B, C), SENTINEL, np.int32)
    for b in range(B):
        if kind == "causal":  # S = C
            kvpos[b] = qpos[b] = np.arange(S)
        elif kind == "verify":  # scratch columns at the top
            p = int(rng.integers(1, C - S))
            kvpos[b, :p] = np.arange(p)
            kvpos[b, C - S :] = p + np.arange(S)
            qpos[b] = p + np.arange(S)
        elif kind == "prefix":  # S queries past a C - S prefix
            kvpos[b] = np.arange(C)
            qpos[b] = C - S + np.arange(S)
        elif kind == "admit":  # a bucket, the last quarter sentinel, over C
            real = S - S // 4
            kvpos[b, :real] = qpos[b, :real] = np.arange(real)
            qpos[b, real:] = SENTINEL
        elif kind == "shuffled":  # positions in no order, a few never seen
            kvpos[b] = rng.permutation(C)
            qpos[b] = np.sort(rng.choice(C, S, replace=False))
    return qpos, kvpos


@pytest.mark.parametrize(
    "B,S,C,Nh,Nkv,D,kind,sms",
    [
        (8, 5, 2053, 24, 8, 128, "verify", H100_SMS),  # spec generate's verify
        (8, 5, 4101, 24, 8, 128, "verify", H100_SMS),  # dense verify
        (8, 5, 2053, 8, 1, 256, "verify", H100_SMS),  # gemma-2B verify (40 rows)
        (1, 256, 1280, 24, 8, 128, "prefix", H100_SMS),
        (1, 256, 1280, 8, 1, 256, "prefix", H100_SMS),  # gemma-2B past a prefix
        (1, 256, 4096, 24, 8, 128, "admit", H100_SMS),  # dense admission
        (1, 256, 256, 24, 8, 128, "admit", H100_SMS),
        (1, 8, 8, 24, 8, 128, "causal", H100_SMS),  # profiler sweep ends
        (1, 512, 512, 24, 8, 128, "causal", H100_SMS),
        (1, 2048, 2048, 24, 8, 128, "causal", H100_SMS),  # fills the card: no split
        (1, 2048, 2048, 6, 2, 128, "causal", H100_SMS),  # a tp-4 shard: split
        (1, 2048, 2048, 8, 1, 256, "causal", H100_SMS),
        (2, 300, 700, 6, 2, 64, "shuffled", 16),
        (1, 5, 70000, 2, 1, 64, "verify", 8),  # past the held tiles
    ],
)
def test_plan_flash_contract(B, S, C, Nh, Nkv, D, kind, sms):
    rng = np.random.default_rng(S + C)
    G = Nh // Nkv
    for dtype in (torch.bfloat16, torch.float32):
        plan = tfa.plan_flash(B, S, C, Nh, Nkv, D, dtype, sms)
        assert plan.route == tfa.flash_route(dtype, S, C, Nh, Nkv, D)
        assert plan.units == (Nh if plan.route == "heads" else Nkv)
        R = plan.row_tiles
        base = B * plan.units * R
        if plan.route == "f32" or base >= sms:
            assert plan.pieces == R and not plan.split
        if plan.split:
            per_sm = 2 if plan.route == "fold" and D <= 128 else 1
            assert B * plan.units * plan.pieces <= per_sm * sms  # one wave
            assert plan.scratch_floats(B, D) == B * plan.units * plan.pieces * plan.rows * (D + 2)
        qpos, kvpos = _positions(kind, B, S, C, rng)
        for b in range(B):
            pieces = tfa.flash_unit_pieces(plan, S, G, qpos[b], kvpos[b])
            assert len(pieces) == plan.pieces
            busy = [p for p in pieces if p is not None]
            assert busy and all(p is not None for p in pieces[: len(busy)])
            for r in range(R):
                runs = [p for p in busy if p.r == r]
                q = tfa.flash_row_positions(plan, S, G, qpos[b], r)
                want = tfa.flash_visible_tiles(plan, q, kvpos[b])
                got = [t for p in runs for t in p.tiles]
                assert got == want  # every visible tile once, in column order
                cols = np.nonzero((kvpos[b][:, None] <= q[None, :]).any(axis=1))[0]
                assert set((cols // plan.tile_cols).tolist()) <= set(want)
                assert all(p.nparts == len(runs) for p in runs)
                if plan.split:  # runs first .. first + nparts - 1 are consecutive CTAs
                    assert [pieces.index(p) for p in runs] == [runs[0].first + i
                                                               for i in range(len(runs))]
                    lens = [len(p.tiles) for p in runs]
                    assert max(lens) - min(lens) <= 1  # runs as equal as whole tiles allow
                    assert len(runs) == 1 or min(lens) >= plan.min_tiles // 2
                else:
                    assert len(runs) == 1 and pieces[R - 1 - r] is runs[0]
        # the same plan serves other positions of the same shapes
        assert tfa.plan_flash(B, S, C, Nh, Nkv, D, dtype, sms) is plan


def _split_form(q, k, v, qpos, kvpos, plan):
    """The kernel's split form with plain pieces: per unit, each run's
    columns through ``attn_stats`` (K/V laid out as 64-key blocks behind a
    trash block 0 the runs never name), merged per output row in run order
    by ``combine_attn_stats``."""
    B, S, Nh, D = q.shape
    C, Nkv = k.shape[1], k.shape[2]
    G = Nh // Nkv
    tc = plan.tile_cols
    nt = -(-C // tc)
    parts = {}
    for b in range(B):
        kb = torch.zeros((nt + 1) * tc, Nkv, D)
        vb = torch.zeros((nt + 1) * tc, Nkv, D)
        kb[tc : tc + C], vb[tc : tc + C] = k[b], v[b]
        pos = np.full((nt + 1) * tc, NEVER, np.int64)
        pos[tc : tc + C] = kvpos[b].numpy()
        ka, va = kb.reshape(nt + 1, tc, Nkv, D), vb.reshape(nt + 1, tc, Nkv, D)
        pieces = tfa.flash_unit_pieces(plan, S, G, qpos[b].numpy(), kvpos[b].numpy())
        for u in range(plan.units):
            for p in pieces:
                if p is None:
                    continue
                tbl = torch.tensor([[t + 1 for t in p.tiles]], dtype=torch.int32)
                cols = np.concatenate([pos[(t + 1) * tc : (t + 2) * tc] for t in p.tiles])
                acc, m, l = tpa.attn_stats(q[b : b + 1], ka, va, tbl, qpos[b : b + 1],
                                           torch.from_numpy(cols.astype(np.int32))[None])
                for s, h in _unit_rows(plan, S, G, u, p.r):
                    parts.setdefault((b, s, h), []).append((acc[0, s, h], m[0, s, h], l[0, s, h]))
    n = max(len(x) for x in parts.values())
    acc = torch.zeros(n, B, S, Nh, D)
    m = torch.full((n, B, S, Nh), -1e30)
    l = torch.zeros(n, B, S, Nh)
    for (b, s, h), xs in parts.items():
        for i, (a, mi, li) in enumerate(xs):
            acc[i, b, s, h], m[i, b, s, h], l[i, b, s, h] = a, mi, li
    assert len(parts) == B * S * Nh  # every output row is some run's
    return tpa.combine_attn_stats(acc, m, l)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize(
    "B,S,C,kind",
    [
        (2, 5, 805, "verify"),  # scratch columns past the written ones
        (1, 160, 800, "prefix"),
        (1, 256, 1024, "admit"),  # sentinel rows see every key
        (1, 8, 8, "causal"),
    ],
)
def test_split_runs_merge_to_jax_flash_kernel(B, S, C, kind, G, D):
    rng = np.random.default_rng(7 * S + C + G + D)
    Nkv = 2
    qpos, kvpos = _positions(kind, B, S, C, rng)
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(qpos), jnp.asarray(kvpos), interpret=True))
    plan = tfa.plan_flash(B, S, C, Nkv * G, Nkv, D, torch.bfloat16, H100_SMS)
    assert plan.route == ("fold" if G * S <= 64 and C > 64 * tfa.flash_min_tiles(D) else "heads")
    if kind != "causal":
        assert plan.split  # narrow shapes leave the SMs idle
    got = _split_form(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(qpos), torch.from_numpy(kvpos), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the plain version the wrapper runs on the CPU gives the same rows
    plain = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, qpos, kvpos)))
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=0)
