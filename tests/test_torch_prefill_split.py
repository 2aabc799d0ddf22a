"""The tensor-core chunked-prefill kernel's route and split plan on the CPU.

- ``prefill_design`` sends bf16 queries at block size 16, 32 or a multiple
  of 64 to the tensor cores and everything else to the CUDA-core tile.
- ``plan_prefill_splits`` against its contract: runs a multiple of the
  block size and of the 64-key tile, covering each live column exactly
  once; no split once a chunk fills the SMs, and a split chunk's CTAs fit
  one wave of them; the B = 1 served shape splits, a short frontier still
  covers its few columns.
- The kernel's split form, run by run: ``attn_stats`` over each run of
  ``prefill_run_cols`` (empty and invisible runs included), merged by
  ``combine_attn_stats``, equals the JAX package's chunked-prefill kernel
  in interpret mode with the ``nlive`` clamp, f32 and int8 arenas, on the
  rows that see a key. Tolerance 1e-5 (summation order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models.cache import POS_SENTINEL  # models first: ops <-> models cycle
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu_torch.ops import paged_attention as tpa

SENTINEL = int(POS_SENTINEL)
H100_SMS = 132


@pytest.mark.parametrize(
    "dtype,bs,want",
    [
        (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 16, "wgmma"),
        (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 8, "tile"), (torch.bfloat16, 48, "tile"),
        (torch.float32, 64, "tile"), (torch.float32, 16, "tile"),
    ],
)
def test_prefill_design_rule(dtype, bs, want):
    assert tpa.prefill_design(dtype, bs) == want


@pytest.mark.parametrize(
    "B,Sc,Nh,live,BS,sms",
    [
        (1, 256, 24, 2048, 64, H100_SMS),  # the heaviest served launch
        (1, 256, 24, 256, 64, H100_SMS),  # short frontier: the first chunk
        (1, 256, 24, 4096, 64, H100_SMS),  # the table's width, as the wrapper plans
        (4, 256, 24, 4096, 64, H100_SMS),  # 192 CTAs: the card is full
        (1, 16, 6, 64, 16, H100_SMS),
        (1, 100, 6, 250 * 16, 16, H100_SMS),  # many CTAs short of the SMs: capped
        (2, 12, 4, 80, 16, 8),
        (1, 256, 24, 4096, 128, H100_SMS),
        (1, 256, 24, 0, 64, H100_SMS),  # nothing written yet
    ],
)
def test_plan_prefill_splits_contract(B, Sc, Nh, live, BS, sms):
    run, nsplit = tpa.plan_prefill_splits(B, Sc, Nh, live, BS, sms)
    assert (run, nsplit) == tpa.plan_prefill_splits(B, Sc, Nh, live, BS, sms)
    assert 1 <= nsplit <= tpa.PREFILL_MAX_SPLITS
    assert run % BS == 0 and run % tpa.PREFILL_TILE_COLS == 0
    assert run == tpa.prefill_run_cols(live, nsplit, BS)
    cover = np.zeros(live, np.int64)
    for i in range(nsplit):
        cover[i * run : min(live, (i + 1) * run)] += 1
    assert (cover == 1).all()
    ctas = B * Nh * -(-Sc // tpa.PREFILL_Q_ROWS)
    if ctas >= sms:
        assert nsplit == 1
    else:
        assert ctas * nsplit <= sms  # one wave
    if B == 1 and Sc == 256 and live >= 2048:
        assert nsplit == 2 and run * 2 >= live  # 96 CTAs instead of 48
    # a run is never longer than one split of the frontier needs
    assert run < -(-live // nsplit) + max(BS, tpa.PREFILL_TILE_COLS) or live == 0


@pytest.mark.parametrize("live,nsplit,BS", [(2048, 2, 64), (112, 3, 16), (180, 3, 16), (0, 4, 64),
                                            (640, 5, 128)])
def test_prefill_run_cols_rounds_to_whole_tiles_and_blocks(live, nsplit, BS):
    run = tpa.prefill_run_cols(live, nsplit, BS)
    unit = max(64, BS)
    assert run % unit == 0 and nsplit * run >= live
    assert run - -(-live // nsplit) < unit


def _split_prefill(q, k, v, tbl, qpos, kvpos, nlive, nsplit, **sc):
    """The kernel's split form with plain pieces: each row's live columns
    cut into nsplit runs, attn_stats per run (an empty run contributes
    (0, -1e30, 0)), merged."""
    BS = k.shape[1]
    T = tbl.shape[1]
    outs = []
    for b in range(q.shape[0]):
        live = min(T, max(int(nlive[b]), 0)) * BS
        run = tpa.prefill_run_cols(live, nsplit, BS)
        parts = []
        for i in range(nsplit):
            lo, hi = min(live, i * run), min(live, (i + 1) * run)
            if lo == hi:
                shape = q[b : b + 1].shape
                parts.append((torch.zeros(shape), torch.full(shape[:3], -1e30), torch.zeros(shape[:3])))
                continue
            parts.append(tpa.attn_stats(
                q[b : b + 1], k, v, tbl[b : b + 1, lo // BS : hi // BS], qpos[b : b + 1],
                kvpos[b : b + 1, lo:hi], **sc,
            ))
        acc, m, l = (torch.stack(x) for x in zip(*parts))
        outs.append(tpa.combine_attn_stats(acc, m, l))
    return torch.cat(outs)


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_split_runs_merge_to_jax_prefill_kernel(monkeypatch, mode, nsplit):
    """Two rows of a 12-token chunk, block size 16, frontiers 100 and 180
    (runs of 64 columns: row 0's third run is empty), stale blocks past each
    frontier, NaN in trash block 0, which the tables map past the
    frontiers only (``attn_stats`` masks a trash column where the kernels
    score it as a zero key; the card's tests map trash inside the window),
    sentinel padding rows (left out: they see no key past the clamp on one
    side and the whole window on the other)."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    rng = np.random.default_rng(50 + nsplit)
    B, Sc, BS, T, Nkv, G, D, NB = 2, 12, 16, 12, 2, 2, 16, 26
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.nan
    perm = rng.permutation(NB - 1) + 1
    tbl = np.stack([perm[:T], perm[T : 2 * T]]).astype(np.int32)
    tbl[0, -1] = 0  # past row 0's frontier
    frontier = [100, 180]
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((B, Sc), np.int32)
    for b, f in enumerate(frontier):
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - Sc, f)
    qpos[0, 10:] = SENTINEL
    nlive = np.array([-(-f // BS) for f in frontier], np.int32)
    q = rng.normal(size=(B, Sc, Nkv * G, D)).astype(np.float32)
    jsc, tsc = {}, {}
    if mode == "int8":
        codes = []
        for x in (k, v):
            x = np.nan_to_num(x, nan=0.0)
            s = np.maximum(np.abs(x).max(axis=(1, 3)), 1e-6) / 127.0
            codes += [np.clip(np.round(x / s[:, None, :, None]), -127, 127).astype(np.int8),
                      s.astype(np.float32)]
        k, ks, v, vs = codes
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = jpa.paged_prefill_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl), jnp.asarray(qpos),
        jnp.asarray(kvpos), interpret=True, nlive=jnp.asarray(nlive), blocks_per_step=1, **jsc,
    )
    got = _split_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tbl),
        torch.from_numpy(qpos), torch.from_numpy(kvpos), nlive, nsplit, **tsc,
    )
    rows = qpos < SENTINEL
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=1e-5)


def test_serve_profile_totals_each_port_kernel_by_name():
    """``serve_profile`` sums a profile's kernel table per port kernel and
    KV storage type, whatever the template arguments, and leaves other
    kernels out."""
    import collections

    from llm_sharding_tpu_torch import serve_profile

    per_kernel = {
        "void (anonymous namespace)::prefill_wgmma_kernel<128, signed char>(CUtensorMap)": 5000.0,
        "void (anonymous namespace)::prefill_wgmma_kernel<64, signed char>(CUtensorMap)": 1000.0,
        "void (anonymous namespace)::prefill_wgmma_kernel<128, __nv_fp8_e4m3>(CUtensorMap)": 300.0,
        "void (anonymous namespace)::prefill_wgmma_kernel<128, __nv_bfloat16>(CUtensorMap)": 200.0,
        "void (anonymous namespace)::flash_kernel<float, 128, 4>(float const*)": 10.0,
        "void (anonymous namespace)::flash_wgmma_kernel<128>(CUtensorMap)": 20.0,
        "void attn::split_merge_kernel<__nv_bfloat16>(float const*)": 7.0,
        "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128, signed char, 1>"
        "(CUtensorMap)": 4.0,
        "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT": 9000.0,
    }
    calls = collections.Counter({k: 3 for k in per_kernel})
    got = {(n, kv): (ms, c) for n, kv, ms, c in serve_profile.port_kernel_totals(per_kernel, calls)}
    assert got == {
        ("prefill_wgmma_kernel", "int8"): (6.0, 6),
        ("prefill_wgmma_kernel", "fp8"): (0.3, 3),
        ("prefill_wgmma_kernel", "-"): (0.2, 3),
        ("flash_kernel", "-"): (0.01, 3),
        ("flash_wgmma_kernel", "-"): (0.02, 3),
        ("split_merge_kernel", "-"): (0.007, 3),
        ("paged_decode_kernel", "int8"): (0.004, 3),
    }


def test_serve_profile_counts_the_served_chunked_prefill_pairs():
    """The served workload's chunked admissions (``smoke_workload``: prompts
    of 1024, 1536, 2048 and 1800 tokens in chunks of 256, 28 chunks) hold
    6,915,484 visible query-key pairs per layer, counted here pair by pair
    from the same rule; 4 flops per pair and head dimension over
    Llama-3.2-3B's 24 heads x 128 x 28 layers at 989 TFLOP/s is 2.41 ms."""
    from llm_sharding_tpu_torch import serve_profile, smoke_workload

    want = 0
    for n in smoke_workload.LENS:
        bucket = 1 << (n - 1).bit_length()
        if bucket <= 256:
            continue
        for off in range(0, bucket, 256):
            for s in range(off, off + 256):
                want += s + 1 if s < n - 1 else off + 256
    got = serve_profile.chunked_prefill_pairs(smoke_workload.LENS, 256)
    assert got == want == 6_915_484
    assert abs(4 * 24 * 128 * got * 28 / serve_profile.BF16_FLOPS * 1e3 - 2.406) < 1e-3
