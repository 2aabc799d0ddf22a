"""The plain versions of the port's three CUDA kernels against the JAX
package's Pallas kernels run in interpret mode on the CPU, plus the arena
scatter/gather. On a CPU tensor each port wrapper runs its plain version,
which is what these tests reach; the kernels themselves are held against
the same plain versions on the card by ``tests/test_torch_gpu.py`` and by
``chip_smoke.py``.

Block constants are shrunk so the JAX recurrence runs over several query
and KV blocks (as ``tests/test_flash_attention.py`` does). Tolerances:
float32 1e-5 (summation order differs), bfloat16 2e-2 (one bf16 ulp of
outputs of magnitude ~1-2).

Rows with no visible key are garbage on every path; the chunked-prefill
comparison leaves out its sentinel (padding) query rows, which the JAX
kernel bounds at ``nlive`` blocks and the plain version does not.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models.cache import POS_SENTINEL  # models first: ops <-> models cycle
from llm_sharding_tpu.ops import flash_attention as jfa
from llm_sharding_tpu.ops import paged_attention as jpa
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import kernels
from llm_sharding_tpu_torch.ops import paged_attention as tpa

SENTINEL = int(POS_SENTINEL)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dt):
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a)).to(tdt)


def _ints(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a, np.int32))


def _close(got, want, dt, rows=None):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        g, w = g[rows], w[rows]
    np.testing.assert_allclose(g, w, atol=DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["ragged_multiblock", "sentinel_padded"])
def test_flash_plain_matches_pallas_interpret(monkeypatch, dt, case):
    monkeypatch.setattr(jfa, "BLOCK_Q", 16)
    monkeypatch.setattr(jfa, "BLOCK_K", 32)
    rng = np.random.default_rng(10)
    if case == "ragged_multiblock":  # pads both the query and the KV axis
        B, S, C, Nh, Nkv, D = 2, 37, 70, 4, 2, 16
        qpos = np.tile(np.arange(S, dtype=np.int32) + 33, (B, 1))
        kvpos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    else:  # G = 3, right-padded prompt: sentinel query rows and KV tail
        B, S, C, Nh, Nkv, D = 2, 24, 64, 6, 2, 16
        qpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        qpos[1, 17:] = SENTINEL
        kvpos = np.full((B, C), SENTINEL, np.int32)
        kvpos[0, :S] = np.arange(S)
        kvpos[1, :17] = np.arange(17)
    q = rng.normal(size=(B, S, Nh, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Nkv, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jqp, tqp), (jkp, tkp) = _ints(qpos), _ints(kvpos)
    want = jfa.flash_attention(jq, jk, jv, jqp, jkp, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, tqp, tkp)
    _close(got, want, dt)


def _arena(rng, NB, BS, Nkv, D):
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    k[0], v[0] = np.nan, np.inf  # the shared trash block holds garbage
    return k, v


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [1, 3])
def test_paged_decode_plain_matches_pallas_interpret(dt, S):
    """Several KV blocks, G = 3, a trash hole inside a row's window and
    NaN/Inf in trash block 0; S = 3 is the verify shape."""
    rng = np.random.default_rng(11)
    B, BS, T, Nkv, G, D, NB = 2, 8, 4, 2, 3, 16, 10
    k, v = _arena(rng, NB, BS, Nkv, D)
    tbl = np.array([[3, 0, 5, 8], [7, 2, 0, 0]], np.int32)
    lengths = [3 * BS + 2, BS + 5]
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    kvpos[0, :BS] = np.arange(BS)
    kvpos[0, 2 * BS : 3 * BS + 2] = np.arange(BS, lengths[0] - BS)
    kvpos[1, : lengths[1]] = np.arange(lengths[1])
    qpos = np.array([[n - S + i for i in range(S)] for n in (lengths[0] - BS, lengths[1])],
                    np.int32)
    q = rng.normal(size=(B, S, Nkv * G, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jt, tt), (jqp, tqp), (jkp, tkp) = _ints(tbl), _ints(qpos), _ints(kvpos)
    want = jpa.paged_attention_tpu(jq, jk, jv, jt, jqp, jkp, interpret=True, blocks_per_step=1)
    got = tpa.paged_attention(tq, tk, tv, tt, tqp, tkp)
    assert torch.isfinite(got).all()
    _close(got, want, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_prefill_plain_matches_pallas_interpret(monkeypatch, dt):
    """A 12-token chunk per row (GQA-folded into 3 query tiles of 8), nlive
    clamping each row at its written frontier while its later blocks hold
    stale data, NaN/Inf in trash block 0 and sentinel padding rows."""
    monkeypatch.setattr(jpa, "BLOCK_Q_PREFILL", 8)
    rng = np.random.default_rng(12)
    B, Sc, BS, T, Nkv, G, D, NB = 2, 12, 8, 5, 2, 2, 16, 12
    k, v = _arena(rng, NB, BS, Nkv, D)
    tbl = np.array([[4, 9, 1, 6, 0], [2, 11, 3, 5, 10]], np.int32)
    frontier = [14, 36]
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((B, Sc), np.int32)
    for b, f in enumerate(frontier):
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - Sc, f)
    qpos[0, 10:] = SENTINEL
    nlive = np.array([-(-f // BS) for f in frontier], np.int32)
    q = rng.normal(size=(B, Sc, Nkv * G, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    (jt, tt), (jqp, tqp), (jkp, tkp), (jnl, tnl) = map(_ints, (tbl, qpos, kvpos, nlive))
    want = jpa.paged_prefill_tpu(
        jq, jk, jv, jt, jqp, jkp, interpret=True, nlive=jnl, blocks_per_step=1
    )
    got = tpa.paged_prefill(tq, tk, tv, tt, tqp, tkp, nlive=tnl)
    _close(got, want, dt, rows=qpos < SENTINEL)


def test_gather_block_kv_matches_jax():
    rng = np.random.default_rng(13)
    k, v = _arena(rng, 6, 4, 2, 8)
    tbl = np.array([[1, 0, 3], [5, 2, 0]], np.int32)
    jk_, jv_ = jpa.gather_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl))
    tk_, tv_ = tpa.gather_block_kv(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tbl))
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk_))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv_))


def test_write_block_kv_matches_jax():
    """Entry-granular ``valid``; the port writes in place. Trash block 0
    (where colliding writes land in any order) is left out."""
    rng = np.random.default_rng(14)
    NB, BS, Nkv, D = 6, 4, 2, 8
    k = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, Nkv, D)).astype(np.float32)
    tbl = np.array([[1, 4, 0], [5, 2, 0]], np.int32)
    cols = np.array([[3, 4, 9], [0, 6, 7]], np.int32)
    kn = rng.normal(size=(2, 3, Nkv, D)).astype(np.float32)
    vn = rng.normal(size=(2, 3, Nkv, D)).astype(np.float32)
    valid = np.array([[True, False, True], [True, True, False]])
    jk_, jv_ = jpa.write_block_kv(
        *map(jnp.asarray, (k, v, tbl, cols, kn, vn)), valid=jnp.asarray(valid)
    )
    tk_, tv_ = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tpa.write_block_kv(tk_, tv_, *map(torch.from_numpy, (tbl, cols, kn, vn)),
                       valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tk_.numpy()[1:], np.asarray(jk_)[1:])
    np.testing.assert_array_equal(tv_.numpy()[1:], np.asarray(jv_)[1:])


def test_kernel_build_plumbing():
    """Each kernel builds from its own source for sm_90a into build/kernels,
    under a name keyed by the sources' hash."""
    names = set()
    for k in kernels.KERNELS:
        path = k.library_path()
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(k.name + "-")
        assert (kernels.CSRC_DIR / k.source).exists()
        names.add(path.name)
    assert len(names) == 3
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """A wrapper picks its plain version only because the tensors lie on
    the CPU: no launch is counted, and a device that is neither CPU nor
    CUDA is refused. (The kernels themselves: ``tests/test_torch_gpu.py``.)"""
    rng = np.random.default_rng(16)
    q = torch.from_numpy(rng.normal(size=(1, 4, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 4, 2, 16)).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    tbl = torch.tensor([[1]], dtype=torch.int32)
    arena = torch.cat([torch.zeros_like(k), k])  # [NB=2, BS=4, 2, 16]
    kernels.reset_launch_counts()
    torch.testing.assert_close(
        tfa.flash_attention(q, k, k, pos, pos), tfa.cached_attention(q, k, k, pos, pos),
        atol=0, rtol=0,
    )
    paged = (q, arena, arena, tbl, pos, pos)
    for fn in (tpa.paged_attention, tpa.paged_prefill):
        torch.testing.assert_close(fn(*paged), tpa.paged_attention_xla(*paged), atol=0, rtol=0)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"), pos, pos)
