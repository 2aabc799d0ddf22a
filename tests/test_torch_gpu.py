"""The port's CUDA kernels on the card: each kernel (and each quantized KV
mode of the paged kernels) against its plain version, the wrappers' input
checks and launch counters, and small served runs that must go through
all three kernels, and through the int8 modes for an int8 arena.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them; ``tests/conftest.py`` imports jax, so run it there as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gpu.py

Tolerances, kernel vs plain version on the same inputs, as in
``chip_smoke.py``: max abs error float32 1e-4 (summation order differs),
bfloat16 3e-2 (one bf16 ulp of outputs of magnitude ~2-4); and max error
relative to the largest output of its (query row, head), float32 1e-3,
bfloat16 2e-2 (about one bf16 ulp of that output, times a margin of 2).
The quantized modes take the same limits: kernel and plain version
dequantize each code with the same two roundings.
"""

import numpy as np
import pytest
import torch

from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.models.cache import POS_SENTINEL
from llm_sharding_tpu_torch.ops import flash_attention as tfa
from llm_sharding_tpu_torch.ops import kernels
from llm_sharding_tpu_torch.ops import paged_attention as tpa
from llm_sharding_tpu_torch.ops import quant as tquant
from llm_sharding_tpu_torch.runtime.engine import Engine

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
TOL_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
BF16_STEP = 2.0**-7  # |x| * 2^-7 is at least the bf16 spacing at x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_args(dev, S, dtype, seed=15):
    """Two rows over a 9-block arena (block size 16, head_dim 128, G = 3):
    NaN/Inf in trash block 0, which both tables map; row 1's block 6 lies
    past its 30 written keys (stale data, sentinel positions)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, BS, T, Nkv, G, D = 2, 16, 4, 2, 3, 128

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    k, v = t(9, BS, Nkv, D), t(9, BS, Nkv, D)
    k[0], v[0] = float("nan"), float("inf")
    tbl = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32, device=dev)
    kvpos = torch.full((B, T * BS), POS_SENTINEL, dtype=torch.int32, device=dev)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, n in enumerate((50, 30)):
        kvpos[b, :n] = torch.arange(n)
        qpos[b] = torch.arange(n - S, n)
    return t(B, S, Nkv * G, D), k, v, tbl, qpos, kvpos


def _flash_args(dev, dtype, S=70):
    g = torch.Generator(device=dev).manual_seed(16)
    Nh, Nkv, D = 6, 2, 64

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(2, 1)
    pos[1, S - 9 :] = POS_SENTINEL  # right-padded second row
    return t(2, S, Nh, D), t(2, S, Nkv, D), t(2, S, Nkv, D), pos, pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["flash", "decode", "prefill"])
def test_kernel_matches_plain_on_gpu(cuda_device, which, dtype):
    """The CUDA kernel against its plain version on the card. The flash
    case leaves out the padded rows (no visible key: garbage on every
    path)."""
    if which == "flash":
        args = _flash_args(cuda_device, dtype)
        got, want = tfa.flash_attention(*args), tfa.cached_attention(*args)
        rows = args[3] < POS_SENTINEL
        got, want = got[rows], want[rows]
    else:
        args = _paged_args(cuda_device, 1 if which == "decode" else 20, dtype)
        fn = tpa.paged_attention if which == "decode" else tpa.paged_prefill
        got, want = fn(*args), tpa.paged_attention_xla(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    row_scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    assert ((got.float() - want.float()).abs() / row_scale).max().item() <= TOL_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_prefill_nlive_bounds_the_kv_loop(cuda_device, dtype):
    """A block at or past ``nlive`` is never read: NaN in row 1's block 6
    leaves the output bit-identical, while without the clamp the NaN
    reaches the output through a masked key's zero probability. f32 runs
    on the CUDA-core tile, bf16 on the tensor cores (TMA boxes)."""
    args = list(_paged_args(cuda_device, 20, dtype))
    nlive = torch.tensor([4, 2], dtype=torch.int32, device=cuda_device)
    want = tpa.paged_prefill(*args, nlive=nlive)
    args[1][6], args[2][6] = float("nan"), float("nan")
    got = tpa.paged_prefill(*args, nlive=nlive)
    unclamped = tpa.paged_prefill(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.isfinite(unclamped[1]).all()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, k, v, pos, _ = _flash_args(cuda_device, torch.float32)
    kernels.reset_launch_counts()
    bad = [
        ((q.half(), k.half(), v.half(), pos, pos), "float32 or bfloat16"),
        ((q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(), pos,
          pos), "head_dim"),
        ((q.transpose(0, 1).contiguous().transpose(0, 1), k, v, pos, pos), "contiguous"),
        ((q, k, v, pos.long(), pos), "int32"),
        ((q, k.bfloat16(), v.bfloat16(), pos, pos), "dtype"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention(*args)
    pq, pk, pv, tbl, qpos, kvpos = _paged_args(cuda_device, 1, torch.float32)
    with pytest.raises(ValueError, match="kv_positions"):
        tpa.paged_attention(pq, pk, pv, tbl, qpos, kvpos[:, :-16])
    with pytest.raises(ValueError, match="cpu"):
        tpa.paged_attention(pq, pk.cpu(), pv.cpu(), tbl, qpos, kvpos)
    assert not any(kernels.launch_counts().values())


@pytest.mark.cuda
def test_launch_counters_count_only_kernel_launches(cuda_device):
    """One launch per wrapper call on the card; the plain version on CPU
    tensors counts nothing."""
    fargs = _flash_args(cuda_device, torch.float32)
    pargs = _paged_args(cuda_device, 1, torch.float32)
    kernels.reset_launch_counts()
    tfa.flash_attention(*fargs)
    tpa.paged_attention(*pargs)
    tpa.paged_prefill(*pargs)
    tpa.paged_prefill(*pargs)
    assert kernels.launch_counts() == {
        "flash_attention": 1, "paged_attention": 1, "paged_prefill": 2,
    }
    tfa.flash_attention(*(a.cpu() for a in fargs))
    tpa.paged_attention(*(a.cpu() for a in pargs))
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["paged_attention"] == 1


@pytest.mark.cuda
def test_served_streams_go_through_the_kernels(cuda_device):
    """A tiny float32 model served on the card, one-shot and chunked
    admissions mixed, streams the port's ``generate`` tokens, and every
    kernel was launched by the serving path."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    eng = Engine(cfg, tllama.init_params(cfg, seed=3, dtype=torch.float32, device=cuda_device))
    rng = np.random.default_rng(3)
    lens, max_new = (5, 20, 30, 12), 8
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=8, kv_blocks=40,
                    prefill_chunk=8)
    kernels.reset_launch_counts()
    reqs = [srv.submit(p, max_new) for p in prompts[:2]]
    srv.step()
    reqs += [srv.submit(p, max_new) for p in prompts[2:]]
    srv.run_until_idle()
    counts = kernels.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    for r, p in zip(reqs, prompts):
        want = eng.generate_ids(p, max_new)
        assert r.tokens == want.tokens[0, len(p) : want.lengths[0]].tolist()


def _quantize(k, v, kv):
    """1-byte codes and [NB, Nkv] scales of K/V; trash block 0 gets code
    0x7F (NaN in fp8) and Inf scales."""
    dt = tquant.kv_storage_dtype(kv)
    out = []
    for x in (k, v):
        x = torch.nan_to_num(x.float(), nan=0.0, posinf=0.0)
        sc = x.abs().amax(dim=(1, 3)) / tquant.kv_qmax(dt)
        codes = tquant.kv_quantize(x, sc[:, None, :, None], dt)
        codes.view(torch.uint8)[0] = 0x7F
        sc[0] = float("inf")
        out += [codes, sc.contiguous()]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["decode", "prefill"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_kernel_matches_plain_on_gpu(cuda_device, kv, which, dtype):
    """The fused-dequant modes of the paged kernels against the plain
    version with the same codes and scales."""
    q, k, v, tbl, qpos, kvpos = _paged_args(cuda_device, 1 if which == "decode" else 20, dtype)
    kc, ks, vc, vs = _quantize(k, v, kv)
    sc = dict(k_scale=ks, v_scale=vs)
    fn = tpa.paged_attention if which == "decode" else tpa.paged_prefill
    kernels.reset_launch_counts()
    got = fn(q, kc, vc, tbl, qpos, kvpos, **sc)
    want = tpa.paged_attention_xla(q, kc, vc, tbl, qpos, kvpos, **sc)
    torch.cuda.synchronize()
    name = "paged_attention" if which == "decode" else "paged_prefill"
    assert kernels.launch_counts()[f"{name}[{kv}]"] == 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    row_scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    assert ((got.float() - want.float()).abs() / row_scale).max().item() <= TOL_REL[dtype]


@pytest.mark.cuda
def test_wrappers_reject_bad_quantized_arenas(cuda_device):
    """A 1-byte arena needs [NB, Nkv] f32 scales, and scales need one."""
    q, k, v, tbl, qpos, kvpos = _paged_args(cuda_device, 1, torch.float32)
    kc, ks, vc, vs = _quantize(k, v, "int8")
    kernels.reset_launch_counts()
    bad = [
        ((kc, vc), {}, "k_scale and v_scale"),
        ((kc, vc), dict(k_scale=ks), "k_scale and v_scale"),
        ((k, v), dict(k_scale=ks, v_scale=vs), "k_scale and v_scale"),
        ((kc, vc), dict(k_scale=ks.double(), v_scale=vs), "float32"),
        ((kc, vc), dict(k_scale=ks[:, :1].contiguous(), v_scale=vs), "shape"),
        ((kc, vc.view(torch.float8_e4m3fn)), dict(k_scale=ks, v_scale=vs), "dtype"),
    ]
    for (ka, va), sc, match in bad:
        for fn in (tpa.paged_attention, tpa.paged_prefill):
            with pytest.raises(ValueError, match=match):
                fn(q, ka, va, tbl, qpos, kvpos, **sc)
    assert not any(kernels.launch_counts().values())


@pytest.mark.cuda
def test_served_int8_stream_goes_through_the_quantized_kernels(cuda_device):
    """A tiny float32 model served on the card from an int8 arena: the
    paged work runs in the int8 modes only, and the streams equal the same
    server's through the plain versions."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    eng = Engine(cfg, tllama.init_params(cfg, seed=3, dtype=torch.float32, device=cuda_device))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 30, 12)]
    streams = {}
    for attn in ("plain", "auto"):
        srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=8, kv_blocks=40,
                        prefill_chunk=8, kv_dtype="int8", paged_attn=attn)
        assert srv.state.k.dtype == torch.int8
        kernels.reset_launch_counts()
        reqs = [srv.submit(p, 8) for p in prompts[:2]]
        srv.step()
        reqs += [srv.submit(p, 8) for p in prompts[2:]]
        srv.run_until_idle()
        streams[attn] = [r.tokens for r in reqs]
        counts = kernels.launch_counts()
        srv._alloc.check()
        assert srv._alloc.in_use == 0
    assert counts["paged_attention[int8]"] > 0 and counts["paged_prefill[int8]"] > 0, counts
    assert counts["flash_attention"] > 0
    assert counts["paged_attention"] == counts["paged_prefill"] == 0
    assert streams["auto"] == streams["plain"]


def _flash_case(dev, dtype, S, D, G, B=1, pad=0, seed=40):
    """B rows of an S-token causal prefill (S = C); the last row's final
    ``pad`` positions carry the sentinel (a bucket-padded admission)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Nkv = 2

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if pad:
        pos[-1, S - pad :] = POS_SENTINEL
    return t(B, S, Nkv * G, D), t(B, S, Nkv, D), t(B, S, Nkv, D), pos, pos


def _assert_close_rows(got, want, dtype, step=False):
    """Absolute limit TOL and row-relative limit TOL_REL. With ``step``
    (bf16 at head dim 256) each output's absolute limit is TOL or one bf16
    step of its expected value, whichever is larger."""
    assert torch.isfinite(got).all()
    if step:
        atol = (want.float().abs() * BF16_STEP).clamp_min(TOL[dtype])
        assert ((got.float() - want.float()).abs() <= atol).all()
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    row_scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    assert ((got.float() - want.float()).abs() / row_scale).max().item() <= TOL_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [37, 200, 2048])
def test_flash_tensor_core_kernel_matches_plain(cuda_device, S, D, G):
    """bf16 flash (wgmma + TMA) against the plain version: ragged and
    tile-multiple lengths, both head dims, with and without GQA."""
    args = _flash_case(cuda_device, torch.bfloat16, S, D, G)
    kernels.reset_launch_counts()
    got = tfa.flash_attention(*args)
    want = tfa.cached_attention(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_tensor_core_kernel_sentinel_padded_rows(cuda_device, D):
    """B = 2, the second row bucket-padded (200 real of 256): the padded
    query rows see every key, as on the plain path."""
    args = _flash_case(cuda_device, torch.bfloat16, 256, D, 3, B=2, pad=56)
    got, want = tfa.flash_attention(*args), tfa.cached_attention(*args)
    torch.cuda.synchronize()
    _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_f32_inputs_take_the_tile_path(cuda_device):
    """The same inputs in f32 (dispatched by dtype to the CUDA-core tile,
    never the tensor cores) meet the f32 limits; in bf16 the bf16 ones."""
    args32 = _flash_case(cuda_device, torch.float32, 200, 128, 3, B=2, pad=56)
    args16 = tuple(a.bfloat16() if a.is_floating_point() else a for a in args32)
    for args, dtype in ((args32, torch.float32), (args16, torch.bfloat16)):
        got, want = tfa.flash_attention(*args), tfa.cached_attention(*args)
        torch.cuda.synchronize()
        _assert_close_rows(got, want, dtype)


def _decode_case(dev, dtype, B, S, ctx, kv, seed=41, Nkv=2, G=3, D=128):
    """Decode over a 40-block table (block size 16): each row maps its
    context's blocks in random arena order, the rest is trash block 0,
    which holds NaN/Inf (0x7F codes and Inf scales for a code arena)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    BS, T = 16, 40
    nblk = [-(-c // BS) for c in ctx]
    NB = sum(nblk) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tbl = torch.zeros((B, T), dtype=torch.int32, device=dev)
    kvpos = torch.full((B, T * BS), POS_SENTINEL, dtype=torch.int32, device=dev)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    j = 0
    for b, c in enumerate(ctx):
        tbl[b, : nblk[b]] = perm[j : j + nblk[b]]
        j += nblk[b]
        kvpos[b, :c] = torch.arange(c)
        qpos[b] = torch.arange(c - S, c)
    q = torch.randn((B, S, Nkv * G, D), generator=g, device=dev).to(dtype)
    sc = {}
    if kv is not None:
        k, ks, v, vs = _quantize(k, v, kv)
        sc = dict(k_scale=ks, v_scale=vs)
    return (q, k, v, tbl, qpos, kvpos), sc


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("B", [1, 8])
def test_split_kv_decode_matches_plain(cuda_device, B, S, kv):
    """Split-KV decode against the plain version: contexts of one block,
    exactly k blocks, and the whole table width; S = 4 folds 12 rows per KV
    head (three CTAs along y); NaN/Inf in trash block 0."""
    full = 40 * 16
    cases = [[16], [48], [full]] if B == 1 else [[16, 48, full, S, 300, 16, 64, full]]
    name = "paged_attention" + (f"[{kv}]" if kv else "")
    for ctx in cases:
        args, sc = _decode_case(cuda_device, torch.bfloat16, B, S, ctx, kv)
        kernels.reset_launch_counts()
        got = tpa.paged_attention(*args, **sc)
        want = tpa.paged_attention_xla(*args, **sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == 1
        _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_split_kv_decode_f32_queries(cuda_device):
    """f32 queries over an f32 arena and an int8 one, at f32 limits."""
    for kv in (None, "int8"):
        args, sc = _decode_case(cuda_device, torch.float32, 8, 1, [16, 48, 640, 1, 300, 16, 64, 640], kv)
        got, want = tpa.paged_attention(*args, **sc), tpa.paged_attention_xla(*args, **sc)
        torch.cuda.synchronize()
        _assert_close_rows(got, want, torch.float32)


def _prefill_case(dev, dtype, frontiers, Sc, BS, D, kv, pad=0, seed=42, Nkv=2, G=3):
    """Chunked prefill of Sc queries per row at the given written frontiers
    over a table with two stale blocks past the longest (sentinel
    positions); rows map their blocks in random arena order. Trash block 0
    (NaN/Inf; 0x7F codes and Inf scales for a code arena) is mapped inside
    row 0's window at visible positions BS..2*BS-1; the last row's final
    ``pad`` queries carry the sentinel. Returns the args, the kernel's and
    the plain version's keywords, and the query rows that see a key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(frontiers)
    T = max(-(-f // BS) for f in frontiers) + 2
    NB = B * T + 1
    k = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tbl = perm[: B * T].reshape(B, T).to(torch.int32)
    tbl[0, 1] = 0
    kvpos = torch.full((B, T * BS), POS_SENTINEL, dtype=torch.int32, device=dev)
    qpos = torch.zeros((B, Sc), dtype=torch.int32, device=dev)
    for b, f in enumerate(frontiers):
        kvpos[b, :f] = torch.arange(f)
        qpos[b] = torch.arange(f - Sc, f)
    if pad:
        qpos[-1, Sc - pad :] = POS_SENTINEL
    nlive = torch.tensor([-(-f // BS) for f in frontiers], dtype=torch.int32, device=dev)
    q = torch.randn((B, Sc, Nkv * G, D), generator=g, device=dev).to(dtype)
    sc = {}
    if kv is not None:
        k, ks, v, vs = _quantize(k, v, kv)
        sc = dict(k_scale=ks, v_scale=vs)
    return (q, k, v, tbl, qpos, kvpos), dict(nlive=nlive, **sc), sc, qpos < POS_SENTINEL


# B = 2: a ragged chunk (100 queries: the second 128-row tile is mostly
# padding) at two frontiers, one split run per row; B = 1: 256 queries at a
# 1500-token frontier, 12 CTAs, so the row is cut into several runs
PREFILL_SHAPES = {"B2-ragged": ((300, 130), 100, 9), "B1-long-split": ((1500,), 256, 40)}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("BS", [16, 64])
@pytest.mark.parametrize("shape", list(PREFILL_SHAPES))
def test_prefill_tensor_core_kernel_matches_plain(cuda_device, shape, BS, D, kv):
    """bf16 chunked prefill on the tensor cores against the plain version:
    both block sizes (16: four TMA boxes per 64-key tile; 64: one), both
    head dims, every KV mode, trash inside a window at visible positions,
    sentinel query rows (left out: no visible key past the clamp on one
    side, the whole window on the other)."""
    frontiers, Sc, pad = PREFILL_SHAPES[shape]
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.bfloat16, frontiers, Sc, BS, D, kv,
                                             pad=pad)
    assert tpa.prefill_design(torch.bfloat16, BS) == "wgmma"
    if shape == "B1-long-split":
        _, nsplit = tpa.plan_prefill_splits(1, Sc, 6, args[3].shape[1] * BS, BS,
                                            kernels.sm_count(cuda_device))
        assert nsplit > 1
    kernels.reset_launch_counts()
    got = tpa.paged_prefill(*args, **kw)
    want = tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_prefill" + (f"[{kv}]" if kv else "")] == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got[rows], want[rows], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
def test_prefill_f32_queries_take_the_tile_path(cuda_device, kv):
    """f32 queries at block size 64 (dispatched by dtype to the CUDA-core
    tile, never the tensor cores) meet the f32 limits, trash and split
    shape as above."""
    assert tpa.prefill_design(torch.float32, 64) == "tile"
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.float32, (1500,), 256, 64, 128,
                                             kv, pad=40)
    got, want = tpa.paged_prefill(*args, **kw), tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    _assert_close_rows(got[rows], want[rows], torch.float32)


# GPT-2's attention: one KV head per query head (G = 1), head dim 64 (and
# 128, Llama-2-7B's); 12 heads, so the prefill kernel's B = 1 chunk has 24
# CTAs and is cut into runs
MHA = dict(Nkv=12, G=1)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_split_kv_decode_mha_matches_plain(cuda_device, D, B, S, kv):
    """Split-KV decode at G = 1 (multi-head attention, as GPT-2) against
    the plain version, the contexts of ``test_split_kv_decode_matches_plain``."""
    full = 40 * 16
    cases = [[16], [48], [full]] if B == 1 else [[16, 48, full, S, 300, 16, 64, full]]
    name = "paged_attention" + (f"[{kv}]" if kv else "")
    for ctx in cases:
        args, sc = _decode_case(cuda_device, torch.bfloat16, B, S, ctx, kv, D=D, **MHA)
        kernels.reset_launch_counts()
        got = tpa.paged_attention(*args, **sc)
        want = tpa.paged_attention_xla(*args, **sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == 1
        _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("BS", [16, 64])
@pytest.mark.parametrize("shape", list(PREFILL_SHAPES))
@pytest.mark.parametrize("D", [64, 128])
def test_prefill_tensor_core_kernel_mha_matches_plain(cuda_device, D, shape, BS, kv):
    """bf16 chunked prefill on the tensor cores at G = 1 (GPT-2's attention
    at D = 64, Llama-2-7B's at D = 128), the shapes of
    ``test_prefill_tensor_core_kernel_matches_plain``."""
    frontiers, Sc, pad = PREFILL_SHAPES[shape]
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.bfloat16, frontiers, Sc, BS, D,
                                             kv, pad=pad, **MHA)
    assert tpa.prefill_design(torch.bfloat16, BS) == "wgmma"
    if shape == "B1-long-split":
        _, nsplit = tpa.plan_prefill_splits(1, Sc, 12, args[3].shape[1] * BS, BS,
                                            kernels.sm_count(cuda_device))
        assert nsplit > 1
    kernels.reset_launch_counts()
    got = tpa.paged_prefill(*args, **kw)
    want = tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_prefill" + (f"[{kv}]" if kv else "")] == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got[rows], want[rows], torch.bfloat16)


# gemma-1's attention, head dim 256: gemma-2B's 8 query heads over one KV
# head (G = 8) and gemma-7B's one query head per KV head (G = 1; 4 KV heads
# here, 16 in the model). A row that sees one or two keys outputs about one
# V value, and among 256-wide rows of unit-scale V some exceed magnitude 4,
# where one bf16 step (2^-5 = 0.031) is above the absolute limit TOL: the
# bf16 decode and prefill cases hold each output to TOL or one step of it.
GEMMA = {8: dict(Nkv=1, G=8), 1: dict(Nkv=4, G=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("G", [8, 1])
def test_split_kv_decode_head_dim_256_matches_plain(cuda_device, G, B, S, kv):
    """Split-KV decode at D = 256 against the plain version, the contexts
    of ``test_split_kv_decode_matches_plain``: a 512-byte bf16 row is one
    key per warp, a 256-byte code row two."""
    full = 40 * 16
    cases = [[16], [48], [full]] if B == 1 else [[16, 48, full, S, 300, 16, 64, full]]
    name = "paged_attention" + (f"[{kv}]" if kv else "")
    for ctx in cases:
        args, sc = _decode_case(cuda_device, torch.bfloat16, B, S, ctx, kv, D=256, **GEMMA[G])
        kernels.reset_launch_counts()
        got = tpa.paged_attention(*args, **sc)
        want = tpa.paged_attention_xla(*args, **sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == 1
        _assert_close_rows(got, want, torch.bfloat16, step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
def test_split_kv_decode_f32_queries_head_dim_256(cuda_device, kv):
    """f32 queries at D = 256 at f32 limits: over an f32 arena a 1 KB row
    is two 16-byte vectors per lane; over a code arena, one."""
    args, sc = _decode_case(cuda_device, torch.float32, 8, 1, [16, 48, 640, 1, 300, 16, 64, 640],
                            kv, D=256, **GEMMA[8])
    got, want = tpa.paged_attention(*args, **sc), tpa.paged_attention_xla(*args, **sc)
    torch.cuda.synchronize()
    _assert_close_rows(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("BS", [16, 64])
@pytest.mark.parametrize("shape", list(PREFILL_SHAPES))
def test_prefill_tensor_core_kernel_head_dim_256_matches_plain(cuda_device, shape, BS, kv):
    """bf16 chunked prefill on the tensor cores at D = 256, G = 8 (gemma-2B's
    attention), the shapes of ``test_prefill_tensor_core_kernel_matches_plain``:
    four TMA boxes per row, two bf16 ring stages (one code stage)."""
    frontiers, Sc, pad = PREFILL_SHAPES[shape]
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.bfloat16, frontiers, Sc, BS, 256,
                                             kv, pad=pad, **GEMMA[8])
    assert tpa.prefill_design(torch.bfloat16, BS) == "wgmma"
    if shape == "B1-long-split":
        _, nsplit = tpa.plan_prefill_splits(1, Sc, 8, args[3].shape[1] * BS, BS,
                                            kernels.sm_count(cuda_device))
        assert nsplit > 1
    kernels.reset_launch_counts()
    got = tpa.paged_prefill(*args, **kw)
    want = tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_prefill" + (f"[{kv}]" if kv else "")] == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got[rows], want[rows], torch.bfloat16, step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
def test_prefill_f32_queries_head_dim_256_take_the_tile_path(cuda_device, kv):
    """f32 queries at D = 256 (the CUDA-core tile, 64-row query tiles)
    meet the f32 limits, trash and split shape as above."""
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.float32, (1500,), 256, 64, 256,
                                             kv, pad=40, **GEMMA[8])
    got, want = tpa.paged_prefill(*args, **kw), tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    _assert_close_rows(got[rows], want[rows], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [8, 1])
def test_flash_f32_head_dim_256_takes_the_tile_path(cuda_device, G):
    """f32 flash at D = 256 (the CUDA-core tile) at f32 limits: a padded
    admission bucket, with and without GQA."""
    args = _flash_case(cuda_device, torch.float32, 200, 256, G, B=2, pad=56)
    got, want = tfa.flash_attention(*args), tfa.cached_attention(*args)
    torch.cuda.synchronize()
    _assert_close_rows(got, want, torch.float32)
