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
    """The same inputs in f32 (dispatched by dtype to the f32 route:
    3xTF32 products, never plain TF32) meet the f32 limits; in bf16 the
    bf16 ones."""
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
    """f32 flash at D = 256 (the f32 route's 64-row tile) at f32 limits: a
    padded admission bucket, with and without GQA."""
    args = _flash_case(cuda_device, torch.float32, 200, 256, G, B=2, pad=56)
    got, want = tfa.flash_attention(*args), tfa.cached_attention(*args)
    torch.cuda.synchronize()
    _assert_close_rows(got, want, torch.float32)


# A prefix-cache hit's shapes. A one-shot hit runs flash with fewer queries
# than keys: S suffix queries at positions P.. over C = P + S keys, the
# first P the prefix. A chunked hit runs its first chunk at column P, over
# table entries that rows share. Decode then reads tables whose leading
# blocks are shared.


def _flash_past_prefix_case(dev, dtype, S, P, D, G, seed=43):
    """Two rows of S queries at positions P..P+S-1 over C = P + S keys; the
    second row bucket-padded (S - S//4 real), its padding queries and keys
    the sentinel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Nkv, C = 2, P + S

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    real = S - S // 4
    qpos = (P + torch.arange(S, dtype=torch.int32, device=dev))[None].repeat(2, 1)
    qpos[1, real:] = POS_SENTINEL
    kvpos = torch.arange(C, dtype=torch.int32, device=dev)[None].repeat(2, 1)
    kvpos[1, P + real :] = POS_SENTINEL
    return t(2, S, Nkv * G, D), t(2, C, Nkv, D), t(2, C, Nkv, D), qpos, kvpos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D, G", [(64, 1), (128, 3), (256, 8)])
@pytest.mark.parametrize("S, P", [(256, 1024), (37, 64)])
def test_flash_past_a_prefix_matches_plain(cuda_device, S, P, D, G, dtype):
    """Flash at S < C with query positions from P: the tensor-core kernel
    (bf16) and the tile (f32) against the plain version, on the rows that
    see a key (every query row here: padding rows see every key)."""
    args = _flash_past_prefix_case(cuda_device, dtype, S, P, D, G)
    kernels.reset_launch_counts()
    got = tfa.flash_attention(*args)
    want = tfa.cached_attention(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    _assert_close_rows(got, want, dtype, step=dtype == torch.bfloat16 and D == 256)


def _shared_prefix_chunk_case(dev, dtype, kv, P, Sc, BS, D, Nkv, G, seed=44):
    """Two rows whose first P / BS table entries are the same shared
    blocks, each with its own private blocks after them; a chunk of Sc
    queries per row at columns and positions P..P+Sc-1, the second row's
    last quarter the sentinel; two stale private blocks past the frontier;
    trash block 0 (NaN/Inf; 0x7F codes and Inf scales) maps the table's
    tail. ``nlive`` counts the prefix."""
    g = torch.Generator(device=dev).manual_seed(seed)
    npfx, nchunk = P // BS, -(-Sc // BS)
    T = npfx + nchunk + 4
    NB = npfx + 2 * (nchunk + 2) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    perm = (torch.randperm(NB - 1, generator=g, device=dev) + 1).to(torch.int32)
    tbl = torch.zeros((2, T), dtype=torch.int32, device=dev)
    tbl[:, :npfx] = perm[:npfx]
    for b in range(2):
        lo = npfx + b * (nchunk + 2)
        tbl[b, npfx : npfx + nchunk + 2] = perm[lo : lo + nchunk + 2]
    kvpos = torch.full((2, T * BS), POS_SENTINEL, dtype=torch.int32, device=dev)
    kvpos[:, : P + Sc] = torch.arange(P + Sc, dtype=torch.int32, device=dev)
    qpos = (P + torch.arange(Sc, dtype=torch.int32, device=dev))[None].repeat(2, 1)
    real = Sc - Sc // 4
    qpos[1, real:] = POS_SENTINEL
    kvpos[1, P + real : P + Sc] = POS_SENTINEL
    nlive = torch.full((2,), -(-(P + Sc) // BS), dtype=torch.int32, device=dev)
    q = torch.randn((2, Sc, Nkv * G, D), generator=g, device=dev).to(dtype)
    sc = {}
    if kv is not None:
        k, ks, v, vs = _quantize(k, v, kv)
        sc = dict(k_scale=ks, v_scale=vs)
    return (q, k, v, tbl, qpos, kvpos), dict(nlive=nlive, **sc), sc, qpos < POS_SENTINEL


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("D, Nkv, G", [(128, 2, 3), (256, 1, 8)])
@pytest.mark.parametrize("P, Sc, BS", [(1024, 256, 64), (48, 100, 16)])
def test_prefill_chunk_past_a_shared_prefix_matches_plain(cuda_device, P, Sc, BS, D, Nkv, G, kv):
    """The first chunk of a chunked radix hit (bf16, tensor cores) against
    the plain version: over blocks two rows share, from column P, ``nlive``
    covering prefix and chunk; held on the query rows that see a key."""
    args, kw, plain_kw, rows = _shared_prefix_chunk_case(cuda_device, torch.bfloat16, kv, P, Sc,
                                                         BS, D, Nkv, G)
    kernels.reset_launch_counts()
    got = tpa.paged_prefill(*args, **kw)
    want = tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_prefill" + (f"[{kv}]" if kv else "")] == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got[rows], want[rows], torch.bfloat16, step=D == 256)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
def test_prefill_chunk_past_a_shared_prefix_f32_tile(cuda_device, kv):
    """The same with f32 queries (the CUDA-core tile), at f32 limits."""
    args, kw, plain_kw, rows = _shared_prefix_chunk_case(cuda_device, torch.float32, kv, 1024, 256,
                                                         64, 128, 2, 3)
    got, want = tpa.paged_prefill(*args, **kw), tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    _assert_close_rows(got[rows], want[rows], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("D, Nkv, G", [(128, 2, 3), (256, 1, 8)])
def test_decode_over_shared_leading_blocks_matches_plain(cuda_device, D, Nkv, G, kv):
    """Split-KV decode over 8 rows whose tables share their first 16
    blocks (a 1024-token prefix at block size 64), each row then its own
    blocks to contexts of 1030-2000 tokens, trash past them."""
    g = torch.Generator(device=cuda_device).manual_seed(45)
    BS, T, npfx = 64, 40, 16
    ctx = [1030, 1100, 1500, 2000, 1024 + 64, 1200, 1900, 1031]
    own = [-(-c // BS) - npfx for c in ctx]
    NB = npfx + sum(own) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=g, device=cuda_device).to(torch.bfloat16)
    v = torch.randn((NB, BS, Nkv, D), generator=g, device=cuda_device).to(torch.bfloat16)
    k[0], v[0] = float("nan"), float("inf")
    perm = (torch.randperm(NB - 1, generator=g, device=cuda_device) + 1).to(torch.int32)
    tbl = torch.zeros((8, T), dtype=torch.int32, device=cuda_device)
    tbl[:, :npfx] = perm[:npfx]
    kvpos = torch.full((8, T * BS), POS_SENTINEL, dtype=torch.int32, device=cuda_device)
    j = npfx
    for b, c in enumerate(ctx):
        tbl[b, npfx : npfx + own[b]] = perm[j : j + own[b]]
        j += own[b]
        kvpos[b, :c] = torch.arange(c)
    qpos = torch.tensor(ctx, dtype=torch.int32, device=cuda_device)[:, None] - 1
    q = torch.randn((8, 1, Nkv * G, D), generator=g, device=cuda_device).to(torch.bfloat16)
    sc = {}
    if kv is not None:
        k, ks, v, vs = _quantize(k, v, kv)
        sc = dict(k_scale=ks, v_scale=vs)
    args = (q, k, v, tbl, qpos, kvpos)
    kernels.reset_launch_counts()
    got = tpa.paged_attention(*args, **sc)
    want = tpa.paged_attention_xla(*args, **sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention" + (f"[{kv}]" if kv else "")] == 1
    _assert_close_rows(got, want, torch.bfloat16, step=D == 256)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_served_prefix_cache_goes_through_the_kernels(cuda_device, tmp_path, kv):
    """A tiny float32 model served on the card with the disk-tier prefix
    cache: a cold prompt, then a one-shot and a chunked hit, then a hit
    after every node was spilled to disk. A demote/restore round trip is
    byte-exact on the card, the hits went through flash and the
    chunked-prefill kernel, and the streams equal the cache-off server's
    (f32 arena) or, with an int8 arena, where a hit reads the prefix from
    codes, the same cached server's through the plain versions."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    eng = Engine(cfg, tllama.init_params(cfg, seed=3, dtype=torch.float32, device=cuda_device))
    rng = np.random.default_rng(4)
    p1 = rng.integers(0, cfg.vocab_size, 33).astype(np.int32)
    prompts = [p1, np.concatenate([p1, rng.integers(0, cfg.vocab_size, 5)]),
               np.concatenate([p1, rng.integers(0, cfg.vocab_size, 30)]),
               np.concatenate([p1, rng.integers(0, cfg.vocab_size, 7)])]
    kw = dict(capacity=128, batch_per_slot=2, kv_block_size=8, kv_blocks=64, prefill_chunk=16,
              kv_dtype=kv)
    runs = [("off", "auto"), ("disk", "auto")] + ([("disk", "plain")] if kv == "int8" else [])
    streams = {}
    for cache, attn in runs:
        extra = {}
        if cache == "disk":
            extra = dict(disk_pool_dir=str(tmp_path / attn))
        srv = eng.serve(prefix_cache=cache, paged_attn=attn, **kw, **extra)
        out = []
        for i, p in enumerate(prompts):
            if cache == "disk" and i == 3:
                node = srv._radix.root.children[int(p1[0])]
                before = srv._read_arena_blocks(list(node.blocks))
                srv._radix.demote_all(to_disk=True)
                ref = srv._radix.take(p1, 32)
                after = srv._read_arena_blocks(list(ref.blocks))
                srv._radix.release(ref)
                assert all(a.tobytes() == b.tobytes() for a, b in zip(before, after))
                srv._radix.demote_all(to_disk=True)
            kernels.reset_launch_counts()
            r = srv.submit(p, 6)
            srv.run_until_idle()
            out.append(r.tokens)
            if (cache, attn) == ("disk", "auto") and i in (1, 2):
                mode = "" if kv == "bf16" else f"[{kv}]"
                name = "flash_attention" if i == 1 else "paged_prefill" + mode
                assert kernels.launch_counts()[name] > 0
        streams[cache, attn] = out
        if cache == "disk":
            st = srv.prefix_cache_stats()
            assert st["hit_tokens"] == 3 * 32 and st["disk_hit_tokens"] == 2 * 32
            srv._radix.check()
            srv._alloc.check()
            assert srv._alloc.in_use == srv._radix.device_blocks
    want = streams["off", "auto"] if kv == "bf16" else streams["disk", "plain"]
    assert streams["disk", "auto"] == want


# ------------------------------ decode by live length, chunked prefill splits

# decode contexts over a capacity-width table: one 2048-token row among
# short ones (one key, a block, ragged lengths)
WIDE_CTX = [2048, 100, 37, 500, 5, 64, 130, 700]


def _wide_case(dev, dtype, ctx, kv, S=1, G=3, Nkv=2, D=128, BS=64, T=None, seed=80):
    """Decode (S = 1) or verify (S > 1) rows over a table of T blocks
    (default capacity 4096), each row's blocks in random arena order, the
    rest trash block 0 (NaN/Inf; 0x7F codes and Inf scales for a code
    arena); the queries sit at each row's last S positions. Returns the
    args, the scales and ``nlive`` (each row's blocks)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    T = 4096 // BS if T is None else T
    nblk = [-(-c // BS) for c in ctx]
    NB = sum(nblk) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=g, device=dev).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    perm = (torch.randperm(NB - 1, generator=g, device=dev) + 1).to(torch.int32)
    B = len(ctx)
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
    return (q, k, v, tbl, qpos, kvpos), sc, torch.tensor(nblk, dtype=torch.int32, device=dev)


def _decode_once(args, sc, kv, nlive):
    """The decode kernel's output over each row's ``nlive`` blocks, its
    plain version's over the window, and the kernel's launches for the
    call."""
    kernels.reset_launch_counts()
    got = tpa.paged_attention(*args, **sc, nlive=nlive, backend="kernel")
    want = tpa.paged_attention_xla(*args, **sc)
    torch.cuda.synchronize()
    return got, want, kernels.launch_counts()["paged_attention" + (f"[{kv}]" if kv else "")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G,S", [(3, 1), (3, 5), (8, 5)], ids=["GS3", "GS15", "GS40"])
def test_decode_holds_every_folded_row_of_a_kv_head(cuda_device, G, S, D, kv, dtype):
    """G * S = 3 (the 3B's decode), 15 (its verify at S = 5) and 40
    (gemma-2B's verify: three 16-row tiles with bf16 queries, three row
    groups with f32) over a capacity-width table (T = 64, block size 64)
    with one 2048-token row among short ones: one launch, the plain
    version's output."""
    args, sc, nlive = _wide_case(cuda_device, dtype, WIDE_CTX, kv, S=S, G=G, D=D)
    got, want, launches = _decode_once(args, sc, kv, nlive)
    assert launches == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got, want, dtype, step=D == 256)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("BS", [16, 32, 64, 128])
def test_decode_at_each_block_size(cuda_device, BS, kv):
    """Block sizes 16 and 32 (several TMA boxes per 64-key tile), 64 (one)
    and 128 (a block is two tiles) over a capacity-4096 table, over the
    rows' written frontiers and over the whole table."""
    args, sc, nlive = _wide_case(cuda_device, torch.bfloat16, [2048, 77, 300, 1500], kv, BS=BS)
    for rows in (nlive, None):  # the written frontiers, then the whole table
        got, want, launches = _decode_once(args, sc, kv, rows)
        assert launches == 1
        _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("ctx", [2048, 64, 5])
def test_decode_one_row_over_a_capacity_table(cuda_device, ctx, kv, dtype):
    """B = 1 over T = 64: 2048 tokens cut across the pieces of every KV
    head (the merge in the launch), one block, a part of one."""
    args, sc, nlive = _wide_case(cuda_device, dtype, [ctx], kv)
    got, want, launches = _decode_once(args, sc, kv, nlive)
    assert launches == 1
    _assert_close_rows(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_chunk_prefill_at_frontiers_256_and_2048(cuda_device, B, kv):
    """Chunks of 256 queries at frontiers 2048 (B = 1: its rows cut into
    runs merged in the launch) or 256 and 2048 in turn (B = 4, 8), block
    size 64, head dim 128: one launch, trash inside row 0's window."""
    frontiers = (2048,) if B == 1 else (256, 2048) * (B // 2)
    args, kw, plain_kw, rows = _prefill_case(cuda_device, torch.bfloat16, frontiers, 256, 64, 128,
                                             kv)
    kernels.reset_launch_counts()
    got = tpa.paged_prefill(*args, **kw)
    want = tpa.paged_attention_xla(*args, **plain_kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_prefill" + (f"[{kv}]" if kv else "")] == 1
    assert torch.isfinite(got).all()
    _assert_close_rows(got[rows], want[rows], torch.bfloat16)


# ---------------------------------------------- resilience on the card


def _tiny_engine(dev, dtype=torch.float32):
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    return Engine(cfg, tllama.init_params(cfg, seed=3, dtype=dtype, device=dev))


_SERVE = dict(capacity=64, batch_per_slot=3, kv_block_size=8, kv_blocks=40, prefill_chunk=8)


def _mid_decode(srv, prompts, max_new=12, steps=4, **kw):
    reqs = [srv.submit(p, max_new, **kw) for p in prompts]
    for _ in range(steps):
        srv.step()
    return reqs


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_snapshot_round_trip_is_byte_exact_on_the_card(cuda_device, kv):
    """A snapshot of a bf16 engine's server mid-decode restored into a fresh
    server: the held blocks' codes and scales, the key positions and the
    tables are byte-identical to the original's on the card."""
    from llm_sharding_tpu_torch.runtime.server import PipelineServer

    eng = _tiny_engine(cuda_device, torch.bfloat16)
    rng = np.random.default_rng(5)
    srv = eng.serve(kv_dtype=kv, **_SERVE)
    _mid_decode(srv, [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20)])
    held = sorted({b for lst in srv._row_blocks + srv._row_shared for b in lst})
    assert held
    snap = srv.snapshot()
    srv2 = PipelineServer.restore(eng, snap)
    before, after = srv._read_arena_blocks(held), srv2._read_arena_blocks(held)
    assert len(before) == (2 if kv == "bf16" else 4)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(before, after))
    assert torch.equal(srv.state.kpos, srv2.state.kpos)
    assert torch.equal(srv.state.block_tables, srv2.state.block_tables)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_restore_mid_decode_is_token_identical_through_the_kernels(cuda_device, kv):
    """Snapshot mid-decode (one-shot and chunked rows), drop the server,
    restore: the streams equal the uninterrupted run's, and the restored
    server decodes through the paged kernel."""
    from llm_sharding_tpu_torch.runtime.server import PipelineServer

    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12)]
    full = eng.serve(kv_dtype=kv, **_SERVE)
    want = _mid_decode(full, prompts)
    full.run_until_idle()
    srv = eng.serve(kv_dtype=kv, **_SERVE)
    reqs = _mid_decode(srv, prompts)
    assert all(r.tokens and not r.done for r in reqs)
    snap = srv.snapshot()
    srv.close()
    del srv
    torch.cuda.empty_cache()
    srv2 = PipelineServer.restore(eng, snap)
    got = {r.id: r for r in srv2._req if r is not None}
    kernels.reset_launch_counts()
    srv2.run_until_idle()
    mode = "" if kv == "bf16" else f"[{kv}]"
    assert kernels.launch_counts()["paged_attention" + mode] > 0
    assert [got[r.id].tokens for r in reqs] == [w.tokens for w in want]
    srv2._alloc.check()
    assert srv2._alloc.in_use == 0


@pytest.mark.cuda
def test_sampled_extract_adopt_carries_the_cuda_generator(cuda_device):
    """Sampled rows extracted mid-decode carry their CUDA generator's state
    (host bytes: seed and offset) to a second server on the card, and
    finish as the port's ``generate(seed=)`` on the card."""
    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20)]
    kw = dict(temperature=0.8, top_k=20, seed=11)
    sa, sb = eng.serve(**_SERVE), eng.serve(**_SERVE)
    reqs = _mid_decode(sa, prompts, **kw)
    for r in reqs:
        assert r.tokens and not r.done
        st = sa.extract(r)
        assert st.rng_device == "cuda" and st.rng is not None
        sb.adopt(st, r)
    sb.run_until_idle()
    for r, p in zip(reqs, prompts):
        want = eng.generate_ids(p, 12, **kw)
        assert r.tokens == want.tokens[0, len(p) : want.lengths[0]].tolist()
    for s in (sa, sb):
        s._alloc.check()
        assert s._alloc.in_use == 0


@pytest.mark.cuda
def test_transient_faults_at_every_site_are_token_identical_on_the_card(cuda_device, tmp_path):
    """A transient plan at all five sites gives the streams of the run
    without faults, through the kernels, with every fault retried."""
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan, FaultSpec

    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12)]
    clean = eng.serve(**_SERVE)
    want = _mid_decode(clean, prompts)
    clean.run_until_idle()
    plan = FaultPlan([
        FaultSpec("admit_dispatch", "transient", at=(0,)),
        FaultSpec("chunk_dispatch", "transient", at=(0, 2, 5)),
        FaultSpec("log_fetch", "transient", at=(1, 4)),
        FaultSpec("snapshot_write", "transient", at=(0,)),
        FaultSpec("request_apply", "transient", at=(2,), key=0),
    ])
    srv = eng.serve(fault_plan=plan, fault_backoff_s=0.0, snapshot_every_s=1e9,
                    snapshot_path=str(tmp_path / "snap"), **_SERVE)
    srv._last_snapshot_at = -1e12
    kernels.reset_launch_counts()
    got = _mid_decode(srv, prompts)
    srv.run_until_idle()
    assert [r.tokens for r in got] == [w.tokens for w in want]
    assert all(r.error is None for r in got) and srv.health == "SERVING"
    assert plan.stats()["total_fires"] == 8
    assert all(n > 0 for n in kernels.launch_counts().values())


# ---------------------------------------- speculative decoding on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("K", [1, 4, 7])
def test_decode_at_verify_width_matches_plain(cuda_device, K, G, kv):
    """The decode kernel at a paged verify's S = K + 1 causal queries per
    row (G·(K+1) folded rows per KV head: 2 to 64), 8 rows of 16-640
    tokens, one row of exactly K + 1, against the plain version."""
    S = K + 1
    name = "paged_attention" + (f"[{kv}]" if kv else "")
    args, sc = _decode_case(cuda_device, torch.bfloat16, 8, S, [16, 48, 640, S, 300, 16, 64, 640],
                            kv, Nkv=2, G=G)
    kernels.reset_launch_counts()
    got = tpa.paged_attention(*args, **sc)
    want = tpa.paged_attention_xla(*args, **sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == 1
    _assert_close_rows(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("K", [1, 4, 7])
def test_flash_at_verify_width_over_scratch_columns(cuda_device, K, D):
    """bf16 flash at speculative ``generate``'s verify: S = K + 1 queries
    per row at that row's own positions over a dense cache of capacity + K
    + 1 columns, the scratch columns at the top holding the in-flight
    entries and sentinel columns below them. The K + 1 real rows ride one
    64-row tensor-core tile whose other rows the TMA fills with zeros and
    the kernel never stores: with B = 3 rows back to back in ``out``, a
    stored padding row of batch row b would land on row b + 1's outputs."""
    g = torch.Generator(device=cuda_device).manual_seed(50 + K)
    B, cap, Nkv, G = 3, 300, 2, 3
    S, C = K + 1, cap + K + 1
    pos0 = [280, 17, 150]
    kvpos = torch.full((B, C), POS_SENTINEL, dtype=torch.int32, device=cuda_device)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=cuda_device)
    for b, p in enumerate(pos0):
        kvpos[b, :p] = torch.arange(p)
        kvpos[b, cap:] = p + torch.arange(S)
        qpos[b] = p + torch.arange(S)

    def t(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)

    args = (t(B, S, Nkv * G, D), t(B, C, Nkv, D), t(B, C, Nkv, D), qpos, kvpos)
    kernels.reset_launch_counts()
    got = tfa.flash_attention(*args)
    want = tfa.cached_attention(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    _assert_close_rows(got, want, torch.bfloat16, step=D == 256)


def _flash_route_case(dev, dtype, kind, B, S, C, Nh, Nkv, D, seed=60):
    """Inputs of one of flash's call shapes: ``verify`` (S queries at each
    row's own positions over C columns, the in-flight keys in the top S
    columns, sentinel between), ``prefix`` (S queries past a C - S prefix),
    ``admit`` (a bucket whose last quarter is the sentinel, over C columns
    written up to the real prompt) or ``causal`` (S = C)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    kvpos = torch.full((B, C), POS_SENTINEL, dtype=torch.int32, device=dev)
    for b in range(B):
        if kind == "verify":
            p = 100 + (b * 997) % (C - S - 100)
            kvpos[b, :p] = torch.arange(p)
            kvpos[b, C - S :] = p + torch.arange(S)
            qpos[b] = p + torch.arange(S)
        elif kind == "prefix":
            kvpos[b] = torch.arange(C)
            qpos[b] = C - S + torch.arange(S)
        elif kind == "admit":
            real = S - S // 4
            kvpos[b, :real] = torch.arange(real)
            qpos[b, :real] = torch.arange(real)
            qpos[b, real:] = POS_SENTINEL
        else:
            kvpos[b] = qpos[b] = torch.arange(S)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return t(B, S, Nh, D), t(B, C, Nkv, D), t(B, C, Nkv, D), qpos, kvpos


# (kind, B, S, C, Nh, Nkv, D): the folded route at verify widths (G * S 15 and
# 40), the per-head route at the profiler's S = 8, split over the SMs (past a
# prefix, a dense admission's sentinel rows, a tp-4 shard's 6 heads) and
# unsplit (a full card)
FLASH_ROUTE_CASES = [
    ("verify", 8, 5, 2053, 24, 8, 128),
    ("verify", 4, 5, 1029, 8, 1, 256),
    ("verify", 3, 5, 700, 6, 2, 64),
    ("causal", 1, 8, 8, 24, 8, 128),
    ("prefix", 1, 256, 1280, 24, 8, 128),
    ("prefix", 1, 256, 1280, 8, 1, 256),
    ("prefix", 2, 200, 900, 4, 4, 64),
    ("admit", 1, 256, 4096, 24, 8, 128),
    ("causal", 1, 2048, 2048, 6, 2, 128),
    ("causal", 1, 2048, 2048, 24, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FLASH_ROUTE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_routes_match_plain(cuda_device, case, dtype):
    """Each route of the flash kernel (the folded and per-head tensor-core
    routes, split or not, and f32's 3xTF32) against the plain version at
    the present limits, in one launch; the route and the split are the
    ones ``flash_route`` / ``plan_flash`` name for the shapes."""
    kind, B, S, C, Nh, Nkv, D = case
    args = _flash_route_case(cuda_device, dtype, kind, B, S, C, Nh, Nkv, D)
    plan = tfa.plan_flash(B, S, C, Nh, Nkv, D, dtype, kernels.sm_count(cuda_device))
    assert plan.route == tfa.flash_route(dtype, S, C, Nh, Nkv, D)
    kernels.reset_launch_counts()
    got = tfa.flash_attention(*args)
    want = tfa.cached_attention(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    _assert_close_rows(got, want, dtype, step=dtype == torch.bfloat16 and D == 256)


# split launches: the folded route at verify, the per-head route past a prefix
FLASH_SPLIT_CASES = [FLASH_ROUTE_CASES[0], FLASH_ROUTE_CASES[4], FLASH_ROUTE_CASES[5],
                     FLASH_ROUTE_CASES[7]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SPLIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_split_is_deterministic_and_sync_free(cuda_device, case):
    """A split launch: the plan splits these shapes; two launches give
    bit-identical outputs (the merge folds the runs in column order,
    whichever finishes last); and a warm call runs under
    ``set_sync_debug_mode("error")`` (the plan is from shapes, the tickets
    and scratch are allocated without a copy, nothing is read back)."""
    kind, B, S, C, Nh, Nkv, D = case
    args = _flash_route_case(cuda_device, torch.bfloat16, kind, B, S, C, Nh, Nkv, D, seed=61)
    assert tfa.plan_flash(B, S, C, Nh, Nkv, D, torch.bfloat16,
                          kernels.sm_count(cuda_device)).split
    first = tfa.flash_attention(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.reset_launch_counts()
        second = tfa.flash_attention(*args)
        assert kernels.launch_counts()["flash_attention"] == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_close_rows(second, tfa.cached_attention(*args), torch.bfloat16, step=D == 256)


@pytest.mark.cuda
def test_flash_split_scratch_is_not_reused_within_its_launch(cuda_device):
    """A split launch's f32 partials live in scratch the wrapper holds until
    the launch is queued: at a tp-4 shard's shapes (an output of 3 MB, from
    the allocator's large pool like the scratch), with a NaN-filled block
    freed before each call, the scratch and the output never alias, and
    every output stays finite and close to the plain version."""
    kind, B, S, C, Nh, Nkv, D = FLASH_ROUTE_CASES[8]
    args = _flash_route_case(cuda_device, torch.bfloat16, kind, B, S, C, Nh, Nkv, D, seed=62)
    plan = tfa.plan_flash(B, S, C, Nh, Nkv, D, torch.bfloat16, kernels.sm_count(cuda_device))
    assert plan.split
    want = tfa.cached_attention(*args)
    for _ in range(3):
        junk = torch.full((plan.scratch_floats(B, D),), float("nan"), device=cuda_device)
        del junk
        got = tfa.flash_attention(*args)
        torch.cuda.synchronize()
        _assert_close_rows(got, want, torch.bfloat16)


def _spec_prompts(eng):
    rng = np.random.default_rng(9)
    return [np.tile(rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32), r)
            for n, r in ((3, 4), (5, 3), (20, 1))]


@pytest.mark.cuda
def test_speculative_server_equals_generate_on_the_card(cuda_device):
    """An f32 engine's speculative server (K = 3, three rows) on the card:
    every greedy stream equals ``generate``'s, the verify launches the
    decode kernel and the admissions flash; speculative ``generate``
    launches flash for its verify and gives the same tokens."""
    eng = _tiny_engine(cuda_device)
    prompts = _spec_prompts(eng)
    srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=8, kv_blocks=40, speculate=3)
    kernels.reset_launch_counts()
    reqs = [srv.submit(p, 16) for p in prompts]
    srv.run_until_idle()
    counts = kernels.launch_counts()
    assert counts["paged_attention"] > 0 and counts["flash_attention"] > 0
    assert counts.get("paged_prefill", 0) == 0  # speculation admits one-shot only
    for r, p in zip(reqs, prompts):
        want = eng.generate_ids(p, 16)
        assert r.tokens == want.tokens[0, len(p) : want.lengths[0]].tolist()
        kernels.reset_launch_counts()
        spec = eng.generate_ids(p, 16, speculate=3)
        assert kernels.launch_counts()["flash_attention"] > 0
        np.testing.assert_array_equal(spec.tokens, want.tokens)
    srv._alloc.check()
    assert srv._alloc.in_use == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_speculative_server_verifies_through_the_quantized_kernel(cuda_device, kv):
    """With an int8 / fp8 arena the verify runs the decode kernel's code
    mode (the quantizing write included) and every request finishes."""
    eng = _tiny_engine(cuda_device)
    srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=8, kv_blocks=40, speculate=3,
                    kv_dtype=kv)
    kernels.reset_launch_counts()
    reqs = [srv.submit(p, 16) for p in _spec_prompts(eng)]
    srv.run_until_idle()
    assert kernels.launch_counts()[f"paged_attention[{kv}]"] > 0
    assert all(r.done and r.error is None and r.tokens for r in reqs)
    srv._alloc.check()
    assert srv._alloc.in_use == 0


# ---------------------------------------------- observability on the card


def _check_step_accounting(recs):
    """The stepline invariant on every card step, and a device wait on
    every step that read tokens: the CUDA event recorded after the copy of
    each log it read was waited on, so ``blocked_s`` > 0."""
    assert recs
    for r in recs:
        host = sum(r["phases"].values())
        assert abs(r["wall_s"] - (host + r["blocked_s"] + r["unattributed_s"])) < 1e-9
        if "fetch" in r["phases"]:
            assert r["blocked_s"] > 0.0, r
        assert r["idle_s"] >= 0.0
    wall = sum(r["wall_s"] for r in recs)
    assert sum(r["unattributed_s"] for r in recs) < 0.05 * wall


@pytest.mark.cuda
@pytest.mark.parametrize("speculate", [0, 3])
def test_stepline_blocks_on_the_cuda_event(cuda_device, tmp_path, speculate):
    """A traced server on the card (one-shot and chunked admissions, or
    verifies): every step's phases + blocked + unattributed sum to its
    wall, each step that read tokens waited on the device, and the traced
    streams equal the untraced ones."""
    eng = _tiny_engine(cuda_device)
    kw = dict(_SERVE, prefill_chunk=None, speculate=speculate) if speculate else _SERVE
    prompts = _spec_prompts(eng)
    plain = eng.serve(**kw)
    base = [plain.submit(p, 16) for p in prompts]
    plain.run_until_idle()
    srv = eng.serve(trace_path=str(tmp_path / "t.jsonl"), **kw)
    reqs = [srv.submit(p, 16) for p in prompts]
    srv.run_until_idle()
    srv.close()
    assert [r.tokens for r in reqs] == [r.tokens for r in base]
    recs = srv.stepline_snapshot()
    _check_step_accounting(recs)
    assert any(r["blocked_s"] > 0.0 for r in recs)


@pytest.mark.cuda
def test_stepline_capture_brackets_a_cuda_trace(cuda_device, tmp_path):
    """``stepline_capture(trace_dir=)`` while a pump thread steps (from
    the capture's arming on, so the window holds the requests' first
    steps): the bundle is complete and its Chrome trace holds the
    window's CUDA kernels."""
    import json
    import threading
    import time

    eng = _tiny_engine(cuda_device)
    srv = eng.serve(**_SERVE)
    for p in _spec_prompts(eng):
        srv.submit(p, 24)
    stop = threading.Event()

    def pump():
        while not srv.stepline.armed and not stop.is_set():
            time.sleep(0.001)
        while not stop.is_set():
            if not srv.step():
                time.sleep(0.001)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        bundle = srv.stepline_capture(3, wait_s=60, trace_dir=str(tmp_path / "prof"))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert bundle["complete"] and bundle["steps_captured"] == 3
    _check_step_accounting(bundle["steps"])
    with open(bundle["device_trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    srv.close()


# ------------------------------------------------------------ the step loop

@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_chained_decode_dispatches_make_no_host_sync(cuda_device, kv, sampled):
    """Three decode chunks dispatched back to back through the server's own
    dispatch (``serve_chunk``, the pinned log copy and its event), with a
    block-table push between them, under ``set_sync_debug_mode("error")``:
    no operation waits for the device. Their logs then read as the
    tokens of the rows."""
    eng = _tiny_engine(cuda_device)
    srv = eng.serve(kv_dtype=kv, **dict(_SERVE, prefill_chunk=None))
    rng = np.random.default_rng(9)
    kw = dict(temperature=0.8, top_k=20, seed=4) if sampled else {}
    reqs = [srv.submit(rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32), 20, **kw)
            for n in (5, 20, 12)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            srv._dispatch_chunk()
            if i == 0:
                srv._tables_dirty = True  # pushed before the next dispatch
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(srv._pending) == 3 and all(e.kind == "chunk" for e in srv._pending)
    logs = [e.log.cpu() for e in srv._pending]
    assert all(tuple(lg.shape) == (1, srv.rows) for lg in logs)
    assert all(int(logs[0][0, r.row]) >= 0 for r in reqs)  # live at the first chunk
    srv.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    srv._alloc.check()
    assert srv._alloc.in_use == 0


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(inflight_steps=2), dict(inflight_steps=4, chunk_cycles=3),
                                   dict(pipeline_depth=2)], ids=["inflight2", "inflight4-cycles3",
                                                                 "depth2"])
def test_chained_streams_equal_serial_on_the_card(cuda_device, knobs):
    """Every request submitted at once (one-shot and chunked admissions):
    the streams with logs in flight, or the async executor's threads, equal
    the serial run's, through the kernels."""
    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12)]
    out = []
    for kw in ({}, knobs):
        srv = eng.serve(**_SERVE, **kw)
        kernels.reset_launch_counts()
        reqs = [srv.submit(p, 16) for p in prompts]
        srv.run_until_idle()
        counts = kernels.launch_counts()
        assert all(counts[n] > 0 for n in ("flash_attention", "paged_attention", "paged_prefill"))
        assert all(r.error is None for r in reqs)
        if srv._sidecar is not None:
            assert srv._sidecar.is_alive() and srv._sidecar.error is None
        out.append([r.tokens for r in reqs])
        srv.close()
        srv._alloc.check()
        assert srv._alloc.in_use == 0
    assert out[0] == out[1]


@pytest.mark.cuda
def test_sidecar_applies_a_log_in_flight_on_the_card(cuda_device):
    """At ``inflight_steps=2`` the completion sidecar meets a log the card
    has not landed yet (its chunk queued behind a device sleep), waits on
    its CUDA event, and applies it; it is alive and unfailed after the
    run, and the streams equal the serial run's."""
    import time

    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12)]
    base = eng.serve(**_SERVE)
    breqs = [base.submit(p, 16) for p in prompts]
    base.run_until_idle()
    want = [r.tokens for r in breqs]
    base.close()
    srv = eng.serve(inflight_steps=2, **_SERVE)
    reqs = [srv.submit(p, 16) for p in prompts]
    srv.step()  # every request admitted
    with srv._mutex:  # the sidecar pops the same queue under it
        srv._drain(0)
    assert all(r.row is not None and not r.done for r in reqs)
    torch.cuda.synchronize()
    applied0 = srv._sidecar.applied
    torch.cuda._sleep(200_000_000)  # the next chunk waits behind ~0.1 s of sleep
    srv.step()
    assert srv._pending and not srv._pending[-1].landed()
    end = time.perf_counter() + 30.0
    while srv._sidecar.applied == applied0 and time.perf_counter() < end:
        time.sleep(0.001)
    assert srv._sidecar.applied > applied0
    srv.run_until_idle()
    assert srv._sidecar.is_alive() and srv._sidecar.error is None
    assert [r.tokens for r in reqs] == want
    srv.close()
    srv._alloc.check()
    assert srv._alloc.in_use == 0


# ---------------------------------------------------- the front door (dense)

_DENSE = dict(capacity=64, batch_per_slot=3, prefill_chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_dense_chained_dispatches_make_no_host_sync(cuda_device, sampled):
    """Dense ``serve_chunk``: three chunks dispatched back to back under
    ``set_sync_debug_mode("error")`` (a done row's KV write is a select, no
    boolean-mask index); the logs then read as the rows' tokens."""
    eng = _tiny_engine(cuda_device)
    srv = eng.serve(**dict(_DENSE, prefill_chunk=None))
    rng = np.random.default_rng(21)
    kw = dict(temperature=0.8, top_k=20, seed=4) if sampled else {}
    reqs = [srv.submit(rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32), 20, **kw)
            for n in (5, 20)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs) and srv.state.dense
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            srv._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    logs = [e.log.cpu() for e in srv._pending]
    assert len(logs) == 3 and all(int(logs[0][0, r.row]) >= 0 for r in reqs)
    assert int(logs[0][0, 2]) == -1  # the free row commits nothing
    srv.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=None, speculate=3)],
                         ids=["one_shot_chunked", "speculate"])
def test_dense_streams_equal_generate_through_flash(cuda_device, kw):
    """Dense serving on the card (one-shot and chunked admission through
    flash over the rows' caches, or a verify at S = K + 1 through flash):
    f32 greedy streams equal ``generate``'s; no paged kernel launches."""
    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12)]
    srv = eng.serve(**dict(_DENSE, **kw))
    kernels.reset_launch_counts()
    reqs = [srv.submit(p, 16) for p in prompts]
    srv.run_until_idle()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] > 0
    assert counts["paged_attention"] == counts["paged_prefill"] == 0
    for p, r in zip(prompts, reqs):
        want = eng.generate_ids(p, 16)
        assert r.tokens == want.tokens[0, len(p) : want.lengths[0]].tolist()
    srv.close()


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_submit_embedding_equals_submit_on_the_card(cuda_device, paged):
    eng = _tiny_engine(cuda_device)
    kw = dict(_SERVE, prefill_chunk=None) if paged else dict(_DENSE, prefill_chunk=None)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20)]
    out = []
    for embed in (False, True):
        srv = eng.serve(**kw)
        reqs = [srv.submit_embedding(eng.embed_prompt(p)[0], 12) if embed else srv.submit(p, 12)
                for p in prompts]
        srv.run_until_idle()
        out.append([r.tokens for r in reqs])
        srv.close()
    assert out[0] == out[1]


# ------------------------------------------------------------- the fleet

@pytest.mark.cuda
def test_replicated_dp2_on_the_card(cuda_device):
    """Two replicas on the one card (``devices=None``): the router spreads
    the requests, every greedy f32 stream equals ``generate``, both
    replicas launch the paged kernels, and a ``replica_step`` fault on
    group 0 mid-decode moves its rows (a sampled one among them) to group
    1, where they finish as the unfaulted fleet's."""
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan
    from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer

    eng = _tiny_engine(cuda_device)
    rng = np.random.default_rng(30)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 12, 9)]
    kws = [dict(temperature=0.9, seed=5, top_k=20), {}, {}, {}]
    out = []
    for plan in (None, FaultPlan.permanent("replica_step", key=0, start=4)):
        rs = ReplicatedServer(eng.cfg, eng.params, data_parallel=2, fault_plan=plan, **_SERVE)
        assert all(s.engine.device.type == "cuda" for s in rs.servers)
        kernels.reset_launch_counts()
        reqs = [rs.submit(p, 16, **k) for p, k in zip(prompts, kws)]
        assert [rs._group_of[rs._owner[r]] for r in reqs] == [0, 1, 0, 1]
        rs.run_until_idle()
        counts = kernels.launch_counts()
        assert counts["paged_attention"] > 0 and counts["paged_prefill"] > 0
        assert all(r.error is None for r in reqs)
        assert len(rs.servers) == (2 if plan is None else 1)
        out.append([r.tokens for r in reqs])
        rs.close()
    assert out[0] == out[1]
    for p, toks in list(zip(prompts, out[0]))[1:]:
        want = eng.generate_ids(p, 16)
        assert toks == want.tokens[0, len(p) : want.lengths[0]].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_handoff_gather_is_queued_before_the_source_overwrites(cuda_device, kv):
    """The hand-off's dispatch-only read: with the stream held behind a
    device sleep, the gathers and their pinned copy are queued, then the
    same blocks are overwritten on the stream; the bytes read are the ones
    before the overwrite, and the queueing itself waited for nothing."""
    eng = _tiny_engine(cuda_device)
    srv = eng.serve(kv_dtype=kv, **dict(_SERVE, prefix_cache="hbm"))
    p = np.random.default_rng(31).integers(0, eng.cfg.vocab_size, 25).astype(np.int32)
    r = srv.submit(p, 4)
    srv.run_until_idle()
    assert r.error is None
    ref = srv._radix.take(p, srv._radix.match_tokens(p))
    blocks = list(ref.blocks)
    want = srv._read_arena_blocks(blocks)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device time ahead of the read
    torch.cuda.set_sync_debug_mode("error")
    try:
        read = srv._read_arena_blocks_dispatch(blocks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not read.event.query()  # queued, not done
    garbage = tuple(np.full_like(a, 7) for a in want)
    srv._write_arena_blocks(blocks, *garbage)  # behind the read on the stream
    got = read.numpy()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a, b) for a, b in zip(srv._read_arena_blocks(blocks), garbage))
    srv._radix.release(ref)
    srv.close()


@pytest.mark.cuda
def test_disagg_handoff_on_the_card(cuda_device):
    """One prefill and one decode replica on the card, the hand-off on its
    sidecar thread: every request hands off ``ok``, the bytes counted are
    the streamed blocks', and the f32 streams equal ``generate``."""
    from llm_sharding_tpu_torch.obs.metrics import DISAGG_HANDOFFS, HANDOFF_BYTES
    from llm_sharding_tpu_torch.runtime.disagg import DisaggServer

    eng = _tiny_engine(cuda_device)
    ds = DisaggServer(eng.cfg, eng.params, data_parallel=2, prefill_replicas=1,
                      **dict(_SERVE, prefix_cache="hbm"))
    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32) for n in (17, 26, 30)]
    ok0, b0 = DISAGG_HANDOFFS.labels(outcome="ok").value, HANDOFF_BYTES.value
    reqs = [ds.submit(p, 12) for p in prompts]
    ds.run_until_idle()
    assert DISAGG_HANDOFFS.labels(outcome="ok").value - ok0 == len(prompts)
    cfg = eng.cfg
    per_block = 2 * cfg.num_hidden_layers * 8 * cfg.num_key_value_heads * 64 * 4
    # a chunked admission inserts the prompt's whole blocks but the last token
    streamed = sum((len(p) - 1) // 8 for p in prompts)
    assert HANDOFF_BYTES.value - b0 == streamed * per_block
    for p, r in zip(prompts, reqs):
        want = eng.generate_ids(p, 12)
        assert r.error is None and r.tokens == want.tokens[0, len(p) : want.lengths[0]].tolist()
    assert ds.handoffs_pending() == 0
    ds.close()


# ------------------------------------------------------- pipeline stages

def _stage_engine(dev, n, dtype=torch.float32):
    """The tiny model of ``_tiny_engine`` (4 layers) as ``n`` stages on the
    one card, staged from a CPU copy of the same weights."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    host = tllama.init_params(cfg, seed=3, dtype=dtype, device="cpu")
    one = Engine(cfg, {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                           [{n_: t.to(dev) for n_, t in p.items()} for p in v])
                       for k, v in host.items()})
    return one, Engine(cfg, host, num_stages=n, devices=[dev] * 4)


def _stage_counts(monkeypatch):
    """Each kernel's launches per stage while the test runs."""
    from llm_sharding_tpu_torch.parallel import pipeline as pipe_mod
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    per: dict = {}
    orig = pipe_mod.run_stages

    def run_stages(stages, h, fn):
        def counted(i, st, h):
            before = kernels.launch_counts()
            out = fn(i, st, h)
            for k, v in kernels.launch_counts().items():
                per.setdefault(i, {}).setdefault(k, 0)
                per[i][k] += v - before.get(k, 0)
            return out

        return orig(stages, h, counted)

    monkeypatch.setattr(pipe_mod, "run_stages", run_stages)
    monkeypatch.setattr(serve_ops, "run_stages", run_stages)
    return per


def _served(srv, prompts, max_new=10, **kw):
    reqs = [srv.submit(p, max_new, **kw) for p in prompts[:2]]
    srv.step()
    reqs += [srv.submit(p, max_new, **kw) for p in prompts[2:]]
    srv.run_until_idle()
    assert all(r.error is None for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_stages_on_one_card_equal_the_one_stage_twin(cuda_device, monkeypatch, n, kv):
    """2 and 4 stages on ``cuda`` repeated, one-shot and chunked admissions
    mixed: the streams equal the one-stage engine's in the same arena, and
    every stage launched all three kernels (in the arena's mode)."""
    one, eng = _stage_engine(cuda_device, n)
    assert eng.num_stages == n and all(st.device.type == "cuda" for st in eng.stages)
    rng = np.random.default_rng(50)
    prompts = [rng.integers(0, one.cfg.vocab_size, m).astype(np.int32) for m in (5, 20, 30, 12)]
    want = _served(one.serve(kv_dtype=kv, **_SERVE), prompts)
    per = _stage_counts(monkeypatch)
    srv = eng.serve(kv_dtype=kv, **_SERVE)
    assert srv.rows == n * _SERVE["batch_per_slot"]
    assert _served(srv, prompts) == want
    srv._alloc.check()
    assert srv._alloc.in_use == 0
    mode = "" if kv == "bf16" else f"[{kv}]"
    for s in range(n):
        for k in ("flash_attention", f"paged_attention{mode}", f"paged_prefill{mode}"):
            assert per[s][k] > 0, (s, k, per)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_pipeline_stage_kernels_equal_their_plain_versions(cuda_device, monkeypatch, kv):
    """The inputs stage 1 of a 2-stage server gave each kernel (its first
    flash, decode and chunked-prefill call, recorded) give the kernel's
    output and the plain version's within ``TOL``; and in the bf16 and int8
    arenas the streams through every stage's kernels equal the same
    server's through the plain versions (fp8's coarser codes leave this
    random tiny model near ties the two summation orders split, as
    ``chip_smoke.py`` [c] holds fp8 streams by a gap rule)."""
    from llm_sharding_tpu_torch.parallel import pipeline as pipe_mod
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    _, eng = _stage_engine(cuda_device, 2)
    stage, seen = [None], {}
    orig = pipe_mod.run_stages

    def run_stages(stages, h, fn):
        def tagged(i, st, h):
            stage[0] = i
            try:
                return fn(i, st, h)
            finally:
                stage[0] = None

        return orig(stages, h, tagged)

    def recorder(name, f):
        def wrapped(*a, **k):
            if stage[0] == 1 and name not in seen:
                def cp(x):
                    return x.clone() if isinstance(x, torch.Tensor) else x

                seen[name] = ([cp(x) for x in a], {kk: cp(vv) for kk, vv in k.items()})
            return f(*a, **k)

        return wrapped

    monkeypatch.setattr(pipe_mod, "run_stages", run_stages)
    monkeypatch.setattr(serve_ops, "run_stages", run_stages)
    for name in ("paged_attention", "paged_prefill", "attention_step"):
        monkeypatch.setattr(tllama, name, recorder(name, getattr(tllama, name)))
    rng = np.random.default_rng(51)
    prompts = [rng.integers(0, eng.cfg.vocab_size, m).astype(np.int32) for m in (5, 20, 30, 12)]
    streams = {a: _served(eng.serve(kv_dtype=kv, paged_attn=a, **_SERVE), prompts)
               for a in ("plain", "auto")}
    assert kv == "fp8" or streams["auto"] == streams["plain"]
    assert set(seen) == {"paged_attention", "paged_prefill", "attention_step"}
    for name, (a, k) in seen.items():
        if name == "attention_step":  # the flash kernel on the card, plain on the CPU
            kernels.reset_launch_counts()
            got = tfa.attention_step(*a)
            assert kernels.launch_counts()["flash_attention"] == 1
            want = tfa.attention_step(*[x.cpu() for x in a]).to(cuda_device)
        else:
            fn = getattr(tpa, name)
            got, want = fn(*a, **{**k, "backend": "kernel"}), fn(*a, **{**k, "backend": "plain"})
        torch.testing.assert_close(got, want, atol=TOL[torch.float32], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_pipeline_chained_decode_makes_no_host_sync(cuda_device, kv, sampled):
    """``serve_chunk`` at 2 stages keeps the step loop's contract: three
    chunks dispatched back to back under ``set_sync_debug_mode("error")``
    (the vocab-sharded head, the sampled rows' gathered logits included),
    one fixed shape; the logs then read as the rows' tokens."""
    _, eng = _stage_engine(cuda_device, 2)
    srv = eng.serve(kv_dtype=kv, **dict(_SERVE, prefill_chunk=None))
    rng = np.random.default_rng(52)
    kw = dict(temperature=0.8, top_k=20, seed=4) if sampled else {}
    reqs = [srv.submit(rng.integers(0, eng.cfg.vocab_size, m).astype(np.int32), 20, **kw)
            for m in (5, 20, 12)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            srv._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    logs = [e.log.cpu() for e in srv._pending]
    assert len(logs) == 3 and all(tuple(lg.shape) == (1, srv.rows) for lg in logs)
    srv.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)


@pytest.mark.cuda
def test_devices_none_groups_the_chain_on_a_one_gpu_host(cuda_device):
    """``devices=None`` is every visible GPU: on a one-GPU host a 4-stage
    chain runs as one grouped stage, and generates the twin's tokens."""
    if torch.cuda.device_count() != 1:
        pytest.skip("the grouping case of a one-GPU host")
    one, _ = _stage_engine(cuda_device, 2)
    host = {k: v for k, v in one.params.items()}
    eng = Engine(one.cfg, {"layers": [{n: t.cpu() for n, t in p.items()} for p in host["layers"]],
                           **{k: v.cpu() for k, v in host.items() if k != "layers"}},
                 num_stages=4)
    assert eng.placement.num_stages == 4 and eng.num_stages == 1
    assert eng.exec_placement.stages == ((0, one.cfg.num_hidden_layers),)
    p = np.random.default_rng(53).integers(0, one.cfg.vocab_size, 9).astype(np.int32)
    assert (eng.generate_ids(p, 8).tokens == one.generate_ids(p, 8).tokens).all()


@pytest.mark.cuda
def test_keep_host_copy_repartitions_an_engine_loaded_on_the_card(cuda_device):
    """An engine loaded straight onto the card (one stage, no host copy)
    takes the host copy at ``keep_host_copy``, as the daemon's first
    ``:placement`` does; its 2-stage chain then generates its own tokens."""
    from llm_sharding_tpu_torch.parallel.placement import PlacementSpec

    one, _ = _stage_engine(cuda_device, 2)
    eng = Engine(one.cfg, one.params)
    assert not eng.host_staged
    p = np.random.default_rng(54).integers(0, one.cfg.vocab_size, 9).astype(np.int32)
    want = eng.generate_ids(p, 8).tokens
    eng.keep_host_copy([cuda_device] * one.cfg.num_hidden_layers)
    assert eng.host_staged and all(t.device.type == "cpu" for t in eng._host["layers"][0].values())
    eng.apply_placement(PlacementSpec.balanced(one.cfg.num_hidden_layers, 2))
    assert eng.num_stages == 2 and all(st.device.type == "cuda" for st in eng.stages)
    assert (eng.generate_ids(p, 8).tokens == want).all()


# -------------------------------------------- tensor and context parallelism


def _shard_inputs(dev, Nh, Nkv, dtype, S, seed=60):
    """Two rows over a 17-block arena (block size 16, head_dim 128) at a
    tensor shard's head counts: row 0 holds 100 keys, row 1 37; the S
    queries sit at each row's last positions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, BS, T, D = 2, 16, 8, 128
    lens = (100, 37)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    k, v = t(1 + B * T, BS, Nkv, D), t(1 + B * T, BS, Nkv, D)
    tbl = torch.arange(1, 1 + B * T, dtype=torch.int32, device=dev).reshape(B, T)
    col = torch.arange(T * BS, device=dev)
    kvpos = torch.stack([torch.where(col < n, col, POS_SENTINEL) for n in lens]).to(torch.int32)
    qpos = torch.stack([torch.arange(n - S, n, device=dev) for n in lens]).to(torch.int32)
    return t(B, S, Nh, D), k, v, tbl, qpos, kvpos, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Nh,Nkv", [(12, 4), (6, 2), (16, 16)],
                         ids=["3B-tp2", "3B-tp4", "llama2-7b-tp2"])
def test_kernels_at_shard_heads_equal_plain(cuda_device, Nh, Nkv, dtype):
    """The three kernels at the head counts a tensor shard gives them (the
    3B's 24/8 heads over 2 and 4 shards, Llama-2-7B's 32/32 over 2): each
    launches (no gate sends a shard to the plain version) and agrees with
    its plain version within ``TOL``."""
    q1, k, v, tbl, qpos1, kvpos, lens = _shard_inputs(cuda_device, Nh, Nkv, dtype, 1)
    kernels.reset_launch_counts()
    got = tpa.paged_attention(q1, k, v, tbl, qpos1, kvpos, backend="kernel")
    want = tpa.paged_attention(q1, k, v, tbl, qpos1, kvpos, backend="plain")
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    q16, _, _, _, qpos16, _, _ = _shard_inputs(cuda_device, Nh, Nkv, dtype, 16, seed=61)
    nlive = torch.tensor([-(-n // 16) for n in lens], dtype=torch.int32, device=cuda_device)
    got = tpa.paged_prefill(q16, k, v, tbl, qpos16, kvpos, nlive=nlive, backend="kernel")
    want = tpa.paged_prefill(q16, k, v, tbl, qpos16, kvpos, nlive=nlive, backend="plain")
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    dense_k, dense_v = k[tbl.long()].flatten(1, 2), v[tbl.long()].flatten(1, 2)
    got = tfa.flash_attention(q16, dense_k.contiguous(), dense_v.contiguous(), qpos16, kvpos)
    want = tfa.flash_attention(q16.cpu(), dense_k.cpu(), dense_v.cpu(), qpos16.cpu(), kvpos.cpu())
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=TOL[dtype], rtol=0)
    counts = kernels.launch_counts()
    assert [counts[n] for n in ("paged_attention", "paged_prefill", "flash_attention")] == [1, 1, 1]


def _tp_engines(dev, tp, stages=1):
    """A tiny f32 llama (12 heads over 4 KV heads, head_dim 64) on the card
    as one stage, and the same weights as ``stages`` stages of ``tp``
    shards on the card repeated."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=12, num_key_value_heads=4)
    host = tllama.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    one = Engine(cfg, {k: ([{n: t.to(dev) for n, t in p.items()} for p in v] if k == "layers"
                           else v.to(dev)) for k, v in host.items()})
    eng = Engine(cfg, host, num_stages=stages, tensor_parallel=tp, devices=[dev] * (stages * tp))
    return one, eng


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("tp,stages", [(2, 1), (4, 1), (2, 2)], ids=["tp2", "tp4", "pp2xtp2"])
def test_tp_served_streams_equal_the_tp1_twin(cuda_device, tp, stages, paged):
    """Tensor shards on ``cuda`` repeated, one-shot and chunked admissions
    mixed: the streams equal the one-device engine's, every shard launches
    what the one-device run launches (``tp`` times its kernels in all), and
    each decode step issues two reduces per layer."""
    from llm_sharding_tpu_torch.models.stack import reduce_count

    one, eng = _tp_engines(cuda_device, tp, stages)
    kw = dict(_SERVE) if paged else dict(capacity=64, batch_per_slot=3, prefill_chunk=8)
    rng = np.random.default_rng(62)
    prompts = [rng.integers(0, one.cfg.vocab_size, m).astype(np.int32) for m in (5, 20, 30, 12)]
    kernels.reset_launch_counts()
    # as many rows as the staged server (stages x batch_per_slot): the same steps
    want = _served(one.serve(**dict(kw, batch_per_slot=kw["batch_per_slot"] * stages)), prompts)
    base = kernels.launch_counts()
    kernels.reset_launch_counts()
    srv = eng.serve(**kw)
    assert _served(srv, prompts) == want
    got = kernels.launch_counts()
    for name in ("flash_attention", "paged_attention", "paged_prefill") if paged else (
            "flash_attention",):
        assert base[name] > 0 and got[name] == tp * base[name], (name, base, got)
    reduce_count(reset=True)
    srv.submit(prompts[0], 4)
    srv.run_until_idle()
    assert reduce_count() % (2 * one.cfg.num_hidden_layers) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_tp_chained_decode_makes_no_host_sync(cuda_device, paged):
    """``serve_chunk`` at tp 2 keeps the step loop's contract: three chunks
    dispatched back to back under ``set_sync_debug_mode("error")``, the
    reduces and the shards' kernels included; the logs then read as the
    rows' tokens."""
    _, eng = _tp_engines(cuda_device, 2)
    kw = dict(_SERVE, prefill_chunk=None) if paged else dict(capacity=64, batch_per_slot=3)
    srv = eng.serve(**kw)
    rng = np.random.default_rng(63)
    reqs = [srv.submit(rng.integers(0, eng.cfg.vocab_size, m).astype(np.int32), 20)
            for m in (5, 20, 12)]
    srv.step()
    srv._drain(0)
    assert all(not r.done for r in reqs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            srv._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    logs = [e.log.cpu() for e in srv._pending]
    assert len(logs) == 3 and all(tuple(lg.shape) == (1, srv.rows) for lg in logs)
    srv.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("cp", [2, 4])
def test_context_generate_on_the_card_equals_generate(cuda_device, cp):
    """The ring prefill on ``cuda`` repeated, then ``decode_from_cache``
    (greedy and seeded): the tokens of the card's own ``generate``."""
    from llm_sharding_tpu_torch.parallel.context import context_generate
    from llm_sharding_tpu_torch.runtime.generate import generate

    one, _ = _tp_engines(cuda_device, 2)
    p = np.random.default_rng(64).integers(1, one.cfg.vocab_size, (2, 32)).astype(np.int32)
    plen = np.array([32, 27])
    for kw in ({}, dict(temperature=0.8, seed=5)):
        got = context_generate(one.cfg, [cuda_device] * cp, one.params, p, 12, prompt_len=plen,
                               **kw)
        want = generate(one.cfg, one.params, p, 12, prompt_len=plen, **kw)
        assert (got.tokens == want.tokens).all() and (got.lengths == want.lengths).all()


# --------------------------------------------------------------- stats mode
# (context-parallel serving: each shard attends the blocks it owns and
# emits (acc, m, l); ops/paged_attention.combine_attn_stats merges them)

# shapes: (Nkv, G, D, BS, decode frontiers, (prefill frontiers, Sc))
STATS_SHAPES = {
    "d64": (2, 3, 64, 16, (1, 16, 50, 300), ((300, 130), 100)),
    "d128": (2, 3, 128, 64, (20, 64, 700, 1500), ((1500,), 256)),
    # Llama-3.2-3B's heads (24 query, 8 KV, head dim 128) at the served
    # block size 64: eight decode rows, and a chunk of six rows whose CTAs
    # fill the card (no split runs)
    "3b": (8, 3, 128, 64, (1, 130, 2048, 700, 64, 33, 1000, 5),
           ((512, 640, 1024, 2048, 256, 1500), 128)),
}


def _striped_case(dev, dtype, kv, cp, frontiers, S, Nkv, G, D, BS, seed=70):
    """One table striped over ``cp`` shards as the server's
    ``ShardedBlockAllocator.alloc_at`` stripes it: a row's logical block j
    lives on shard j % cp, at the shard's next free local block (local 0 is
    each shard's trash, NaN/Inf: 0x7F codes and Inf scales for a code
    arena). Returns the queries and positions, the per-shard arenas, local
    tables and scale keywords, and the global arena, table and scales (the
    shards' blocks side by side) for the whole-window reference."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(frontiers)
    T = max(-(-f // BS) for f in frontiers) + 1
    NBs = -(-B * T // cp) + 2
    k = torch.randn((cp * NBs, BS, Nkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((cp * NBs, BS, Nkv, D), generator=g, device=dev).to(dtype)
    nxt = [1] * cp
    gtbl = torch.zeros((B, T), dtype=torch.int32, device=dev)
    kvpos = torch.full((B, T * BS), POS_SENTINEL, dtype=torch.int32, device=dev)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, f in enumerate(frontiers):
        for j in range(-(-f // BS)):
            s = j % cp
            gtbl[b, j] = s * NBs + nxt[s]
            nxt[s] += 1
        kvpos[b, :f] = torch.arange(f)
        qpos[b] = torch.arange(f - S, f)
    shards, glob = [], []
    for s in range(cp):
        ks, vs = k[s * NBs : (s + 1) * NBs].clone(), v[s * NBs : (s + 1) * NBs].clone()
        ks[0], vs[0] = float("nan"), float("inf")
        sc = {}
        if kv is not None:
            ks, kss, vs, vss = _quantize(ks, vs, kv)
            sc = dict(k_scale=kss, v_scale=vss)
        local = torch.where(gtbl // NBs == s, gtbl % NBs, 0).to(torch.int32)
        local[gtbl == 0] = 0
        shards.append((ks, vs, local, sc))
        glob.append((ks, vs, sc))
    gk = torch.cat([x[0] for x in glob])
    gv = torch.cat([x[1] for x in glob])
    gsc = {} if kv is None else {
        n: torch.cat([x[2][n] for x in glob]) for n in ("k_scale", "v_scale")
    }
    q = torch.randn((B, S, Nkv * G, D), generator=g, device=dev).to(dtype)
    return q, qpos, kvpos, shards, (gk, gv, gtbl, gsc)


def _check_stats(got, want, dtype):
    """A kernel's triple against ``attn_stats``'s: dead rows exactly (0,
    -1e30, 0); live rows' m to 1e-3, l to 1e-3 relative, and acc / l within
    the normalised outputs' limits."""
    acc, m, l = got
    wacc, wm, wl = want
    assert torch.isfinite(acc).all() and torch.isfinite(m).all() and torch.isfinite(l).all()
    dead = wl == 0
    assert (l[dead] == 0).all() and (m[dead] == -1e30).all()
    assert (acc[dead] == 0).all()
    live = ~dead
    torch.testing.assert_close(m[live], wm[live], atol=1e-3, rtol=0)
    torch.testing.assert_close(l[live], wl[live], atol=0, rtol=1e-3)
    _assert_close_rows((acc / l.clamp_min(1e-30)[..., None])[live],
                       (wacc / wl.clamp_min(1e-30)[..., None])[live], dtype)
    return dead


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(STATS_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", [None, "int8", "fp8"], ids=["query-dtype", "int8", "fp8"])
@pytest.mark.parametrize("which", ["decode", "prefill"])
@pytest.mark.parametrize("cp", [2, 4])
def test_stats_mode_matches_attn_stats(cuda_device, cp, which, kv, dtype, shape):
    """Stats mode of the decode and chunked-prefill kernels over every
    shard of a round-robin-striped table, against the plain ``attn_stats``
    on the same shard: rows that see no key on a shard (a one-block row,
    every shard but the first), tiles wholly of trash blocks, and NaN/Inf
    in each shard's trash block; then the shards merged by
    ``combine_attn_stats`` against attention over the whole window. Every
    call is one stats-mode launch."""
    Nkv, G, D, BS, dec, (pre, Sc) = STATS_SHAPES[shape]
    frontiers, S = (dec, 1) if which == "decode" else (pre, Sc)
    q, qpos, kvpos, shards, (gk, gv, gtbl, gsc) = _striped_case(
        cuda_device, dtype, kv, cp, frontiers, S, Nkv, G, D, BS)
    nlive = torch.tensor([-(-f // BS) for f in frontiers], dtype=torch.int32,
                         device=cuda_device)
    fn = tpa.paged_attention if which == "decode" else tpa.paged_prefill
    name = ("paged_attention" if which == "decode" else "paged_prefill") + (
        f"[{kv},stats]" if kv else "[stats]")
    parts, dead_any = [], False
    for ks, vs, local, sc in shards:
        kernels.reset_launch_counts()
        got = fn(q, ks, vs, local, qpos, kvpos, nlive=nlive, stats=True, **sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == 1
        want = tpa.attn_stats(q, ks, vs, local, qpos, kvpos, **sc)
        dead_any |= bool(_check_stats(got, want, dtype).any())
        parts.append(got)
    if which == "decode":
        assert dead_any  # the one-block rows see nothing on the later shards
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    merged = tpa.combine_attn_stats(acc, m, l)
    whole = tpa.paged_attention_xla(q, gk, gv, gtbl, qpos, kvpos, **gsc)
    _assert_close_rows(merged, whole.float(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cp", [2, 4])
def test_cp_served_streams_go_through_the_stats_kernels(cuda_device, cp):
    """A context-parallel server on ``cuda`` repeated (every shard on the
    card), one-shot and chunked admissions mixed, at a table width (25
    blocks) that puts each shard's plane at an offset of 100 bytes: the
    streams equal the cp-1 server's (f32), every shard launched the stats
    mode of both paged kernels, and no normal-mode paged launch ran."""
    cfg = tcfg.tiny_llama(head_dim=64, num_attention_heads=6, num_key_value_heads=2)
    host = tllama.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    eng = Engine(cfg, host, num_stages=1, devices=[cuda_device] * cp)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 30, 12)]
    kw = dict(capacity=200, batch_per_slot=3, kv_block_size=8, kv_blocks=40, prefill_chunk=16)
    want = _served(eng.serve(**kw), prompts)
    kernels.reset_launch_counts()
    srv = eng.serve(cp=cp, **kw)
    assert tuple(srv.state.block_tables.shape) == (cp, 3, 25)
    assert _served(srv, prompts) == want
    counts = kernels.launch_counts()
    assert counts["paged_attention[stats]"] > 0 and counts["paged_prefill[stats]"] > 0
    assert counts["paged_attention"] == counts["paged_prefill"] == 0
    srv._alloc.check()
    assert srv._alloc.in_use == 0


@pytest.mark.cuda
def test_profiler_sweep_goes_through_flash(cuda_device):
    """The capability profiler on the card (``profiler/profiler.py``): every
    prefill forward of the sweep, warm-ups included, launches the flash
    kernel once a layer; the decode curve's prompt prefill does too, its
    one-token steps do not; the samples are positive and the curve rises."""
    from llm_sharding_tpu_torch.profiler.profiler import Profiler, detect_hbm_bytes

    cfg = tcfg.tiny_llama(hidden_size=256, intermediate_size=512)  # head dim 64
    params = tllama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda_device)
    prof = Profiler(cfg, params, dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    rep = prof.profile_prefill(lengths=(8, 16, 64), repeats=2)
    forwards = 2 + 3 + 3 * 2  # two warm-ups, one per length, then the repeats
    assert kernels.launch_counts()["flash_attention"] == cfg.num_hidden_layers * forwards
    assert all(t > 0 for t in rep.latencies_s) and rep.capability_c_k > 0
    kernels.reset_launch_counts()
    dec = prof.profile_decode(max_tokens=16, measure_every=4)
    assert kernels.launch_counts()["flash_attention"] == cfg.num_hidden_layers
    assert all(b > a for a, b in zip(dec.cumulative_s, dec.cumulative_s[1:]))
    assert detect_hbm_bytes(cuda_device) == torch.cuda.get_device_properties(0).total_memory
