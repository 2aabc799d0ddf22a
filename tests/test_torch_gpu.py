"""The port's CUDA kernels on the card: each kernel against its plain
version, the wrappers' input checks and launch counters, and a small served
run that must go through all three kernels.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them; ``tests/conftest.py`` imports jax, so run it there as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gpu.py

Tolerances, kernel vs plain version on the same inputs, as in
``chip_smoke.py``: max abs error float32 1e-4 (summation order differs),
bfloat16 3e-2 (one bf16 ulp of outputs of magnitude ~2-4); and max error
relative to the largest output of its (query row, head), float32 1e-3,
bfloat16 2e-2 (about one bf16 ulp of that output, times a margin of 2).
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
from llm_sharding_tpu_torch.runtime.engine import Engine

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
TOL_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


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
def test_paged_prefill_nlive_bounds_the_kv_loop(cuda_device):
    """A block at or past ``nlive`` is never read: NaN in row 1's block 6
    leaves the output bit-identical, while without the clamp the NaN
    reaches the output through a masked key's zero probability."""
    args = list(_paged_args(cuda_device, 20, torch.float32))
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
