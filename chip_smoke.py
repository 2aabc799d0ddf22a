#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_sharding_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels MODEL [MODEL ...]

The second form runs (a) and (b) only, bf16 queries, at the named
models' shapes (``llama32_3b``, ``gpt2_small``, ``gemma_2b``,
``gemma_7b``), and prints the rows as one JSON line: run it in two trees
in one call to compare their kernels.

Phases, each of which fails the run (non-zero exit) when it fails:

(a) build the three CUDA kernels from ``llm_sharding_tpu_torch/csrc``;
(b) hold each kernel, and each KV mode of the paged kernels (an arena in
    the query dtype, int8 codes, fp8-e4m3 codes, each code arena with
    per-(block, KV head) f32 scales), against its plain PyTorch version on
    the card at the serving path's shapes, with bf16 and f32 queries.
    Llama-3.2-3B (G = 3, D = 128): decode at 8 rows of 100-2048 tokens and
    at one 2048-token row, chunked prefill, flash at S = C = 2048, at a
    one-shot admission's bucket (256, 200 real positions) and ragged.
    GPT-2 small (G = 1, D = 64): decode at 8 rows of 100-960 tokens,
    chunked prefill of one row at frontier 512, flash at the admission
    bucket. gemma-2B (G = 8, D = 256): the 3B's decode, chunked-prefill
    and flash shapes but the ragged ones, both query dtypes; gemma-7B
    (G = 1, D = 256): decode at 8 rows, one chunk at frontier 2048, flash
    at S = C = 2048, bf16 only. Time kernel, plain version and (flash only)
    ``F.scaled_dot_product_attention`` with the equivalent boolean mask, a
    yardstick the port never calls;
(c) f32 token checks: the served greedy streams, one-shot and chunked,
    must be token-identical to the port's ``generate`` on the same weights
    (a mismatch passes only where the oracle's top-2 logit gap is < 1e-4):
    Llama-3.2-3B at full width and 4 layers, raw, then loaded from a
    port-written int8 store (vocab table quantized too) and an int4 store;
    GPT-2 small at full width and depth; gemma-2B at full width and 4
    layers, also against ``generate`` run on this machine's CPU (no kernel
    on that side, flash included). With int8 and fp8 arenas, the 3B's and
    gemma-2B's served streams through the kernels (``paged_attn="auto"``)
    must equal the same server's through the plain versions
    (``paged_attn="plain"``), or differ first where the plain run's top-2
    gap is < 1e-3;
(d) write shard stores of seeded random full-depth weights with the
    port's ``save_shards`` (Llama-3.2-3B bf16, and int8 and int4 layers
    quantized from the same bf16 weights; GPT-2 small bf16; gemma-2B bf16,
    full depth; gemma-7B bf16, full width, 4 of its 28 layers), load each
    with ``Engine.from_shards`` and serve its ``smoke_workload`` (8
    staggered requests, 64 new tokens each) through the paged server: the
    3B, GPT-2 and gemma-2B bf16 stores once per KV dtype (bf16, int8,
    fp8), the others with a bf16 arena. In each run every request must finish, the
    block allocator must drain and every kernel (mode) of that path must
    have launched; each store's bytes on disk and resident after load are
    printed;
(e) one JSON line of per-kernel, per-mode numbers, then the card's name and
    power limit, then the final ``{"ok": true, "device": ...}`` line.

Without a CUDA device, or without the rest of the repository next to it,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
# Kernel vs plain version, both limits must hold. Absolute: max |got - want|.
# Relative to the row: max over elements of |got - want| / max |want| of
# that (query row, head), so rows that attend over ~2k keys (outputs ~0.04)
# are held as tightly as short ones. bf16: both sides round p to bf16
# before PV in different places (normalised vs running-max scaled) and then
# round the output, so they may differ by about one bf16 ulp (2^-7
# relative) of the row's largest output; 2e-2 leaves a margin of ~2, while
# a dropped KV block or a wrong load/cast moves whole rows by 10-100 %.
#
# The quantized modes are held to the same limits: kernel and plain version
# dequantize each code to the query dtype with the same two roundings (an
# exact f32 product, then one cast), so they see the same K/V values.
TOL_ABS = {"bfloat16": 3e-2, "float32": 1e-4}
TOL_REL = {"bfloat16": 2e-2, "float32": 1e-3}
SENTINEL = 2**30
KV_MODES = ("int8", "fp8")
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's boost clock: sleeps at least as long as asked


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events. The
    device first sleeps for twice the host time of the calls, so all of
    them are queued before the start event runs: the events then time the
    device's work, not the host's enqueueing."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase (b)

def quantize_arena(k, v, kv: str):
    """Codes and per-(block, KV head) scales of a [NB, BS, Nkv, D] K/V pair
    (absmax / qmax, as an admission writes them); trash block 0 gets codes
    0x7F (fp8 NaN) and Inf scales, which the kernels must never read."""
    import torch

    from llm_sharding_tpu_torch.ops import quant

    out = []
    dt = quant.kv_storage_dtype(kv)
    for x in (k, v):
        x = torch.nan_to_num(x.float(), nan=0.0, posinf=0.0)
        sc = x.abs().amax(dim=(1, 3)) / quant.kv_qmax(dt)
        codes = quant.kv_quantize(x, sc[:, None, :, None], dt)
        codes.view(torch.uint8)[0] = 0x7F
        sc[0] = float("inf")
        out += [codes, sc.contiguous()]
    return out


def code_bytes(kv, dtype_bytes: int) -> int:
    return 1 if kv else dtype_bytes


def decode_case(cfg, dtype, device, gen, kv=None, ctx=None, T=64):
    """Decode rows (default 8, contexts 100-2048), block size 64, table
    width ``T`` (64: capacity 4096) with the tail trash-mapped; trash
    block 0 holds NaN/Inf (an Inf scale for a code arena)."""
    import torch

    BS = 64
    ctx = np.linspace(100, 2048, 8).astype(int) if ctx is None else np.asarray(ctx)
    B = len(ctx)
    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    nblk = [-(-int(c) // BS) for c in ctx]
    NB = sum(nblk) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    perm = torch.randperm(NB - 1, generator=gen, device=device).cpu().numpy() + 1
    tbl = np.zeros((B, T), np.int32)
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    j = 0
    for b, c in enumerate(ctx):
        tbl[b, : nblk[b]] = perm[j : j + nblk[b]]
        j += nblk[b]
        kvpos[b, :c] = np.arange(c)
    q = torch.randn((B, 1, Nh, D), generator=gen, device=device).to(dtype)
    qpos = torch.from_numpy((ctx - 1)[:, None].astype(np.int32)).to(device)
    scales = {}
    if kv:
        k, ks, v, vs = quantize_arena(k, v, kv)
        scales = {"k_scale": ks, "v_scale": vs}
    args = (q, k, v, torch.from_numpy(tbl).to(device), qpos, torch.from_numpy(kvpos).to(device))
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * int(ctx.sum()) * Nkv * D * code_bytes(kv, isz)
              + tbl.nbytes + kvpos.nbytes + (2 * sum(nblk) * Nkv * 4 if kv else 0))
    flops = 4.0 * Nh * D * float(ctx.sum())
    return args, scales, scales, nbytes, flops, None


def prefill_case(cfg, dtype, device, gen, kv=None, frontier=(256, 2048, 256, 2048), trash=False,
                 prompt=2048, T=64):
    """Chunks of 256 queries at the given written frontiers (default two
    rows at 256 and two at 2048); every row maps blocks for a
    ``prompt``-token prompt + 65 columns in a table of width ``T``, and
    the blocks past the frontier hold stale data the nlive clamp skips.
    With ``trash``, the last row's table maps trash block 0 (NaN/Inf; 0x7F
    codes and Inf scales for a code arena) at its sixth block, positions
    320-383, visible to every query of the chunk."""
    import torch

    BS, Sc = 64, 256
    frontier = np.asarray(frontier)
    B = len(frontier)
    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    per_row = -(-(prompt + 65) // BS)
    NB = B * per_row + 1
    k = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    tbl = np.zeros((B, T), np.int32)
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    qpos = np.zeros((B, Sc), np.int32)
    for b, f in enumerate(frontier):
        tbl[b, :per_row] = 1 + b * per_row + np.arange(per_row)
        kvpos[b, :f] = np.arange(f)
        qpos[b] = np.arange(f - Sc, f)
    if trash:
        tbl[-1, 5] = 0
    nlive_np = -(-frontier // BS).astype(np.int32)
    nlive = torch.from_numpy(nlive_np).to(device)
    q = torch.randn((B, Sc, Nh, D), generator=gen, device=device).to(dtype)
    scales = {}
    if kv:
        k, ks, v, vs = quantize_arena(k, v, kv)
        scales = {"k_scale": ks, "v_scale": vs}
    args = (
        q, k, v, torch.from_numpy(tbl).to(device), torch.from_numpy(qpos).to(device),
        torch.from_numpy(kvpos).to(device),
    )
    isz = q.element_size()
    read_blocks = int(nlive_np.sum()) - int(trash)  # the trash block is never read
    nbytes = (2 * q.numel() * isz + 2 * read_blocks * BS * Nkv * D * code_bytes(kv, isz)
              + tbl.nbytes + kvpos.nbytes + qpos.nbytes
              + (2 * read_blocks * Nkv * 4 if kv else 0))
    flops = 4.0 * Nh * D * float((qpos.astype(np.int64) + 1).sum())
    return args, {"nlive": nlive, **scales}, scales, nbytes, flops, None


def flash_case(cfg, dtype, device, gen, S, real=None):
    """Causal self-attention prefill of one S-token prompt (S = C); with
    ``real``, only the first ``real`` positions are the prompt and the rest
    of the bucket carries the sentinel (a one-shot admission's shape)."""
    import torch

    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    real = S if real is None else real
    q = torch.randn((1, S, Nh, D), generator=gen, device=device).to(dtype)
    k = torch.randn((1, S, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((1, S, Nkv, D), generator=gen, device=device).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    pos[:, real:] = SENTINEL
    args = (q, k, v, pos, pos)
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + 2 * pos.numel() * 4
    # visible (query, key) pairs: causal over the prompt; each sentinel row sees every key
    flops = 4.0 * Nh * D * (real * (real + 1) / 2 + (S - real) * S)
    G = Nh // Nkv
    # yardstick: one library call computing the same function
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    mask = (pos[0][None, :] <= pos[0][:, None])[None, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return args, {}, {}, nbytes, flops, library


def kernel_cases(model: str) -> list:
    """``(name, shape label, kernel, plain version, case maker, TPU
    function, port source)`` of each [b] case at ``model``'s serving
    shapes; a case without a TPU function is checked but not tabled."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention, paged_attention

    dec = ("llm_sharding_tpu/ops/paged_attention.py:484", "llm_sharding_tpu_torch/csrc/paged_attention.cu")
    pre = ("llm_sharding_tpu/ops/paged_attention.py:689", "llm_sharding_tpu_torch/csrc/paged_prefill.cu")
    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    pa, pp, xla = paged_attention.paged_attention, paged_attention.paged_prefill, paged_attention.paged_attention_xla
    fa, plain_fa = flash_attention.flash_attention, attention.cached_attention
    cases = []
    if model == "gemma_7b":
        # gemma-7B: 16 heads over 16 KV heads (G = 1), head dim 256; bf16 only
        return [
            ("paged_attention", "gemma7b decode B=8 ctx 100-2048", pa, xla, decode_case, *dec),
            ("paged_prefill", "gemma7b chunk Sc=256 B=1 frontier 2048", pp, xla,
             lambda *a: prefill_case(*a, frontier=(2048,)), *pre),
            ("flash_attention", "gemma7b S=C=2048 causal", fa, plain_fa,
             lambda *a: flash_case(*a, S=2048), *fla),
        ]
    if model == "gemma_2b":
        # gemma-2B: 8 heads over 1 KV head (G = 8), head dim 256; the 3B's
        # served shapes (capacity 4096, block size 64, chunks of 256)
        for kv in (None, *KV_MODES):
            mode = f"[{kv}]" if kv else ""
            cases += [
                (f"paged_attention{mode}", "gemma2b decode B=8 ctx 100-2048", pa, xla,
                 lambda *a, kv=kv: decode_case(*a, kv=kv), *dec),
                (f"paged_attention{mode}", "gemma2b decode B=1 ctx 2048", pa, xla,
                 lambda *a, kv=kv: decode_case(*a, kv=kv, ctx=[2048]), *dec),
                (f"paged_prefill{mode}", "gemma2b chunk Sc=256 frontiers 256/2048", pp, xla,
                 lambda *a, kv=kv: prefill_case(*a, kv=kv), *pre),
                (f"paged_prefill{mode}", "gemma2b chunk Sc=256 B=1 frontier 2048", pp, xla,
                 lambda *a, kv=kv: prefill_case(*a, kv=kv, frontier=(2048,)), *pre),
            ]
        return cases + [
            ("flash_attention", "gemma2b S=C=2048 causal", fa, plain_fa,
             lambda *a: flash_case(*a, S=2048), *fla),
            ("flash_attention", "gemma2b S=C=256 200 real (admission)", fa, plain_fa,
             lambda *a: flash_case(*a, S=256, real=200), *fla),
        ]
    if model == "gpt2_small":
        # GPT-2 small: 12 heads, G = 1, D = 64; table width 16 (capacity 1024);
        # the served chunks end at frontiers 256 and 512 (prompts <= 512)
        gpt2_ctx = np.linspace(100, 960, 8).astype(int)
        for kv in (None, *KV_MODES):
            mode = f"[{kv}]" if kv else ""
            cases += [
                (f"paged_attention{mode}", "gpt2 decode B=8 ctx 100-960", pa, xla,
                 lambda *a, kv=kv: decode_case(*a, kv=kv, ctx=gpt2_ctx, T=16), *dec),
                (f"paged_prefill{mode}", "gpt2 chunk Sc=256 B=1 frontier 512", pp, xla,
                 lambda *a, kv=kv: prefill_case(*a, kv=kv, frontier=(512,), prompt=512, T=16),
                 *pre),
            ]
        return cases + [("flash_attention", "gpt2 S=C=256 200 real (admission)", fa, plain_fa,
                         lambda *a: flash_case(*a, S=256, real=200), *fla)]
    for kv in (None, *KV_MODES):
        mode = f"[{kv}]" if kv else ""
        cases += [
            (f"paged_attention{mode}", "decode B=8 ctx 100-2048", pa, xla,
             lambda *a, kv=kv: decode_case(*a, kv=kv), *dec),
            (f"paged_attention{mode}", "decode B=1 ctx 2048", pa, xla,
             lambda *a, kv=kv: decode_case(*a, kv=kv, ctx=[2048]), *dec),
            (f"paged_prefill{mode}", "chunk Sc=256 frontiers 256/2048", pp, xla,
             lambda *a, kv=kv: prefill_case(*a, kv=kv), *pre),
            (f"paged_prefill{mode}", "chunk Sc=256 B=1 frontier 2048", pp, xla,
             lambda *a, kv=kv: prefill_case(*a, kv=kv, frontier=(2048,)), *pre),
            (f"paged_prefill{mode}", "chunk Sc=256 B=2 trash in window", pp, xla,
             lambda *a, kv=kv: prefill_case(*a, kv=kv, frontier=(1024, 2048), trash=True),
             None, None),
        ]
    return cases + [
        ("flash_attention", "S=C=2048 causal", fa, plain_fa, lambda *a: flash_case(*a, S=2048), *fla),
        ("flash_attention", "S=C=256 200 real (admission)", fa, plain_fa,
         lambda *a: flash_case(*a, S=256, real=200), *fla),
        ("flash_attention", "S=C=37 ragged", fa, plain_fa, lambda *a: flash_case(*a, S=37), None, None),
    ]


def phase_kernels(cfg, device, model: str, dtypes=("bfloat16", "float32")) -> list:
    """Each kernel case of ``model`` against its plain version, with
    queries of each of ``dtypes``, timed; returns the tabled rows (bf16
    queries), tagged with the model."""
    import torch

    from llm_sharding_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=device).manual_seed(1234)
    cases = kernel_cases(model)
    rows = []
    for name, label, fn, plain, make, replaces, source in cases:
        for dtype in (getattr(torch, d) for d in dtypes):
            dname = str(dtype).split(".")[-1]
            args, kw, plain_kw, nbytes, flops, library = make(cfg, dtype, device, gen)
            got = fn(*args, **kw)
            want = plain(*args, **plain_kw)
            torch.cuda.synchronize()
            # rows with no visible key are garbage on every path (callers
            # discard them); every row here sees at least its own key
            diff = (got.float() - want.float()).abs()
            row_scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
            err = diff.max().item()
            rel = (diff / row_scale).max().item()
            require(bool(torch.isfinite(got).all()), f"{name} {label} {dname}: non-finite output")
            tol, tol_rel = TOL_ABS[dname], TOL_REL[dname]
            status = "ok" if err <= tol and rel <= tol_rel else "FAIL"
            ms = cuda_ms(lambda: fn(*args, **kw), iters=20)
            plain_ms = cuda_ms(lambda: plain(*args, **plain_kw), iters=3, warmup=1)
            lib_ms = cuda_ms(library, iters=20) if library is not None else None
            bms, by = bound(nbytes, flops, dname)
            design = None
            if name.startswith("paged_prefill"):
                # the route the wrapper's rule picks for these inputs (BS = 64)
                design = paged_attention.prefill_design(dtype, args[1].shape[1])
                require(dtype != torch.bfloat16 or design == "wgmma",
                        f"{name} {label}: bf16 at block size 64 must take the wgmma route")
            log(
                f"[b] {name:21s} {label:40s} {dname:8s} {design or '':5s} max_abs_err={err:.3g} tol={tol:g} "
                f"max_row_rel_err={rel:.3g} tol={tol_rel:g} {status} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"bound_ms={bms:.4f} ({by})"
            )
            require(err <= tol, f"{name} {label} {dname}: max abs error {err} > {tol}")
            require(rel <= tol_rel,
                    f"{name} {label} {dname}: max row-relative error {rel} > {tol_rel}")
            if replaces is not None and dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, model=model, shape=label, route="cuda", source=source, replaces=replaces,
                    launches=None, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms,
                    **({"design": design} if design else {}),
                ))
            del args, got, want
    return rows


# --------------------------------------------------------------- phase (c)

def top2_gap(cfg, params, ids: np.ndarray) -> float:
    """Top-2 logit gap of the next token after ``ids``, from a fresh
    prefill of the whole sequence (the oracle's decision margin)."""
    import torch

    from llm_sharding_tpu_torch.models.cache import init_cache
    from llm_sharding_tpu_torch.ops.quant import act_dtype, base
    from llm_sharding_tpu_torch.parallel.pipeline import model_fns

    dev = base(params["embed"]).device
    cache = init_cache(cfg, 1, len(ids), dtype=act_dtype(params["embed"]), device=dev)
    pos = torch.arange(len(ids), dtype=torch.int32, device=dev)[None]
    logits, _ = model_fns(cfg).forward(cfg, params, torch.from_numpy(ids[None]).to(dev), cache, pos)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


@contextlib.contextmanager
def recorded_gaps(srv):
    """Record the top-2 logit gap of every token ``srv`` samples, per
    request id (the served run's own decision margins)."""
    import torch

    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    gaps = collections.defaultdict(list)
    sample = serve_ops._sample_rows

    def recording(state, rows, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        for i, r in enumerate(rows):
            gaps[srv._req[r].id].append(float(top[i, 0] - top[i, 1]))
        return sample(state, rows, logits)

    serve_ops._sample_rows = recording
    try:
        yield gaps
    finally:
        serve_ops._sample_rows = sample


def served_streams(eng, prompts, max_new: int, capacity: int = 2048, **serve_kw):
    """Staggered submits (the even-indexed prompts, two steps, then the
    odd-indexed ones) on a fresh server; returns each request's tokens and
    sampled-token gaps, in prompt order."""
    srv = eng.serve(capacity=capacity, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                    prefill_chunk=256, **serve_kw)
    order = [*range(0, len(prompts), 2), *range(1, len(prompts), 2)]
    first = (len(prompts) + 1) // 2
    with recorded_gaps(srv) as gaps:
        reqs = [srv.submit(prompts[i], max_new) for i in order[:first]]
        srv.step()
        srv.step()
        reqs += [srv.submit(prompts[i], max_new) for i in order[first:]]
        srv.run_until_idle()
    srv._alloc.check()
    require(srv._alloc.in_use == 0, "phase c: KV blocks leaked")
    by_prompt = dict(zip(order, reqs))
    n = len(prompts)
    return [by_prompt[i].tokens for i in range(n)], [gaps[by_prompt[i].id] for i in range(n)]


def check_against_generate(tag: str, eng, prompts, lens, max_new: int, capacity: int = 2048,
                           oracle=None) -> None:
    """The served greedy streams (one-shot and chunked admissions) must be
    the ``generate`` tokens of ``oracle`` (default: the same engine); a
    mismatch passes only where the oracle's top-2 logit gap is < 1e-4."""
    oracle = oracle or eng
    served, _ = served_streams(eng, prompts, max_new, capacity=capacity)
    for i, got in enumerate(served):
        want = oracle.generate_ids(prompts[i], max_new)
        w = want.tokens[0, lens[i] : want.lengths[0]].tolist()
        path = "chunked" if lens[i] > 256 else "one-shot"
        if w == got:
            log(f"[c] {tag} prompt {lens[i]:5d} ({path}): {len(w)} tokens identical to generate")
            continue
        step = next(j for j in range(min(len(w), len(got))) if w[j] != got[j])
        gap = top2_gap(oracle.cfg, oracle.params,
                       np.concatenate([prompts[i], np.asarray(w[:step], np.int32)]))
        log(f"[c] {tag} prompt {lens[i]:5d} ({path}): first mismatch at step {step}, "
            f"oracle top-2 gap {gap:.3g}")
        require(gap < 1e-4, f"phase c {tag}: served tokens differ from generate (gap {gap})")


def check_kernels_against_plain(tag: str, eng, prompts, lens, max_new: int) -> None:
    """With int8 and fp8 arenas, the served streams through the kernels must
    equal the same server's through the plain versions, or differ first
    where the plain run's top-2 gap is < 1e-3."""
    for kv in KV_MODES:
        kernel, _ = served_streams(eng, prompts, max_new, kv_dtype=kv, paged_attn="auto")
        plain, gaps = served_streams(eng, prompts, max_new, kv_dtype=kv, paged_attn="plain")
        for i, (got, want) in enumerate(zip(kernel, plain)):
            path = "chunked" if lens[i] > 256 else "one-shot"
            require(len(got) == len(want), f"phase c {tag} {kv}: stream lengths differ")
            if got == want:
                log(f"[c] {tag} {kv} prompt {lens[i]:5d} ({path}): {len(got)} tokens of the "
                    f"kernels identical to the plain versions'")
                continue
            step = next(j for j in range(len(got)) if got[j] != want[j])
            gap = gaps[i][step]
            log(f"[c] {tag} {kv} prompt {lens[i]:5d} ({path}): first mismatch at step {step}, "
                f"plain run's top-2 gap {gap:.3g}")
            require(gap < 1e-3, f"phase c {tag} {kv}: kernel tokens differ from plain (gap {gap})")


def to_device(tree, device):
    """A params tree (dicts, lists, tensors) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def phase_token_check(device, store_root: str) -> None:
    """f32 token checks: Llama-3.2-3B at 4 layers (raw weights, then from
    an int8 store with the head quantized and from an int4 store, both
    written by the port), GPT-2 small at full depth, and gemma-2B at 4
    layers, whose served streams are also held against ``generate`` run on
    this machine's CPU (a reference with no kernel in it)."""
    import torch

    from llm_sharding_tpu_torch.models import config, gpt2, llama
    from llm_sharding_tpu_torch.ops.quant import quantize_params
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    params = llama.init_params(cfg, seed=7, dtype=torch.float32, device=device)
    eng = Engine(cfg, params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]  # buckets 64 and 256 one-shot, 1024 chunked
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    max_new = 16
    check_against_generate("3B", eng, prompts, lens, max_new)
    check_kernels_against_plain("3B", eng, prompts, lens, max_new)
    del eng
    for bits, head in ((8, True), (4, False)):
        tag = f"3B int{bits}{' +head' if head else ''} store"
        store = os.path.join(store_root, f"c_int{bits}")
        save_shards(cfg, quantize_params(params, quantize_head=head, bits=bits), store)
        qeng = Engine.from_shards(store, dtype=torch.float32, device=device)
        shutil.rmtree(store)
        check_against_generate(tag, qeng, prompts, lens, max_new)
        del qeng
    del params
    torch.cuda.empty_cache()

    gcfg = config.gpt2_small()
    geng = Engine(gcfg, gpt2.init_params(gcfg, seed=8, dtype=torch.float32, device=device))
    glens = [40, 200, 300, 500]  # buckets 64 and 256 one-shot, 512 chunked
    gprompts = [rng.integers(0, gcfg.vocab_size, n).astype(np.int32) for n in glens]
    check_against_generate("gpt2", geng, gprompts, glens, max_new, capacity=1024)
    del geng
    torch.cuda.empty_cache()

    # gemma-2B (G = 8, head dim 256) at full width, 4 layers; the same
    # weights on the card and on the CPU
    mcfg = dataclasses.replace(config.gemma_2b(), num_hidden_layers=4)
    cpu_params = llama.init_params(mcfg, seed=9, dtype=torch.float32, device="cpu")
    meng = Engine(mcfg, to_device(cpu_params, device))
    mlens = [40, 300]  # bucket 64 one-shot, 512 chunked (two chunks)
    mprompts = [rng.integers(0, mcfg.vocab_size, n).astype(np.int32) for n in mlens]
    check_against_generate("gemma2b", meng, mprompts, mlens, max_new)
    t0 = time.perf_counter()
    check_against_generate("gemma2b vs CPU", meng, mprompts, mlens, max_new,
                           oracle=Engine(mcfg, cpu_params))
    log(f"[c] gemma2b: CPU generate reference took {time.perf_counter() - t0:.1f}s")
    check_kernels_against_plain("gemma2b", meng, mprompts, mlens, max_new)
    del meng, cpu_params
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase (d)

def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def serve_run(eng, model: str, tag: str, kv: str = "bf16") -> tuple[dict, list]:
    """``model``'s workload on a fresh server with a ``kv`` arena: checks
    it, prints its numbers; returns the run's launch counts and tokens."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    cfg = eng.cfg
    srv = smoke_workload.serve(eng, model, kv_dtype=kv)
    prompts = smoke_workload.prompts(cfg.vocab_size, np.random.default_rng(0),
                                     smoke_workload.WORKLOADS[model].lens)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_start = time.perf_counter()
    reqs = smoke_workload.submit_staggered(srv, prompts)
    srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = K.launch_counts()
    for r in reqs:
        require(r.done and r.error is None, f"phase d {tag}: request {r.id} did not finish")
        require(len(r.tokens) == smoke_workload.MAX_NEW
                or r.tokens[-1] in cfg.eos_token_ids,
                f"phase d {tag}: request {r.id} produced {len(r.tokens)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.tokens),
                f"phase d {tag}: token out of range")
    srv._alloc.check()
    require(srv._alloc.in_use == 0, f"phase d {tag}: {srv._alloc.in_use} KV blocks still held")
    mode = "" if kv == "bf16" else f"[{kv}]"
    for name in ("flash_attention", f"paged_attention{mode}", f"paged_prefill{mode}"):
        require(counts.get(name, 0) > 0,
                f"phase d {tag}: kernel {name} was never launched on the main path")
    ttft = np.array([r.first_token_at - r.submitted_at for r in reqs])
    ntok = sum(len(r.tokens) for r in reqs)
    decode_span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    decode_tok_s = sum(len(r.tokens) - 1 for r in reqs) / decode_span
    log(f"[d] {tag}: served {len(reqs)} requests, {ntok} tokens in {wall:.2f}s: "
        f"decode {decode_tok_s:.1f} tok/s, TTFT p50 {np.percentile(ttft, 50) * 1e3:.0f} ms "
        f"p99 {np.percentile(ttft, 99) * 1e3:.0f} ms, arena {srv.arena_bytes() / 2**30:.3f} GiB "
        f"({srv.kv_store_dtype}), peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"[d] {tag}: kernel launches on the main path: {counts}")
    tokens = [list(r.tokens) for r in reqs]
    del srv, reqs
    torch.cuda.empty_cache()
    return counts, tokens


def load_store(store: str, tag: str, device, write_s: float):
    """``Engine.from_shards`` of a store, printing its bytes on disk, the
    weight bytes it made resident and the write and load seconds."""
    import torch

    from llm_sharding_tpu_torch.runtime.engine import Engine

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = Engine.from_shards(store, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - before
    log(f"[d] {tag} store: {dir_bytes(store) / 1e9:.3f} GB on disk, {resident / 1e9:.3f} GB "
        f"resident after load, written in {write_s:.1f}s, loaded in {load_s:.1f}s "
        f"({eng.cfg.num_hidden_layers} layers)")
    return eng


def phase_serve(device, store_root: str) -> dict:
    """The workloads on random full-size weights loaded from port-written
    stores: Llama-3.2-3B bf16 (once per KV dtype), int8 and int4 (bf16
    arena), GPT-2 small and gemma-2B bf16 (once per KV dtype), then
    gemma-7B bf16 at 4 layers (bf16 arena). Returns the launch counts of
    each kernel mode per model, each from the run that serves through it
    (unquantized modes: the bf16 weights' bf16 arena)."""
    import torch

    from llm_sharding_tpu_torch.models import config, gpt2, llama
    from llm_sharding_tpu_torch.ops.quant import quantize_params
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = config.llama32_3b()
    stores, write_s = {}, {}
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    for w in ("bf16", "int8", "int4"):
        t0 = time.perf_counter()
        stores[w] = os.path.join(store_root, f"llama32_3b_{w}")
        out = params if w == "bf16" else quantize_params(params, bits=8 if w == "int8" else 4)
        save_shards(cfg, out, stores[w])
        del out
        write_s[w] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    eng = load_store(stores["bf16"], "3B bf16", device, write_s["bf16"])
    counts, base = serve_run(eng, "llama32_3b", "3B bf16 weights, kv bf16")
    for kv in KV_MODES:
        kv_counts, tokens = serve_run(eng, "llama32_3b", f"3B bf16 weights, kv {kv}", kv)
        counts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
        log(f"[d] kv {kv}: token match against the bf16 arena's run {match_frac(tokens, base):.3f} "
            f"(random weights: printed, not gated)")
    del eng
    shutil.rmtree(stores["bf16"])
    torch.cuda.empty_cache()
    for w in ("int8", "int4"):
        eng = load_store(stores[w], f"3B {w}", device, write_s[w])
        _, tokens = serve_run(eng, "llama32_3b", f"3B {w} weights, kv bf16")
        log(f"[d] {w} weights: token match against the bf16 weights' run "
            f"{match_frac(tokens, base):.3f} (random weights: printed, not gated)")
        del eng
        shutil.rmtree(stores[w])
        torch.cuda.empty_cache()

    gcfg = config.gpt2_small()
    t0 = time.perf_counter()
    gstore = os.path.join(store_root, "gpt2_small_bf16")
    gparams = gpt2.init_params(gcfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(gcfg, gparams, gstore)
    del gparams
    torch.cuda.empty_cache()
    eng = load_store(gstore, "gpt2 bf16", device, time.perf_counter() - t0)
    gcounts, gbase = serve_run(eng, "gpt2_small", "gpt2 bf16 weights, kv bf16")
    for kv in KV_MODES:
        kv_counts, tokens = serve_run(eng, "gpt2_small", f"gpt2 bf16 weights, kv {kv}", kv)
        gcounts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
        log(f"[d] gpt2 kv {kv}: token match against the bf16 arena's run "
            f"{match_frac(tokens, gbase):.3f} (random weights: printed, not gated)")
    del eng
    torch.cuda.empty_cache()

    mcfg = config.gemma_2b()
    t0 = time.perf_counter()
    mstore = os.path.join(store_root, "gemma_2b_bf16")
    mparams = llama.init_params(mcfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(mcfg, mparams, mstore)
    del mparams
    torch.cuda.empty_cache()
    eng = load_store(mstore, "gemma2b bf16", device, time.perf_counter() - t0)
    mcounts, mbase = serve_run(eng, "gemma_2b", "gemma2b bf16 weights, kv bf16")
    for kv in KV_MODES:
        kv_counts, tokens = serve_run(eng, "gemma_2b", f"gemma2b bf16 weights, kv {kv}", kv)
        mcounts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
        log(f"[d] gemma2b kv {kv}: token match against the bf16 arena's run "
            f"{match_frac(tokens, mbase):.3f} (random weights: printed, not gated)")
    del eng
    shutil.rmtree(mstore)
    torch.cuda.empty_cache()

    # gemma-7B (G = 1) at full width, depth cut to 4 of its 28 layers
    scfg = dataclasses.replace(config.gemma_7b(), num_hidden_layers=4)
    t0 = time.perf_counter()
    sstore = os.path.join(store_root, "gemma_7b_bf16")
    sparams = llama.init_params(scfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(scfg, sparams, sstore)
    del sparams
    torch.cuda.empty_cache()
    eng = load_store(sstore, "gemma7b bf16", device, time.perf_counter() - t0)
    scounts, _ = serve_run(eng, "gemma_7b", "gemma7b bf16 weights, kv bf16")
    del eng
    shutil.rmtree(sstore)
    torch.cuda.empty_cache()
    return {"llama32_3b": counts, "gpt2_small": gcounts, "gemma_2b": mcounts,
            "gemma_7b": scounts}


def match_frac(tokens, base) -> float:
    return float(np.mean([np.mean([a == b for a, b in zip(t, u)]) for t, u in zip(tokens, base)]))


def main(argv: list) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from llm_sharding_tpu_torch.models import config
        from llm_sharding_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the llm_sharding_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_all = time.perf_counter()

    secs = K.build_all()
    with open(K.BUILD_DIR / "ptxas.log", "w") as f:
        for k in K.KERNELS:
            f.write(f"=== {k.source}\n{k.build_log}\n")
    for k in K.KERNELS:
        spills = [ln.strip() for ln in k.build_log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        log(f"[a] built {k.source}; non-zero spill lines: {len(spills)}")
    log(f"[a] kernel build: {secs:.1f}s (nvcc, sm_90a, one process per source)")
    if argv[:1] == ["--kernels"]:
        rows = [r for m in argv[1:]
                for r in phase_kernels(getattr(config, m)(), device, m, dtypes=("bfloat16",))]
        print(json.dumps({"kernels": rows}))
        return 0

    rows = phase_kernels(config.llama32_3b(), device, "llama32_3b")
    rows += phase_kernels(config.gpt2_small(), device, "gpt2_small")
    rows += phase_kernels(config.gemma_2b(), device, "gemma_2b")
    rows += phase_kernels(config.gemma_7b(), device, "gemma_7b", dtypes=("bfloat16",))
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        phase_token_check(device, store)
        counts = phase_serve(device, store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for r in rows:
        r["launches"] = counts[r["model"]][r["name"]]
    log(f"[e] total {time.perf_counter() - t_all:.0f}s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
