#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_sharding_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

(a) build the three CUDA kernels from ``llm_sharding_tpu_torch/csrc``;
(b) hold each kernel against its plain PyTorch version on the card at the
    Llama-3.2-3B shapes of the serving path, in bf16 and f32, and time
    kernel, plain version and (flash only) ``F.scaled_dot_product_attention``
    with the equivalent boolean mask, a yardstick the port never calls;
(c) f32 at full 3B width and 4 layers: the served greedy streams, one-shot
    and chunked, must be token-identical to the port's ``generate`` (a
    mismatch passes only where the oracle's top-2 logit gap is < 1e-4);
(d) write a shard store of seeded random Llama-3.2-3B weights (28 layers,
    bf16), load it with ``Engine.from_shards`` and serve 8 staggered
    requests (4 prompts of 20-200 tokens, 4 of 1024-2048, 64 new tokens
    each) through the paged server; every request must finish, the block
    allocator must drain and every kernel must have launched;
(e) one JSON line of per-kernel numbers, then the card's name and power
    limit, then the final ``{"ok": true, "device": ...}`` line.

Without a CUDA device, or without the rest of the repository next to it,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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
TOL_ABS = {"bfloat16": 3e-2, "float32": 1e-4}
TOL_REL = {"bfloat16": 2e-2, "float32": 1e-3}
SENTINEL = 2**30


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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

def decode_case(cfg, dtype, device, gen):
    """8 decode rows, contexts 100-2048, block size 64, table width 64
    (capacity 4096) with the tail trash-mapped; trash block 0 holds NaN/Inf."""
    import torch

    B, BS, T = 8, 64, 64
    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    ctx = np.linspace(100, 2048, B).astype(int)
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
    args = (q, k, v, torch.from_numpy(tbl).to(device), qpos, torch.from_numpy(kvpos).to(device))
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + 2 * int(ctx.sum()) * Nkv * D * isz + tbl.nbytes + kvpos.nbytes
    flops = 4.0 * Nh * D * float(ctx.sum())
    return args, {}, nbytes, flops, None


def prefill_case(cfg, dtype, device, gen):
    """Chunks of 256 queries at written frontiers 256 and 2048 (two rows
    each); every row maps blocks for a 2048-token prompt + 65 columns, and
    the blocks past the frontier hold stale data the nlive clamp skips."""
    import torch

    BS, Sc = 64, 256
    frontier = np.array([256, 2048, 256, 2048])
    B = len(frontier)
    T = 64
    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    per_row = -(-(2048 + 65) // BS)
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
    nlive = torch.from_numpy(-(-frontier // BS).astype(np.int32)).to(device)
    q = torch.randn((B, Sc, Nh, D), generator=gen, device=device).to(dtype)
    args = (
        q, k, v, torch.from_numpy(tbl).to(device), torch.from_numpy(qpos).to(device),
        torch.from_numpy(kvpos).to(device),
    )
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * int(frontier.sum()) * Nkv * D * isz + tbl.nbytes
              + kvpos.nbytes + qpos.nbytes)
    flops = 4.0 * Nh * D * float((qpos.astype(np.int64) + 1).sum())
    return args, {"nlive": nlive}, nbytes, flops, None


def flash_case(cfg, dtype, device, gen, S):
    """Causal self-attention prefill of one S-token prompt (S = C)."""
    import torch

    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    q = torch.randn((1, S, Nh, D), generator=gen, device=device).to(dtype)
    k = torch.randn((1, S, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((1, S, Nkv, D), generator=gen, device=device).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    args = (q, k, v, pos, pos)
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + 2 * pos.numel() * 4
    flops = 4.0 * Nh * D * S * (S + 1) / 2
    G = Nh // Nkv
    # yardstick: one library call computing the same function
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    mask = (pos[0][None, :] <= pos[0][:, None])[None, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return args, {}, nbytes, flops, library


def phase_kernels(cfg, device) -> list:
    import torch

    from llm_sharding_tpu_torch.ops import attention, flash_attention, paged_attention
    from llm_sharding_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device).manual_seed(1234)
    cases = [
        ("paged_attention", "decode B=8 ctx 100-2048", K.PAGED_DECODE,
         paged_attention.paged_attention, paged_attention.paged_attention_xla,
         decode_case, "llm_sharding_tpu/ops/paged_attention.py:484",
         "llm_sharding_tpu_torch/csrc/paged_attention.cu"),
        ("paged_prefill", "chunk Sc=256 frontiers 256/2048", K.PAGED_PREFILL,
         paged_attention.paged_prefill, paged_attention.paged_attention_xla,
         prefill_case, "llm_sharding_tpu/ops/paged_attention.py:689",
         "llm_sharding_tpu_torch/csrc/paged_prefill.cu"),
        ("flash_attention", "S=C=2048 causal", K.FLASH,
         flash_attention.flash_attention, attention.cached_attention,
         lambda *a: flash_case(*a, S=2048), "llm_sharding_tpu/ops/flash_attention.py:124",
         "llm_sharding_tpu_torch/csrc/flash_attention.cu"),
        ("flash_attention", "S=C=37 ragged", K.FLASH,
         flash_attention.flash_attention, attention.cached_attention,
         lambda *a: flash_case(*a, S=37), None, None),
    ]
    rows = []
    for name, label, kern, fn, plain, make, replaces, source in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            args, kw, nbytes, flops, library = make(cfg, dtype, device, gen)
            got = fn(*args, **kw)
            want = plain(*args)
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
            plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
            lib_ms = cuda_ms(library, iters=20) if library is not None else None
            bms, by = bound(nbytes, flops, dname)
            log(
                f"[b] {name:16s} {label:32s} {dname:8s} max_abs_err={err:.3g} tol={tol:g} "
                f"max_row_rel_err={rel:.3g} tol={tol_rel:g} {status} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"bound_ms={bms:.4f} ({by})"
            )
            require(err <= tol, f"{name} {label} {dname}: max abs error {err} > {tol}")
            require(rel <= tol_rel,
                    f"{name} {label} {dname}: max row-relative error {rel} > {tol_rel}")
            if replaces is not None and dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, route="cuda", source=source, replaces=replaces,
                    launches=None, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms,
                ))
            del args, got, want
    return rows


# --------------------------------------------------------------- phase (c)

def top2_gap(cfg, params, ids: np.ndarray) -> float:
    """Top-2 logit gap of the next token after ``ids``, from a fresh
    prefill of the whole sequence (the oracle's decision margin)."""
    import torch

    from llm_sharding_tpu_torch.models import llama
    from llm_sharding_tpu_torch.models.cache import init_cache

    dev = params["embed"].device
    cache = init_cache(cfg, 1, len(ids), dtype=params["embed"].dtype, device=dev)
    pos = torch.arange(len(ids), dtype=torch.int32, device=dev)[None]
    logits, _ = llama.forward(cfg, params, torch.from_numpy(ids[None]).to(dev), cache, pos)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def phase_token_check(device) -> None:
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    params = llama.init_params(cfg, seed=7, dtype=torch.float32, device=device)
    eng = Engine(cfg, params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]  # buckets 64 and 256 one-shot, 1024 chunked
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    max_new = 16
    srv = eng.serve(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                    prefill_chunk=256)
    reqs = [srv.submit(prompts[0], max_new), srv.submit(prompts[2], max_new)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[1], max_new), srv.submit(prompts[3], max_new)]
    order = [0, 2, 1, 3]
    srv.run_until_idle()
    srv._alloc.check()
    require(srv._alloc.in_use == 0, "phase c: KV blocks leaked")
    for r, i in zip(reqs, order):
        want = eng.generate_ids(prompts[i], max_new)
        w = want.tokens[0, lens[i] : want.lengths[0]].tolist()
        path = "chunked" if lens[i] > 256 else "one-shot"
        if w == r.tokens:
            log(f"[c] prompt {lens[i]:5d} ({path}): {len(w)} tokens identical to generate")
            continue
        step = next(j for j in range(min(len(w), len(r.tokens))) if w[j] != r.tokens[j])
        gap = top2_gap(cfg, params, np.concatenate([prompts[i], np.asarray(w[:step], np.int32)]))
        log(f"[c] prompt {lens[i]:5d} ({path}): first mismatch at step {step}, "
            f"oracle top-2 gap {gap:.3g}")
        require(gap < 1e-4, f"phase c: served tokens differ from generate (gap {gap})")
    del eng, params, srv
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase (d)

def phase_serve(device, store_dir: str) -> dict:
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = config.llama32_3b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store_dir)
    del params
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    eng = Engine.from_shards(store_dir, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[d] store written in {t1 - t0:.1f}s, loaded in {t2 - t1:.1f}s "
        f"({cfg.num_hidden_layers} layers, bf16)")
    srv = eng.serve(capacity=4096, batch_per_slot=8, kv_block_size=64, kv_blocks=1024,
                    prefill_chunk=256)
    prompts = smoke_workload.prompts(cfg.vocab_size, np.random.default_rng(0))
    K.reset_launch_counts()
    t_start = time.perf_counter()
    reqs = smoke_workload.submit_staggered(srv, prompts)
    srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = K.launch_counts()
    for r in reqs:
        require(r.done and r.error is None, f"phase d: request {r.id} did not finish")
        require(len(r.tokens) == smoke_workload.MAX_NEW
                or r.tokens[-1] in cfg.eos_token_ids,
                f"phase d: request {r.id} produced {len(r.tokens)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.tokens), "phase d: token out of range")
    srv._alloc.check()
    require(srv._alloc.in_use == 0, f"phase d: {srv._alloc.in_use} KV blocks still held")
    for name, n in counts.items():
        require(n > 0, f"phase d: kernel {name} was never launched on the main path")
    ttft = np.array([r.first_token_at - r.submitted_at for r in reqs])
    ntok = sum(len(r.tokens) for r in reqs)
    decode_span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    decode_tok_s = sum(len(r.tokens) - 1 for r in reqs) / decode_span
    log(f"[d] served {len(reqs)} requests, {ntok} tokens in {wall:.2f}s: "
        f"decode {decode_tok_s:.1f} tok/s, TTFT p50 {np.percentile(ttft, 50) * 1e3:.0f} ms "
        f"p99 {np.percentile(ttft, 99) * 1e3:.0f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"[d] kernel launches on the main path: {counts}")
    return counts


def main() -> int:
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

    cfg = config.llama32_3b()
    rows = phase_kernels(cfg, device)
    phase_token_check(device)
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        counts = phase_serve(device, store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for r in rows:
        r["launches"] = counts[r["name"]]
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
    sys.exit(main())
