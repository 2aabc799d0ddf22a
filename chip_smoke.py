#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_sharding_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels MODEL [MODEL ...]
    python3 chip_smoke.py --fleet
    python3 chip_smoke.py --pipeline
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --profile
    python3 chip_smoke.py --flash

The second form runs (a) and (b) only, bf16 queries, at the named
models' shapes (``llama32_3b``, ``gpt2_small``, ``gemma_2b``,
``gemma_7b``, ``llama2_7b``), and prints the rows as one JSON line: run
it in two trees in one call to compare their kernels. The third runs (a)
and the fleet's parts of (c) and (d) alone, the fourth (a) and the
pipeline's parts, the fifth (a) and the tensor and context parallel
parts of (b), (c) and (d), printing its [b] rows as one JSON line. The
sixth runs (a), [b]'s profile rows and [d]'s profile part alone, on a
3B store of ``D_3B`` layers it writes itself. ``--flash`` builds the flash
kernel alone, prints its instantiations' registers and spills and runs
every [b] flash case (each route), printing the rows as one JSON line.

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
    at S = C = 2048, bf16 only. A prefix-cache hit's shapes: flash at the
    3B's and gemma-2B's with S = 256 queries at positions 1024-1279 over
    C = 1280 keys; the 3B's chunked prefill of two rows at column 1024 over
    16 shared blocks, in each KV mode. Llama-2-7B (G = 1, D = 128): decode
    at 8 rows, chunked prefill at frontiers 256/2048, flash at S = C =
    2048, bf16 only. Speculative decoding (K = 4): the paged verify's decode
    at S = 5 over 8 rows of 100-2048 tokens, 3B, Llama-2-7B and gemma-2B
    (G * S = 40 folded rows), in each KV mode; speculative ``generate``'s verify, flash at S = 5 over 2048 + 5
    columns (3B). At a tensor shard's heads (bf16 arena): the 3B's decode,
    chunked prefill and flash at 12 / 4 heads (tp 2) and 6 / 2 (tp 4),
    Llama-2-7B's at 16 / 16 (tp 2). The profiler's sweep: flash at the 3B's
    S = C = 8 and 512, one row. Time kernel, plain version and
    (flash only) ``F.scaled_dot_product_attention`` with the equivalent
    boolean mask, a yardstick the port never calls;
(c) f32 token checks: the served greedy streams, one-shot and chunked,
    must be token-identical to the port's ``generate`` on the same weights
    (a mismatch passes only where the oracle's top-2 logit gap is < 1e-4):
    Llama-3.2-3B at full width and 4 layers, raw, then loaded from a
    port-written int8 store (vocab table quantized too) and an int4 store;
    GPT-2 small at full width and depth; gemma-2B at full width and 4
    layers. The raw 3B's, GPT-2's and gemma-2B's streams are also held
    against ``generate`` run on this machine's CPU (no kernel on that side,
    flash included; the weights are made on the CPU and copied to the
    card). With int8 and fp8 arenas, the 3B's and gemma-2B's served
    streams through the kernels (``paged_attn="auto"``) must equal the same
    server's through the plain versions (``paged_attn="plain"``), or
    differ first where the plain run's top-2 gap is < 1e-3. The prefix
    cache, 3B raw: a primer caches a 512-token prefix, then a one-shot and
    a chunked hit, with ``prefix_cache`` hbm, host and disk (the lower
    tiers stream the prefix back), held to the cache-off streams and to
    ``generate`` on the CPU; with int8 and fp8 arenas, the cached streams
    through the kernels against the plain versions' (gap < 1e-3).
    Resilience, 3B raw: snapshot, drop, restore mid-decode in each arena
    (restored streams identical to the uninterrupted ones; the f32 arena's
    also held to CPU ``generate``); ``extract`` / ``adopt`` of 2 greedy and 2
    sampled rows to a second server (greedy: the uninterrupted streams and
    CPU ``generate``, gap rule; sampled: identical to ``generate(seed=)`` on
    the card); a transient fault plan at all five sites (identical); a
    permanent ``request_apply`` fault (that request fails, the others hold);
    a snapshot with ``prefix_cache="hbm"`` whose restored tree a new request
    hits. Speculation, 3B raw (the prompts above and two that repeat a
    64-token passage): speculative ``generate`` (K = 2, 4; burst 1, 4)
    against ``generate`` on the card and on the CPU, launching flash for
    its verify; the speculative server (K = 3) against the non-speculative
    one-shot server, ``generate`` and CPU ``generate``, and with int8 / fp8
    arenas its kernels against its plain versions (gap < 1e-3); a stop
    string (fake tokenizer) completing inside a verify run cuts it there;
    kill and restore mid-decode and extract / adopt of two rows against the
    uninterrupted run (gap rule: a revived row drafts afresh); sampled
    rows reproduce by seed; at Llama-2-7B's width (4 layers, G = 1) the
    speculative server and ``generate`` against the non-speculative
    server and ``generate``. Observability, 3B raw: the served streams
    with a ``trace_path`` and a 4-step ``stepline_capture(trace_dir=)``
    armed (``torch.profiler`` with CUDA activity brackets the window)
    must be identical to the streams without, the capture's Chrome trace
    must hold kernels, every request one span tree without orphans, and
    every step must account (``sum(phases) + blocked + unattributed ==
    wall``; a step that dispatched a program and read its log with no log
    left in flight shows a device wait). The step loop, 3B raw, every
    request submitted before the first step into as many rows:
    ``pipeline_depth=2``, ``inflight_steps=2`` and ``inflight_steps=4,
    chunk_cycles=4``, one-shot and chunked, f32 arena (and int8 at
    ``inflight_steps=2``), greedy streams identical to the serial run's
    (gap rule) and to CPU ``generate``; sampled rows at ``inflight_steps=2``
    identical to the serial run's; a mid-flight snapshot / restore at
    ``inflight_steps=2`` and an extract / adopt (a sampled row among them)
    at ``pipeline_depth=2`` continue the streams. The fleet, 3B raw
    (``check_fleet``): ``ReplicatedServer`` at dp 2 on the card against
    ``generate`` (gap rule), launches counted per replica; a
    ``replica_step`` fault on group 0 mid-decode (one failover, the
    migrated count the rows it held), ``drain(1)`` then ``spawn_replica()``,
    each against the uninterrupted fleet; ``DisaggServer`` 1 + 1 with
    ``prefix_cache="hbm"``: every hand-off ``ok``, the bytes counted the
    streamed blocks'; an ``Autoscaler`` (injected load and clock) 2 -> 3 -> 2
    replicas; no stream dropped. Pipeline stages, 3B raw
    (``check_pipeline``), staged from the CPU copy onto the card repeated:
    at 2 and 4 stages and the ragged ``0:1,1:4``, the f32, int8 and fp8
    arenas' streams, one-shot and chunked, against the one-stage server's
    and the f32 ones against CPU ``generate`` (gap rules as above), every
    stage launching all three kernels; at 2 stages a radix hit,
    ``speculate=4``, a snapshot restored, an extract / adopt onto the
    one-stage engine, ``pipeline_generate`` and ``generate_many`` against
    CPU ``generate``; ``devices=None`` on the one-GPU host runs a 4-stage
    chain as one grouped stage. Tensor and context parallelism, 3B raw
    (``check_parallel``), staged from the CPU copy onto the card repeated
    and held to CPU ``generate`` (gap < 1e-4): ``generate_ids`` at tp 2,
    tp 4, pp 2 x tp 2 and dp 2 x pp 2; the served streams (one-shot and
    chunked) at tp 2 and pp 2 x tp 2, every shard launching the three
    kernels; ``speculate=3``, a prefix handle and the dense server at tp 2;
    GPT-2 small (4 layers) and int8 weights at tp 2; ``context_generate``
    at cp 2 and 4 over a 1000-token prompt;
    ``decode_from_cache(donate_cache=False)`` twice from one ring prefill;
    a sampled ``context_generate`` against the card's ``generate(seed=)``;
(d) write shard stores of seeded random full-width weights with the
    port's ``save_shards`` (Llama-3.2-3B bf16 at ``D_3B`` = 7 of its 28
    layers, and int8 and int4 layers quantized from the same bf16 weights,
    7 of them; GPT-2 small bf16, full depth; gemma-2B bf16, 9 of its 18
    layers; gemma-7B bf16, 4 of its 28 layers), load each
    with ``Engine.from_shards`` and serve its ``smoke_workload`` (8
    staggered requests, 64 new tokens each) through the paged server: the
    3B, GPT-2 and gemma-2B bf16 stores once per KV dtype (bf16, int8,
    fp8; the 3B's int8 and fp8 runs at 7 of its 28 layers),
    the others with a bf16 arena. In each run every request must finish, the
    block allocator must drain and every kernel (mode) of that path must
    have launched; each store's bytes on disk and resident after load are
    printed. The 3B (at 7 of its 28 layers) also serves the
    shared-prefix workload
    (``smoke_workload.SHARED_PREFIX``: a primer caches a 1024-token prefix,
    then 8 staggered requests, each the prefix and a suffix of 20-1000
    tokens), cold (``prefix_cache="off"``) and warm (hbm) in the bf16
    arena, warm in the int8 and fp8 arenas, printing TTFT p50/p99, decode
    tok/s and the hit rate; every warm request must hit the whole prefix,
    flash and the chunked-prefill kernel must launch, and after the tree is
    dropped no block may stay held. Then the host tier (prefixes A, B, A
    through a 40-block arena) and the disk tier (A, B, C, A, a 16-block
    host pool, the pool under ``TMPDIR``, removed after) must each show
    evictions to and hits from their tier. The 3B (at 7 of its 28
    layers) then serves the resilience workload
    (``smoke_workload.RESILIENCE``: the 8 prompts over 320 blocks):
    in each arena, killed once every row holds 8 tokens (``save_snapshot``
    under ``TMPDIR``, the server dropped, ``load_snapshot`` and ``restore``),
    every stream must equal the uninterrupted run's, the tokens streamed
    before the kill a prefix of it, and the restore's peak device memory
    stay under the resident bytes plus half an arena (snapshot bytes,
    capture, write, load and restore seconds, the first step's wall and the
    peak are printed); 4 live rows (2 greedy, 2 sampled at 0.8) migrated to
    a second server, which must launch flash and the chunked-prefill kernel
    for the re-prefills, every stream equal to the uninterrupted run's or
    first differing at a bf16 tie: greedy, a top-2 gap of at most one bf16
    ulp of the top logit; sampled, a noised top-2 margin (scaled logits
    plus the row's Gumbel draw) of at most ``MIGRATED_SAMPLED_ULPS`` = 2 bf16
    ulps of the top logit over the temperature; a transient plan at all five sites (identical
    streams, retries by site printed), a ``max_queue=4`` burst
    (``QueueFull``), a 50 ms deadline (``DeadlineExceeded``, blocks
    returned) and the health states SERVING, DEGRADED, SERVING, DRAINING;
    the registry's TTFT p50 / p99 beside the host clock's. gemma-2B serves
    the shared-prefix workload warm. The 3B and Llama-2-7B (8 of its 32
    layers, from a port-written bf16 store of ~3.7 GB, written once the
    earlier stores are gone; it also serves the standard workload in the
    bf16 arena; the 3B's speculative runs take 7 of its 28 layers) serve
    ``smoke_workload.SPECULATIVE`` (the 8 prompts, each a 64-token passage
    repeated, one-shot admission, K = 4) in each arena,
    beside the same one-shot server without speculation: every request
    finishes, flash and the decode kernel launch and chunked prefill does
    not; acceptance, tokens per verify step, decode tok/s, TTFT, launches
    and the share of streams identical to the non-speculative run's are
    printed, and in the bf16 arena a stream may first differ only at a near
    tie (top-2 gap <= ``TIE_ULPS`` = 4 bf16 ulps of the top logit). The 3B
    also runs
    speculative ``generate`` (K = 4, 7 rows up to 1800 tokens, capacity
    2048) beside ``generate``. Observability, the 3B store's 7 layers,
    bf16 arena: the
    standard workload traced, stepped by a pump thread, with a
    ``MetricsServer`` on 127.0.0.1 scraped during the run (``/metrics``
    with the step families, ``/statz``, ``/debugz``, ``/healthz``,
    ``/profilez`` and an 8-step ``/profilez`` capture); ``trace-report``
    over its span file must give 8 trees without orphans, each root
    holding ``prefill`` and ``decode``; every step must account as in
    [c], all three kernels launch, and the step-phase table is printed;
    then the workload served with tracing off, on, on, off (the flight
    recorder disabled and no span file when off; 7 of the 3B's 28 layers,
    a view of the same weights), the on / off decode tok/s
    ratio printed. The step loop, 3B at 7 of its 28 layers:
    the standard workload at
    (``inflight_steps``, ``chunk_cycles``) = (1, 1), (2, 1), (4, 1), (2, 4)
    and at ``pipeline_depth=2`` in the bf16 arena, and at (2, 1) in the
    int8 arena, each printing decode tok/s, TTFT p50 / p99, the stepline's
    phase, blocked, idle and unattributed shares and, after the timed run,
    the device-busy share of 12 decode steps at 8 live rows (kernel time
    under ``torch.profiler`` with CUDA activity over their wall); every
    request finishes, the blocks drain,
    all three kernels launch, every step accounts, and each stream equals
    the same arena's (1, 1) stream or first differs at a near tie
    (``TIE_ULPS``, from a recorded (1, 1) run made only then). The fleet,
    3B (``fleet_runs``; in process at 7 of its 28 layers, the
    daemon on the 7-layer store; ``smoke_workload.FLEET``: the standard prompts,
    every second pair swapped, 320 blocks per replica): the one-replica
    twin, ``ReplicatedServer`` dp 2 (every replica launching every kernel),
    dp 2 with a failover, a ``spawn_replica()`` and a drain mid-decode,
    ``DisaggServer`` 1 + 1, and the ``serve --data-parallel 2 --disagg``
    daemon over HTTP; streams held to the twin's (``TIE_ULPS``;
    ``MIGRATED_ULPS`` = 1 for the in-process runs' migrated and handed-off
    ones, submitted as the twin's), hand-offs ``ok``
    but for a prompt under one block (``cold``) and the 2048-token one
    (``fallback``, no layout), bytes the streamed blocks'; decode tok/s and
    TTFT beside the twin's, launches per replica, hand-off ms (queue /
    stream / lock) and bytes, the failover's wall and the spawn's seconds
    printed, and each 3B row of the JSON line carries ``replica_launches``.
    Pipeline stages, 3B at 7 of its 28 layers
    (``pipeline_runs``): staged from a host copy onto the card repeated,
    the standard workload over 8 rows at 2 and 4 stages and the ragged
    ``0:1,1:7``, a 1-stage run before the first and after each, every
    stream held to the 7-layer one-stage twin's
    (``TIE_ULPS``), every stage launching the three kernels; decode tok/s
    and TTFT beside the mean of the 1-stage runs on either side, launches,
    weight and head bytes per stage, the dispatch share and each
    repartition's seconds printed; then a ``serve --stages 2
    --tensor-parallel 2`` daemon over HTTP (the 7-layer store) takes
    ``:placement 4`` on stdin while round 1 of the workload streams, and
    serves round 2 on 4 stages (every request 200, both rounds held to the
    twin's; the swap's ``engine_placement_swap_seconds`` printed); each 3B
    row of the JSON line carries ``stage_launches``. Tensor parallelism,
    the 3B store's 7 layers (``parallel_runs``): the standard workload at
    tp 2, tp 4 and pp 2 x tp 2 (shards on the card repeated), a tp-1 run before the first
    and after each, every stream held to the twin's (``TIE_ULPS``), every
    shard launching each kernel as often as the tp-1 run, every decode step
    issuing two reduces a layer; decode tok/s and TTFT beside the mean of
    the tp-1 neighbours, launches per shard, reduces per step, weight bytes
    per shard and the dispatch share printed (the ``--tensor-parallel 2``
    daemon is the pipeline's, above); one 8160-token prompt through
    ``context_generate`` at cp 2 and 4 against ``generate`` (prefill wall,
    peak memory, the first 32 tokens); ``generate`` at capacity 4096 and
    288 (the segment rungs, decode tok/s); Llama-2-7B at full depth
    (weights made on the card: its store holds 8 layers) at tp 2 against
    its tp-1 run. The shard-shape rows of the JSON line carry their launches
    per shard (``shard_launches``). The profile part (``profile_runs``):
    ``profile --preset llama32_3b --hops 4 --suggest-stages 2`` in this
    process, Llama-3.2-3B at full width and depth (28 layers, bf16, weights
    made on the card, the hop ring 4 stages on the card): every prefill
    latency and both ``c_k`` finite and positive, the decode curve strictly
    rising, ``max_layers_fit`` (the card's memory) 28, the suggested
    placement covering 28 layers, ``profile.json`` read back by the
    planner with a finite ``predict_ttft``, and flash launched once a layer
    for every prefill forward the command ran (warm-ups and the decode
    curve's prompt included); hop rings of 1 and 2 beside the command's 4
    (``PROFILE_RING_REPEATS`` samples); then ``profile --shards`` on the
    3B's ``D_3B``-layer store with ``--cold-start``, which must time every
    layer. The lengths, latencies, ``c_k``, fits, verdict, hops, cold
    start, ``max_layers_fit`` and the part's seconds are printed beside the
    card's name and power limit;
(e) one JSON line of per-kernel, per-mode numbers, then the card's name and
    power limit, then the final ``{"ok": true, "device": ...}`` line.

Without a CUDA device, or without the rest of the repository next to it,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
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
# [d]'s depths, cut for the whole script's time limit (widths stay full):
# the 3B's store, the 3B's earlier paths (views of the store engine's
# first layers), gemma-2B's store and Llama-2-7B's store (its tp-2 run
# takes all 32 layers, made on the card)
D_3B, D_3B_VIEW, D_GEMMA2B, D_7B_STORE = 7, 7, 9, 8


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


def flash_ptxas(build_log: str) -> list:
    """``ptxas -v``'s registers and spill bytes of each flash instantiation
    (``flash_wgmma_kernel<D, fold>``, ``flash_f32_kernel<D>``), from the
    build's log: ``[{"kernel", "registers", "spill_stores", "spill_loads"}]``."""
    names = {}

    def label(mangled: str) -> str:
        w = re.search(r"flash_wgmma_kernelILi(\d+)ELb([01])E", mangled)
        if w:
            return f"{'fold' if w.group(2) == '1' else 'heads'} bf16 D={w.group(1)}"
        f = re.search(r"flash_f32_kernelILi(\d+)E", mangled)
        return f"f32 D={f.group(1)}" if f else ""

    cur = ""
    for ln in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            cur = label(m.group(1))
            if cur:
                names.setdefault(cur, {"kernel": cur})
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            names[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            names[cur]["registers"] = int(m.group(1))
    return sorted(names.values(), key=lambda r: r["kernel"])


def log_flash_ptxas(K) -> list:
    """Print each flash instantiation's registers and spills; every one must
    spill nothing."""
    rows = flash_ptxas(K.FLASH.build_log)
    for r in rows:
        log(f"[a] ptxas flash {r['kernel']:16s} registers={r.get('registers')} "
            f"spill_stores={r.get('spill_stores')} spill_loads={r.get('spill_loads')}")
    require(len(rows) == 9, f"flash: expected 9 instantiations in the ptxas log, got {rows}")
    spilled = [r for r in rows if r.get("spill_stores") != 0 or r.get("spill_loads") != 0]
    require(not spilled, f"flash: instantiations spill registers: {spilled}")
    return rows


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


def decode_case(cfg, dtype, device, gen, kv=None, ctx=None, T=64, S=1):
    """Decode rows (default 8, contexts 100-2048), block size 64, table
    width ``T`` (64: capacity 4096) with the tail trash-mapped; trash
    block 0 holds NaN/Inf (an Inf scale for a code arena). ``S`` > 1 is a
    paged verify: each row's last S context positions are its queries. The
    kernel gets ``nlive``, the blocks of each row's context."""
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
    q = torch.randn((B, S, Nh, D), generator=gen, device=device).to(dtype)
    qpos_np = (ctx[:, None] - S + np.arange(S)[None, :]).astype(np.int32)
    qpos = torch.from_numpy(qpos_np).to(device)
    scales = {}
    if kv:
        k, ks, v, vs = quantize_arena(k, v, kv)
        scales = {"k_scale": ks, "v_scale": vs}
    args = (q, k, v, torch.from_numpy(tbl).to(device), qpos, torch.from_numpy(kvpos).to(device))
    # the kernel reads each row's blocks up to its written frontier, as the
    # server passes them
    nlive = torch.from_numpy(np.asarray(nblk, np.int32)).to(device)
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * int(ctx.sum()) * Nkv * D * code_bytes(kv, isz)
              + tbl.nbytes + kvpos.nbytes + (2 * sum(nblk) * Nkv * 4 if kv else 0))
    flops = 4.0 * Nh * D * float((qpos_np.astype(np.int64) + 1).sum())
    return args, {"nlive": nlive, **scales}, scales, nbytes, flops, None


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


def flash_verify_case(cfg, dtype, device, gen, K=4, cap=2048, B=8, canonical=False):
    """Speculative ``generate``'s verify: B rows of S = K + 1 queries at
    positions pos0 .. pos0 + K (pos0 100-2000) over a dense cache of cap +
    K + 1 columns: the row's first pos0 columns written, the K + 1 scratch
    columns at the top holding the in-flight entries, sentinel between.
    With ``canonical`` (a dense server's verify) the in-flight entries sit
    at their own columns pos0 .. pos0 + K instead. The bound reads each
    row's visible columns once."""
    import torch

    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    S, C = K + 1, cap + K + 1
    pos0 = np.linspace(100, 2000, B).astype(int)
    kvpos = np.full((B, C), SENTINEL, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b, p in enumerate(pos0):
        kvpos[b, :p] = np.arange(p)
        if canonical:
            kvpos[b, p : p + S] = p + np.arange(S)
        else:
            kvpos[b, cap:] = p + np.arange(S)
        qpos[b] = p + np.arange(S)
    q = torch.randn((B, S, Nh, D), generator=gen, device=device).to(dtype)
    k = torch.randn((B, C, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, C, Nkv, D), generator=gen, device=device).to(dtype)
    qp, kp = torch.from_numpy(qpos).to(device), torch.from_numpy(kvpos).to(device)
    args = (q, k, v, qp, kp)
    isz = q.element_size()
    visible = int((pos0 + S).sum())
    nbytes = 2 * q.numel() * isz + 2 * visible * Nkv * D * isz + qpos.nbytes + kvpos.nbytes
    flops = 4.0 * Nh * D * float((qpos.astype(np.int64) + 1).sum())  # query at p sees p + 1 keys
    G = Nh // Nkv
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    mask = (kp[:, None, :] <= qp[:, :, None])[:, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return args, {}, {}, nbytes, flops, library


def flash_dense_case(cfg, dtype, device, gen, S=256, real=256, start=0, C=4096):
    """A dense server's prefill flash: one row's S queries at positions
    ``start`` .. ``start + real - 1`` (the rest of the bucket at the
    sentinel) over its whole C-column cache, of which the first ``start +
    real`` columns are written and the rest hold the sentinel: a one-shot
    admission (``start`` 0, ``real`` < S) or a chunk of a chunked one. A
    sentinel query sees every column, so with one the bound reads all C."""
    import torch

    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    q = torch.randn((1, S, Nh, D), generator=gen, device=device).to(dtype)
    k = torch.randn((1, C, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((1, C, Nkv, D), generator=gen, device=device).to(dtype)
    qpos = torch.full((1, S), SENTINEL, dtype=torch.int32, device=device)
    qpos[0, :real] = start + torch.arange(real, dtype=torch.int32, device=device)
    kvpos = torch.full((1, C), SENTINEL, dtype=torch.int32, device=device)
    kvpos[0, : start + real] = torch.arange(start + real, dtype=torch.int32, device=device)
    args = (q, k, v, qpos, kvpos)
    isz = q.element_size()
    cols = C if real < S else start + real
    nbytes = 2 * q.numel() * isz + 2 * cols * Nkv * D * isz + (qpos.numel() + C) * 4
    flops = 4.0 * Nh * D * ((start + 1) * real + real * (real - 1) / 2 + (S - real) * C)
    G = Nh // Nkv
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    mask = (kvpos[0][None, :] <= qpos[0][:, None])[None, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return args, {}, {}, nbytes, flops, library


def flash_prefix_case(cfg, dtype, device, gen, S=256, P=1024):
    """A one-shot radix hit's flash: the suffix bucket's S queries at
    positions P..P+S-1 over C = P + S keys, the first P the cached
    prefix's (fewer queries than keys)."""
    import torch

    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    C = P + S
    q = torch.randn((1, S, Nh, D), generator=gen, device=device).to(dtype)
    k = torch.randn((1, C, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((1, C, Nkv, D), generator=gen, device=device).to(dtype)
    qpos = (P + torch.arange(S, dtype=torch.int32, device=device))[None]
    kvpos = torch.arange(C, dtype=torch.int32, device=device)[None]
    args = (q, k, v, qpos, kvpos)
    isz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + (qpos.numel() + kvpos.numel()) * 4
    flops = 4.0 * Nh * D * (S * P + S * (S + 1) / 2)  # query i sees P + i + 1 keys
    G = Nh // Nkv
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    mask = (kvpos[0][None, :] <= qpos[0][:, None])[None, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return args, {}, {}, nbytes, flops, library


def prefill_prefix_case(cfg, dtype, device, gen, kv=None, P=1024, Sc=256, B=2):
    """A chunked radix hit's first chunk: B rows whose first P / 64 table
    entries are the same shared blocks (the cached prefix), each a chunk of
    Sc queries at columns and positions P..P+Sc-1 over its own private
    blocks, two stale blocks past the frontier, trash block 0 (NaN/Inf;
    0x7F codes and Inf scales) in the rest of a width-64 table; ``nlive``
    counts the prefix. The bound reads each distinct block once."""
    import torch

    BS, T = 64, 64
    Nh, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    npfx, nchunk = P // BS, Sc // BS
    NB = npfx + B * (nchunk + 2) + 1
    k = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((NB, BS, Nkv, D), generator=gen, device=device).to(dtype)
    k[0], v[0] = float("nan"), float("inf")
    tbl = np.zeros((B, T), np.int32)
    tbl[:, :npfx] = 1 + np.arange(npfx)
    for b in range(B):
        lo = 1 + npfx + b * (nchunk + 2)
        tbl[b, npfx : npfx + nchunk + 2] = lo + np.arange(nchunk + 2)
    kvpos = np.full((B, T * BS), SENTINEL, np.int32)
    kvpos[:, : P + Sc] = np.arange(P + Sc)
    qpos = np.tile(P + np.arange(Sc, dtype=np.int32), (B, 1))
    nlive = torch.full((B,), (P + Sc) // BS, dtype=torch.int32, device=device)
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
    read_blocks = npfx + B * nchunk
    nbytes = (2 * q.numel() * isz + 2 * read_blocks * BS * Nkv * D * code_bytes(kv, isz)
              + tbl.nbytes + kvpos.nbytes + qpos.nbytes
              + (2 * read_blocks * Nkv * 4 if kv else 0))
    flops = 4.0 * Nh * D * float((qpos.astype(np.int64) + 1).sum())
    return args, {"nlive": nlive, **scales}, scales, nbytes, flops, None


def prefix_kernel_cases(model: str) -> list:
    """The [b] cases of a prefix-cache hit at ``model``'s serving shapes
    (a 1024-token cached prefix, block size 64, chunks of 256): flash past
    the prefix, and for the 3B the chunked prefill over shared blocks in
    each KV mode. Same tuple as ``kernel_cases``."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention, paged_attention

    pre = ("llm_sharding_tpu/ops/paged_attention.py:689", "llm_sharding_tpu_torch/csrc/paged_prefill.cu")
    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    tag = {"llama32_3b": "", "gemma_2b": "gemma2b "}[model]
    cases = [("flash_attention", f"{tag}S=256 C=1280 past a 1024 prefix", flash_attention.flash_attention,
              attention.cached_attention, flash_prefix_case, *fla)]
    if model == "llama32_3b":
        for kv in (None, *KV_MODES):
            mode = f"[{kv}]" if kv else ""
            cases.append((f"paged_prefill{mode}", "chunk Sc=256 B=2 at column 1024, 16 shared blocks",
                          paged_attention.paged_prefill, paged_attention.paged_attention_xla,
                          lambda *a, kv=kv: prefill_prefix_case(*a, kv=kv), *pre))
    return cases


def profile_kernel_cases(model: str) -> list:
    """The [b] cases of the profiler's prefill sweep (``profile`` command,
    [d]'s profile part): flash at its extreme lengths, S = C = 8 and 512,
    one row. Same tuple as ``kernel_cases``."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention

    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    return [("flash_attention", f"profile sweep S=C={S} B=1", flash_attention.flash_attention,
             attention.cached_attention, lambda *a, S=S: flash_case(*a, S=S), *fla)
            for S in (8, 512)]


def spec_kernel_cases(model: str) -> list:
    """The [b] cases of speculative decoding at ``model``'s serving shapes
    (``smoke_workload.SPECULATIVE``: K = 4, block size 64, capacity 4096):
    the paged verify's decode at S = K + 1 = 5 over 8 rows of 100-2048
    tokens in each KV mode, launches from the [d] ``SPECULATIVE`` run
    (gemma-2B, G * S = 40: its standard run's decode launches); for
    the 3B also speculative ``generate``'s verify, flash at S = 5 over C =
    2048 + 5, launches from the [d] speculative ``generate`` run. Each
    tuple is ``kernel_cases``'s with the [d] workload appended."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention, paged_attention

    dec = ("llm_sharding_tpu/ops/paged_attention.py:484", "llm_sharding_tpu_torch/csrc/paged_attention.cu")
    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    tag = {"llama32_3b": "", "llama2_7b": "llama2-7b ", "gemma_2b": "gemma2b "}[model]
    # gemma-2B (G * S = 40 at K = 4) serves no speculative [d] run: its
    # verify rows take the decode kernel's launches of its standard run
    workload = "standard" if model == "gemma_2b" else "speculative"
    cases = []
    for kv in (None, *KV_MODES):
        mode = f"[{kv}]" if kv else ""
        cases.append((f"paged_attention{mode}", f"{tag}verify S=5 B=8 ctx 100-2048",
                      paged_attention.paged_attention, paged_attention.paged_attention_xla,
                      lambda *a, kv=kv: decode_case(*a, kv=kv, S=5), *dec, workload))
    if model == "llama32_3b":
        cases.append(("flash_attention", "verify S=5 B=8 C=2048+5 (spec generate)",
                      flash_attention.flash_attention, attention.cached_attention,
                      flash_verify_case, *fla, "spec_generate"))
    return cases


def dense_kernel_cases(model: str) -> list:
    """The [b] cases of dense serving at the 3B's shapes (capacity 4096, 8
    rows, chunks of 256; ``smoke_workload.serve(dense=True)``): flash at a
    one-shot admission's bucket (S = 256, 200 real) over a row's C = 4096
    columns, at a chunk (positions 1024-1279) over C = 4096, and at a dense
    verify (S = 5, B = 8) over C = 4096 + 5 with the in-flight entries at
    their own columns. Launches from the [d] dense run. Same tuple as
    ``spec_kernel_cases``."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention

    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    fa, plain = flash_attention.flash_attention, attention.cached_attention
    return [
        ("flash_attention", "dense S=256 200 real over C=4096 (admit)", fa, plain,
         lambda *a: flash_dense_case(*a, S=256, real=200), *fla, "dense"),
        ("flash_attention", "dense S=256 at 1024-1279 over C=4096", fa, plain,
         lambda *a: flash_dense_case(*a, S=256, real=256, start=1024), *fla, "dense"),
        ("flash_attention", "dense verify S=5 B=8 C=4096+5", fa, plain,
         lambda *a: flash_verify_case(*a, cap=4096, canonical=True), *fla, "dense"),
    ]


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
    if model == "llama2_7b":
        # Llama-2-7B: 32 heads over 32 KV heads (G = 1), head dim 128; bf16 only
        return [
            ("paged_attention", "llama2-7b decode B=8 ctx 100-2048", pa, xla, decode_case, *dec),
            ("paged_prefill", "llama2-7b chunk Sc=256 frontiers 256/2048", pp, xla,
             prefill_case, *pre),
            ("flash_attention", "llama2-7b S=C=2048 causal", fa, plain_fa,
             lambda *a: flash_case(*a, S=2048), *fla),
        ]
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


# the f32 flash case that is tabled (workload "f32": its launches come from
# the [c] f32 3B run), with SDPA in f32 beside it
F32_FLASH_ROW = ("llama32_3b", "S=C=2048 causal")


def phase_kernels(cfg, device, model: str, dtypes=("bfloat16", "float32"), prefix=False,
                  spec=False, dense=False, tp=False, profile=False, only=None) -> list:
    """Each kernel case of ``model`` against its plain version, with
    queries of each of ``dtypes``, timed; returns the tabled rows (bf16
    queries, and ``F32_FLASH_ROW`` in f32), tagged with the model and the
    [d] workload whose run counts their launches. ``prefix``: the
    prefix-cache hit's cases; ``spec``: speculative decoding's; ``dense``:
    dense serving's; ``tp``: a tensor shard's; ``profile``: the profiler's
    sweep's; ``only``: the cases of that kernel alone. A flash row names its
    route (``flash_route``)."""
    import torch

    from llm_sharding_tpu_torch.ops import flash_attention, paged_attention

    gen = torch.Generator(device=device).manual_seed(1234)
    if tp:
        cases = tp_kernel_cases(model)
    elif dense:
        cases = dense_kernel_cases(model)
    elif spec:
        cases = spec_kernel_cases(model)
    elif profile:
        cases = [(*c, "profile") for c in profile_kernel_cases(model)]
    else:
        workload = "shared_prefix" if prefix else "standard"
        cases = [(*c, workload) for c in (prefix_kernel_cases(model) if prefix
                                          else kernel_cases(model))]
    rows = []
    for name, label, fn, plain, make, replaces, source, workload in cases:
        if only is not None and name != only:
            continue
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
            if name == "flash_attention":
                q, k = args[0], args[1]
                design = flash_attention.flash_route(dtype, q.shape[1], k.shape[1], q.shape[2],
                                                     k.shape[2], q.shape[3])
            log(
                f"[b] {name:21s} {label:40s} {dname:8s} {design or '':5s} max_abs_err={err:.3g} tol={tol:g} "
                f"max_row_rel_err={rel:.3g} tol={tol_rel:g} {status} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"bound_ms={bms:.4f} ({by})"
            )
            require(err <= tol, f"{name} {label} {dname}: max abs error {err} > {tol}")
            require(rel <= tol_rel,
                    f"{name} {label} {dname}: max row-relative error {rel} > {tol_rel}")
            f32_row = dtype == torch.float32 and (model, label) == F32_FLASH_ROW
            if replaces is not None and (dtype == torch.bfloat16 or f32_row):
                rows.append(dict(
                    name=name, model=model, workload="f32" if f32_row else workload,
                    shape=label + (" f32" if f32_row else ""), route="cuda",
                    source=source, replaces=replaces,
                    launches=None, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms,
                    **({"design": design} if design else {}),
                ))
            del args, got, want
    return rows


def shard_plane(tbl, cp: int, shard: int):
    """Shard ``shard``'s plane of a table whose logical block ``j`` lives on
    shard ``j % cp`` (``ShardedBlockAllocator.alloc_at``'s stripes): the
    other shards' blocks map to trash block 0."""
    import torch

    cols = torch.arange(tbl.shape[1], device=tbl.device) % cp == shard
    return torch.where(cols[None, :], tbl, torch.zeros_like(tbl))


def check_stats(tag: str, got, want, dname: str) -> tuple:
    """A stats-mode triple against ``attn_stats``'s: dead rows exactly (0,
    -1e30, 0), live rows' m to 1e-3 and l to 1e-3 relative, and acc / l
    within the normalised outputs' limits. Returns the normalised
    output's max abs and row-relative errors."""
    import torch

    acc, m, l = got
    wacc, wm, wl = want
    for x in got:
        require(bool(torch.isfinite(x).all()), f"{tag}: non-finite stats output")
    dead = wl == 0
    require(bool((l[dead] == 0).all() and (m[dead] == -1e30).all() and (acc[dead] == 0).all()),
            f"{tag}: a row that sees no key is not (0, -1e30, 0)")
    live = ~dead
    m_err = (m[live] - wm[live]).abs().max().item() if live.any() else 0.0
    l_err = ((l[live] - wl[live]).abs() / wl[live]).max().item() if live.any() else 0.0
    require(m_err <= 1e-3, f"{tag}: row max off by {m_err}")
    require(l_err <= 1e-3, f"{tag}: exp-sum off by {l_err} relative")
    o = (acc / l.clamp_min(1e-30)[..., None])[live]
    w = (wacc / wl.clamp_min(1e-30)[..., None])[live]
    diff = (o - w).abs()
    err = diff.max().item()
    rel = (diff / w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)).max().item()
    require(err <= TOL_ABS[dname] and rel <= TOL_REL[dname],
            f"{tag}: normalised output off by {err} abs, {rel} row-relative")
    return err, rel, int(dead.sum())


def phase_stats_kernels(cfg, device, model: str, cp: int = 2) -> list:
    """[b] The stats mode of the decode and chunked-prefill kernels (what a
    context-parallel server's shards run), at ``model``'s decode and chunk
    shapes, on shard 0's plane of a table striped over ``cp`` shards:
    against ``attn_stats`` on the same inputs, every KV mode in bf16 and
    the query-dtype arena in f32 too. The bound counts the shard's own
    blocks only. Returns the rows of the bf16 arena in bf16 (the [d] cp
    runs serve that arena), tagged with the ``cp2`` workload whose [d] run
    counts their launches; the code arenas are checked and printed."""
    import torch

    from llm_sharding_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device=device).manual_seed(4321)
    dec = ("llm_sharding_tpu/ops/paged_attention.py:484",
           "llm_sharding_tpu_torch/csrc/paged_attention.cu")
    pre = ("llm_sharding_tpu/ops/paged_attention.py:689",
           "llm_sharding_tpu_torch/csrc/paged_prefill.cu")
    cases = []
    for kv in (None, *KV_MODES):
        mode = f"[{kv},stats]" if kv else "[stats]"
        cases += [
            (f"paged_attention{mode}", f"cp {cp} shard 0 decode B=8 ctx 100-2048",
             tpa.paged_attention, lambda *a, kv=kv: decode_case(*a, kv=kv), *dec),
            (f"paged_prefill{mode}", f"cp {cp} shard 0 chunk Sc=256 frontiers 256/2048",
             tpa.paged_prefill, lambda *a, kv=kv: prefill_case(*a, kv=kv), *pre),
        ]
    rows = []
    Nh, D = cfg.num_attention_heads, cfg.head_dim_
    for name, label, fn, make, replaces, source in cases:
        dtypes = (torch.bfloat16, torch.float32) if "[stats]" in name else (torch.bfloat16,)
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            args, kw, plain_kw, _, _, _ = make(cfg, dtype, device, gen)
            q, k, v, tbl, qpos, kvpos = args
            args = (q, k, v, shard_plane(tbl, cp, 0), qpos, kvpos)
            got = fn(*args, stats=True, **kw)
            want = tpa.attn_stats(*args, **plain_kw)
            torch.cuda.synchronize()
            err, rel, dead = check_stats(f"phase b {name} {label} {dname}", got, want, dname)
            ms = cuda_ms(lambda: fn(*args, stats=True, **kw), iters=20)
            plain_ms = cuda_ms(lambda: tpa.attn_stats(*args, **plain_kw), iters=3, warmup=1)
            # the shard's share: its owned live columns, each read once,
            # and the f32 triple written once
            tb = args[3].cpu().numpy()
            BS = k.shape[1]
            nl = kw["nlive"].cpu().numpy()
            kvp = kvpos.cpu().numpy()
            qp = qpos.cpu().numpy().astype(np.int64)
            isz, csz = q.element_size(), k.element_size()
            owned = sum(int(np.count_nonzero(tb[b, : nl[b]])) for b in range(tb.shape[0]))
            pairs = 0
            for b in range(tb.shape[0]):
                live = np.repeat(tb[b, : nl[b]] != 0, BS)
                kp = kvp[b, : nl[b] * BS][live]
                pairs += int((kp[None, :] <= qp[b][:, None]).sum())
            Nkv = k.shape[2]
            nbytes = (q.numel() * isz + 2 * owned * BS * Nkv * D * csz + tb.nbytes + kvp.nbytes
                      + q.numel() * 4 + 2 * q.numel() // D * 4
                      + (2 * owned * Nkv * 4 if "k_scale" in kw else 0))
            bms, by = bound(nbytes, 4.0 * Nh * D * pairs, dname)
            log(f"[b] {name:27s} {label:45s} {dname:8s} max_abs_err={err:.3g} "
                f"tol={TOL_ABS[dname]:g} max_row_rel_err={rel:.3g} tol={TOL_REL[dname]:g} ok "
                f"dead_rows={dead} owned_blocks={owned} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms=- bound_ms={bms:.4f} ({by})")
            if dtype == torch.bfloat16 and "[stats]" in name:
                rows.append(dict(
                    name=name, model=model, workload="cp2", shape=label, route="cuda",
                    source=source, replaces=replaces, launches=None, max_abs_err=err,
                    max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None,
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
def recorded_gaps(srv, tops=None, noised=None):
    """Record the top-2 logit gap of every token ``srv`` commits, per
    request id (the served run's own decision margins); with ``tops`` (a
    dict) also the top logit of each, and with ``noised`` (a dict) each
    sampled token's decision margin: the top-2 gap of its filtered scaled
    logits plus the Gumbel noise it is drawn with (from a copy of the row's
    generator; the draw itself is left to the server). A sampled token's
    margin is read where it is sampled; a verify's committed run takes
    each position's margin from that verify's logits."""
    import torch

    from llm_sharding_tpu_torch.ops.sampling import filter_rows, gumbel
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    gaps = collections.defaultdict(list)
    sample, fns, commit = serve_ops._sample_rows, serve_ops.model_fns, serve_ops.commit_verify
    last = {}

    def note(rid, top):
        gaps[rid].append(float(top[0] - top[1]))
        if tops is not None:
            tops.setdefault(rid, []).append(float(top[0]))

    def noised_margin(state, r, row_logits):
        g = torch.Generator(device=row_logits.device)
        g.set_state(state.rng[r].get_state())
        scaled = (row_logits / float(state.temp[r])).float()
        k, p = int(state.topk[r]), float(state.topp[r])
        if k > 0 or p < 1.0:
            scaled = filter_rows(scaled[None], torch.tensor([k]), torch.tensor([p]))[0]
        vals = torch.topk(scaled + gumbel(scaled.shape, g, scaled.device), 2, dim=-1).values
        return float(vals[0, 0] - vals[0, 1])

    def recording(state, rows, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        # a decode chunk samples every row (``rows`` is a range): only the
        # rows live on the device commit this step
        live = (~state.done).cpu() if isinstance(rows, range) else None
        for i, r in enumerate(rows):
            if live is None or (live[i] and srv._req[r] is not None):
                note(srv._req[r].id, top[i])
                if noised is not None and state.rng[r] is not None:
                    noised.setdefault(srv._req[r].id, []).append(
                        noised_margin(state, r, logits[i : i + 1]))
        return sample(state, rows, logits)

    def fns_recording(cfg):
        f = fns(cfg)

        def final_logits(*a):
            logits = f.final_logits(*a)
            last["top"] = torch.topk(logits.float(), 2, dim=-1).values.cpu()
            return logits

        return f._replace(final_logits=final_logits)

    def commit_recording(cfg, state, rows, log):
        if state is srv.state and "top" in last:  # pipeline stages: no one-stage logits
            for i, r in enumerate(rows):
                for j in range(int((log[i] >= 0).sum())):
                    note(srv._req[r].id, last["top"][i, j])
        return commit(cfg, state, rows, log)

    serve_ops._sample_rows = recording
    serve_ops.model_fns = fns_recording
    serve_ops.commit_verify = commit_recording
    try:
        yield gaps
    finally:
        serve_ops._sample_rows, serve_ops.model_fns, serve_ops.commit_verify = sample, fns, commit


def served_streams(eng, prompts, max_new: int, capacity: int = 2048, embed: bool = False,
                   **serve_kw):
    """Staggered submits (the even-indexed prompts, two steps, then the
    odd-indexed ones) on a fresh server (paged unless ``serve_kw`` sets
    ``kv_block_size=None, kv_blocks=None``), as ids or, with ``embed``, as
    ``submit_embedding`` of ``eng.embed_prompt``; returns each request's
    tokens and sampled-token gaps, in prompt order."""
    srv = eng.serve(**{**dict(capacity=capacity, batch_per_slot=4, kv_block_size=64,
                              kv_blocks=160, prefill_chunk=256), **serve_kw})
    order = [*range(0, len(prompts), 2), *range(1, len(prompts), 2)]
    first = (len(prompts) + 1) // 2

    def submit(p):
        if embed:  # the privacy entry: the prompt's hidden states
            return srv.submit_embedding(eng.embed_prompt(p)[0], max_new)
        return srv.submit(p, max_new)

    with recorded_gaps(srv) as gaps:
        reqs = [submit(prompts[i]) for i in order[:first]]
        srv.step()
        srv.step()
        reqs += [submit(prompts[i]) for i in order[first:]]
        srv.run_until_idle()
    if srv.paged:
        srv._alloc.check()
        require(srv._alloc.in_use == 0, "phase c: KV blocks leaked")
    by_prompt = dict(zip(order, reqs))
    n = len(prompts)
    return [by_prompt[i].tokens for i in range(n)], [gaps[by_prompt[i].id] for i in range(n)]


def check_against_generate(tag: str, eng, prompts, lens, max_new: int, capacity: int = 2048,
                           oracle=None, **serve_kw) -> list:
    """The served greedy streams (one-shot and chunked admissions; the
    server's options ``serve_kw``) must be the ``generate`` tokens of
    ``oracle`` (default: the same engine); a mismatch passes only where the
    oracle's top-2 logit gap is < 1e-4. Returns the oracle's streams."""
    oracle = oracle or eng
    served, _ = served_streams(eng, prompts, max_new, capacity=capacity, **serve_kw)
    wants = []
    for i, got in enumerate(served):
        want = oracle.generate_ids(prompts[i], max_new)
        w = want.tokens[0, lens[i] : want.lengths[0]].tolist()
        wants.append(w)
        chunk = serve_kw.get("prefill_chunk", 256)
        path = "chunked" if chunk and lens[i] > chunk else "one-shot"
        if w == got:
            log(f"[c] {tag} prompt {lens[i]:5d} ({path}): {len(w)} tokens identical to generate")
            continue
        step = next(j for j in range(min(len(w), len(got))) if w[j] != got[j])
        gap = top2_gap(oracle.cfg, oracle.params,
                       np.concatenate([prompts[i], np.asarray(w[:step], np.int32)]))
        log(f"[c] {tag} prompt {lens[i]:5d} ({path}): first mismatch at step {step}, "
            f"oracle top-2 gap {gap:.3g}")
        require(gap < 1e-4, f"phase c {tag}: served tokens differ from generate (gap {gap})")
    return wants


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


# ------------------------------------------------- the front door ([c], [d])

DENSE = dict(kv_block_size=None, kv_blocks=None)


def http_post(port: int, path: str, body: dict, headers=None, timeout: float = 600.0):
    """A JSON POST to the local ingress: ``(status, events or body,
    first_token_s, done_s)`` with the client's perf_counter times; with
    ``"stream": true`` in ``body`` the SSE events up to ``[DONE]``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if not body.get("stream") or resp.status != 200:
            data = resp.read()
            return resp.status, json.loads(data) if data else None, None, time.perf_counter()
        events, first = [], None
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if line.strip():
                ev = json.loads(line.strip()[len(b"data: "):])
                if first is None and ev["choices"][0]["token_ids"]:
                    first = time.perf_counter()
                events.append(ev)
        return resp.status, events, first, time.perf_counter()
    finally:
        conn.close()


def response_tokens(tag: str, status: int, got) -> list:
    """The token ids of a whole response or an SSE event list; anything but
    200 and a clean finish fails the phase."""
    require(status == 200, f"{tag}: HTTP {status}: {got}")
    if isinstance(got, dict):
        return got["choices"][0]["token_ids"]
    require(got and got[-1]["choices"][0]["finish_reason"] in ("length", "stop"),
            f"{tag}: the stream ended without a clean finish: {got[-1:]}")
    return [t for ev in got for t in ev["choices"][0]["token_ids"]]


def check_frontdoor(tag: str, eng, prompts, lens, max_new: int) -> None:
    """[c] Dense serving against ``generate`` (one-shot and chunked, then
    ``speculate=4`` one-shot), ``submit_embedding`` of ``embed_prompt``
    against ``submit`` on dense and paged one-shot servers (identical), and
    an in-process ingress on 127.0.0.1 over a dense and a paged server:
    completions whole and streamed, and an embeddings request, each sent
    alone, identical to the same server's ``submit`` stream sent alone."""
    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.runtime.ingress import start_ingress

    K.reset_launch_counts()
    check_against_generate(f"{tag} dense", eng, prompts, lens, max_new, **DENSE)
    check_against_generate(f"{tag} dense speculate=4", eng, prompts, lens, max_new,
                           prefill_chunk=None, speculate=4, **DENSE)
    counts = K.launch_counts()
    require(counts["flash_attention"] > 0, f"phase c {tag} dense: flash was never launched")
    require(counts["paged_attention"] == counts["paged_prefill"] == 0,
            f"phase c {tag} dense: a paged kernel launched on a dense server: {counts}")
    for layout, kw in (("dense", DENSE), ("paged", {})):
        ids, _ = served_streams(eng, prompts, max_new, prefill_chunk=None, **kw)
        emb, _ = served_streams(eng, prompts, max_new, embed=True, prefill_chunk=None, **kw)
        require(emb == ids, f"phase c {tag} {layout}: submit_embedding streams differ from submit")
        log(f"[c] {tag} {layout}: submit_embedding(embed_prompt(p)) streams identical to "
            f"submit(p) for {len(prompts)} prompts")
        srv = eng.serve(capacity=2048, batch_per_slot=4, prefill_chunk=256, **kw)
        want = [srv.result(srv.submit(p, max_new)) for p in prompts]
        ing = start_ingress(srv, port=0, poll_interval_s=0.0005)
        try:
            for i, p in enumerate(prompts):
                for stream in (False, True):
                    got = response_tokens(f"phase c {tag} {layout} http", *http_post(
                        ing.port, "/v1/completions",
                        {"prompt": [int(t) for t in p], "max_tokens": max_new,
                         "stream": stream})[:2])
                    require(got == want[i], f"phase c {tag} {layout}: HTTP stream {i} "
                            f"(stream={stream}) differs from submit's")
                    log(f"[c] {tag} {layout} ingress prompt {lens[i]:5d} "
                        f"{'SSE' if stream else 'whole'}: {len(got)} tokens identical to submit")
            emb = eng.embed_prompt(prompts[0])[0].float().cpu().numpy().tolist()
            for stream in (False, True):
                got = response_tokens(f"phase c {tag} {layout} embeddings", *http_post(
                    ing.port, "/v1/embeddings",
                    {"input": emb, "max_tokens": max_new, "stream": stream})[:2])
                require(got == want[0], f"phase c {tag} {layout}: /v1/embeddings (stream="
                        f"{stream}) differs from submit's")
            log(f"[c] {tag} {layout} ingress /v1/embeddings whole and SSE: identical to submit")
        finally:
            ing.stop()
            srv.close()


# ------------------------------------------------- observability ([c], [d])

class Pump:
    """A step pump on a thread of its own, as a daemon runs one: steps the
    server until stopped, sleeping a millisecond when it is idle."""

    def __init__(self, srv):
        import threading

        self.srv, self.stop = srv, threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.error = None

    def _run(self):
        try:
            while not self.stop.is_set():
                if not self.srv.step():
                    time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001 — re-raised by __exit__
            self.error = e

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=120)
        require(not self.thread.is_alive(), "the step pump did not stop")
        if self.error is not None:
            raise self.error


def wait_done(reqs, tag: str, timeout_s: float = 300.0) -> None:
    t0 = time.perf_counter()
    while not all(r.done for r in reqs):
        require(time.perf_counter() - t0 < timeout_s, f"{tag}: requests did not finish")
        time.sleep(0.005)
    for r in reqs:
        require(r.error is None, f"{tag}: request {r.id} failed: {r.error!r}")


def check_step_records(tag: str, recs: list) -> None:
    """The stepline invariant on every card step (``sum(phases) + blocked
    + unattributed == wall``), a device wait (``blocked_s > 0``: the CUDA
    event of each log it read, waited on even when the log has landed) on
    every step that read tokens, and the unattributed share under 5 % of
    the wall."""
    require(bool(recs), f"{tag}: no step records")
    for r in recs:
        host = sum(r["phases"].values())
        resid = abs(r["wall_s"] - (host + r["blocked_s"] + r["unattributed_s"]))
        require(resid < 1e-9, f"{tag}: step accounting off by {resid} s")
        require("fetch" not in r["phases"] or r["blocked_s"] > 0.0,
                f"{tag}: a step read tokens without a device wait: {r}")
    wall = sum(r["wall_s"] for r in recs)
    unatt = sum(r["unattributed_s"] for r in recs)
    require(unatt < 0.05 * wall, f"{tag}: unattributed {unatt / wall:.1%} of the step wall")


def check_trace_trees(tag: str, paths: list, reqs: list, children=("prefill", "decode")) -> int:
    """One tree per request in the merged span files: its ``request`` root
    (the request's own span id), no orphan, ``children`` under the root.
    Returns the number of traces in the files."""
    from llm_sharding_tpu_torch.obs.report import build_traces, load_events

    traces = build_traces(load_events(paths))
    for r in reqs:
        tr = traces.get(r.trace.trace_id)
        require(tr is not None, f"{tag}: request {r.id} left no trace")
        require(tr.root["span"] == "request" and tr.root["span_id"] == r.trace.span_id,
                f"{tag}: request {r.id}'s tree has root {tr.root}")
        require(tr.orphans() == [], f"{tag}: request {r.id} has orphan spans {tr.orphans()}")
        kids = {e["span"] for e in tr.children_of(r.trace.span_id)}
        require(set(children) <= kids, f"{tag}: request {r.id}'s root holds only {sorted(kids)}")
    return len(traces)


def check_observability(tag: str, eng, prompts, lens, max_new: int, trace_root: str) -> None:
    """[c] The served streams of ``served_streams``' schedule with a
    ``trace_path`` and a deep capture armed (``stepline_capture(4,
    trace_dir=)`` on a second thread: ``torch.profiler`` with CUDA
    activity brackets the window) must be identical to the streams
    without; the capture is complete and its Chrome trace holds kernels;
    each request gives one tree; every step accounts. The serving thread
    takes the window's four steps, then waits until the capture has
    stopped the profiler and written its trace before it steps on: that
    export holds the interpreter for a while, and a step running beside it
    would count the stall as unattributed time."""
    import threading

    base, _ = served_streams(eng, prompts, max_new)
    path = os.path.join(trace_root, "c_trace.jsonl")
    srv = eng.serve(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                    prefill_chunk=256, trace_path=path)
    order = [*range(0, len(prompts), 2), *range(1, len(prompts), 2)]
    first = (len(prompts) + 1) // 2
    out = {}
    exported = threading.Event()  # set once stepline_capture has returned

    def drive():
        """``served_streams``' schedule, once the capture is armed: the
        window is steps 1-4; the steps after it wait for the export."""
        try:
            t0 = time.perf_counter()
            while not srv.stepline.armed:
                require(time.perf_counter() - t0 < 60, f"phase c {tag}: capture not armed")
                time.sleep(0.001)
            reqs = [srv.submit(prompts[i], max_new) for i in order[:first]]
            srv.step()
            srv.step()
            reqs += [srv.submit(prompts[i], max_new) for i in order[first:]]
            srv.step()
            srv.step()
            require(exported.wait(300), f"phase c {tag}: the capture never returned")
            srv.run_until_idle()
            out["reqs"] = reqs
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=drive)
    t.start()
    # the profiler starts and stops on this thread; the steps run on the other
    try:
        bundle = srv.stepline_capture(4, wait_s=300,
                                      trace_dir=os.path.join(trace_root, "c_prof"))
    finally:
        exported.set()
    t.join(timeout=600)
    require(not t.is_alive(), f"phase c {tag}: the serving thread did not return")
    if "error" in out:
        raise out["error"]
    srv.close()
    reqs = out["reqs"]
    by_prompt = dict(zip(order, reqs))
    got = [by_prompt[i].tokens for i in range(len(prompts))]
    require(got == base, f"phase c {tag}: traced and captured streams differ from the plain run")
    require(bundle["complete"] and bundle["steps_captured"] == 4,
            f"phase c {tag}: capture incomplete: {bundle['steps_captured']} steps")
    with open(bundle["device_trace"]) as fh:
        kernels = sum(1 for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel")
    require(kernels > 0, f"phase c {tag}: the capture's trace holds no CUDA kernel")
    check_step_records(f"phase c {tag}", srv.stepline_snapshot())
    check_trace_trees(f"phase c {tag}", [path], reqs)
    log(f"[c] {tag}: traced streams with a 4-step capture armed identical to the plain run's; "
        f"the capture's trace holds {kernels} kernel events; {len(reqs)} trees, no orphans")


def to_device(tree, device):
    """A params tree (dicts, lists, tensors) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def prefix_streams(eng, primer, prompts, max_new: int, cache: str = "off", pool=None,
                   **serve_kw):
    """The prefix-cache pattern on a fresh server (``served_streams``'s
    shape): the primer run to idle, so its prefix is in the tree; with a
    host or disk tier every node then demoted to that tier; then
    ``prompts`` submitted together. Returns each request's tokens and
    sampled-token gaps, and the cache's stats. Both invariants must hold
    and, once the tree is dropped, no block may stay held."""
    srv = eng.serve(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                    prefill_chunk=256, prefix_cache=cache,
                    **({"disk_pool_dir": pool} if cache == "disk" else {}), **serve_kw)
    with recorded_gaps(srv) as gaps:
        srv.result(srv.submit(primer, max_new))
        if cache in ("host", "disk"):
            srv._radix.demote_all(to_disk=cache == "disk")
        reqs = [srv.submit(p, max_new) for p in prompts]
        srv.run_until_idle()
    srv._alloc.check()
    stats = srv.prefix_cache_stats()
    if srv._radix is not None:
        srv._radix.check()
        require(srv._alloc.in_use == srv._radix.device_blocks, "phase c: row blocks leaked")
        srv._radix.drop_all()
    require(srv._alloc.in_use == 0, "phase c: KV blocks leaked")
    return [r.tokens for r in reqs], [gaps[r.id] for r in reqs], stats


def hold_streams(tag: str, got: list, want: list, prompts, oracle, limit: float = 1e-4,
                 gaps=None) -> None:
    """Each stream of ``got`` equals ``want``'s, or first differs where the
    oracle's top-2 logit gap is below ``limit``: ``gaps`` (the ``want``
    run's own, recorded) when given, else a fresh prefill on ``oracle``."""
    for i, (g, w) in enumerate(zip(got, want)):
        n = len(prompts[i])
        if g == w:
            log(f"[c] {tag} prompt {n:5d}: {len(w)} tokens identical")
            continue
        require(len(g) == len(w), f"phase c {tag}: stream lengths differ")
        step = next(j for j in range(len(w)) if w[j] != g[j])
        gap = gaps[i][step] if gaps is not None else top2_gap(
            oracle.cfg, oracle.params, np.concatenate([prompts[i], np.asarray(w[:step], np.int32)]))
        log(f"[c] {tag} prompt {n:5d}: first mismatch at step {step}, top-2 gap {gap:.3g}")
        require(gap < limit, f"phase c {tag}: streams differ (gap {gap})")


def check_prefix_cache(tag: str, eng, cpu_eng, rng, pool_root: str) -> None:
    """Prefix-cache hits on the card: a 512-token prefix (8 blocks) cached
    by a primer, then a one-shot hit (suffix 40: flash at S = 64 past the
    prefix) and a chunked hit (suffix 500: chunks from column 512), in each
    tier (hbm; host and disk, where the hits stream the prefix back). The
    streams must equal the cache-off server's and ``generate``'s on the
    CPU (top-2 gap rule); with int8 and fp8 arenas the kernels' cached
    streams must equal the plain versions' (gap < 1e-3)."""
    V = eng.cfg.vocab_size
    prefix = rng.integers(0, V, 512).astype(np.int32)
    primer = np.concatenate([prefix, rng.integers(0, V, 64).astype(np.int32)])
    prompts = [np.concatenate([prefix, rng.integers(0, V, n).astype(np.int32)]) for n in (40, 500)]
    max_new = 16
    off, _, _ = prefix_streams(eng, primer, prompts, max_new)
    cpu = []
    for p in prompts:
        r = cpu_eng.generate_ids(p, max_new)
        cpu.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
    hold_streams(f"{tag} cache off vs CPU generate", off, cpu, prompts, cpu_eng)
    for cache in ("hbm", "host", "disk"):
        pool = tempfile.mkdtemp(prefix="chip_smoke_pool_", dir=pool_root)
        got, _, st = prefix_streams(eng, primer, prompts, max_new, cache, pool)
        shutil.rmtree(pool)
        tier = {"hbm": None, "host": "host_hit_tokens", "disk": "disk_hit_tokens"}[cache]
        log(f"[c] {tag} prefix_cache={cache}: hit {st['hit_tokens']} of {st['eligible_tokens']} "
            f"tokens, host hits {st['host_hit_tokens']}, disk hits {st['disk_hit_tokens']}")
        require(st["hit_tokens"] == 2 * 512, f"phase c {tag} {cache}: hits {st}")
        require(tier is None or st[tier] == 512, f"phase c {tag} {cache}: tier hits {st}")
        hold_streams(f"{tag} {cache} vs cache off", got, off, prompts, eng)
        hold_streams(f"{tag} {cache} vs CPU generate", got, cpu, prompts, cpu_eng)
    for kv in KV_MODES:
        kernel, _, _ = prefix_streams(eng, primer, prompts, max_new, "hbm", kv_dtype=kv)
        plain, gaps, _ = prefix_streams(eng, primer, prompts, max_new, "hbm", kv_dtype=kv,
                                        paged_attn="plain")
        hold_streams(f"{tag} {kv} cached, kernels vs plain", kernel, plain, prompts, None,
                     limit=1e-3, gaps=gaps)


def resilience_server(eng, **kw):
    """The [c] resilience checks' server: ``served_streams``'s shape
    (``kw`` may override its options)."""
    return eng.serve(**{**dict(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                               prefill_chunk=256), **kw})


def step_until(srv, reqs, n: int) -> None:
    """Step ``srv`` until every request of ``reqs`` holds ``n`` tokens or is
    done. A step without progress fails the phase unless the requests got
    there meanwhile: with ``inflight_steps`` > 1 the completion sidecar
    applies logs between the loop's test and the step, and may finish every
    request (the step then finds nothing to do)."""
    while any(not r.done and len(r.tokens) < n for r in reqs):
        if not srv.step():
            require(all(r.done or len(r.tokens) >= n for r in reqs),
                    "a step made no progress")


def interrupted_run(eng, prompts, max_new: int, interrupt=None, sampling=None, gaps=False,
                    **serve_kw):
    """Submit every prompt at once (``sampling[i]``: request ``i``'s sampling
    options), step until each request holds 4 tokens, then hand the server
    and its requests to ``interrupt``, which returns the servers and the
    requests to run on; run those to idle. Returns each request's tokens
    (and, with ``gaps``, the run's recorded top-2 gaps: uninterrupted runs
    only). Every server's allocator must drain, and its completion sidecar
    (``inflight_steps`` > 1) be alive."""
    srv = resilience_server(eng, **serve_kw)
    ctx = recorded_gaps(srv) if gaps else contextlib.nullcontext(None)
    with ctx as recorded:
        reqs = [srv.submit(p, max_new, **(sampling or {}).get(i, {}))
                for i, p in enumerate(prompts)]
        step_until(srv, reqs, 4)
        servers = [srv]
        if interrupt is not None:
            servers, reqs = interrupt(srv, reqs)
        for s in servers:
            s.run_until_idle()
            s._alloc.check()
            require(s._radix is not None or s._alloc.in_use == 0, "phase c: KV blocks leaked")
            require(s._sidecar is None or (s._sidecar.is_alive() and s._sidecar.error is None),
                    "phase c: the completion sidecar died")
    tokens = [list(r.tokens) for r in reqs]
    return (tokens, [recorded[r.id] for r in reqs]) if gaps else tokens


def restore_interrupt(eng):
    """Snapshot the server, drop it, restore a fresh one on ``eng``."""
    import torch

    from llm_sharding_tpu_torch.runtime.server import PipelineServer

    def interrupt(srv, reqs):
        snap = srv.snapshot()
        srv.close()
        torch.cuda.empty_cache()
        srv2 = PipelineServer.restore(eng, snap)
        by_id = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
        return [srv2], [by_id[r.id] for r in reqs]

    return interrupt


def migrate_interrupt(eng, **serve_kw):
    """Extract every live request from the server and adopt it on a second
    server on the same engine; the same request objects stream on."""
    def interrupt(srv, reqs):
        dst = resilience_server(eng, **serve_kw)
        for r in reqs:
            require(not r.done, "phase c: a request to migrate finished early")
            dst.adopt(srv.extract(r), r)
        return [srv, dst], reqs

    return interrupt


def check_resilience(tag: str, eng, cpu_eng, prompts, cpu_want) -> None:
    """[c] on the 4-layer f32 3B: snapshot, drop, restore mid-decode in each
    arena (restored streams equal the uninterrupted ones exactly, the same
    launches on the same bytes; the f32 arena's also hold to CPU
    ``generate``); ``extract`` / ``adopt`` of 2 greedy and 2 sampled rows
    to a second server (greedy: the uninterrupted streams and CPU
    ``generate`` under the top-2 gap rule, a re-prefill is not the decode's
    arithmetic; sampled: the port's ``generate(seed=)`` on the card); a
    transient plan at all five sites (exact); a permanent ``request_apply``
    fault on one request (it fails, the others hold under the gap rule);
    and a snapshot with ``prefix_cache="hbm"`` after which a new request
    hits the restored tree."""
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan, FaultSpec, PermanentFault

    max_new = 16
    for kv in ("bf16", *KV_MODES):
        base, gaps = interrupted_run(eng, prompts, max_new, gaps=True, kv_dtype=kv)
        got = interrupted_run(eng, prompts, max_new, restore_interrupt(eng), kv_dtype=kv)
        require(got == base, f"phase c {tag} {kv}: restored streams differ from the uninterrupted")
        log(f"[c] {tag} kv {kv}: snapshot / drop / restore mid-decode, {len(got)} streams "
            f"identical to the uninterrupted run")
        if kv == "bf16":
            f32_base, f32_gaps = base, gaps
            hold_streams(f"{tag} restored vs CPU generate", got, cpu_want, prompts, cpu_eng)
    sampling = {2: dict(temperature=0.8, seed=5), 3: dict(temperature=0.8, seed=6)}
    sbase, sgaps = interrupted_run(eng, prompts, max_new, sampling=sampling, gaps=True)
    got = interrupted_run(eng, prompts, max_new, migrate_interrupt(eng), sampling=sampling)
    hold_streams(f"{tag} migrated greedy vs uninterrupted", got[:2], sbase[:2], prompts, None,
                 gaps=sgaps)
    hold_streams(f"{tag} migrated greedy vs CPU generate", got[:2], cpu_want[:2], prompts,
                 cpu_eng)
    for i in (2, 3):
        want = eng.generate_ids(prompts[i], max_new, **sampling[i])
        w = want.tokens[0, len(prompts[i]) : want.lengths[0]].tolist()
        require(got[i] == w, f"phase c {tag}: migrated sampled stream {i} differs from generate")
        require(sbase[i] == w, f"phase c {tag}: served sampled stream {i} differs from generate")
    log(f"[c] {tag}: 2 greedy + 2 sampled rows migrated mid-decode; sampled streams identical "
        f"to generate(seed=) on the card")
    plan = FaultPlan([
        FaultSpec("admit_dispatch", "transient", at=(0, 2)),
        FaultSpec("chunk_dispatch", "transient", at=(0, 3, 7)),
        FaultSpec("log_fetch", "transient", at=(1, 5)),
        FaultSpec("snapshot_write", "transient", at=(0,)),
        FaultSpec("request_apply", "transient", at=(2,), key=1),
    ])

    def snapshot_once(srv, reqs):
        srv.enable_auto_snapshot(tempfile.mkdtemp(prefix="chip_smoke_snap_"), 0.0)
        srv.step()
        shutil.rmtree(srv._snapshot_path, ignore_errors=True)
        srv.enable_auto_snapshot(None, None)
        return [srv], reqs

    got = interrupted_run(eng, prompts, max_new, snapshot_once, fault_plan=plan,
                          fault_backoff_s=0.0)
    require(got == f32_base, f"phase c {tag}: streams under transient faults differ")
    require(plan.stats()["total_fires"] == 9, f"phase c {tag}: fires {plan.stats()}")
    log(f"[c] {tag}: transient faults at all five sites ({plan.stats()['total_fires']} fired, "
        f"all retried): streams identical to the run without faults")
    victim = {}

    def keep(srv, reqs):
        victim.update(req=reqs[1])
        return [srv], reqs

    got = interrupted_run(eng, prompts, max_new, keep, fault_plan=FaultPlan(
        [FaultSpec("request_apply", "permanent", key=1, from_call=3)]), fault_backoff_s=0.0)
    require(isinstance(victim["req"].error, PermanentFault) and len(got[1]) == 3,
            f"phase c {tag}: the poisoned request did not fail at its 4th token")
    others = [0, 2, 3]
    hold_streams(f"{tag} beside a failed request", [got[i] for i in others],
                 [f32_base[i] for i in others], [prompts[i] for i in others], None,
                 gaps=[f32_gaps[i] for i in others])
    log(f"[c] {tag}: a permanent request_apply fault failed its request only")
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, eng.cfg.vocab_size, 512).astype(np.int32)
    primer = np.concatenate([prefix, rng.integers(0, eng.cfg.vocab_size, 64).astype(np.int32)])
    hits = [np.concatenate([prefix, rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)])
            for n in (40, 500)]
    srv = resilience_server(eng, prefix_cache="hbm")
    srv.result(srv.submit(primer, max_new))
    r0 = srv.submit(hits[0], max_new)
    step_until(srv, [r0], 4)
    [srv], [r0] = restore_interrupt(eng)(srv, [r0])
    before = srv.prefix_cache_stats()["hit_tokens"]
    r1 = srv.submit(hits[1], max_new)
    srv.run_until_idle()
    st = srv.prefix_cache_stats()
    require(st["hit_tokens"] == before + 512, f"phase c {tag}: restored tree not hit: {st}")
    srv._radix.check()
    srv._alloc.check()
    want = []
    for p in hits:
        w = cpu_eng.generate_ids(p, max_new)
        want.append(w.tokens[0, len(p) : w.lengths[0]].tolist())
    hold_streams(f"{tag} hit on a restored tree vs CPU generate", [r0.tokens, r1.tokens], want,
                 hits, cpu_eng)
    srv.close()


def check_async_exec(tag: str, eng, cpu_eng, prompts, cpu_want) -> None:
    """[c] The step loop's knobs on the 4-layer f32 3B. Every request is
    submitted before the first step into as many rows as requests
    (``interrupted_run``), so the admission groups are the same at every
    depth. ``pipeline_depth=2``, ``inflight_steps=2`` and ``inflight_steps=4,
    chunk_cycles=4``, one-shot (no ``prefill_chunk``) and chunked
    (``prefill_chunk=256``: the two long prompts), plus the int8 arena at
    ``inflight_steps=2``: greedy streams identical to the serial run's of
    the same arena and path, or first differing where its top-2 gap is <
    1e-4, and (f32 arena) to CPU ``generate`` under the same rule. Sampled
    rows at ``inflight_steps=2`` identical to the serial run's; a
    mid-flight snapshot / restore at ``inflight_steps=2`` and an extract /
    adopt at ``pipeline_depth=2`` (a sampled row among the four: identical;
    greedy rows: the gap rule, a re-prefill is not the decode's
    arithmetic) continue the serial run's streams."""
    max_new = 16
    knobs = (dict(pipeline_depth=2), dict(inflight_steps=2),
             dict(inflight_steps=4, chunk_cycles=4))
    for path, chunk in (("one-shot", None), ("chunked", 256)):
        for kv in ("bf16", "int8"):
            base, gaps = interrupted_run(eng, prompts, max_new, gaps=True, prefill_chunk=chunk,
                                         kv_dtype=kv)
            for kw in knobs if kv == "bf16" else (dict(inflight_steps=2),):
                name = f"{tag} {path} kv {kv} " + " ".join(f"{k}={v}" for k, v in kw.items())
                got = interrupted_run(eng, prompts, max_new, prefill_chunk=chunk, kv_dtype=kv,
                                      **kw)
                hold_streams(f"{name} vs serial", got, base, prompts, None, gaps=gaps)
                if kv == "bf16":
                    hold_streams(f"{name} vs CPU generate", got, cpu_want, prompts, cpu_eng)
    sampling = {i: dict(temperature=0.8, seed=30 + i) for i in range(len(prompts))}
    sbase = interrupted_run(eng, prompts, max_new, sampling=sampling)
    sgot = interrupted_run(eng, prompts, max_new, sampling=sampling, inflight_steps=2)
    require(sgot == sbase, f"phase c {tag}: sampled streams at inflight_steps=2 differ")
    log(f"[c] {tag}: {len(sgot)} sampled streams at inflight_steps=2 identical to the serial run's")
    base, gaps = interrupted_run(eng, prompts, max_new, gaps=True)
    got = interrupted_run(eng, prompts, max_new, restore_interrupt(eng), inflight_steps=2)
    require(got == base, f"phase c {tag}: restored streams at inflight_steps=2 differ")
    log(f"[c] {tag}: snapshot / restore mid-flight at inflight_steps=2, {len(got)} streams "
        f"identical to the serial run's")
    mixed = {2: dict(temperature=0.8, seed=5)}
    mbase, mgaps = interrupted_run(eng, prompts, max_new, sampling=mixed, gaps=True)
    got = interrupted_run(eng, prompts, max_new, migrate_interrupt(eng, pipeline_depth=2),
                          sampling=mixed, pipeline_depth=2)
    require(got[2] == mbase[2], f"phase c {tag}: the migrated sampled row differs at depth 2")
    hold_streams(f"{tag} migrated greedy at pipeline_depth=2 vs serial",
                 [got[i] for i in (0, 1, 3)], [mbase[i] for i in (0, 1, 3)],
                 [prompts[i] for i in (0, 1, 3)], None, gaps=[mgaps[i] for i in (0, 1, 3)])
    log(f"[c] {tag}: extract / adopt at pipeline_depth=2, the sampled row's stream identical to "
        f"the serial run's")


class FakeTok:
    """Renders id i as "<i>", so a stop string names tokens exactly."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{int(i)}>" for i in ids)


def spec_streams(eng, prompts, max_new: int, speculate: int = 3, **serve_kw):
    """``served_streams`` on a one-shot server (no ``prefill_chunk``, as
    speculation requires) with ``speculate``: staggered submits; each
    request's tokens and committed-token gaps, in prompt order."""
    return served_streams(eng, prompts, max_new, speculate=speculate, prefill_chunk=None,
                          **serve_kw)


def spec_counters() -> tuple:
    """The spec_* counters and the tokens-per-step histogram's sum and count."""
    from llm_sharding_tpu_torch.runtime import spec

    _, tsum, tcount = spec.M_SPEC_TOKENS_PER_STEP.labels().snap()
    return spec.M_SPEC_DRAFTED.value, spec.M_SPEC_ACCEPTED.value, tsum, tcount


def spec_rates(before: tuple) -> tuple:
    """(acceptance rate, tokens committed per row per verify step) since
    ``before`` (a ``spec_counters()``)."""
    d, a, tsum, tcount = (x - y for x, y in zip(spec_counters(), before))
    return (a / d if d else 0.0), (tsum / tcount if tcount else 0.0)


def check_speculation(tag: str, eng, cpu_eng, prompts, cpu_want, rng) -> None:
    """[c] speculative decoding on the 4-layer f32 3B. Speculative
    ``generate`` (K = 2, 4; burst 1, 4) equals ``generate`` on the card and
    on this machine's CPU (top-2 gap rule), and launches flash for its
    verify; the speculative server's streams equal the non-speculative
    server's and ``generate``'s (an f32 arena), and with int8 / fp8 arenas
    the kernels' the plain versions' (gap < 1e-3); a stop string completing
    inside a verify run cuts it there; kill and restore mid-decode, and
    extract / adopt of two rows, give the uninterrupted streams; sampled
    rows reproduce by seed. The prompts: ``prompts`` and two that repeat a
    64-token passage (the drafter's traffic)."""
    import torch

    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    V = eng.cfg.vocab_size
    passage = rng.integers(0, V, 64).astype(np.int32)
    reps = [np.resize(passage, n) for n in (150, 600)]
    max_new = 16
    rep_cpu = []
    for p in reps:
        r = cpu_eng.generate_ids(p, max_new)
        rep_cpu.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
    allp, cpu = list(prompts) + reps, list(cpu_want) + rep_cpu
    card = []
    for p in allp:
        r = eng.generate_ids(p, max_new)
        card.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
    hold_streams(f"{tag} generate on the card vs CPU", card, cpu, allp, cpu_eng)
    for k in (2, 4):
        for burst in (1, 4):
            before = spec_counters()
            K.reset_launch_counts()
            got = []
            for p in allp:
                r = eng.generate_ids(p, max_new, speculate=k, spec_burst=burst)
                got.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
            flash = K.launch_counts().get("flash_attention", 0)
            require(flash > len(allp) * eng.cfg.num_hidden_layers,
                    f"phase c {tag}: speculative generate's verify did not launch flash")
            acc, per = spec_rates(before)
            log(f"[c] {tag} speculative generate K={k} burst={burst}: acceptance {acc:.3f}, "
                f"{per:.2f} tokens per verify step, flash launches {flash}")
            hold_streams(f"{tag} spec generate K={k} burst={burst} vs generate", got, card, allp,
                         eng)
            hold_streams(f"{tag} spec generate K={k} burst={burst} vs CPU generate", got, cpu,
                         allp, cpu_eng)
    before = spec_counters()
    K.reset_launch_counts()
    spec, _ = spec_streams(eng, allp, max_new)
    counts = K.launch_counts()
    require(counts.get("paged_attention", 0) > 0 and counts.get("flash_attention", 0) > 0,
            f"phase c {tag}: the speculative server did not launch decode and flash: {counts}")
    acc, per = spec_rates(before)
    log(f"[c] {tag} speculative server: acceptance {acc:.3f}, {per:.2f} tokens per verify step")
    plain_srv, plain_gaps = spec_streams(eng, allp, max_new, speculate=0)
    hold_streams(f"{tag} spec server vs non-spec server", spec, plain_srv, allp, None,
                 gaps=plain_gaps)
    hold_streams(f"{tag} spec server vs generate", spec, card, allp, eng)
    hold_streams(f"{tag} spec server vs CPU generate", spec, cpu, allp, cpu_eng)
    for kv in KV_MODES:
        kernel, _ = spec_streams(eng, allp, max_new, kv_dtype=kv)
        plain, gaps = spec_streams(eng, allp, max_new, kv_dtype=kv, paged_attn="plain")
        hold_streams(f"{tag} {kv} spec server, kernels vs plain", kernel, plain, allp, None,
                     limit=1e-3, gaps=gaps)
    # a stop string completing inside a verify run, not at its end
    srv = resilience_server(eng, prefill_chunk=None, speculate=3)
    runs = []
    commit = serve_ops.commit_verify

    def recording(cfg, state, rows, lg):
        runs.append(lg[0][lg[0] >= 0].tolist())
        return commit(cfg, state, rows, lg)

    serve_ops.commit_verify = recording
    try:
        full = srv.result(srv.submit(reps[1], 32))
    finally:
        serve_ops.commit_verify = commit
    text = FakeTok().decode
    stop, at = None, 1
    for run in runs:
        for i in range(at, at + len(run) - 1):
            cand = next((text(full[max(i - m + 1, 0) : i + 1]) for m in range(1, 5)
                         if text(full[max(i - m + 1, 0) : i + 1]) not in text(full[:i])), None)
            if cand is not None:
                stop, cut = cand, i + 1
                break
        if stop is not None:
            break
        at += len(run)
    require(stop is not None, f"phase c {tag}: no multi-token verify run to stop inside")
    eng.tokenizer = FakeTok()
    try:
        r = srv.submit(reps[1], 32, stop=[stop])
        srv.run_until_idle()
    finally:
        eng.tokenizer = None
    require(r.done and r.error is None and r.tokens == full[:cut],
            f"phase c {tag}: the stop string did not cut the run at token {cut}")
    log(f"[c] {tag}: stop string {stop!r} cut a verify run at token {cut} of {len(full)}")
    srv._alloc.check()
    require(srv._alloc.in_use == 0, f"phase c {tag}: KV blocks leaked")
    # kill and restore, migration, sampled rows: the speculative server's.
    # A revived or adopted row drafts at the full width again (a new
    # AdaptiveK, as in the JAX package), so its verifies batch other
    # positions than the uninterrupted run's: held by the gap rule
    # (four prompts, one per row of the server, both repeated ones among them)
    kw = dict(prefill_chunk=None, speculate=3)
    sub = allp[-4:]
    base, base_gaps = interrupted_run(eng, sub, max_new, gaps=True, **kw)
    got = interrupted_run(eng, sub, max_new, restore_interrupt(eng), **kw)
    hold_streams(f"{tag} restored spec server vs uninterrupted", got, base, sub, None,
                 gaps=base_gaps)
    got = interrupted_run(eng, sub[2:], max_new, migrate_interrupt(eng, **kw), **kw)
    hold_streams(f"{tag} spec rows migrated vs uninterrupted", got, base[2:], sub[2:], None,
                 gaps=base_gaps[2:])
    sampling = {1: dict(temperature=0.8, seed=5, top_k=50), 3: dict(temperature=0.8, seed=6)}
    s1 = interrupted_run(eng, sub, max_new, sampling=sampling, **kw)
    s2 = interrupted_run(eng, sub, max_new, sampling=sampling, **kw)
    require(s1 == s2, f"phase c {tag}: sampled speculative rows did not reproduce by seed")
    hold_streams(f"{tag} greedy rows beside sampled ones", [s1[0], s1[2]], [base[0], base[2]],
                 [sub[0], sub[2]], None, gaps=[base_gaps[0], base_gaps[2]])
    log(f"[c] {tag}: speculative snapshot / restore and 2 migrated rows held to the "
        f"uninterrupted run, sampled rows reproduced by seed")
    torch.cuda.empty_cache()


def check_speculation_7b(device) -> None:
    """[c] the speculative paths at Llama-2-7B's width (G = 1: a verify
    folds 5 rows per KV head into 2 decode CTAs of 4), 4 of its 32 layers,
    f32: the speculative server (K = 4) against the non-speculative
    one-shot server and ``generate`` on the card, speculative ``generate``
    against ``generate`` (top-2 gap rule, < 1e-4)."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine

    cfg = dataclasses.replace(config.llama2_7b(), num_hidden_layers=4)
    eng = Engine(cfg, llama.init_params(cfg, seed=10, dtype=torch.float32, device=device))
    rng = np.random.default_rng(10)
    passage = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 700)]
    prompts += [np.resize(passage, n) for n in (150, 600)]
    max_new = 16
    card = []
    for p in prompts:
        r = eng.generate_ids(p, max_new)
        card.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
    before = spec_counters()
    spec, _ = spec_streams(eng, prompts, max_new, speculate=4)
    acc, per = spec_rates(before)
    log(f"[c] llama2-7b width: speculative server acceptance {acc:.3f}, {per:.2f} tokens per "
        f"verify step")
    plain, gaps = spec_streams(eng, prompts, max_new, speculate=0)
    hold_streams("llama2-7b width, spec server vs non-spec server", spec, plain, prompts, None,
                 gaps=gaps)
    hold_streams("llama2-7b width, spec server vs generate", spec, card, prompts, eng)
    got = []
    for p in prompts:
        r = eng.generate_ids(p, max_new, speculate=4)
        got.append(r.tokens[0, len(p) : r.lengths[0]].tolist())
    hold_streams("llama2-7b width, spec generate vs generate", got, card, prompts, eng)
    del eng
    torch.cuda.empty_cache()


def phase_token_check(device, store_root: str) -> dict:
    """f32 token checks: Llama-3.2-3B at 4 layers (raw weights, then from
    an int8 store with the head quantized and from an int4 store, both
    written by the port), GPT-2 small at full depth, and gemma-2B at 4
    layers. The raw 3B's, GPT-2's and gemma-2B's served streams are also
    held against ``generate`` run on this machine's CPU (a reference with
    no kernel in it: the weights are made on the CPU and copied to the
    card), and the raw 3B's prefix-cache hits against the cache-off
    streams and that CPU reference (``check_prefix_cache``). Returns the
    flash launches of the raw 3B's first check (its f32 route's, for the
    tabled f32 row)."""
    import torch

    from llm_sharding_tpu_torch.models import config, gpt2, llama
    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.ops.quant import quantize_params
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    cpu_params = llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    params = to_device(cpu_params, device)
    eng = Engine(cfg, params)
    cpu_eng = Engine(cfg, cpu_params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]  # buckets 64 and 256 one-shot, 1024 chunked
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    max_new = 16
    K.reset_launch_counts()
    card_want = check_against_generate("3B", eng, prompts, lens, max_new)
    f32_flash = K.launch_counts()["flash_attention"]
    require(f32_flash > 0, "phase c 3B: the f32 streams never launched flash")
    log(f"[c] 3B f32: flash's f32 route launched {f32_flash} times (served and generate)")
    t0 = time.perf_counter()
    check_observability("3B", eng, prompts, lens, max_new, store_root)
    log(f"[c] 3B observability checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cpu_want = check_against_generate("3B vs CPU", eng, prompts, lens, max_new, oracle=cpu_eng)
    log(f"[c] 3B: CPU generate reference took {time.perf_counter() - t0:.1f}s")
    check_kernels_against_plain("3B", eng, prompts, lens, max_new)
    t0 = time.perf_counter()
    check_prefix_cache("3B", eng, cpu_eng, rng, store_root)
    log(f"[c] 3B prefix cache checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_resilience("3B", eng, cpu_eng, prompts, cpu_want)
    log(f"[c] 3B resilience checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_speculation("3B", eng, cpu_eng, prompts, cpu_want, rng)
    log(f"[c] 3B speculation checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_async_exec("3B", eng, cpu_eng, prompts, cpu_want)
    log(f"[c] 3B async executor checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_frontdoor("3B", eng, prompts, lens, max_new)
    log(f"[c] 3B front door checks took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_fleet("3B", eng, cpu_eng, prompts, lens, max_new, card_want)
    log(f"[c] 3B fleet checks took {time.perf_counter() - t0:.1f}s")
    check_pipeline("3B", eng, cpu_eng, cpu_params, prompts, lens, max_new, cpu_want, rng)
    check_parallel("3B", eng, cpu_eng, cpu_params, prompts, lens, max_new, cpu_want)
    check_cp("3B", eng, cpu_eng, cpu_params, prompts, lens, max_new, cpu_want, card_want)
    del eng, cpu_eng, cpu_params
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
    gcpu_params = gpt2.init_params(gcfg, seed=8, dtype=torch.float32, device="cpu")
    geng = Engine(gcfg, to_device(gcpu_params, device))
    glens = [40, 200, 300, 500]  # buckets 64 and 256 one-shot, 512 chunked
    gprompts = [rng.integers(0, gcfg.vocab_size, n).astype(np.int32) for n in glens]
    check_against_generate("gpt2", geng, gprompts, glens, max_new, capacity=1024)
    t0 = time.perf_counter()
    check_against_generate("gpt2 vs CPU", geng, gprompts, glens, max_new, capacity=1024,
                           oracle=Engine(gcfg, gcpu_params))
    log(f"[c] gpt2: CPU generate reference took {time.perf_counter() - t0:.1f}s")
    del geng, gcpu_params
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
    check_speculation_7b(device)
    return {"flash_attention": f32_flash}


# --------------------------------------------------------------- phase (d)

def depth_view(eng, layers: int):
    """The first ``layers`` layers of a one-stage engine as an engine of
    their own, over the same tensors (no copy): an earlier path run at a
    cut depth."""
    from llm_sharding_tpu_torch.runtime.engine import Engine

    p = eng.params
    return Engine(dataclasses.replace(eng.cfg, num_hidden_layers=layers),
                  {**{k: v for k, v in p.items() if k != "layers"}, "layers": p["layers"][:layers]})


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def serve_run(eng, model: str, tag: str, kv: str = "bf16", twin=None) -> tuple[dict, list]:
    """``model``'s workload on a fresh server with a ``kv`` arena: checks
    it, prints its numbers; returns the run's launch counts and tokens.
    ``twin`` (a dict) receives what ``inprocess_run`` returns, for the
    front door's paged daemon to be held to."""
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
    if twin is not None:
        twin.update(tokens=tokens, ids=[r.id for r in reqs], counts=counts, prompts=prompts,
                    ttft=list(ttft), tok_s=decode_tok_s)
    del srv, reqs
    torch.cuda.empty_cache()
    return counts, tokens


def http_get(port: int, path: str) -> tuple:
    """``(status, body)`` of a GET on the local exposition; an HTTP error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_serve_run(eng, trace_root: str, smi: str) -> dict:
    """[d] The 3B standard workload (bf16 arena) traced, with a step pump
    thread and a ``MetricsServer`` on 127.0.0.1 scraped during the run:
    every endpoint answers, ``/metrics`` carries the step families, an
    8-step ``/profilez`` capture completes; ``trace-report`` over the
    span file gives 8 trees without orphans, each root holding
    ``prefill`` and ``decode``; every step accounts and waited on the
    device where it read tokens; all three kernels launched. Prints the
    step-phase table."""
    import contextlib
    import io

    import torch

    from llm_sharding_tpu_torch import cli, smoke_workload
    from llm_sharding_tpu_torch.obs import MetricsServer
    from llm_sharding_tpu_torch.obs.report import step_phase_table, step_summary
    from llm_sharding_tpu_torch.ops import kernels as K

    tag = "phase d 3B observability"
    path = os.path.join(trace_root, "d_trace.jsonl")
    srv = smoke_workload.serve(eng, "llama32_3b", trace_path=path)
    ms = MetricsServer(port=0, statz_extra={"counters": srv.counters.snapshot},
                       health_provider=lambda: srv.health)
    ms.set_profilez_provider(lambda steps, wait_s: (
        srv.stepline_capture(steps, wait_s) if steps is not None
        else {"stepline": srv.stepline_stats(), "steps": srv.stepline_snapshot(64)}))
    port = ms.start()
    prompts = smoke_workload.prompts(eng.cfg.vocab_size, np.random.default_rng(0),
                                     smoke_workload.WORKLOADS["llama32_3b"].lens)
    answers = {}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with Pump(srv):
            reqs = [srv.submit(p, smoke_workload.MAX_NEW) for p in prompts[:2]]
            code, body = http_get(port, "/profilez?steps=8&wait_s=120")
            bundle = json.loads(body)
            require(code == 200 and bundle["complete"] and bundle["steps_captured"] == 8,
                    f"{tag}: /profilez capture {code} {body[:300]!r}")
            reqs += [srv.submit(p, smoke_workload.MAX_NEW) for p in prompts[2:]]
            for ep in ("/metrics", "/statz", "/debugz", "/healthz", "/profilez"):
                answers[ep] = http_get(port, ep)
            wait_done(reqs, tag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        for ep, (code, body) in answers.items():
            require(code == 200, f"{tag}: {ep} answered {code}")
        text = answers["/metrics"][1].decode()
        for fam in ("server_step_phase_seconds", "server_host_occupancy"):
            require(f"# TYPE {fam}" in text, f"{tag}: /metrics lacks {fam}")
        require(answers["/healthz"][1] == b"ok\n", f"{tag}: /healthz {answers['/healthz']}")
        dbg = json.loads(answers["/debugz"][1])
        require(dbg["recent_spans"] and dbg["recent_steps"], f"{tag}: /debugz bundle empty")
    finally:
        ms.stop()
        srv.close()
    check_step_records(tag, bundle["steps"])
    recs = srv.stepline_snapshot()
    check_step_records(tag, recs)
    require(any("fetch" in r["phases"] for r in recs), f"{tag}: no step read tokens")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        require(cli.main(["trace-report", "--json", path]) == 0, f"{tag}: trace-report failed")
    report = json.loads(out.getvalue())
    require(report["traces"] == len(reqs) == 8, f"{tag}: trace-report found {report['traces']}")
    require(all(t["orphans"] == 0 for t in report["slowest"]), f"{tag}: orphans {report}")
    check_trace_trees(tag, [path], reqs)
    for name in ("flash_attention", "paged_attention", "paged_prefill"):
        require(counts.get(name, 0) > 0, f"{tag}: kernel {name} never launched")
    summ = step_summary(recs)
    log(f"[d] 3B observability: {len(reqs)} requests in {wall:.2f}s through a pump thread, "
        f"5 endpoints answered, an 8-step /profilez capture, {report['traces']} trees without "
        f"orphans; launches {counts}; on {smi}")
    log(f"[d] 3B standard step profile ({summ['steps']} steps, {summ['wall_s']:.3f}s wall): "
        f"host occupancy {summ['host_occupancy']:.3f}, blocked {summ['blocked_frac']:.3f}, "
        f"device idle {summ['device_idle_frac']:.3f}, unattributed "
        f"{summ['unattributed_frac']:.4f}")
    for r in step_phase_table(recs):
        log(f"[d]   {r['phase']:<13} {r['count']:5d} steps  p50 {r['p50_ms']:8.3f} ms  "
            f"p99 {r['p99_ms']:8.3f} ms  total {r['total_s']:7.3f} s  {r['wall_pct']:5.1f}% of wall")


def trace_overhead_run(eng, trace_root: str, smi: str) -> None:
    """[d] The 3B standard workload served four times in turns, tracing
    off (the flight recorder disabled, no ``trace_path``), on (the
    recorder and a span file), on, off; prints each run's decode tok/s and
    the on / off ratio of their sums (printed, not gated: the served host
    wall moves tens of percent between runs)."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.obs import FLIGHT_RECORDER

    prompts = smoke_workload.prompts(eng.cfg.vocab_size, np.random.default_rng(0),
                                     smoke_workload.WORKLOADS["llama32_3b"].lens)
    rates = {"on": [], "off": []}
    try:
        for i, mode in enumerate(("off", "on", "on", "off")):
            FLIGHT_RECORDER.set_enabled(mode == "on")
            path = os.path.join(trace_root, f"overhead_{i}.jsonl") if mode == "on" else None
            srv = smoke_workload.serve(eng, "llama32_3b", trace_path=path)
            torch.cuda.synchronize()
            reqs = smoke_workload.submit_staggered(srv, prompts)
            srv.run_until_idle()
            torch.cuda.synchronize()
            srv.close()
            span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
            rates[mode].append(sum(len(r.tokens) - 1 for r in reqs) / span)
    finally:
        FLIGHT_RECORDER.set_enabled(True)
    log(f"[d] 3B tracing overhead on {smi}: decode tok/s off {rates['off'][0]:.1f} / "
        f"{rates['off'][1]:.1f}, on {rates['on'][0]:.1f} / {rates['on'][1]:.1f}; on / off "
        f"{sum(rates['on']) / sum(rates['off']):.4f} (printed, not gated)")


def busy_window(srv, prompts, cycles: int) -> tuple:
    """``(kernel ms, wall ms)`` of ``cycles`` decode steps of ``srv`` at
    all its rows live (``prompts``, one a row, admitted first), under
    ``torch.profiler`` with CUDA activity only (kernel time, no host op
    recording), the device drained before and after; ``(None, wall)``
    when the profiler recorded no kernel. The requests are cancelled
    after the window."""
    import torch

    reqs = [srv.submit(p, 64) for p in prompts]
    while srv._queue or len(srv._live_rows()) < len(prompts):
        srv.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(-(-cycles // srv.chunk_cycles)):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for r in reqs:
        srv.cancel(r)
    srv.run_until_idle()
    us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us += float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    return (us / 1e3 if us > 0 else None), wall_ms


# [d] the step-loop configurations: (inflight_steps, chunk_cycles) and the
# serial loop at pipeline_depth=2, each beside the (1, 1) run
ASYNC_CONFIGS = (
    ("(1, 1)", {}), ("(2, 1)", dict(inflight_steps=2)), ("(4, 1)", dict(inflight_steps=4)),
    ("(2, 4)", dict(inflight_steps=2, chunk_cycles=4)), ("pipeline_depth=2", dict(pipeline_depth=2)),
)
BUSY_WINDOW_CYCLES = 12


def async_serve_run(eng, tag: str, kv: str = "bf16", record: bool = False, **knobs) -> dict:
    """The 3B standard workload with the step-loop ``knobs``: every request
    must finish, the blocks drain, flash, chunked prefill and decode
    launch, and every step accounts. Unless ``record``, the run is timed
    and a window of ``BUSY_WINDOW_CYCLES`` decode steps at 8 live rows
    (the 4 short prompts twice) then runs under ``busy_window`` for the
    device-busy share; with ``record`` each committed token's top-2 gap
    and top logit are recorded (a sync per step, so the run is not timed).
    Prints decode tok/s, TTFT p50 / p99, the stepline shares and the busy
    share; returns the streams and what was recorded."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.obs.report import step_phase_table, step_summary
    from llm_sharding_tpu_torch.ops import kernels as K

    cfg = eng.cfg
    srv = smoke_workload.serve(eng, "llama32_3b", kv_dtype=kv, **knobs)
    prompts = smoke_workload.prompts(cfg.vocab_size, np.random.default_rng(0),
                                     smoke_workload.WORKLOADS["llama32_3b"].lens)
    tops: dict = {}
    pushed, push = [0], srv._push_pending

    def counted_push(*args):
        pushed[0] += 1
        push(*args)

    srv._push_pending = counted_push  # every log put in flight, for the sidecar's share
    torch.cuda.synchronize()
    K.reset_launch_counts()
    steps0 = srv.stepline.steps_total
    t0 = time.perf_counter()
    with (recorded_gaps(srv, tops) if record else contextlib.nullcontext({})) as gaps:
        reqs = smoke_workload.submit_staggered(srv, prompts)
        srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    recs = srv.stepline_snapshot()[-(srv.stepline.steps_total - steps0):]
    for r in reqs:
        require(r.done and r.error is None, f"phase d {tag}: request {r.id} did not finish")
        require(len(r.tokens) == smoke_workload.MAX_NEW or r.tokens[-1] in cfg.eos_token_ids,
                f"phase d {tag}: request {r.id} produced {len(r.tokens)} tokens")
    mode = "" if kv == "bf16" else f"[{kv}]"
    for name in ("flash_attention", f"paged_attention{mode}", f"paged_prefill{mode}"):
        require(counts.get(name, 0) > 0, f"phase d {tag}: kernel {name} was never launched")
    check_step_records(f"phase d {tag}", recs)
    side = srv._sidecar
    if side is not None:
        require(side.is_alive() and side.error is None,
                f"phase d {tag}: the completion sidecar died: {side.error!r}")
    side_txt = "" if side is None else f"; the sidecar applied {side.applied} of {pushed[0]} logs"
    del srv._push_pending
    run = dict(tokens=[list(r.tokens) for r in reqs], ids=[r.id for r in reqs], gaps=gaps,
               tops=tops)
    short = [p for p in prompts if len(p) <= smoke_workload.PREFILL_CHUNK]
    busy = None if record else busy_window(srv, short * (smoke_workload.ROWS // len(short)),
                                           BUSY_WINDOW_CYCLES)
    srv.close()
    srv._alloc.check()
    require(srv._alloc.in_use == 0, f"phase d {tag}: {srv._alloc.in_use} KV blocks still held")
    if record:
        return run
    ttft = np.array([r.first_token_at - r.submitted_at for r in reqs])
    span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    tok_s = sum(len(r.tokens) - 1 for r in reqs) / span
    summ = step_summary(recs)
    share = {r["phase"]: r["wall_pct"] for r in step_phase_table(recs)}
    phases = ", ".join(f"{p} {share.get(p, 0.0):.2f}%"
                       for p in ("publish", "admit", "dispatch", "drain", "fetch", "apply"))
    kern_ms, win_ms = busy
    busy_txt = ("not measured (the profiler recorded no kernel)" if kern_ms is None
                else f"{kern_ms / win_ms:.1%} ({kern_ms:.1f} ms of kernels in {win_ms:.1f} ms)")
    log(f"[d] {tag}: {len(reqs)} requests in {wall:.2f}s, decode {tok_s:.1f} tok/s, TTFT p50 "
        f"{np.percentile(ttft, 50) * 1e3:.0f} ms p99 {np.percentile(ttft, 99) * 1e3:.0f} ms; "
        f"{len(recs)} steps: {phases}; blocked {summ['blocked_frac']:.2%}, device idle "
        f"(estimate) {summ['device_idle_frac']:.2%}, unattributed "
        f"{summ['unattributed_frac']:.2%}; device busy over {BUSY_WINDOW_CYCLES} decode steps "
        f"at {smoke_workload.ROWS} rows {busy_txt}{side_txt}")
    return run


def async_serve_runs(eng, smi: str) -> None:
    """[d] The 3B standard workload at each of ``ASYNC_CONFIGS`` in the bf16
    arena and at (2, 1) in the int8 arena, each held to the same arena's
    (1, 1) streams: identical, or first differing at a near tie of the
    (1, 1) run (top-2 gap <= ``TIE_ULPS`` bf16 ulps of its top logit). The
    gaps come from a recorded (1, 1) run, made only when a stream differs
    (its streams must equal the timed (1, 1) run's)."""
    log(f"[d] step-loop configurations on {smi}")
    for kv, configs in (("bf16", ASYNC_CONFIGS), ("int8", (("(2, 1)", dict(inflight_steps=2)),))):
        base, rec = None, []
        if configs[0][1]:
            base = async_serve_run(eng, f"3B kv {kv} (1, 1)", kv=kv)

        def recorded(kv=kv, rec=rec):  # one recorded (1, 1) run per arena, made when needed
            if not rec:
                rec.append(async_serve_run(eng, f"3B kv {kv} (1, 1) recorded", kv=kv, record=True))
            return rec[0]

        for name, knobs in configs:
            run = async_serve_run(eng, f"3B kv {kv} {name}", kv=kv, **knobs)
            base = base or run
            hold_to(f"3B kv {kv} {name} vs (1, 1)", run["tokens"], base["tokens"], recorded)


def prefix_serve_run(eng, model: str, tag: str, cache: str = "hbm", kv: str = "bf16"):
    """``model``'s shared-prefix workload (``smoke_workload.SHARED_PREFIX``)
    on a fresh server: the primer run to idle, then the 8 staggered
    requests, timed. Every request must finish; with the cache on every
    one must hit the whole prefix, and once the tree is dropped no block
    may stay held; both paged kernels (of the ``kv`` mode) must have
    launched, and flash with the cache on. Prints TTFT, decode tok/s, the hit rate and the
    launches; returns the counts, the tokens and ``(TTFT p50, p99, tok/s)``."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    cfg = eng.cfg
    w = smoke_workload.SHARED_PREFIX[model]
    srv = smoke_workload.serve(eng, model, shared_prefix=True, kv_dtype=kv, prefix_cache=cache)
    primer, prompts = smoke_workload.shared_prefix_prompts(cfg.vocab_size, np.random.default_rng(1), w)
    srv.result(srv.submit(primer, smoke_workload.MAX_NEW))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t_start = time.perf_counter()
    reqs = smoke_workload.submit_staggered(srv, prompts)
    srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = K.launch_counts()
    for r in reqs:
        require(r.done and r.error is None, f"phase d {tag}: request {r.id} did not finish")
        require(len(r.tokens) == smoke_workload.MAX_NEW or r.tokens[-1] in cfg.eos_token_ids,
                f"phase d {tag}: request {r.id} produced {len(r.tokens)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.tokens), f"phase d {tag}: token out of range")
    srv._alloc.check()
    st = srv.prefix_cache_stats()
    hits = "cache off"
    if st is not None:
        srv._radix.check()
        require(st["hit_tokens"] == len(prompts) * w.prefix,
                f"phase d {tag}: {st['hit_tokens']} hit tokens, not {len(prompts)} x {w.prefix}")
        hits = (f"hit {st['hit_tokens']} of {st['eligible_tokens']} eligible tokens "
                f"({st['hit_tokens'] / st['eligible_tokens']:.3f}, the primer's included)")
        srv._radix.drop_all()
    require(srv._alloc.in_use == 0, f"phase d {tag}: {srv._alloc.in_use} KV blocks held after drop_all")
    mode = "" if kv == "bf16" else f"[{kv}]"
    # cold, every prompt (1044-2024 tokens) admits chunked: no flash
    for name in ("flash_attention",) * (cache != "off") + (f"paged_attention{mode}",
                                                           f"paged_prefill{mode}"):
        require(counts.get(name, 0) > 0, f"phase d {tag}: kernel {name} was never launched")
    ttft = np.array([r.first_token_at - r.submitted_at for r in reqs])
    decode_span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    tok_s = sum(len(r.tokens) - 1 for r in reqs) / decode_span
    p50, p99 = (float(np.percentile(ttft, q)) * 1e3 for q in (50, 99))
    log(f"[d] {tag}: {len(reqs)} requests in {wall:.2f}s: decode {tok_s:.1f} tok/s, TTFT p50 "
        f"{p50:.0f} ms p99 {p99:.0f} ms, {hits}")
    log(f"[d] {tag}: kernel launches: {counts}")
    tokens = [list(r.tokens) for r in reqs]
    del srv, reqs
    torch.cuda.empty_cache()
    return counts, tokens, (p50, p99, tok_s)


def prefix_tier_run(eng, cache: str, pool_root: str) -> None:
    """The tiers under pressure: 1088-token requests over alternating
    1024-token prefixes through a 40-block arena, one at a time. "host":
    prefixes A, B, A (B's admission demotes A to host RAM, the second A
    streams it back). "disk": a host pool of 16 blocks and A, B, C, A (C's
    admission demotes B to host and spills A to disk, the last A promotes
    it back). The tier's evictions and hits must be nonzero, and once the
    tree is dropped no block may stay held; the pool is removed."""
    from llm_sharding_tpu_torch import smoke_workload

    cfg = eng.cfg
    rng = np.random.default_rng(2)
    prefixes = [rng.integers(0, cfg.vocab_size, 1024).astype(np.int32) for _ in range(3)]
    order = [0, 1, 0] if cache == "host" else [0, 1, 2, 0]
    pool = tempfile.mkdtemp(prefix="chip_smoke_pool_", dir=pool_root) if cache == "disk" else None
    try:
        srv = eng.serve(capacity=4096, batch_per_slot=smoke_workload.ROWS,
                        kv_block_size=smoke_workload.BLOCK_SIZE, kv_blocks=40,
                        prefill_chunk=smoke_workload.PREFILL_CHUNK, prefix_cache=cache,
                        **({"host_pool_blocks": 16, "disk_pool_dir": pool} if pool else {}))
        t0 = time.perf_counter()
        for i in order:
            p = np.concatenate([prefixes[i], rng.integers(0, cfg.vocab_size, 64).astype(np.int32)])
            r = srv.submit(p, smoke_workload.MAX_NEW)
            srv.run_until_idle()
            require(r.done and r.error is None, f"phase d {cache} tier: request {r.id} failed")
        st = srv.prefix_cache_stats()
        log(f"[d] 3B {cache} tier, prefixes {order} through 40 blocks, {time.perf_counter() - t0:.2f}s: "
            f"{st}")
        require(st[f"evictions_to_{cache}"] > 0 and st[f"{cache}_hit_tokens"] > 0,
                f"phase d {cache} tier: no eviction to, or hit from, the {cache} tier: {st}")
        srv._radix.check()
        srv._alloc.check()
        srv._radix.drop_all()
        require(srv._alloc.in_use == 0, f"phase d {cache} tier: blocks held after drop_all")
        srv.close()
    finally:
        if pool is not None:
            shutil.rmtree(pool, ignore_errors=True)


def ttft_window(reqs, before: dict) -> str:
    """The registry's ``server_ttft_seconds`` p50 / p99 over the
    observations since ``before`` (its bucket counts then), beside the same
    requests' host-clock TTFT."""
    from llm_sharding_tpu_torch.obs.metrics import REGISTRY, _quantile_from

    child = REGISTRY.get("server_ttft_seconds").labels()
    counts = [a - b for a, b in zip(child.snap()[0], before)]
    reg = [_quantile_from(child.bounds, counts, sum(counts), q) for q in (0.5, 0.99)]
    host = np.array([r.first_token_at - r.submitted_at for r in reqs])
    return (f"registry TTFT p50 {reg[0] * 1e3:.0f} ms p99 {reg[1] * 1e3:.0f} ms (bucket "
            f"interpolation, {sum(counts)} requests); host clock p50 "
            f"{np.percentile(host, 50) * 1e3:.0f} ms p99 {np.percentile(host, 99) * 1e3:.0f} ms")


def resilience_serve_run(eng, pool_root: str) -> dict:
    """[d] the 3B's ``RESILIENCE`` workload (``smoke_workload``: the 8
    standard prompts, 64 new tokens, 320 blocks) on ``eng``. In each arena,
    kill and restore: submit all 8, step until every row holds 8 tokens,
    ``save_snapshot`` under TMPDIR, drop the server, ``load_snapshot`` and
    ``restore``, run to idle; every stream must equal the uninterrupted
    run's, what was streamed before the kill a prefix of it, the restore's
    peak device memory under the resident bytes plus half an arena, and the
    run must have launched flash and both paged kernels of the mode. Then
    migration: 2 greedy and 2 sampled rows extracted mid-decode from one
    server and adopted on a second on the same engine, which must launch
    flash and the chunked-prefill kernel for the re-prefills. Then a
    transient plan at all five sites, a ``max_queue`` burst, a 50 ms
    deadline and the health states. Returns the launch counts of the bf16
    kill-and-restore run."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload as sw
    from llm_sharding_tpu_torch.obs.metrics import REGISTRY
    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan, FaultSpec
    from llm_sharding_tpu_torch.runtime.server import (
        DeadlineExceeded, PipelineServer, QueueFull, load_snapshot, save_snapshot,
    )

    model = "llama32_3b"
    prompts = sw.prompts(eng.cfg.vocab_size, np.random.default_rng(0), sw.RESILIENCE[model].lens)

    def start(srv, sampling=None):
        reqs = [srv.submit(p, sw.MAX_NEW, **(sampling or {}).get(i, {}))
                for i, p in enumerate(prompts)]
        step_until(srv, reqs, 8)
        return reqs

    def finish(srv, tag):
        srv.run_until_idle()
        torch.cuda.synchronize()
        srv._alloc.check()
        require(srv._alloc.in_use == 0, f"phase d {tag}: KV blocks still held")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[d] resilience workload (3B bf16 store, 320 blocks) on {smi}")
    counts = {}
    for kv in ("bf16", *KV_MODES):
        tag = f"3B resilience kv {kv}"
        mode = "" if kv == "bf16" else f"[{kv}]"
        srv = sw.serve(eng, model, resilience=True, kv_dtype=kv)
        ttft0 = list(REGISTRY.get("server_ttft_seconds").labels().snap()[0])
        reqs = start(srv)
        finish(srv, tag)
        base = [list(r.tokens) for r in reqs]
        log(f"[d] {tag}: uninterrupted run, {ttft_window(reqs, ttft0)}")
        arena = srv.arena_bytes()
        srv.close()
        del srv, reqs
        torch.cuda.empty_cache()
        srv = sw.serve(eng, model, resilience=True, kv_dtype=kv)
        K.reset_launch_counts()
        reqs = start(srv)
        streamed = {r.id: list(r.tokens) for r in reqs}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = srv.snapshot()
        capture_s = time.perf_counter() - t0
        where = tempfile.mkdtemp(prefix="chip_smoke_snap_", dir=pool_root)
        path = os.path.join(where, "snap")
        t0 = time.perf_counter()
        save_snapshot(snap, path)
        write_s = time.perf_counter() - t0
        nbytes, held = dir_bytes(path), len(snap["arena"]["blocks"])
        srv.close()
        del srv, reqs, snap
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        snap = load_snapshot(path)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv = PipelineServer.restore(eng, snap)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        peak, resident = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        del snap
        shutil.rmtree(where)
        by_id = {r.id: r for r in list(srv._req) + list(srv._queue) if r is not None}
        reqs = [by_id[i] for i in sorted(streamed)]
        # the snapshot applied the logs in flight first: a restored request
        # holds what was streamed and perhaps the tokens of those logs
        require(all(r.tokens[: len(streamed[i])] == streamed[i]
                    for r, i in zip(reqs, sorted(streamed))),
                f"phase d {tag}: the restored requests do not hold the streamed tokens")
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        first_step_s = time.perf_counter() - t0
        finish(srv, tag)
        kv_counts = K.launch_counts()
        got = [list(r.tokens) for r in reqs]
        for i, (g, w) in enumerate(zip(got, base)):
            require(g[: len(streamed[i])] == streamed[i], f"phase d {tag}: tokens lost")
            require(g == w, f"phase d {tag}: request {i}'s restored stream differs from the "
                            f"uninterrupted run")
        for name in ("flash_attention", f"paged_attention{mode}", f"paged_prefill{mode}"):
            require(kv_counts.get(name, 0) > 0, f"phase d {tag}: kernel {name} never launched")
        require(peak < resident + arena / 2,
                f"phase d {tag}: restore peak {peak} >= resident {resident} + half an arena")
        log(f"[d] {tag}: kill at >= 8 tokens a row, restore: {len(got)} streams identical to the "
            f"uninterrupted run, none lost or doubled; snapshot {nbytes / 2**30:.3f} GiB "
            f"({held} held blocks of 320, arena {arena / 2**30:.3f} GiB), capture "
            f"{capture_s:.3f} s, write {write_s:.3f} s, load {load_s:.3f} s, restore "
            f"{restore_s:.3f} s, first step after restore {first_step_s * 1e3:.1f} ms; restore "
            f"peak {peak / 2**30:.3f} GiB, resident {resident / 2**30:.3f} GiB")
        log(f"[d] {tag}: kernel launches (kill and restore): {kv_counts}")
        counts.update({k: n for k, n in kv_counts.items() if kv == "bf16" or k.endswith(mode)})
        if kv == "bf16":
            bf16_base = base
        srv.close()
        del srv, reqs
        torch.cuda.empty_cache()

    # migration: 4 live rows (2 greedy, 2 sampled) from A to B, one engine
    sampling = {2: dict(temperature=0.8, seed=21), 3: dict(temperature=0.8, seed=22)}
    srv = sw.serve(eng, model, resilience=True)
    tops, noised = {}, {}
    with recorded_gaps(srv, tops, noised) as gaps:
        reqs = start(srv, sampling)
        finish(srv, "3B migration base")
    sbase = [list(r.tokens) for r in reqs]
    sgaps = [list(gaps[r.id]) for r in reqs]
    stops = [tops[r.id] for r in reqs]
    snoised = {i: noised[reqs[i].id] for i in sampling}
    srv.close()
    del srv, reqs
    a = sw.serve(eng, model, resilience=True)
    b = sw.serve(eng, model, resilience=True)
    reqs = start(a, sampling)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:4]:
        b.adopt(a.extract(r), r)
    move_s = time.perf_counter() - t0
    finish(b, "3B migration target")
    b_counts = K.launch_counts()
    finish(a, "3B migration source")
    for name in ("flash_attention", "paged_prefill", "paged_attention"):
        require(b_counts.get(name, 0) > 0, f"phase d migration: {name} never launched on B")
    same = [list(r.tokens) == sbase[i] for i, r in enumerate(reqs)]
    for i, r in enumerate(reqs):
        g, w = list(r.tokens), sbase[i]
        if g == w:
            continue
        require(len(g) == len(w), f"phase d migration: request {i}'s stream length differs")
        # the logits are bf16: a re-prefill rounds differently from the
        # uninterrupted decode, and the moved row's later logits from KV
        # that differs in its last bits, which may break a tie between two
        # logits that are equal or adjacent bf16 values the other way; a
        # sampled token's decision is its noised top-2 margin, which the
        # same few ulps of its logits (over the temperature) may cross
        step = next(j for j in range(len(w)) if g[j] != w[j])
        if i in sampling:
            margin, top = snoised[i][step], stops[i][step]
            ulp = bf16_ulp(top) / sampling[i]["temperature"]
            log(f"[d] 3B migration: request {i} (moved, sampled) first differs at token {step}: "
                f"the uninterrupted run's noised top-2 margin {margin:.4g} ({margin / ulp:.2f} "
                f"bf16 ulps of its top logit {top:.4g} over the temperature)")
            require(margin <= MIGRATED_SAMPLED_ULPS * ulp,
                    f"phase d migration: sampled request {i} differs at a noised margin of "
                    f"{margin} > {MIGRATED_SAMPLED_ULPS} ulps")
            continue
        gap, top = sgaps[i][step], stops[i][step]
        ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
        log(f"[d] 3B migration: request {i} ({'moved' if i < 4 else 'stayed'}, greedy) first "
            f"differs at token {step}: the uninterrupted run's top-2 gap {gap:.4g} at top logit "
            f"{top:.4g} (one bf16 ulp there: {ulp:.4g})")
        require(gap <= ulp, f"phase d migration: request {i} differs at a gap of {gap} > one "
                            f"bf16 ulp ({ulp}) of its top logit")
    log(f"[d] 3B migration: 4 rows (2 greedy, 2 sampled) extracted and adopted in "
        f"{move_s * 1e3:.1f} ms; streams identical to the uninterrupted run: {same} (the others "
        f"first differ at a bf16 tie); B's launches for the re-prefills and decode: {b_counts}")
    a.close()
    b.close()
    del a, b, reqs

    # faults, queue cap, deadline, health
    plan = FaultPlan([
        FaultSpec("admit_dispatch", "transient", at=(0, 3)),
        FaultSpec("chunk_dispatch", "transient", at=(0, 4, 9)),
        FaultSpec("log_fetch", "transient", at=(2, 7)),
        FaultSpec("snapshot_write", "transient", at=(0,)),
        FaultSpec("request_apply", "transient", at=(5,), key=3),
    ])
    series = REGISTRY.get("server_retries_total")
    r0 = {v[0]: c.value for v, c in series.series()}
    srv = sw.serve(eng, model, resilience=True, fault_plan=plan, fault_backoff_s=0.0)
    reqs = start(srv)
    where = tempfile.mkdtemp(prefix="chip_smoke_snap_", dir=pool_root)
    srv.enable_auto_snapshot(os.path.join(where, "snap"), 0.0)
    srv.step()  # one auto-snapshot through the snapshot_write site
    srv.enable_auto_snapshot(None, None)
    shutil.rmtree(where)
    finish(srv, "3B transient faults")
    retries = {v[0]: c.value - r0.get(v[0], 0.0) for v, c in series.series()}
    require([list(r.tokens) for r in reqs] == bf16_base,
            "phase d: streams under transient faults differ from the run without faults")
    require(plan.stats()["total_fires"] == 9 and sum(retries.values()) == 9,
            f"phase d: faults {plan.stats()}, retries {retries}")
    require(srv.health == "SERVING", "phase d: transient faults degraded the server")
    log(f"[d] 3B transient faults at all five sites: streams identical to the run without "
        f"faults; retries by site {retries}")
    srv.close()
    del srv, reqs

    srv = sw.serve(eng, model, resilience=True, max_queue=4)
    for p in prompts[:4]:
        srv.submit(p, sw.MAX_NEW)
    try:
        srv.submit(prompts[4], sw.MAX_NEW)
        require(False, "phase d: a fifth submit passed max_queue=4")
    except QueueFull as e:
        log(f"[d] 3B max_queue=4: the fifth submit raised QueueFull ({e})")
    srv.close()

    srv = sw.serve(eng, model, resilience=True, fault_plan=FaultPlan.permanent(
        "request_apply", key=0), fault_backoff_s=0.0)
    states = [srv.health]
    poisoned = srv.submit(prompts[0], sw.MAX_NEW)  # id 0: fails at its first token
    while not poisoned.done:
        srv.step()
    states.append(srv.health)
    late = srv.submit(prompts[5], sw.MAX_NEW, deadline_s=0.05)  # 2048 tokens: chunked
    while not late.done:
        srv.step()
    require(isinstance(late.error, DeadlineExceeded),
            f"phase d: the 50 ms request ended with {late.error!r}")
    require(srv._alloc.in_use == 0, "phase d: the expired request's blocks did not return")
    clean = srv.submit(prompts[2], sw.MAX_NEW)
    finish(srv, "3B health")
    require(clean.error is None and len(clean.tokens) > 0, "phase d: no clean request after")
    states.append(srv.health)
    srv.close()
    states.append(srv.health)
    require(states == ["SERVING", "DEGRADED", "SERVING", "DRAINING"], f"phase d: health {states}")
    log(f"[d] 3B deadline_s=0.05: DeadlineExceeded after {len(late.tokens)} tokens, its blocks "
        f"returned; health {' -> '.join(states)}")
    torch.cuda.empty_cache()
    return counts


# [d] speculative vs non-speculative bf16 streams: the largest top-2 gap, in
# bf16 ulps of the top logit, at which they may first differ. On an NVIDIA
# H100 the 3B's first differences sat at 0-1 ulp, Llama-2-7B's (32 layers
# of width 4096) at up to 3 (0.046875 at 3.83); the f32 checks of [c] hold
# both models' speculative paths token-exact, so these are rounding, not
# choices
TIE_ULPS = 4
# a migrated sampled row may first differ where its noised top-2 margin is
# at most this many bf16 ulps of the top logit (over the temperature): the
# two logits a re-prefill moved by one ulp each (the 3B's first difference
# on an NVIDIA H100 sat at 1.61)
MIGRATED_SAMPLED_ULPS = 2


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0**-133


def spec_serve_run(eng, model: str, tag: str, kv: str = "bf16") -> dict:
    """``model``'s ``SPECULATIVE`` workload (``smoke_workload``): the
    non-speculative one-shot server (``speculate=0``), then the speculative
    one, each on a fresh server; in the bf16 arena each runs once more
    before, with its committed tokens' top-2 gaps recorded (the recording
    syncs every step, so those runs are not timed). Every request must
    finish, the blocks drain, and each run launch flash (admissions) and
    the decode kernel (decode steps, verifies) and no chunked prefill.
    Prints acceptance, tokens per verify step, decode tok/s, TTFT, the
    launches and the share of streams identical to the non-speculative
    run's. In the bf16 arena a stream may first differ only at a near tie
    of the non-speculative run: a top-2 gap of at most ``TIE_ULPS`` bf16
    ulps of its top logit (the two runs round differently: a verify's
    GEMMs take 5 rows a request, a decode step's 1). Returns the
    speculative run's launch counts."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    cfg = eng.cfg
    w = smoke_workload.SPECULATIVE[model]
    prompts = smoke_workload.speculative_prompts(cfg.vocab_size, np.random.default_rng(0), w)
    out, recorded = {}, {}
    plan = [(0, False), (w.speculate, False)]
    if kv == "bf16":
        plan = [(0, True), (0, False), (w.speculate, True), (w.speculate, False)]
    for k, record in plan:
        srv = smoke_workload.serve(eng, model, speculative=True, kv_dtype=kv, speculate=k)
        tops: dict = {}
        before = spec_counters()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        ctx = recorded_gaps(srv, tops) if record else contextlib.nullcontext({})
        t0 = time.perf_counter()
        with ctx as gaps:
            reqs = smoke_workload.submit_staggered(srv, prompts)
            srv.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        for r in reqs:
            require(r.done and r.error is None, f"phase d {tag}: request {r.id} did not finish")
            require(len(r.tokens) == smoke_workload.MAX_NEW or r.tokens[-1] in cfg.eos_token_ids,
                    f"phase d {tag}: request {r.id} produced {len(r.tokens)} tokens")
            require(all(0 <= t < cfg.vocab_size for t in r.tokens), f"phase d {tag}: bad token")
        srv._alloc.check()
        require(srv._alloc.in_use == 0, f"phase d {tag}: {srv._alloc.in_use} KV blocks held")
        mode = "" if kv == "bf16" else f"[{kv}]"
        for name in ("flash_attention", f"paged_attention{mode}"):
            require(counts.get(name, 0) > 0, f"phase d {tag}: {name} never launched (k={k})")
        require(counts.get(f"paged_prefill{mode}", 0) == 0, f"phase d {tag}: a chunked admission ran")
        ttft = np.array([r.first_token_at - r.submitted_at for r in reqs])
        span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
        tok_s = sum(len(r.tokens) - 1 for r in reqs) / span
        run = dict(tokens=[list(r.tokens) for r in reqs], ids=[r.id for r in reqs],
                   counts=counts, gaps=gaps, tops=tops)
        if record:
            recorded[k] = run
            del srv, reqs
            continue
        out[k] = run
        name = f"speculate={k}" if k else "non-speculative"
        extra = ""
        if k:
            acc, per = spec_rates(before)
            extra = f"acceptance {acc:.3f}, {per:.2f} tokens per verify step, "
        log(f"[d] {tag} {name}: {len(reqs)} requests in {wall:.2f}s, {extra}decode {tok_s:.1f} "
            f"tok/s, TTFT p50 {np.percentile(ttft, 50) * 1e3:.0f} ms p99 "
            f"{np.percentile(ttft, 99) * 1e3:.0f} ms; launches flash "
            f"{counts.get('flash_attention', 0)}, decode {counts.get(f'paged_attention{mode}', 0)}")
        del srv, reqs
        torch.cuda.empty_cache()
    base, spec = out[0], out[w.speculate]
    same = sum(a == b for a, b in zip(spec["tokens"], base["tokens"]))
    log(f"[d] {tag}: {same} of {len(prompts)} speculative streams identical to the "
        f"non-speculative run's (token match {match_frac(spec['tokens'], base['tokens']):.3f})")
    if kv == "bf16":
        for k in recorded:
            require(recorded[k]["tokens"] == out[k]["tokens"],
                    f"phase d {tag}: the recorded and the timed run (k={k}) gave other streams")
        rb, rs = recorded[0], recorded[w.speculate]
        for i, (g, b) in enumerate(zip(spec["tokens"], base["tokens"])):
            if g == b:
                continue
            j = next((j for j in range(min(len(g), len(b))) if g[j] != b[j]), None)
            require(j is not None, f"phase d {tag}: stream {i} lengths differ at equal tokens")
            gap, top = rb["gaps"][rb["ids"][i]][j], rb["tops"][rb["ids"][i]][j]
            sgap, stop = rs["gaps"][rs["ids"][i]][j], rs["tops"][rs["ids"][i]][j]
            ulp = bf16_ulp(top)
            log(f"[d] {tag}: stream {i} first differs at token {j}: non-speculative top-2 gap "
                f"{gap:.4g} ({gap / ulp:.0f} bf16 ulp) at top logit {top:.4g}; the speculative "
                f"run's gap there {sgap:.4g}, its top logit {stop:.4g}")
            require(gap <= TIE_ULPS * ulp,
                    f"phase d {tag}: stream {i} differs at a gap of {gap} > {TIE_ULPS} bf16 ulp")
    return spec["counts"]


def spec_generate_run(eng, tag: str) -> dict:
    """Speculative ``generate`` at full width: the 3B's ``SPECULATIVE``
    prompts up to 1800 tokens, right-padded into one batch, capacity 2048,
    K = 4, 64 new tokens, beside ``generate``; every verify runs flash at
    S = 5 over 2048 + 5 columns. Prints tok/s and the token match (random
    weights: printed, not gated; [c] gates the f32 tokens). Returns the
    speculative run's launch counts."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    w = smoke_workload.SPECULATIVE["llama32_3b"]
    prompts = [p for p in smoke_workload.speculative_prompts(
        eng.cfg.vocab_size, np.random.default_rng(0), w) if len(p) <= 1800]
    S = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        batch[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts])
    res = {}
    for k in (0, w.speculate):
        before = spec_counters()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = eng.generate_ids(batch, smoke_workload.MAX_NEW, prompt_len=plen, capacity=2048,
                             speculate=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[k] = (r, K.launch_counts())
        new = int((r.lengths - plen).sum())
        extra = ""
        if k:
            acc, per = spec_rates(before)
            extra = f", acceptance {acc:.3f}, {per:.2f} tokens per verify step"
        log(f"[d] {tag} generate speculate={k}: {len(prompts)} rows, {new} tokens in {wall:.2f}s "
            f"({new / wall:.1f} tok/s){extra}; flash launches {res[k][1].get('flash_attention', 0)}")
    a, b = res[0][0], res[w.speculate][0]
    toks = [b.tokens[i, plen[i] : b.lengths[i]].tolist() for i in range(len(prompts))]
    ref = [a.tokens[i, plen[i] : a.lengths[i]].tolist() for i in range(len(prompts))]
    log(f"[d] {tag}: speculative generate token match against generate {match_frac(toks, ref):.3f} "
        f"(bf16, random weights: printed, not gated)")
    return res[w.speculate][1]


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
    """The workloads on random full-width weights loaded from port-written
    stores (depths ``D_3B``, ``D_3B_VIEW``, ``D_GEMMA2B``, ``D_7B_STORE``):
    Llama-3.2-3B bf16 (once per KV dtype; its shared-prefix
    workload cold and warm in each arena, and the host and disk tiers under
    pressure), int8 and int4 (bf16 arena), GPT-2 small and gemma-2B bf16
    (once per KV dtype, gemma-2B's shared-prefix workload warm), then
    gemma-7B bf16 at 4 layers (bf16 arena) and Llama-2-7B (its store's
    speculative workload; all 32 layers at tp 1 and 2, made on the card).
    Returns the launch counts of
    each kernel mode per model and workload (``model`` or
    ``model/shared_prefix``), each from the run that serves through it
    (unquantized modes: the bf16 weights' bf16 arena, warm for the shared
    prefix)."""
    import torch

    from llm_sharding_tpu_torch.models import config, gpt2, llama
    from llm_sharding_tpu_torch.ops.quant import quantize_params
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"[e] (d) {what} took {now - t_lap[0]:.0f}s")
        t_lap[0] = now

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    stores, write_s = {}, {}
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    cfgv = dataclasses.replace(cfg, num_hidden_layers=D_3B_VIEW)
    for w in ("bf16", "int8", "int4"):
        t0 = time.perf_counter()
        stores[w] = os.path.join(store_root, f"llama32_3b_{w}")
        if w == "bf16":
            save_shards(cfg, params, stores[w])
            write_s[w] = time.perf_counter() - t0
            continue
        out = quantize_params({**params, "layers": params["layers"][:D_3B_VIEW]},
                              bits=8 if w == "int8" else 4)
        save_shards(cfgv, out, stores[w])
        del out
        write_s[w] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    eng = load_store(stores["bf16"], "3B bf16", device, write_s["bf16"])
    paged_twin: dict = {}
    counts, base = serve_run(eng, "llama32_3b", "3B bf16 weights, kv bf16", twin=paged_twin)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    obs_serve_run(eng, store_root, smi)
    # the tracing overhead and the step-loop configurations run at 7 of the
    # 28 layers (a view of the same weights): the whole script's
    # time limit
    half = depth_view(eng, D_3B_VIEW)
    log(f"[d] the tracing overhead and step-loop runs below: 3B at "
        f"{half.cfg.num_hidden_layers} of the store's {eng.cfg.num_hidden_layers} layers")
    trace_overhead_run(half, store_root, smi)
    log(f"[d] 3B observability workloads took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    async_serve_runs(half, smi)
    del half
    log(f"[d] 3B step-loop configurations took {time.perf_counter() - t0:.1f}s")
    try:
        dcounts = frontdoor_runs(eng, stores["bf16"], smi, paged_twin)
        fleet = fleet_runs(eng, stores["bf16"], smi)
        pipeline = pipeline_runs(eng, stores["bf16"], smi, paged_twin)
    finally:
        stop_prestarted()
    tp_counts = parallel_runs(eng, stores["bf16"], smi, paged_twin, daemon=False)
    context_runs(eng, smi)
    segment_runs(eng, smi)
    cp_counts = cp_runs(eng, smi, paged_twin)
    cp_long_run(device, smi)
    launch_run(eng, stores["bf16"], smi)
    profile_counts = profile_runs(device, stores["bf16"], smi)
    lap("3B standard, observability, step loop, front door, fleet, pipeline, tensor / context, "
        "context-parallel serving, launch, profile")
    # the quantized arenas' runs, the shared-prefix workload, the
    # tiers under pressure and the int8 / int4 weight stores take 7 of the
    # 28 layers (a view of the same weights: the whole script's time limit)
    half = depth_view(eng, D_3B_VIEW)
    v = f"3B/{D_3B_VIEW}"
    _, base = serve_run(half, "llama32_3b", f"{v} bf16 weights, kv bf16")
    for kv in KV_MODES:
        kv_counts, tokens = serve_run(half, "llama32_3b", f"{v} bf16 weights, kv {kv}", kv)
        counts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
        log(f"[d] kv {kv}: token match against the {D_3B_VIEW}-layer bf16 arena's run "
            f"{match_frac(tokens, base):.3f} (random weights: printed, not gated)")
    # the shared-prefix workload, cold (cache off) and warm in each arena,
    # then the host and disk tiers under pressure
    log(f"[d] shared-prefix workload on {smi}")
    _, cold_tokens, cold = prefix_serve_run(half, "llama32_3b", f"{v} shared prefix, cold",
                                            "off")
    pcounts, warm_base, warm = prefix_serve_run(half, "llama32_3b", f"{v} shared prefix, warm")
    log(f"[d] {v} shared prefix: warm / cold TTFT p50 {warm[0] / cold[0]:.3f}, p99 "
        f"{warm[1] / cold[1]:.3f}, decode tok/s {warm[2] / cold[2]:.3f}; warm token match against "
        f"cold {match_frac(warm_base, cold_tokens):.3f} (printed, not gated)")
    for kv in KV_MODES:
        kv_counts, tokens, _ = prefix_serve_run(half, "llama32_3b",
                                                f"{v} shared prefix, warm, kv {kv}", kv=kv)
        pcounts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
        log(f"[d] shared prefix kv {kv}: token match against the bf16 arena's warm run "
            f"{match_frac(tokens, warm_base):.3f} (random weights: printed, not gated)")
    prefix_tier_run(half, "host", store_root)
    prefix_tier_run(half, "disk", store_root)
    del half
    lap("3B kv modes, shared prefix and tiers")
    t0 = time.perf_counter()
    # the resilience and speculative workloads run at 7 of the 3B's 28
    # layers (a view of the same weights) for the whole script's time limit
    half = depth_view(eng, D_3B_VIEW)
    resilience_serve_run(half, store_root)
    log(f"[d] 3B resilience workload took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    log(f"[d] speculative workload on {smi}")
    scounts = spec_serve_run(half, "llama32_3b", f"{v} speculative, kv bf16")
    for kv in KV_MODES:
        kv_counts = spec_serve_run(half, "llama32_3b", f"{v} speculative, kv {kv}", kv)
        scounts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
    del half
    gcounts_spec = spec_generate_run(eng, "3B")
    log(f"[d] 3B speculative workloads took {time.perf_counter() - t0:.1f}s")
    del eng
    shutil.rmtree(stores["bf16"])
    torch.cuda.empty_cache()
    for w in ("int8", "int4"):
        eng = load_store(stores[w], f"{v} {w}", device, write_s[w])
        _, tokens = serve_run(eng, "llama32_3b", f"{v} {w} weights, kv bf16")
        log(f"[d] {w} weights: token match against the {D_3B_VIEW}-layer bf16 weights' run "
            f"{match_frac(tokens, base):.3f} (random weights: printed, not gated)")
        del eng
        shutil.rmtree(stores[w])
        torch.cuda.empty_cache()
    lap("3B int8 / int4 weights")

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
    lap("gpt2")

    mcfg = dataclasses.replace(config.gemma_2b(), num_hidden_layers=D_GEMMA2B)
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
    mpcounts, _, _ = prefix_serve_run(eng, "gemma_2b", "gemma2b shared prefix, warm")
    lap("gemma2b")
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
    s7counts, _ = serve_run(eng, "gemma_7b", "gemma7b bf16 weights, kv bf16")
    lap("gemma7b")
    del eng
    shutil.rmtree(sstore)
    torch.cuda.empty_cache()

    # Llama-2-7B (G = 1, D = 128) at full width: a store of its first 8
    # layers, written once every earlier store is gone, serves the
    # speculative workload; the standard workload and tp 2 take all 32
    # layers, on the weights made on the card (no store)
    lcfg = config.llama2_7b()
    t0 = time.perf_counter()
    lstore = os.path.join(store_root, "llama2_7b_bf16")
    lparams = llama.init_params(lcfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(dataclasses.replace(lcfg, num_hidden_layers=D_7B_STORE),
                {**lparams, "layers": lparams["layers"][:D_7B_STORE]}, lstore)
    torch.cuda.empty_cache()
    seng = load_store(lstore, f"llama2-7b/{D_7B_STORE} bf16", device, time.perf_counter() - t0)
    shutil.rmtree(lstore)
    t0 = time.perf_counter()
    lscounts = spec_serve_run(seng, "llama2_7b", f"llama2-7b/{D_7B_STORE} speculative, kv bf16")
    for kv in KV_MODES:
        kv_counts = spec_serve_run(seng, "llama2_7b",
                                   f"llama2-7b/{D_7B_STORE} speculative, kv {kv}", kv)
        lscounts.update({k: n for k, n in kv_counts.items() if k.endswith(f"[{kv}]")})
    log(f"[d] llama2-7b speculative workload took {time.perf_counter() - t0:.1f}s")
    del seng
    torch.cuda.empty_cache()
    eng = Engine(lcfg, lparams)
    del lparams
    lcounts, ltokens = serve_run(eng, "llama2_7b", "llama2-7b bf16 weights, kv bf16")
    l7tp = tp_7b_run(eng, smi, ltokens)
    del eng
    torch.cuda.empty_cache()
    return {"llama32_3b": counts, "gpt2_small": gcounts, "gemma_2b": mcounts,
            "gemma_7b": s7counts, "llama32_3b/shared_prefix": pcounts,
            "gemma_2b/shared_prefix": mpcounts, "llama32_3b/speculative": scounts,
            "llama32_3b/spec_generate": gcounts_spec, "llama2_7b": lcounts,
            "llama2_7b/speculative": lscounts, "llama32_3b/dense": dcounts,
            "llama32_3b/fleet": fleet, "llama32_3b/pipeline": pipeline,
            "llama2_7b/tp2": l7tp, "llama32_3b/profile": profile_counts,
            **{f"llama32_3b/{k}": v for k, v in tp_counts.items()},
            **{f"llama32_3b/{k}": v for k, v in cp_counts.items()}}


REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


class Daemon:
    """``python -m llm_sharding_tpu_torch serve STORE`` as users start it:
    a subprocess with the HTTP ingress and the metrics exposition on free
    local ports and the tenants file, its stdin held open (the daemon reads
    prompts from it) and its stderr collected by a thread. Ready once the
    ingress banner is printed; ``startup_s`` runs from the start to the
    banner (``wait=False``: the caller waits with ``wait_ready``)."""

    def __init__(self, store: str, args: list, tenants: str, timeout_s: float = 300.0,
                 wait: bool = True):
        import socket
        import threading

        ports = []
        for _ in range(2):
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                ports.append(sk.getsockname()[1])
        self.port, self.metrics_port = ports
        self.lines: list = []
        self.ready_at = None
        self._timeout_s = timeout_s
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_sharding_tpu_torch", "serve", store, *args,
             "--http-port", str(self.port), "--metrics-port", str(self.metrics_port),
             "--tenants-config", tenants],
            cwd=REPO_ROOT, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
        )
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        if wait:
            self.wait_ready()

    def wait_ready(self) -> None:
        while self.ready_at is None:
            if self.proc.poll() is not None or time.perf_counter() - self._t0 > self._timeout_s:
                self.kill()
                raise RuntimeError("the serve daemon did not come up:\n" + self.tail())
            time.sleep(0.05)
        self.startup_s = self.ready_at - self._t0

    def _read(self) -> None:
        for line in self.proc.stderr:
            if self.ready_at is None and line.startswith("ingress: http://"):
                self.ready_at = time.perf_counter()
            self.lines.append(line)

    def tail(self, n: int = 30) -> str:
        return "".join(self.lines[-n:])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


# daemons started ahead by ``prestart_daemons``, by (store, args)
_PRESTARTED: dict = {}


def prestart_daemons(store: str, arg_lists: list, tenants: str) -> None:
    """Start the [d] daemons all at once and wait until every one is up,
    before any of them is measured: each takes ~13 s to reach the card and
    load the store, which one after another the script's time limit pays
    for each. ``daemon`` hands them out; an idle one sleeps in its poll
    loop and holds only its memory on the card."""
    started = [(tuple(a), Daemon(store, a, tenants, wait=False)) for a in arg_lists]
    try:
        for args, d in started:
            d.wait_ready()
    except Exception:
        for _, d in started:
            d.kill()
        raise
    _PRESTARTED.update({(store, args): d for args, d in started})
    log(f"[d] {len(started)} daemons started together, up in "
        f"{max(d.startup_s for _, d in started):.1f}s ({', '.join(f'{d.startup_s:.1f}' for _, d in started)})")


def daemon(store: str, args: list, tenants: str) -> "Daemon":
    """The daemon of ``args`` on ``store``: the one started ahead, else a
    new one."""
    d = _PRESTARTED.pop((store, tuple(args)), None)
    return d if d is not None else Daemon(store, args, tenants)


def stop_prestarted() -> None:
    """Kill the daemons started ahead that no part took (a part failed)."""
    while _PRESTARTED:
        _PRESTARTED.popitem()[1].kill()


def write_tenants(store: str) -> str:
    """The daemons' tenants file beside ``store``."""
    from llm_sharding_tpu_torch import smoke_workload

    tenants = os.path.join(os.path.dirname(store), "tenants.json")
    with open(tenants, "w") as f:
        json.dump(smoke_workload.TENANTS, f)
    return tenants


def pipeline_daemon_args(eng) -> list:
    from llm_sharding_tpu_torch import smoke_workload

    return (["--stages", "2", "--tensor-parallel", "2", "--device", str(eng.device)]
            + smoke_workload.daemon_args("llama32_3b", False))


def http_workload(port: int, prompts, max_new: int) -> list:
    """The standard workload as clients send it: requests in pairs 50 ms
    apart, alternately from the two ``smoke_workload.TENANTS``, the pairs
    alternately streamed (``smoke_workload.streamed``: each tenant streams a
    short and a long prompt); each ``(tokens, sent_s, first_token_s or
    None, done_s)``."""
    import threading

    from llm_sharding_tpu_torch import smoke_workload

    keys = [t["key"] for t in smoke_workload.TENANTS["tenants"].values()]
    out: list = [None] * len(prompts)

    def client(i):
        sent = time.perf_counter()
        try:
            status, got, first, done = http_post(
                port, "/v1/completions",
                {"prompt": [int(t) for t in prompts[i]], "max_tokens": max_new,
                 "stream": smoke_workload.streamed(i)},
                {"Authorization": f"Bearer {keys[i % 2]}"})
            out[i] = (response_tokens(f"phase d http request {i}", status, got), sent, first, done)
        except Exception as e:  # noqa: BLE001 — the phase fails on it below
            out[i] = e

    threads = []
    for i in range(len(prompts)):
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
        if i % 2:
            time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    for i, r in enumerate(out):
        require(isinstance(r, tuple), f"phase d: HTTP request {i} failed: {r!r}")
    return out


def hold_to(tag: str, got: list, want: list, rec, ulps=TIE_ULPS, index=None) -> None:
    """Each stream of ``got`` equals ``want``'s (stream ``index[i]`` of it,
    where given) or first differs at a near tie of the run ``rec()``
    records (made only then; its streams must be ``want``): a top-2 gap of
    at most ``ulps`` bf16 ulps of its top logit (``TIE_ULPS``; a list gives
    each stream its own)."""
    rec_run = None
    limits = list(ulps) if isinstance(ulps, (list, tuple)) else [ulps] * len(got)
    index = list(index) if index is not None else list(range(len(got)))
    for i, g in enumerate(got):
        w = want[index[i]]
        if g == w:
            continue
        if rec_run is None:
            rec_run = rec()
            require(rec_run["tokens"] == want, f"phase d {tag}: the recorded run gave other streams")
        j = next((j for j in range(min(len(g), len(w))) if g[j] != w[j]), None)
        require(j is not None, f"phase d {tag}: stream {i} lengths differ at equal tokens")
        rid = rec_run["ids"][index[i]]
        gap, top = rec_run["gaps"][rid][j], rec_run["tops"][rid][j]
        ulp = bf16_ulp(top)
        log(f"[d] {tag}: stream {i} first differs at token {j}: top-2 gap {gap:.4g} "
            f"({gap / ulp:.1f} bf16 ulp; limit {limits[i]})")
        require(gap <= limits[i] * ulp, f"phase d {tag}: stream {i} differs at a gap of {gap} "
                f"> {limits[i]} ulp")
    same = sum(g == want[k] for g, k in zip(got, index))
    log(f"[d] {tag}: {same} of {len(got)} streams identical")


def inprocess_run(eng, dense: bool, record: bool = False, model: str = "llama32_3b") -> dict:
    """The standard workload on the in-process twin of a daemon
    (``smoke_workload.serve``, dense or paged bf16), staggered: its streams,
    request ids, launch counts and, unless ``record``, decode tok/s and TTFT
    p50 / p99 (with ``record`` each token's top-2 gap and top logit)."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    cfg = eng.cfg
    srv = smoke_workload.serve(eng, model, dense=dense)
    prompts = smoke_workload.prompts(cfg.vocab_size, np.random.default_rng(0),
                                     smoke_workload.WORKLOADS[model].lens)
    tops: dict = {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with (recorded_gaps(srv, tops) if record else contextlib.nullcontext({})) as gaps:
        reqs = smoke_workload.submit_staggered(srv, prompts)
        srv.run_until_idle()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for r in reqs:
        require(r.done and r.error is None, f"phase d in-process run: request {r.id} failed")
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    srv.close()
    return dict(tokens=[list(r.tokens) for r in reqs], ids=[r.id for r in reqs], gaps=gaps,
                tops=tops, counts=counts, prompts=prompts, ttft=ttft,
                tok_s=sum(len(r.tokens) - 1 for r in reqs) / span)


def frontdoor_runs(eng, store: str, smi: str, paged_twin: dict) -> dict:
    """[d] The ``serve`` daemon on the port-written 3B store, dense (the
    command's default, capacity 4096) and paged (64 x 1024 blocks): the
    standard workload over HTTP as token ids from two tenants, half
    streamed. Each stream equals the in-process twin's or first differs at
    a near tie; ``/healthz`` answers 200, ``/metrics`` holds the ingress
    and tenant families and ``/statz`` the daemon's own kernel launches
    (flash > 0 in the dense run); the client's decode tok/s and TTFT
    p50 / p99 print beside the twin's (the paged twin is the standard bf16
    run ``serve_run`` made, ``paged_twin``). The paged daemon then gets
    SIGTERM with a stream live: the stream completes and the daemon exits
    0. Returns the dense twin's launch counts."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload

    t_all = time.perf_counter()
    tenants = write_tenants(store)
    dense_twin = inprocess_run(eng, True)
    dense_counts = dense_twin["counts"]
    require(dense_counts["flash_attention"] > 0, "phase d 3B daemon dense: flash never launched")
    torch.cuda.empty_cache()
    # this part's two daemons, the fleet's and the pipeline's
    prestart_daemons(store, [smoke_workload.daemon_args("llama32_3b", True),
                             smoke_workload.daemon_args("llama32_3b", False),
                             smoke_workload.fleet_daemon_args("llama32_3b"),
                             pipeline_daemon_args(eng)], tenants)
    for dense in (True, False):
        layout = "dense" if dense else "paged"
        tag = f"3B daemon {layout}"
        twin = dense_twin if dense else paged_twin
        d = daemon(store, smoke_workload.daemon_args("llama32_3b", dense), tenants)
        try:
            # two requests first, one-shot and chunked: the fresh process loads
            # the kernels and warms its libraries, as the twin's did long before
            key = smoke_workload.TENANTS["tenants"]["alice"]["key"]
            for n in (20, 300):
                response_tokens(f"phase d {tag} warm-up", *http_post(
                    d.port, "/v1/completions",
                    {"prompt": [int(t) for t in twin["prompts"][1][:n]], "max_tokens": 2},
                    {"Authorization": f"Bearer {key}"})[:2])
            t0 = time.perf_counter()
            runs = http_workload(d.port, twin["prompts"], smoke_workload.MAX_NEW)
            wall = time.perf_counter() - t0
            got = [r[0] for r in runs]
            hold_to(f"{tag} vs in-process", got, twin["tokens"],
                    lambda: inprocess_run(eng, dense, record=True))
            # TTFT where the client sees it (the streamed requests), beside
            # the twin's for the same requests; decode from the first token
            # a client saw to the last finish
            firsts = [r[2] - r[1] for r in runs if r[2] is not None]
            twin_firsts = [t for i, t in enumerate(twin["ttft"]) if smoke_workload.streamed(i)]
            span = max(r[3] for r in runs) - min(r[2] for r in runs if r[2] is not None)
            tok_s = sum(len(g) - 1 for g in got) / span
            status, body = http_get(d.port, "/healthz")
            require(status == 200, f"phase d {tag}: /healthz answered {status}")
            status, body = http_get(d.metrics_port, "/metrics")
            text = body.decode()
            for fam in ("server_ingress_requests_total", "server_ingress_ttft_seconds",
                        "server_tenant_service_tokens_total", "server_tenant_queued"):
                require(fam in text, f"phase d {tag}: /metrics lacks {fam}")
            require('tenant="alice"' in text and 'tenant="bob"' in text,
                    f"phase d {tag}: /metrics lacks the tenants' series")
            statz = json.loads(http_get(d.metrics_port, "/statz")[1])
            launches = statz["kernels"]
            require(launches["flash_attention"] > 0, f"phase d {tag}: the daemon never launched flash")
            if dense:
                require(launches["paged_attention"] == launches["paged_prefill"] == 0,
                        f"phase d {tag}: a paged kernel launched in the dense daemon: {launches}")
            # the clients send all 8 within 150 ms; the twin submits each pair
            # two steps after the last, so only request 0 meets the same queue
            log(f"[d] {tag} on {smi}: up in {d.startup_s:.1f}s; {len(got)} HTTP requests in "
                f"{wall:.2f}s: decode {tok_s:.1f} tok/s, TTFT of the {len(firsts)} streamed "
                f"requests p50 {np.percentile(firsts, 50) * 1e3:.0f} ms p99 "
                f"{np.percentile(firsts, 99) * 1e3:.0f} ms (each: "
                f"{', '.join(f'{t * 1e3:.0f}' for t in firsts)} ms); in-process twin: decode "
                f"{twin['tok_s']:.1f} tok/s, TTFT of the same requests p50 "
                f"{np.percentile(twin_firsts, 50) * 1e3:.0f} ms p99 "
                f"{np.percentile(twin_firsts, 99) * 1e3:.0f} ms (each: "
                f"{', '.join(f'{t * 1e3:.0f}' for t in twin_firsts)} ms; all 8: p50 "
                f"{np.percentile(twin['ttft'], 50) * 1e3:.0f} ms p99 "
                f"{np.percentile(twin['ttft'], 99) * 1e3:.0f} ms); the daemon's launches {launches}")
            if not dense:
                # SIGTERM with a stream live: it finishes, the daemon drains and exits 0
                import http.client

                conn = http.client.HTTPConnection("127.0.0.1", d.port, timeout=300)
                conn.request("POST", "/v1/completions", json.dumps(
                    {"prompt": [int(t) for t in twin["prompts"][0]],
                     "max_tokens": smoke_workload.MAX_NEW, "stream": True}),
                    {"Content-Type": "application/json", "Authorization": f"Bearer {key}"})
                resp = conn.getresponse()
                first = resp.readline()
                d.proc.send_signal(15)  # SIGTERM
                rest = resp.read().decode()
                conn.close()
                events = [json.loads(first[6:])] + [json.loads(ln[6:]) for ln in rest.splitlines()
                                                    if ln.startswith("data: {")]
                toks = response_tokens(f"phase d {tag} drain", 200, events)
                require(rest.rstrip().endswith("data: [DONE]"), f"phase d {tag}: no [DONE]")
                require(len(toks) == len(got[0]), f"phase d {tag}: the drained stream is cut")
                rc = d.proc.wait(timeout=120)
                d._reader.join(timeout=10)
                require(rc == 0 and "drained; exiting 0" in "".join(d.lines),
                        f"phase d {tag}: SIGTERM exit {rc}:\n{d.tail()}")
                log(f"[d] {tag}: SIGTERM during a streamed request: {len(toks)} tokens delivered, "
                    f"[DONE], exit 0")
        except Exception:
            log(f"[d] {tag}: daemon stderr tail:\n{d.tail()}")
            raise
        finally:
            if d.proc.poll() is None:
                d.proc.send_signal(15)
                try:
                    d.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    d.kill()
    log(f"[d] 3B front door took {time.perf_counter() - t_all:.1f}s")
    return dense_counts


# ---------------------------------------------------------- the fleet ([c], [d])

# a migrated or handed-off greedy bf16 stream may first differ from the
# one-replica twin's only where the twin's top-2 gap is at most this many
# bf16 ulps of its top logit (the re-prefilled KV moved by an ulp, as in
# the resilience workload's migration)
MIGRATED_ULPS = 1


@contextlib.contextmanager
def launches_per(sites, wrap):
    """Each kernel's launches per key while the block runs: every
    ``(owner, attr)`` in ``sites`` is replaced by ``wrap(orig, count)``, in
    which ``count(key, fn, *args)`` calls ``fn(*args)`` and attributes the
    launches the kernels' own counters took during it to ``key``."""
    from llm_sharding_tpu_torch.ops import kernels as K

    out: dict = collections.defaultdict(collections.Counter)

    def count(key, fn, *a, **kw):
        before = K.launch_counts()
        try:
            return fn(*a, **kw)
        finally:
            for k, n in K.launch_counts().items():
                if n > before.get(k, 0):
                    out[key][k] += n - before.get(k, 0)

    origs = [(o, attr, getattr(o, attr)) for o, attr in sites]
    for o, attr, fn in origs:
        setattr(o, attr, wrap(fn, count))
    try:
        yield out
    finally:
        for o, attr, fn in origs:
            setattr(o, attr, fn)


def replica_launches():
    """Each kernel's launches per replica (``r<d>``, its span source) while
    the block runs: every ``PipelineServer.step`` is wrapped (every kernel
    of a served run launches inside a step)."""
    from llm_sharding_tpu_torch.runtime.server import PipelineServer

    return launches_per([(PipelineServer, "step")],
                        lambda fn, count: lambda self: count(self._span_src, fn, self))

def run_fleet(rs, prompts, max_new: int, at=None) -> tuple:
    """Two requests, two router steps, until all are submitted, then the
    router stepped until every request is done and ``run_until_idle``
    (hand-offs landed); ``at[n]()`` runs before the router's n-th step.
    Returns the requests, the group each landed on at submit, and the
    wall seconds."""
    at = dict(at or {})
    reqs, groups, n = [], [], 0
    t0 = time.perf_counter()

    def step():
        nonlocal n
        if n in at:
            at.pop(n)()
        rs.step()
        n += 1

    for i in range(0, len(prompts), 2):
        for p in prompts[i : i + 2]:
            reqs.append(rs.submit(p, max_new))
            groups.append(rs._group_of[rs._owner[reqs[-1]]])
        step()
        step()
    while not all(r.done for r in reqs) or at:
        require(n < 10_000, "fleet run: requests never finished")
        step()
    rs.run_until_idle()
    return reqs, groups, time.perf_counter() - t0


def router_spans(since: float, name: str) -> list:
    """The router's ``name`` spans in the flight recorder emitted at or
    after ``since`` (the ring is bounded: by [c] it is full, so positions
    shift while it records)."""
    from llm_sharding_tpu_torch.obs.trace import FLIGHT_RECORDER

    return [e for e in FLIGHT_RECORDER.snapshot()
            if e["ts"] >= since and e.get("src") == "router" and e["span"] == name]


def fleet_tally() -> dict:
    from llm_sharding_tpu_torch.obs import metrics as M

    out = {f"handoff_{k}": M.DISAGG_HANDOFFS.labels(outcome=k).value
           for k in ("ok", "cold", "retried", "fallback", "no_target", "failed")}
    out.update(failovers=M.REPLICA_FAILOVERS.value, drains=M.REPLICA_DRAINS.value,
               spawns=M.REPLICA_SPAWNS.value, bytes=M.HANDOFF_BYTES.value,
               migrated_ok=M.REQUESTS_MIGRATED.labels(outcome="ok").value,
               migrated_failed=M.REQUESTS_MIGRATED.labels(outcome="failed").value,
               as_spawns=M.AUTOSCALE_SPAWNS.value, as_drains=M.AUTOSCALE_DRAINS.value)
    return out


def tally_delta(before: dict) -> dict:
    after = fleet_tally()
    return {k: after[k] - before[k] for k in before}


def count_moves(rs) -> list:
    """Wrap the router's ``_migrate_all`` to record, per call, how many live
    requests the source held when it began (what migration must move)."""
    seen = []
    orig = rs._migrate_all

    def migrate_all(src, cause):
        seen.append(sum(r is not None and not r.done for r in src._req)
                    + sum(not r.done for r in src._queue))
        return orig(src, cause)

    rs._migrate_all = migrate_all
    return seen


def block_bytes(cfg, elem_bytes: int, block: int = 64) -> int:
    """Bytes of one arena block of K and V over every layer."""
    hd = cfg.head_dim or cfg.hidden_size // cfg.num_attention_heads
    return 2 * cfg.num_hidden_layers * block * cfg.num_key_value_heads * hd * elem_bytes


def check_fleet(tag: str, eng, cpu_eng, prompts, lens, max_new: int, want: list) -> None:
    """[c] The fleet on the card, f32 3B at 4 layers, the host weights the
    CPU engine's: ``ReplicatedServer`` at dp 2 (one short and one long
    prompt per replica), its streams against ``generate``'s by the gap rule
    (< 1e-4) and every replica's decode kernel launched; a transient
    ``replica_step`` fault on group 0 mid-decode (failure threshold 1) fails
    it over: ``server_replica_failovers_total`` + 1, the migrated count the
    rows it held, every stream as the uninterrupted fleet's (gap rule);
    ``drain(1)`` then ``spawn_replica()`` mid-decode, likewise; a
    ``DisaggServer`` (1 prefill + 1 decode, ``prefix_cache="hbm"``) on the
    prompts of a block or more: every hand-off ``ok``, the bytes counted
    equal to the streamed blocks times the block's bytes, the streams as
    ``generate``'s; an ``Autoscaler`` (injected load and clock) takes a dp-3
    router from 2 live replicas to 3 and back to 2 mid-decode, no stream
    dropped."""
    import torch

    from llm_sharding_tpu_torch.runtime.autoscale import Autoscaler
    from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan
    from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer

    cfg, host = eng.cfg, cpu_eng.params
    kw = dict(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160, prefill_chunk=256)
    order = [0, 2, 3, 1]  # pairs (short, long) and (long, short): each replica gets one of each
    ps, ws = [prompts[i] for i in order], [want[i] for i in order]

    rs = ReplicatedServer(cfg, host, data_parallel=2, **kw)
    with replica_launches() as per:
        reqs, groups, _ = run_fleet(rs, ps, max_new)
    rs.close()
    base = [list(r.tokens) for r in reqs]
    hold_streams(f"{tag} dp=2 vs generate", base, ws, ps, eng)
    log(f"[c] {tag} dp=2: requests per replica {collections.Counter(groups)}; kernel launches "
        f"per replica {dict((k, dict(v)) for k, v in per.items())}")
    for r in ("r0", "r1"):
        require(per[r]["paged_attention"] > 0, f"phase c {tag} dp=2: replica {r} never decoded")

    b = fleet_tally()
    rs = ReplicatedServer(cfg, host, data_parallel=2, failure_threshold=1,
                          fault_plan=FaultPlan.transient_at("replica_step", 6, key=0), **kw)
    moves = count_moves(rs)
    reqs, _, _ = run_fleet(rs, ps, max_new)
    d = tally_delta(b)
    require(len(rs.servers) == 1 and 0 not in rs._by_group, f"phase c {tag}: no failover")
    rs.close()
    require(d["failovers"] == 1 and d["migrated_failed"] == 0 and moves
            and d["migrated_ok"] == sum(moves) > 0,
            f"phase c {tag} failover: deltas {d}, live rows at migration {moves}")
    require(all(r.error is None for r in reqs), f"phase c {tag} failover: a stream failed")
    hold_streams(f"{tag} dp=2 failover vs uninterrupted", [r.tokens for r in reqs], base, ps, eng)
    log(f"[c] {tag} dp=2 failover of group 0 mid-decode: failovers +{d['failovers']:g}, "
        f"requests migrated ok +{d['migrated_ok']:g} (the {sum(moves)} live on it)")

    b = fleet_tally()
    rs = ReplicatedServer(cfg, host, data_parallel=2, **kw)
    moves = count_moves(rs)
    reqs, _, _ = run_fleet(rs, ps, max_new, at={6: lambda: rs.drain(1),
                                                 8: lambda: rs.spawn_replica()})
    d = tally_delta(b)
    require(sorted(rs._by_group) == [0, 1], f"phase c {tag}: spawn did not revive group 1")
    rs.close()
    require(d["drains"] == 1 and d["spawns"] == 1 and d["migrated_ok"] == sum(moves) > 0
            and all(r.error is None for r in reqs), f"phase c {tag} drain/spawn: deltas {d}")
    hold_streams(f"{tag} dp=2 drain/spawn vs uninterrupted", [r.tokens for r in reqs], base, ps,
                 eng)
    log(f"[c] {tag} dp=2 drain(1) + spawn_replica() mid-decode: {sum(moves)} moved, none dropped")

    long_i = [i for i, n in enumerate(lens) if n >= 64]  # at least one whole block to stream
    dps, dws = [prompts[i] for i in long_i], [want[i] for i in long_i]
    b, mark = fleet_tally(), time.time()
    ds = DisaggServer(cfg, host, data_parallel=2, prefill_replicas=1, prefix_cache="hbm", **kw)
    with replica_launches() as per:
        reqs, _, _ = run_fleet(ds, dps, max_new)
    ds.close()
    d = tally_delta(b)
    spans = router_spans(mark, "handoff")
    streamed = sum(s.get("streamed", 0) for s in spans)
    require(d["handoff_ok"] == len(dps) and len(spans) == len(dps)
            and all(s["outcome"] == "ok" for s in spans),
            f"phase c {tag} disagg: hand-offs {d}, spans {[s['outcome'] for s in spans]}")
    require(d["bytes"] == sum(s.get("bytes", 0) for s in spans)
            == streamed // 64 * block_bytes(cfg, 4) > 0,
            f"phase c {tag} disagg: {d['bytes']} bytes counted, {streamed} tokens streamed")
    hold_streams(f"{tag} disagg 1+1 vs generate", [r.tokens for r in reqs], dws, dps, eng)
    log(f"[c] {tag} disagg 1+1: {len(spans)} hand-offs ok, {streamed} tokens / "
        f"{d['bytes'] / 1e6:.1f} MB streamed; launches per replica "
        f"{dict((k, dict(v)) for k, v in per.items())}")

    b = fleet_tally()
    rs = ReplicatedServer(cfg, host, data_parallel=3, min_replicas=2, **kw)
    rs.drain(2)
    now, load = [0.0], [0.5]
    sc = Autoscaler(rs, min_replicas=2, max_replicas=3, up_after_s=0.0, down_after_s=0.0,
                    cooldown_s=0.0, clock=lambda: now[0], load_fn=lambda: load[0])
    seen = []

    def tick(lv):
        load[0] = lv
        now[0] += 1.0
        seen.append((sc.tick(), len(rs.servers)))

    reqs, _, _ = run_fleet(rs, ps, max_new, at={3: lambda: tick(2.0), 7: lambda: tick(0.0)})
    d = tally_delta(b)
    rs.close()
    require(seen == [("spawn", 3), ("drain", 2)] and d["as_spawns"] == 1 == d["as_drains"],
            f"phase c {tag} autoscale: decisions {seen}, deltas {d}")
    require(all(r.error is None for r in reqs), f"phase c {tag} autoscale: a stream failed")
    hold_streams(f"{tag} autoscale 2 -> 3 -> 2 vs generate", [r.tokens for r in reqs], ws, ps, eng)
    log(f"[c] {tag} autoscaler: decisions {seen}, no stream dropped")
    torch.cuda.empty_cache()


def fleet_twin(eng, prompts, record: bool = False) -> dict:
    """[d] The fleet cell on one replica (``smoke_workload.fleet_kwargs``),
    staggered: streams, request ids, launches, TTFT and decode tok/s (with
    ``record`` each token's top-2 gap and top logit)."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K

    srv = eng.serve(**smoke_workload.fleet_kwargs("llama32_3b"))
    tops: dict = {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with (recorded_gaps(srv, tops) if record else contextlib.nullcontext({})) as gaps:
        reqs = smoke_workload.submit_staggered(srv, prompts)
        srv.run_until_idle()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for r in reqs:
        require(r.done and r.error is None, f"phase d fleet twin: request {r.id} failed")
    out = dict(tokens=[list(r.tokens) for r in reqs], ids=[r.id for r in reqs], gaps=gaps,
               tops=tops, counts=counts, ttft=[r.first_token_at - r.submitted_at for r in reqs],
               **fleet_numbers(reqs))
    srv.close()
    return out


def fleet_numbers(reqs) -> dict:
    """Decode tok/s (first token to last finish) and TTFT p50 / p99 (ms)."""
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    span = max(r.finished_at for r in reqs) - min(r.first_token_at for r in reqs)
    return dict(tok_s=sum(len(r.tokens) - 1 for r in reqs) / span,
                p50=float(np.percentile(ttft, 50) * 1e3), p99=float(np.percentile(ttft, 99) * 1e3))


def fleet_line(name: str, got: dict, twin: dict) -> str:
    return (f"{name}: decode {got['tok_s']:.1f} tok/s ({got['tok_s'] / twin['tok_s']:.3f} of the "
            f"twin's {twin['tok_s']:.1f}), TTFT p50 {got['p50']:.0f} ms p99 {got['p99']:.0f} ms "
            f"(twin {twin['p50']:.0f} / {twin['p99']:.0f} ms)")


def fleet_runs(eng, store: str, smi: str) -> dict:
    """[d] The fleet on the 3B bf16 (the store's engine; its weights
    copied to the host once, each replica staging its own): the one-replica
    twin; ``ReplicatedServer`` dp 2; dp 2 with a transient ``replica_step``
    fault on group 0 mid-decode (failover), then ``spawn_replica()`` (timed)
    and ``drain(1)``; ``DisaggServer`` 1 + 1 with ``prefix_cache="hbm"``;
    then the ``serve --data-parallel 2 --disagg`` daemon over HTTP. Every
    request finishes; streams equal the twin's or first differ at a near
    tie (``TIE_ULPS``; ``MIGRATED_ULPS`` for the in-process runs' migrated
    and handed-off ones); every replica of dp 2 launches every kernel; hand-offs are
    ``ok`` (``cold`` where a prompt has no whole block) and the bytes
    counted are the streamed blocks'. Prints decode tok/s and TTFT beside
    the twin's, requests and launches per replica, hand-offs by outcome
    with their ms and bytes, the failover's wall and the spawn's seconds.
    Returns each in-process fleet's launches per replica."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
    from llm_sharding_tpu_torch.runtime.faults import FaultPlan
    from llm_sharding_tpu_torch.runtime.replicated import ReplicatedServer, map_params

    t_all = time.perf_counter()
    # the in-process fleets run at 7 of the 28 layers (a view of the same
    # weights) for the whole script's time limit; the daemon
    # serves the whole store and is held to a twin on the store engine
    full, eng = eng, depth_view(eng, D_3B_VIEW)
    cfg = eng.cfg
    kw = smoke_workload.fleet_kwargs("llama32_3b")
    prompts = smoke_workload.fleet_order(smoke_workload.prompts(
        cfg.vocab_size, np.random.default_rng(0), smoke_workload.FLEET["llama32_3b"].lens))
    t0 = time.perf_counter()
    host = map_params(lambda x: x.to("cpu"), eng.params)
    log(f"[d] fleet on {smi}: host copy of the 3B weights in {time.perf_counter() - t0:.1f}s")
    twin = fleet_twin(eng, prompts)
    recorded: list = []
    src = [eng]  # the twin's engine: the depth view, then the full one

    def rec():  # the twin recorded once, only if a stream differs
        if not recorded:
            recorded.append(fleet_twin(src[0], prompts, record=True))
        return recorded[0]

    log("[d] " + fleet_line(f"3B/{cfg.num_hidden_layers} fleet twin (1 replica, 320 blocks)",
                            twin, twin))
    out: dict = {}

    def build(cls, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = cls(cfg, host, data_parallel=2, **extra, **kw)
        torch.cuda.synchronize()
        return srv, time.perf_counter() - t0

    rs, up_s = build(ReplicatedServer)
    with replica_launches() as per:
        reqs, groups, _ = run_fleet(rs, prompts, smoke_workload.MAX_NEW)
    rs.close()
    del rs
    torch.cuda.empty_cache()
    got = [list(r.tokens) for r in reqs]
    hold_to("3B dp=2 vs twin", got, twin["tokens"], rec)
    out["dp2"] = {k: dict(v) for k, v in per.items()}
    log(f"[d] " + fleet_line(f"3B dp=2 (up in {up_s:.1f}s)", fleet_numbers(reqs), twin))
    log(f"[d] 3B dp=2: requests per replica {dict(collections.Counter(groups))}; launches per "
        f"replica {out['dp2']}")
    for r in ("r0", "r1"):
        for k in ("flash_attention", "paged_attention", "paged_prefill"):
            require(per[r][k] > 0, f"phase d dp=2: replica {r} never launched {k}")

    b, mark = fleet_tally(), time.time()
    rs, _ = build(ReplicatedServer, failure_threshold=1,
                  fault_plan=FaultPlan.transient_at("replica_step", 14, key=0))
    moves = count_moves(rs)
    spawn_s = []

    def spawn():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.spawn_replica()
        torch.cuda.synchronize()
        spawn_s.append(time.perf_counter() - t0)

    # the replica holding the 2048-token prompt cannot be emptied once that
    # row has a token (its resumed prompt's bucket, 4096, leaves no room in
    # the capacity for its budget: a drain would fail it), so the drain
    # takes the revived replica's new traffic: two short prompts again
    extra = []
    reqs, _, _ = run_fleet(rs, prompts, smoke_workload.MAX_NEW, at={
        22: spawn,
        23: lambda: extra.extend(rs.submit(prompts[i], smoke_workload.MAX_NEW) for i in (0, 3)),
        26: lambda: rs.drain(0)})
    d = tally_delta(b)
    fail = router_spans(mark, "failover")
    migrated = {s["trace_id"] for s in router_spans(mark, "migrate") if s["outcome"] == "ok"}
    rs.close()
    del rs
    torch.cuda.empty_cache()
    require(d["failovers"] == 1 and d["spawns"] == 1 and d["drains"] == 1
            and d["migrated_failed"] == 0 and d["migrated_ok"] == sum(moves) > 0
            and len(moves) == 2 and moves[1] == 2,
            f"phase d dp=2 chaos: deltas {d}, live rows at each migration {moves}")
    require(all(r.done and r.error is None for r in extra), "phase d dp=2 chaos: extra failed")
    moved = [r.trace.trace_id in migrated for r in reqs + extra]
    hold_to("3B dp=2 failover/spawn/drain vs twin", [list(r.tokens) for r in reqs + extra],
            twin["tokens"], rec, ulps=[MIGRATED_ULPS if m else TIE_ULPS for m in moved],
            index=list(range(len(reqs))) + [0, 3])
    log(f"[d] 3B dp=2 chaos on {smi}: failover of group 0 at its step 14 in "
        f"{fail[0]['dur_s'] * 1e3:.0f} ms ({moves[0]} rows moved), spawn_replica() "
        f"{spawn_s[0]:.2f}s, two new requests on it, drain(0) moved {moves[1]}; "
        f"{sum(moved)} of {len(moved)} streams migrated, none dropped")

    b, mark = fleet_tally(), time.time()
    ds, up_s = build(DisaggServer, prefill_replicas=1, prefix_cache="hbm")
    with replica_launches() as per:
        reqs, _, _ = run_fleet(ds, prompts, smoke_workload.MAX_NEW)
    ds.close()
    del ds
    torch.cuda.empty_cache()
    d = tally_delta(b)
    spans = router_spans(mark, "handoff")
    outcomes = collections.Counter(s["outcome"] for s in spans)
    streamed = sum(s.get("streamed", 0) for s in spans)
    out["disagg"] = {k: dict(v) for k, v in per.items()}
    # cold: a prompt under one block has nothing to stream; fallback: the
    # 2048-token prompt's resumed prompt (bucket 4096) does not lay out on
    # the decode side, so it decodes where it prefilled (no layout)
    lens = [len(p) for p in prompts]
    want_out = collections.Counter(
        "cold" if n < 64 else "fallback" if n + 1 > 2048 else "ok" for n in lens)
    require(outcomes == want_out and all(s.get("reason", "no_layout") == "no_layout"
                                         for s in spans if s["outcome"] == "fallback"),
            f"phase d disagg: hand-off outcomes {dict(outcomes)}, expected {dict(want_out)}")
    require(d["bytes"] == sum(s.get("bytes", 0) for s in spans)
            == streamed // 64 * block_bytes(cfg, 2),
            f"phase d disagg: {d['bytes']} bytes counted for {streamed} streamed tokens")
    handed = {s["trace_id"] for s in spans if s["outcome"] in ("ok", "cold")}
    hold_to("3B disagg 1+1 vs twin", [list(r.tokens) for r in reqs], twin["tokens"], rec,
            ulps=[MIGRATED_ULPS if r.trace.trace_id in handed else TIE_ULPS for r in reqs])
    ms = [s["dur_s"] * 1e3 for s in spans if s["outcome"] == "ok"]
    log(f"[d] " + fleet_line(f"3B disagg 1+1 (up in {up_s:.1f}s)", fleet_numbers(reqs), twin))
    log(f"[d] 3B disagg on {smi}: hand-offs {dict(outcomes)}; ok hand-off ms p50 "
        f"{np.percentile(ms, 50):.1f} max {max(ms):.1f}, {streamed} tokens / "
        f"{d['bytes'] / 1e6:.1f} MB streamed ({[s.get('bytes') for s in spans]} B each); launches "
        f"per replica {out['disagg']}")
    # where an ok hand-off's wall goes: waiting for the sidecar, the stream
    # (the replicas' mutexes and the copy), the wait for the router lock
    log("[d] 3B disagg ok hand-offs (tokens: queue / stream / lock / all ms): " + ", ".join(
        f"{s['streamed']}: {s['queue_s'] * 1e3:.1f} / {s['stream_s'] * 1e3:.1f} / "
        f"{s['lock_s'] * 1e3:.1f} / {s['dur_s'] * 1e3:.1f}" for s in spans if s["outcome"] == "ok"))

    del host
    src[0] = full
    recorded.clear()
    twin = fleet_twin(full, prompts)
    tenants = write_tenants(store)
    dm = daemon(store, smoke_workload.fleet_daemon_args("llama32_3b"), tenants)
    tag = "3B daemon --data-parallel 2 --disagg"
    try:
        key = smoke_workload.TENANTS["tenants"]["alice"]["key"]
        warm = np.random.default_rng(99).integers(0, cfg.vocab_size, 300).astype(np.int32)
        for n in (20, 300):
            response_tokens(f"phase d {tag} warm-up", *http_post(
                dm.port, "/v1/completions", {"prompt": [int(t) for t in warm[:n]],
                                             "max_tokens": 2},
                {"Authorization": f"Bearer {key}"})[:2])
        t0 = time.perf_counter()
        runs = http_workload(dm.port, prompts, smoke_workload.MAX_NEW)
        wall = time.perf_counter() - t0
        got = [r[0] for r in runs]
        # the clients send all 8 within 150 ms, the twin each pair two steps
        # after the last: other rows share each step, so the front door's
        # near-tie rule holds here (a handed-off stream first differed at a
        # 2.0 ulp gap on an NVIDIA H100)
        hold_to(f"{tag} vs twin", got, twin["tokens"], rec)
        firsts = [r[2] - r[1] for r in runs if r[2] is not None]
        twin_firsts = [x for i, x in enumerate(twin["ttft"]) if smoke_workload.streamed(i)]
        span = max(r[3] for r in runs) - min(r[2] for r in runs if r[2] is not None)
        statz = json.loads(http_get(dm.metrics_port, "/statz")[1])
        reps = [(e["replica"], e["role"], e["counters"]["requests_completed"])
                for e in statz["replicas"]]
        require([r[1] for r in reps] == ["prefill", "decode"], f"phase d {tag}: roles {reps}")
        text = http_get(dm.metrics_port, "/metrics")[1].decode()
        hand = {ln.split('outcome="')[1].split('"')[0]: float(ln.split()[-1])
                for ln in text.splitlines() if ln.startswith("server_disagg_handoffs_total{")}
        require(hand.get("ok", 0) >= want_out["ok"] and not hand.get("failed"),
                f"phase d {tag}: hand-offs {hand}")
        log(f"[d] {tag} on {smi}: up in {dm.startup_s:.1f}s; {len(got)} HTTP requests in "
            f"{wall:.2f}s: decode {sum(len(g) - 1 for g in got) / span:.1f} tok/s, TTFT of the "
            f"{len(firsts)} streamed requests p50 {np.percentile(firsts, 50) * 1e3:.0f} ms p99 "
            f"{np.percentile(firsts, 99) * 1e3:.0f} ms (the twin: decode {twin['tok_s']:.1f} "
            f"tok/s, the same requests' TTFT p50 {np.percentile(twin_firsts, 50) * 1e3:.0f} ms p99 "
            f"{np.percentile(twin_firsts, 99) * 1e3:.0f} ms); replicas (group, role, completed) "
            f"{reps}; hand-offs {hand}; the daemon's launches {statz['kernels']}")
        dm.proc.send_signal(15)  # SIGTERM: nothing live, drains and exits 0
        rc = dm.proc.wait(timeout=120)
        dm._reader.join(timeout=10)
        require(rc == 0 and "drained; exiting 0" in "".join(dm.lines),
                f"phase d {tag}: SIGTERM exit {rc}:\n{dm.tail()}")
    except Exception:
        log(f"[d] {tag}: daemon stderr tail:\n{dm.tail()}")
        raise
    finally:
        if dm.proc.poll() is None:
            dm.proc.send_signal(15)
            try:
                dm.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                dm.kill()
    log(f"[d] 3B fleet took {time.perf_counter() - t_all:.1f}s")
    return out


def phase_fleet(device, store_root: str) -> dict:
    """``--fleet``: [c]'s fleet checks on the f32 3B at 4 layers and [d]'s
    fleet runs on the 3B bf16 from a port-written store (``D_3B``
    layers), alone."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    cpu_params = llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    eng, cpu_eng = Engine(cfg, to_device(cpu_params, device)), Engine(cfg, cpu_params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    want = check_against_generate("3B", eng, prompts, lens, 16)
    t0 = time.perf_counter()
    check_fleet("3B", eng, cpu_eng, prompts, lens, 16, want)
    log(f"[c] 3B fleet checks took {time.perf_counter() - t0:.1f}s")
    del eng, cpu_eng, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    t0 = time.perf_counter()
    store = os.path.join(store_root, "llama32_3b_bf16")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store)
    del params
    torch.cuda.empty_cache()
    eng = load_store(store, "3B bf16", device, time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return fleet_runs(eng, store, smi)


# ------------------------------------------------------ the pipeline ([c], [d])

def stage_launches():
    """Each kernel's launches per pipeline stage while the block runs:
    every stage's turn in the chain (``parallel/pipeline.run_stages``, which
    the serve programs and ``generate`` share) is attributed to its stage."""
    from llm_sharding_tpu_torch.parallel import pipeline as pipe_mod
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    def wrap(orig, count):
        return lambda stages, h, fn: orig(
            stages, h, lambda i, st, h: count(i, fn, i, st, h))

    return launches_per([(pipe_mod, "run_stages"), (serve_ops, "run_stages")], wrap)

def require_stage_kernels(tag: str, per: dict, n: int, modes=("",)) -> None:
    """Every one of ``n`` stages launched flash and both paged kernels (in
    each KV ``mode`` suffix, e.g. ``[int8]``)."""
    for s in range(n):
        for m in modes:
            for k in ("flash_attention", f"paged_attention{m}", f"paged_prefill{m}"):
                require(per[s][k] > 0, f"{tag}: stage {s} never launched {k}")


def tree_bytes(tree) -> int:
    from llm_sharding_tpu_torch.parallel.pipeline import map_params

    total = [0]
    map_params(lambda t: total.__setitem__(0, total[0] + t.numel() * t.element_size()), tree)
    return total[0]


def same_or_tie(tag: str, got: list, want: list, gaps: list, limit: float) -> None:
    """Each stream of ``got`` equals ``want``'s or first differs where the
    run that made ``want`` had a top-2 gap under ``limit``."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((j for j in range(min(len(g), len(w))) if g[j] != w[j]), None)
        require(j is not None and j < len(gaps[i]), f"{tag}: stream {i} lengths differ")
        log(f"[c] {tag}: stream {i} first differs at token {j}, top-2 gap {gaps[i][j]:.3g}")
        require(gaps[i][j] < limit, f"{tag}: stream {i} differs at a gap of {gaps[i][j]}")
    log(f"[c] {tag}: {sum(g == w for g, w in zip(got, want))} of {len(got)} streams identical")


# [c]: the 4-layer 3B's placements on the one card
PIPELINE_C = (("2 stages", None, 2), ("4 stages", None, 4), ("ragged 0:1,1:4", ((0, 1), (1, 4)), 2))


def check_pipeline(tag: str, eng, cpu_eng, cpu_params, prompts, lens, max_new: int,
                   cpu_want: list, rng) -> None:
    """[c] pipeline stages on one card (``devices=[cuda:0] * 4``), the
    weights staged from the CPU copy: at 2 and 4 stages and the ragged
    ``0:1,1:4``, the served streams in the f32, int8 and fp8 arenas,
    one-shot and chunked, held to the one-stage twin's (gap < 1e-4; the
    quantized arenas' gap < 1e-3, the twin's recorded gaps) and the f32
    arena's to CPU ``generate`` (gap < 1e-4); every stage launches all
    three kernels. At 2 stages: a radix hit, ``speculate=4``, a snapshot
    restored, an extract / adopt onto the one-stage engine, and
    ``pipeline_generate`` / ``generate_many`` against ``generate``.
    ``devices=None`` on this one-GPU host runs a 4-stage chain grouped."""
    import torch

    from llm_sharding_tpu_torch.parallel.placement import PlacementSpec
    from llm_sharding_tpu_torch.runtime.engine import Engine

    cfg, dev = eng.cfg, eng.device
    L = cfg.num_hidden_layers
    t_all = time.perf_counter()
    twin = {kv: served_streams(eng, prompts, max_new, kv_dtype=kv) for kv in ("bf16",) + KV_MODES}
    t0 = time.perf_counter()
    peng = Engine(cfg, cpu_params, num_stages=2, devices=[dev] * 4)
    torch.cuda.synchronize()
    log(f"[c] {tag} pipeline: staged 2 stages from the CPU copy in {time.perf_counter() - t0:.2f}s")
    for name, ranges, n in PIPELINE_C:
        spec = (PlacementSpec.from_ranges(ranges, L) if ranges
                else PlacementSpec.balanced(L, n))
        peng.apply_placement(spec)
        require(peng.num_stages == n and peng.exec_placement == spec,
                f"phase c {tag} {name}: runs {peng.exec_placement}")
        with stage_launches() as per:
            for kv in ("bf16",) + KV_MODES:
                got, _ = served_streams(peng, prompts, max_new, kv_dtype=kv)
                want, gaps = twin[kv]
                same_or_tie(f"{tag} {name} {kv} vs one stage", got, want, gaps,
                            1e-4 if kv == "bf16" else 1e-3)
                if kv == "bf16":
                    for i, (g, w) in enumerate(zip(got, cpu_want)):
                        if g != w:
                            j = next(j for j in range(min(len(g), len(w))) if g[j] != w[j])
                            gap = top2_gap(cfg, cpu_eng.params, np.concatenate(
                                [prompts[i], np.asarray(w[:j], np.int32)]))
                            require(gap < 1e-4, f"phase c {tag} {name}: stream {i} differs "
                                    f"from CPU generate at a gap of {gap}")
        require_stage_kernels(f"phase c {tag} {name}", per, n,
                              ("",) + tuple(f"[{kv}]" for kv in KV_MODES))
        log(f"[c] {tag} {name} ({spec.stages}): launches per stage "
            f"{ {s: dict(c) for s, c in sorted(per.items())} }")
    peng.apply_placement(PlacementSpec.balanced(L, 2))
    # a radix hit: a primer caches 3 of its blocks, a second prompt shares 2
    primer = prompts[1][:200]
    hit = np.concatenate([primer[:128], prompts[3][:300]]).astype(np.int32)
    outs = []
    for e in (eng, peng):
        srv = resilience_server(e, prefix_cache="hbm")
        a = srv.submit(primer, max_new)
        srv.run_until_idle()
        b = srv.submit(hit, max_new)
        srv.run_until_idle()
        outs.append(([list(a.tokens), list(b.tokens)], srv.prefix_cache_stats()["hit_tokens"]))
        srv.close()
    require(outs[1][1] == 128 == outs[0][1], f"phase c {tag}: radix hits {outs}")
    require(outs[1][0] == outs[0][0], f"phase c {tag}: the 2-stage radix hit's streams differ")
    log(f"[c] {tag} 2 stages: a radix hit of 128 tokens (one-shot suffix, chunked) identical to "
        "the one-stage server's")
    # speculation, one-shot admission: against the one-stage speculative server
    spec_twin = served_streams(eng, prompts, max_new, speculate=4, prefill_chunk=None)
    got, _ = served_streams(peng, prompts, max_new, speculate=4, prefill_chunk=None)
    same_or_tie(f"{tag} 2 stages speculate=4 vs one stage", got, spec_twin[0], spec_twin[1], 1e-4)
    # snapshot / restore mid-decode, and extract / adopt onto the one-stage engine
    base, gaps = interrupted_run(peng, prompts, max_new, gaps=True, kv_dtype="int8")
    restored = interrupted_run(peng, prompts, max_new, interrupt=restore_interrupt(peng),
                               kv_dtype="int8")
    require(restored == base, f"phase c {tag}: the 2-stage restored streams differ")
    uninterrupted = interrupted_run(peng, prompts, max_new)
    moved = interrupted_run(peng, prompts, max_new, interrupt=migrate_interrupt(eng))
    same_or_tie(f"{tag} 2 stages -> 1 stage migrated", moved, uninterrupted,
                interrupted_run(eng, prompts, max_new, gaps=True)[1], 1e-4)
    log(f"[c] {tag} 2 stages: snapshot restored (int8 arena) identical; 4 rows extracted and "
        "adopted by a one-stage server")
    # the chain's generate and the many-request schedule against generate
    few = [p[:200] for p in prompts]
    pad = np.zeros((len(few), 200), np.int32)
    for i, p in enumerate(few):
        pad[i, : len(p)] = p
    plen = np.array([len(p) for p in few])
    want = cpu_eng.generate_ids(pad, max_new, prompt_len=plen).tokens
    for what, res in (("pipeline_generate", peng.generate_ids(pad, max_new, prompt_len=plen)),
                      ("generate_many", peng.generate_many(pad, max_new, prompt_len=plen))):
        same = int((res.tokens == want).all(axis=1).sum())
        log(f"[c] {tag} 2 stages {what}: {same} of {len(few)} rows identical to CPU generate")
        require(same == len(few), f"phase c {tag}: {what} differs from generate")
    grouped = Engine(cfg, cpu_params, num_stages=4)
    require(grouped.num_stages == torch.cuda.device_count() == 1
            and grouped.placement.num_stages == 4,
            f"phase c {tag}: devices=None ran {grouped.num_stages} stages")
    log(f"[c] {tag}: devices=None on this {torch.cuda.device_count()}-GPU host runs the 4-stage "
        f"chain as {grouped.exec_placement.stages}")
    del grouped, peng
    torch.cuda.empty_cache()
    log(f"[c] {tag} pipeline checks took {time.perf_counter() - t_all:.1f}s")


# [d]: the 3B's placements on the one card, each over the standard
# workload's 8 rows; a 1-stage run comes before the first and after each
# (``PIPELINE_BASE``), so each placement is held to the 1-stage runs on
# either side of it and a drift over the sequence shows apart
PIPELINE_BASE = ("1 stage", None, 1)
PIPELINE_D = (("2 stages", None, 2), ("4 stages", None, 4), ("ragged", "ragged", 2))


def pipeline_serve(eng, stages: int) -> tuple:
    """The standard workload over 8 rows (``8 // stages`` per slot),
    staggered, with the stepline's dispatch share; returns ``(tokens,
    numbers, per-stage launches, dispatch share)``."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.obs.report import step_phase_table

    w = smoke_workload.WORKLOADS["llama32_3b"]
    srv = eng.serve(capacity=w.capacity, batch_per_slot=smoke_workload.ROWS // stages,
                    kv_block_size=smoke_workload.BLOCK_SIZE, kv_blocks=w.kv_blocks,
                    prefill_chunk=smoke_workload.PREFILL_CHUNK)
    require(srv.rows == smoke_workload.ROWS, f"phase d pipeline: {srv.rows} rows")
    prompts = smoke_workload.prompts(eng.cfg.vocab_size, np.random.default_rng(0), w.lens)
    steps0 = srv.stepline.steps_total
    torch.cuda.synchronize()
    with stage_launches() as per:
        reqs = smoke_workload.submit_staggered(srv, prompts)
        srv.run_until_idle()
    torch.cuda.synchronize()
    recs = srv.stepline_snapshot()[-(srv.stepline.steps_total - steps0):]
    for r in reqs:
        require(r.done and r.error is None, f"phase d pipeline: request {r.id} failed")
    srv._alloc.check()
    require(srv._alloc.in_use == 0, "phase d pipeline: KV blocks still held")
    share = {r["phase"]: r["wall_pct"] for r in step_phase_table(recs)}.get("dispatch", 0.0)
    srv.close()
    return [list(r.tokens) for r in reqs], fleet_numbers(reqs), per, share


def pipeline_daemon(store: str, eng, paged_twin: dict, rec) -> None:
    """A ``serve --stages 2 --tensor-parallel 2`` daemon over HTTP (also
    the tensor-parallel daemon of the whole script) takes
    ``:placement 4`` on stdin (4 stages of 2 shards) while round 1 of the
    workload is streaming (sent once two
    requests have their first token): the ingress pauses, the old server
    runs its requests to the end, the rebuilt 4-stage one serves round 2.
    Every request of both rounds answers 200 and its stream is held to the
    twin's (``TIE_ULPS``); at least one stream of round 1 is still open
    when the line is sent. Prints the streams cut across the swap and the
    daemon's ``engine_placement_swap_seconds``."""
    import threading

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.parallel.placement import PlacementSpec

    d = daemon(store, pipeline_daemon_args(eng), write_tenants(store))

    def metrics():
        return json.loads(http_get(d.metrics_port, "/statz")[1])["metrics"]

    def swaps():
        m = metrics()
        h = m["engine_placement_swap_seconds"]["series"][0]
        return h["count"], h["sum"], m["engine_pipeline_stages"]["series"][0]["value"]

    def first_tokens():
        return sum(x["count"] for x in metrics()["server_ingress_ttft_seconds"]["series"])

    try:
        require(any("serving llama on 2 stages from 2 tensor shards each" in ln
                    for ln in d.lines), f"phase d pipeline daemon: banner\n{d.tail()}")
        before, ft0 = swaps(), first_tokens()
        box: dict = {}

        def round1():
            try:
                box["runs"] = http_workload(d.port, paged_twin["prompts"], smoke_workload.MAX_NEW)
            except BaseException as e:  # noqa: BLE001 — the phase fails on it below
                box["error"] = e

        client = threading.Thread(target=round1)
        client.start()
        t0 = time.perf_counter()
        while first_tokens() < ft0 + 2:
            require(client.is_alive() and time.perf_counter() - t0 < 300,
                    f"phase d pipeline daemon: round 1 ended before two first tokens "
                    f"{box.get('error')!r}\n{d.tail()}")
            time.sleep(0.01)
        d.proc.stdin.write(":placement 4\n")
        d.proc.stdin.flush()
        sent = time.perf_counter()
        client.join(timeout=600)
        require("runs" in box, f"phase d pipeline daemon: round 1 failed: {box.get('error')!r}")
        while not any("placement applied" in ln or "placement" in ln and "fail" in ln
                      for ln in d.lines):
            require(time.perf_counter() - sent < 300 and d.proc.poll() is None,
                    f"phase d pipeline daemon: no placement line\n{d.tail()}")
            time.sleep(0.05)
        line = next(ln for ln in d.lines if "placement" in ln and ("applied" in ln or "fail" in ln))
        want = f"placement applied: {list(PlacementSpec.balanced(eng.cfg.num_hidden_layers, 4).stages)}"
        require(line.startswith(want), f"phase d pipeline daemon: {line}, not {want}")
        open_at_swap = sum(r[3] > sent for r in box["runs"])
        require(open_at_swap >= 1, "phase d pipeline daemon: every stream of round 1 had "
                "finished before :placement 4 was sent")
        rounds = [[r[0] for r in box["runs"]],
                  [r[0] for r in http_workload(d.port, paged_twin["prompts"],
                                               smoke_workload.MAX_NEW)]]
        for i, got in enumerate(rounds):
            hold_to(f"3B serve --stages 2 --tensor-parallel 2 daemon, round {i + 1} "
                    f"({'2 stages, :placement 4 mid-run' if i == 0 else '4 stages'}) vs twin",
                    got, paged_twin["tokens"], rec)
        after = swaps()
        require(after[0] == before[0] + 1 and before[2] == 2 and after[2] == 4,
                f"phase d pipeline daemon: swaps {before} -> {after}")
        log(f"[d] 3B serve --stages 2 --tensor-parallel 2 daemon: up in {d.startup_s:.1f}s (its staging: "
            f"engine_placement_swap_seconds {before[1]:.3f}s); :placement 4 sent "
            f"{(sent - t0) * 1e3:.0f} ms into round 1 with {open_at_swap} of "
            f"{len(box['runs'])} streams open, every request 200; {line.strip()}: "
            f"engine_placement_swap_seconds {after[1] - before[1]:.3f}s, "
            f"engine_pipeline_stages {before[2]:g} -> {after[2]:g}")
    except Exception:
        log(f"[d] pipeline daemon stderr tail:\n{d.tail()}")
        raise
    finally:
        if d.proc.poll() is None:
            d.proc.send_signal(15)
            try:
                d.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                d.kill()


def pipeline_runs(eng, store: str, smi: str, paged_twin: dict) -> dict:
    """[d] The 3B bf16 at 7 of its 28 layers (for the whole
    script's time limit; a view of the store engine's weights, copied to
    the host) staged onto ``cuda:0`` repeated: the standard workload at 2
    and 4 stages and at the ragged ``0:1,1:7`` (8 rows each), with a
    1-stage run before the first and after each; every stage launches the
    three kernels, every stream equals the 7-layer one-stage twin's or
    first differs at a near tie (``TIE_ULPS``). Printed: decode
    tok/s and TTFT p50 / p99 of each run, each placement's beside the mean
    of the 1-stage runs on either side of it, the spread of the 1-stage
    runs, launches, weight and head bytes per stage, the stepline's
    dispatch share and each ``apply_placement``'s seconds. Then
    ``pipeline_daemon`` on the whole store, held to ``paged_twin``. Returns
    the launches per stage of each placement."""
    import torch

    from llm_sharding_tpu_torch.parallel.placement import PlacementSpec
    from llm_sharding_tpu_torch.runtime.engine import Engine

    from llm_sharding_tpu_torch.parallel.pipeline import map_params

    t_all = time.perf_counter()
    full_rec = lambda: inprocess_run(eng, False, record=True)  # noqa: E731 — only on a mismatch
    half = depth_view(eng, D_3B_VIEW)
    L = half.cfg.num_hidden_layers
    twin = inprocess_run(half, False)
    rec = lambda: inprocess_run(half, False, record=True)  # noqa: E731
    t0 = time.perf_counter()
    peng = Engine(half.cfg, map_params(lambda t: t.to("cpu"), half.params),
                  placement=PlacementSpec.balanced(L, 1), devices=[eng.device] * 4)
    torch.cuda.synchronize()
    log(f"[d] pipeline on {smi}: the 3B at {L} of its {eng.cfg.num_hidden_layers} layers "
        f"copied to the host and staged as 1 stage in {time.perf_counter() - t0:.1f}s")
    out, runs = {}, []
    order = [PIPELINE_BASE]
    for p in PIPELINE_D:
        order += [p, PIPELINE_BASE]
    for k, (name, ranges, n) in enumerate(order):
        if ranges == "ragged":  # the reference's short first stage: 3/14 of the layers
            ranges = ((0, L * 3 // 14), (L * 3 // 14, L))
            name = f"ragged 0:{L * 3 // 14},{L * 3 // 14}:{L}"
        spec = (PlacementSpec.from_ranges(ranges, L) if ranges
                else PlacementSpec.balanced(L, n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peng.apply_placement(spec)
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        require(peng.num_stages == n, f"phase d pipeline {name}: {peng.num_stages} stages")
        tokens, nums, per, share = pipeline_serve(peng, n)
        runs.append(nums)
        hold_to(f"3B/{L} pipeline {name} (run {k + 1}) vs twin", tokens, twin["tokens"], rec)
        require_stage_kernels(f"phase d pipeline {name}", per, n)
        out.setdefault(name, {s: dict(c) for s, c in sorted(per.items())})
        sizes = [(tree_bytes(st.layers), tree_bytes({k: v for k, v in st.head.items()}))
                 for st in peng.stages]
        log(f"[d] 3B pipeline run {k + 1}, {name} ({spec.stages}; applied in {swap_s:.2f}s): "
            f"decode {nums['tok_s']:.1f} tok/s, TTFT p50 {nums['p50']:.0f} ms p99 "
            f"{nums['p99']:.0f} ms; dispatch {share:.2f}% of step wall; launches per stage "
            f"{out[name]}; weight / head bytes per stage "
            f"{[(f'{a / 1e9:.3f} GB', f'{b / 1e6:.1f} MB') for a, b in sizes]}")
    for k in range(1, len(order), 2):  # each placement against its two 1-stage neighbours
        base = {m: (runs[k - 1][m] + runs[k + 1][m]) / 2 for m in ("tok_s", "p50", "p99")}
        log(f"[d] " + fleet_line(f"3B pipeline {order[k][0]}", runs[k], base)
            .replace("the twin's", "the 1-stage runs' mean").replace("(twin", "(1-stage mean")
            + f"; TTFT p50 {runs[k]['p50'] / base['p50']:.3f}x")
    ones = runs[::2]
    log(f"[d] 3B pipeline, the {len(ones)} 1-stage runs in order: decode "
        f"{[round(r['tok_s'], 1) for r in ones]} tok/s, TTFT p50 "
        f"{[round(r['p50']) for r in ones]} ms")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    del half
    pipeline_daemon(store, eng, paged_twin, full_rec)
    log(f"[d] 3B pipeline took {time.perf_counter() - t_all:.1f}s")
    return out


def phase_pipeline(device, store_root: str) -> dict:
    """``--pipeline``: [c]'s pipeline checks on the f32 3B at 4 layers and
    [d]'s pipeline runs on the 3B bf16 from a port-written store of
    ``D_3B`` layers (7 of its 28 in process, the daemon on the whole
    store), alone."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    cpu_params = llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    eng, cpu_eng = Engine(cfg, to_device(cpu_params, device)), Engine(cfg, cpu_params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    cpu_want = check_against_generate("3B vs CPU", eng, prompts, lens, 16, oracle=cpu_eng)
    check_pipeline("3B", eng, cpu_eng, cpu_params, prompts, lens, 16, cpu_want, rng)
    del eng, cpu_eng, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    t0 = time.perf_counter()
    store = os.path.join(store_root, "llama32_3b_bf16")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store)
    del params
    torch.cuda.empty_cache()
    eng = load_store(store, "3B bf16", device, time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    paged_twin = inprocess_run(eng, False)
    log(f"[d] 3B pipeline twin (the store engine, 1 stage, 8 rows): decode "
        f"{paged_twin['tok_s']:.1f} tok/s, TTFT p50 {np.percentile(paged_twin['ttft'], 50) * 1e3:.0f}"
        f" ms p99 {np.percentile(paged_twin['ttft'], 99) * 1e3:.0f} ms")
    return pipeline_runs(eng, store, smi, paged_twin)


# ------------------------------------- tensor and context parallelism ([b]-[d])

def shard_cfg(cfg, tp: int):
    """``cfg`` at the head counts one of ``tp`` tensor shards attends over
    (the head dim kept)."""
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                               num_key_value_heads=cfg.num_key_value_heads // tp,
                               head_dim=cfg.head_dim_)


def tp_kernel_cases(model: str) -> list:
    """The [b] cases at a tensor shard's shapes (bf16 arena: quantized KV is
    refused under tp): the 3B's 24 / 8 heads over 2 shards (12 / 4) and 4
    (6 / 2), Llama-2-7B's 32 / 32 over 2 (16 / 16), G and D as the model's;
    decode at 8 rows of 100-2048 tokens, chunked prefill at frontiers
    256 / 2048, flash at S = C = 2048. Launches per shard from the [d]
    tensor-parallel run of the same degree. Same tuple as
    ``spec_kernel_cases``."""
    from llm_sharding_tpu_torch.ops import attention, flash_attention, paged_attention

    dec = ("llm_sharding_tpu/ops/paged_attention.py:484", "llm_sharding_tpu_torch/csrc/paged_attention.cu")
    pre = ("llm_sharding_tpu/ops/paged_attention.py:689", "llm_sharding_tpu_torch/csrc/paged_prefill.cu")
    fla = ("llm_sharding_tpu/ops/flash_attention.py:124", "llm_sharding_tpu_torch/csrc/flash_attention.cu")
    pa, pp, xla = (paged_attention.paged_attention, paged_attention.paged_prefill,
                   paged_attention.paged_attention_xla)
    fa, plain_fa = flash_attention.flash_attention, attention.cached_attention
    tag = {"llama32_3b": "", "llama2_7b": "llama2-7b "}[model]
    cases = []
    for tp in ((2, 4) if model == "llama32_3b" else (2,)):
        def sh(make, tp=tp):
            return lambda cfg, *a: make(shard_cfg(cfg, tp), *a)

        cases += [
            ("paged_attention", f"{tag}tp{tp} shard decode B=8 ctx 100-2048", pa, xla,
             sh(decode_case), *dec, f"tp{tp}"),
            ("paged_prefill", f"{tag}tp{tp} shard chunk Sc=256 frontiers 256/2048", pp, xla,
             sh(prefill_case), *pre, f"tp{tp}"),
            ("flash_attention", f"{tag}tp{tp} shard S=C=2048 causal", fa, plain_fa,
             sh(lambda *a: flash_case(*a, S=2048)), *fla, f"tp{tp}"),
        ]
    return cases


def shard_launches():
    """Each kernel's launches per tensor shard while the block runs: every
    shard's part of a layer (``models/stack.tp_reduce``'s per-shard call,
    which holds the shard's attention) is attributed to its shard; a
    one-device layer counts as shard 0."""
    from llm_sharding_tpu_torch.models import gpt2, llama

    def wrap(orig, count):
        return lambda p, h, fn: orig(p, h, lambda pj, hj, j: count(j or 0, fn, pj, hj, j))

    return launches_per([(llama, "tp_reduce"), (gpt2, "tp_reduce")], wrap)

@contextlib.contextmanager
def decode_reduces():
    """The reduces each ``serve_chunk`` issued, with its step count:
    ``[(reduces, cycles), ...]``."""
    from llm_sharding_tpu_torch.models.stack import reduce_count
    from llm_sharding_tpu_torch.parallel import serve as serve_ops

    out: list = []
    orig = serve_ops.serve_chunk

    def serve_chunk(cfg, model, state, cycles=1, backend="auto"):
        n0 = reduce_count()
        try:
            return orig(cfg, model, state, cycles, backend)
        finally:
            out.append((reduce_count() - n0, cycles))

    serve_ops.serve_chunk = serve_chunk
    try:
        yield out
    finally:
        serve_ops.serve_chunk = orig


def shard_bytes(eng) -> list:
    """Weight bytes each tensor shard holds, summed over the stages (the
    heads and norms of a stage stay whole on its first device)."""
    from llm_sharding_tpu_torch.models.stack import Shards

    out = [0] * eng.tensor_parallel
    for st in eng.stages:
        for layer in st.layers:
            for j, p in enumerate(layer if isinstance(layer, Shards) else [layer]):
                out[j] += tree_bytes(p)
    return out


def hold_to_cpu(tag: str, got: list, want: list, prompts, cpu_eng, limit: float = 1e-4) -> None:
    """Each of ``got`` (token lists) equals ``want``'s (CPU ``generate``'s)
    or first differs where the CPU run's top-2 gap is under ``limit``."""
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) == list(w):
            continue
        j = next((j for j in range(min(len(g), len(w))) if g[j] != w[j]), None)
        require(j is not None, f"phase c {tag}: stream {i} lengths differ at equal tokens")
        gap = top2_gap(cpu_eng.cfg, cpu_eng.params,
                       np.concatenate([prompts[i], np.asarray(w[:j], np.int32)]))
        log(f"[c] {tag}: stream {i} first differs at token {j}, CPU top-2 gap {gap:.3g}")
        require(gap < limit, f"phase c {tag}: stream {i} differs from CPU generate at a gap "
                f"of {gap}")
    log(f"[c] {tag}: {sum(list(g) == list(w) for g, w in zip(got, want))} of {len(got)} "
        "streams identical to CPU generate")


def padded(prompts, S: int) -> tuple:
    """``prompts`` cut to ``S`` tokens, right-padded to ``[n, S]``, and
    their lengths."""
    few = [p[:S] for p in prompts]
    out = np.zeros((len(few), S), np.int32)
    for i, p in enumerate(few):
        out[i, : len(p)] = p
    return out, np.array([len(p) for p in few])


def check_parallel(tag: str, eng, cpu_eng, cpu_params, prompts, lens, max_new: int,
                   cpu_want: list) -> None:
    """[c] tensor and context parallelism on one card (``devices=[cuda:0]
    * n``), f32, the weights staged from the CPU copy; every stream held to
    ``generate`` run on the CPU (a mismatch passes only where the CPU
    run's top-2 gap is < 1e-4). ``generate_ids`` at tp 2 and 4, pp 2 × tp 2
    and dp 2 × pp 2; the served streams (paged, one-shot and chunked) at tp
    2 and pp 2 × tp 2, every shard launching all three kernels;
    ``speculate=3``, a prefix handle and the dense server at tp 2; GPT-2
    small (4 layers, full width: the permuted qkv) and int8 weights at tp
    2; ``context_generate`` at cp 2 and 4 over a 1000-token prompt;
    ``decode_from_cache`` with ``donate_cache=False`` twice from
    one ring prefill; a sampled ``context_generate`` against the card's
    ``generate(seed=)``."""
    import torch

    from llm_sharding_tpu_torch.models import config, gpt2
    from llm_sharding_tpu_torch.ops.quant import quantize_params
    from llm_sharding_tpu_torch.parallel.context import context_generate, context_prefill_cache
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.runtime.generate import decode_from_cache, generate

    cfg, dev = eng.cfg, eng.device
    t_all = time.perf_counter()
    pad, plen = padded(prompts, 200)
    want = cpu_eng.generate_ids(pad, max_new, prompt_len=plen)
    want_rows = [want.tokens[i, plen[i]: want.lengths[i]].tolist() for i in range(len(plen))]
    few = [p[:200] for p in prompts]
    for name, kw in (("tp 2", dict(tensor_parallel=2)), ("tp 4", dict(tensor_parallel=4)),
                     ("pp 2 x tp 2", dict(num_stages=2, tensor_parallel=2)),
                     ("dp 2 x pp 2", dict(num_stages=2, data_parallel=2))):
        n = kw.get("num_stages", 1) * kw.get("tensor_parallel", 1) * kw.get("data_parallel", 1)
        t0 = time.perf_counter()
        peng = Engine(cfg, cpu_params, devices=[dev] * n, **kw)
        torch.cuda.synchronize()
        staged = time.perf_counter() - t0
        with shard_launches() as per:
            res = peng.generate_ids(pad, max_new, prompt_len=plen)
        got = [res.tokens[i, plen[i]: res.lengths[i]].tolist() for i in range(len(plen))]
        hold_to_cpu(f"{tag} generate_ids {name}", got, want_rows, few, cpu_eng)
        tp = kw.get("tensor_parallel", 1)
        require(all(per[j]["flash_attention"] > 0 for j in range(tp)),
                f"phase c {tag} {name}: a shard never launched flash ({dict(per)})")
        log(f"[c] {tag} generate_ids {name}: staged in {staged:.2f}s; flash launches per shard "
            f"{[per[j]['flash_attention'] for j in range(tp)]}")
        if name in ("tp 2", "pp 2 x tp 2"):
            with shard_launches() as per:
                got, _ = served_streams(peng, prompts, max_new)
            hold_to_cpu(f"{tag} served {name} (one-shot + chunked)", got, cpu_want, prompts,
                        cpu_eng)
            for j in range(tp):
                for k in ("flash_attention", "paged_attention", "paged_prefill"):
                    require(per[j][k] > 0, f"phase c {tag} served {name}: shard {j} never "
                            f"launched {k}")
            log(f"[c] {tag} served {name}: launches per shard "
                f"{ {j: dict(c) for j, c in sorted(per.items())} }")
        if name == "tp 2":
            got, _ = served_streams(peng, prompts, max_new, speculate=3, prefill_chunk=None)
            hold_to_cpu(f"{tag} served tp 2 speculate=3", got, cpu_want, prompts, cpu_eng)
            got, _ = served_streams(peng, prompts, max_new, kv_block_size=None, kv_blocks=None)
            hold_to_cpu(f"{tag} served tp 2 dense", got, cpu_want, prompts, cpu_eng)
            srv = peng.serve(capacity=2048, batch_per_slot=2, kv_block_size=64, kv_blocks=160)
            h = srv.prefill_prefix(prompts[2][:512])
            r = srv.submit(prompts[2][512:], max_new, prefix=h)
            srv.run_until_idle()
            hold_to_cpu(f"{tag} served tp 2 prefix handle (512 + {lens[2] - 512})",
                        [r.tokens], [cpu_want[2]], [prompts[2]], cpu_eng)
            srv.close()
        del peng
        torch.cuda.empty_cache()
    # int8 weights at tp 2, against the int8 model on the CPU
    q = quantize_params(cpu_params, bits=8)
    qcpu = Engine(cfg, q)
    qres = Engine(cfg, q, tensor_parallel=2, devices=[dev] * 2).generate_ids(
        pad, max_new, prompt_len=plen)
    qwant = qcpu.generate_ids(pad, max_new, prompt_len=plen)
    hold_to_cpu(f"{tag} int8 weights generate_ids tp 2",
                [qres.tokens[i, plen[i]: qres.lengths[i]].tolist() for i in range(len(plen))],
                [qwant.tokens[i, plen[i]: qwant.lengths[i]].tolist() for i in range(len(plen))],
                few, qcpu)
    del q, qcpu
    # GPT-2 small at full width, 4 layers: the permuted fused qkv
    gcfg = dataclasses.replace(config.gpt2_small(), num_hidden_layers=4)
    gcpu = gpt2.init_params(gcfg, seed=8, dtype=torch.float32, device="cpu")
    gpad, gplen = padded([np.random.default_rng(8).integers(0, gcfg.vocab_size, n)
                          .astype(np.int32) for n in (40, 200)], 200)
    gres = Engine(gcfg, gcpu, tensor_parallel=2, devices=[dev] * 2).generate_ids(
        gpad, max_new, prompt_len=gplen)
    gcpu_eng = Engine(gcfg, gcpu)
    gwant = gcpu_eng.generate_ids(gpad, max_new, prompt_len=gplen)
    hold_to_cpu(f"{tag} gpt2 (4 layers) generate_ids tp 2",
                [gres.tokens[i, gplen[i]: gres.lengths[i]].tolist() for i in range(2)],
                [gwant.tokens[i, gplen[i]: gwant.lengths[i]].tolist() for i in range(2)],
                [gpad[i, : gplen[i]] for i in range(2)], gcpu_eng)
    del gcpu, gcpu_eng
    # context parallelism: the 1000-token prompt (a multiple of 2 and 4; the
    # padded case runs in the cuda tests), cp 2 and 4, against CPU generate
    long = prompts[3][None]
    by_cp = {}
    for cp in (2, 4):
        t0 = time.perf_counter()
        res = by_cp[cp] = context_generate(cfg, [dev] * cp, eng.params, long, max_new)
        torch.cuda.synchronize()
        hold_to_cpu(f"{tag} context_generate cp {cp} (1000 tokens)",
                    [res.tokens[0, lens[3]: res.lengths[0]].tolist()], [cpu_want[3]],
                    [prompts[3]], cpu_eng)
        log(f"[c] {tag} context_generate cp {cp}: {time.perf_counter() - t0:.2f}s")
    logits, cache = context_prefill_cache(cfg, [dev] * 2, eng.params, long)
    runs = [decode_from_cache(cfg, eng.params, long, logits, cache, max_new,
                              donate_cache=False).tokens for _ in range(2)]
    require((runs[0] == runs[1]).all() and (runs[0] == by_cp[2].tokens).all(),
            f"phase c {tag}: decode_from_cache(donate_cache=False) twice gave other tokens")
    sampled = dict(temperature=0.8, top_k=40, seed=11)
    s_cp = context_generate(cfg, [dev] * 2, eng.params, long, max_new, **sampled)
    s_gen = generate(cfg, eng.params, long, max_new, **sampled)
    require((s_cp.tokens == s_gen.tokens).all(),
            f"phase c {tag}: sampled context_generate differs from generate(seed=)")
    log(f"[c] {tag}: decode_from_cache(donate_cache=False) twice from one ring prefill "
        "identical; a sampled context_generate (T 0.8, top-k 40) identical to the card's "
        "generate(seed=11)")
    del cache, logits
    torch.cuda.empty_cache()
    log(f"[c] {tag} tensor / context parallel checks took {time.perf_counter() - t_all:.1f}s")


@contextlib.contextmanager
def cp_launches():
    """Each kernel's launches per context-parallel shard while the block
    runs, and ``register(srv)``: every shard's attention call of a cp layer
    (``models/llama.cp_attn_fn`` calls the kernel wrappers once per shard)
    is attributed to its shard by the arena storage it reads, which a
    registered server's state names (-1: not registered)."""
    from llm_sharding_tpu_torch.models import llama

    owner: dict = {}

    def register(srv):
        for ar in srv.state.arenas:
            for sh, part in enumerate(ar.k.parts):
                owner[part.untyped_storage().data_ptr()] = sh

    def wrap(fn, count):
        return lambda q, k_arena, *a, **kw: count(
            owner.get(k_arena.untyped_storage().data_ptr(), -1), fn, q, k_arena, *a, **kw)

    with launches_per([(llama, "paged_attention"), (llama, "paged_prefill")], wrap) as out:
        yield out, register

def stats_only(tag: str, per: dict, cp: int) -> None:
    """Every shard launched the stats mode of both paged kernels, and no
    shard ran the normal mode (a cp server's attention is stats only)."""
    for sh in range(cp):
        c = per.get(sh, {})
        for k in ("paged_attention[stats]", "paged_prefill[stats]"):
            require(c.get(k, 0) > 0, f"{tag}: shard {sh} never launched {k} ({dict(c)})")
        normal = {k: n for k, n in c.items() if "stats" not in k and n}
        require(not normal, f"{tag}: shard {sh} launched the normal mode {normal}")
    require(-1 not in per, f"{tag}: paged launches outside the cp shards: {dict(per.get(-1, {}))}")


def cp_engine(cfg, params, dev, cp: int):
    """A one-stage engine with room for a cp-shard grid (``devices=[dev] *
    cp``: every shard on the one card)."""
    from llm_sharding_tpu_torch.runtime.engine import Engine

    return Engine(cfg, params, num_stages=1, devices=[dev] * cp)


def check_cp(tag: str, eng, cpu_eng, cpu_params, prompts, lens, max_new: int,
             cpu_want: list, card_want: list) -> None:
    """[c] context-parallel serving on one card (``serve(cp=N)``, every
    shard on ``cuda:0``), f32: the served streams (one-shot and chunked) at
    cp 2 and 4 held to the cp-1 server's and to ``generate`` on the CPU
    (a mismatch passes only where the CPU run's top-2 gap is < 1e-4), every
    shard launching the stats mode of both paged kernels and no normal
    mode; at cp 2 a radix hit (admitted chunked), a snapshot restored into
    a fresh server mid-decode, and a disagg hand-off between two cp-2
    replicas (``ok``, streamed per shard)."""
    import torch

    from llm_sharding_tpu_torch.obs.metrics import CP_STREAM_SHARDS, DISAGG_HANDOFFS
    from llm_sharding_tpu_torch.runtime.disagg import DisaggServer
    from llm_sharding_tpu_torch.runtime.server import PipelineServer

    cfg, dev = eng.cfg, eng.device
    t_all = time.perf_counter()
    cp1, _ = served_streams(eng, prompts, max_new)
    hold_to_cpu(f"{tag} served cp 1 vs the card's generate", cp1, card_want, prompts, cpu_eng)
    for cp in (2, 4):
        ceng = cp_engine(cfg, cpu_params, dev, cp)
        with cp_launches() as (per, register_cp):
            orig = ceng.serve

            def serve(**kw):
                srv = orig(**kw)
                register_cp(srv)
                return srv

            ceng.serve = serve
            got, _ = served_streams(ceng, prompts, max_new, cp=cp)
        del ceng.serve
        hold_to_cpu(f"{tag} served cp {cp} vs cp 1 (one-shot + chunked)", got, cp1,
                    prompts, cpu_eng)
        hold_to_cpu(f"{tag} served cp {cp} vs CPU generate", got, cpu_want, prompts, cpu_eng)
        stats_only(f"phase c {tag} cp {cp}", per, cp)
        log(f"[c] {tag} served cp {cp}: launches per shard "
            f"{ {sh: dict(c) for sh, c in sorted(per.items())} } "
            f"({time.perf_counter() - t_all:.1f}s in)")
        if cp == 4:
            del ceng
            continue
        # a radix hit: the long prompt's first 512 tokens, then another suffix
        srv = ceng.serve(capacity=2048, batch_per_slot=2, kv_block_size=64, kv_blocks=160,
                         prefill_chunk=256, prefix_cache="hbm", cp=cp)
        r1 = srv.submit(prompts[3], max_new)
        srv.run_until_idle()
        p2 = np.concatenate([prompts[3][:512], prompts[1]])
        hit0 = srv._radix.hit_tokens
        r2 = srv.submit(p2, max_new)
        srv.run_until_idle()
        require(srv._radix.hit_tokens - hit0 == 512, f"phase c {tag} cp 2: the radix hit fell "
                f"back ({srv._radix.hit_tokens - hit0} tokens)")
        w2 = cpu_eng.generate_ids(p2, max_new)
        hold_to_cpu(f"{tag} cp 2 radix hit (512 + {len(prompts[1])})", [r1.tokens, r2.tokens],
                    [cpu_want[3], w2.tokens[0, len(p2): w2.lengths[0]].tolist()],
                    [prompts[3], p2], cpu_eng)
        srv._alloc.check()
        srv._radix.check()
        srv.close()
        log(f"[c] {tag} cp 2 radix hit: 512 tokens ({time.perf_counter() - t_all:.1f}s in)")
        # snapshot mid-decode, restored into a fresh server
        srv = ceng.serve(capacity=2048, batch_per_slot=4, kv_block_size=64, kv_blocks=160,
                         prefill_chunk=256, cp=cp)
        reqs = [srv.submit(p, max_new) for p in prompts]
        for _ in range(40):
            srv.step()
            if all(r.tokens for r in reqs):
                break
        srv.step()
        snap = srv.snapshot()
        srv.close()
        srv2 = PipelineServer.restore(ceng, snap)
        require(srv2.cp == 2, f"phase c {tag}: restored at cp {srv2.cp}")
        revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
        srv2.run_until_idle()
        got = [revived[r.id].tokens if r.id in revived else r.tokens for r in reqs]
        hold_to_cpu(f"{tag} cp 2 snapshot / restore", got, cpu_want, prompts, cpu_eng)
        srv2._alloc.check()
        srv2.close()
        del ceng
        torch.cuda.empty_cache()
    # the disagg hand-off between two cp-2 replicas, streamed per shard
    ok0 = DISAGG_HANDOFFS.labels(outcome="ok").value
    sh0 = CP_STREAM_SHARDS.labels(outcome="ok").value
    ds = DisaggServer(cfg, cpu_params, data_parallel=2, cp=2, devices=[dev] * 4,
                      roles=["prefill", "decode"], capacity=2048, kv_block_size=64,
                      kv_blocks=160, prefill_chunk=256, prefix_cache="hbm", async_handoff=False)
    reqs = []
    for p in prompts[2:]:
        r = ds.submit(p, max_new)
        reqs.append(r)
        while not r.tokens:
            ds.step()
    ds.run_until_idle()
    hold_to_cpu(f"{tag} cp 2 disagg hand-off", [r.tokens for r in reqs], cpu_want[2:],
                prompts[2:], cpu_eng)
    oks = DISAGG_HANDOFFS.labels(outcome="ok").value - ok0
    shards = CP_STREAM_SHARDS.labels(outcome="ok").value - sh0
    require(oks == len(reqs), f"phase c {tag}: {oks} of {len(reqs)} cp hand-offs ok")
    require(shards >= 2 * len(reqs), f"phase c {tag}: {shards} per-shard stream passes")
    for s in ds.servers:
        s._alloc.check()
    ds.close()
    del ds
    torch.cuda.empty_cache()
    log(f"[c] {tag} cp 2 disagg: {oks:g} hand-offs ok, {shards:g} per-shard stream passes; "
        f"context-parallel serving checks took {time.perf_counter() - t_all:.1f}s")


# [d]: the 3B store engine over the standard workload's 8 rows at each placement,
# with a tp-1 run before the first and after each (``PARALLEL_BASE``):
# each placement is held to the mean of the tp-1 runs on either side
PARALLEL_BASE = ("tp 1", 1, 1)
PARALLEL_D = (("tp 2", 1, 2), ("tp 4", 1, 4), ("pp 2 x tp 2", 2, 2))


def parallel_serve(eng, stages: int, tag: str) -> tuple:
    """``pipeline_serve`` with each kernel's launches per shard and each
    decode step's reduces counted; returns ``(tokens, numbers, per-shard
    launches, dispatch share)``. At tp > 1 every ``serve_chunk`` must have
    issued two reduces per layer per step."""
    with shard_launches() as per, decode_reduces() as reds:
        tokens, nums, _, share = pipeline_serve(eng, stages)
    L = eng.cfg.num_hidden_layers
    require(reds, f"phase d {tag}: no decode step ran")
    if eng.tensor_parallel > 1:
        bad = [r for r in reds if r[0] != 2 * L * r[1]]
        require(not bad, f"phase d {tag}: decode steps issued {bad[:3]} (reduces, steps), "
                f"not {2 * L} reduces a step")
    nums["reduces_per_step"] = reds[0][0] / reds[0][1]
    return tokens, nums, per, share


def parallel_runs(eng, store: str, smi: str, paged_twin: dict, daemon: bool = True) -> dict:
    """[d] The 3B bf16 store engine (its weights copied once to the host):
    the standard workload at tp 2, tp 4 and pp 2 × tp 2 (8 rows each,
    every stage and shard on ``cuda:0`` repeated), with a tp-1 run (the
    store engine) before the first and after each; every stream equals the
    twin's or first differs at a near tie (``TIE_ULPS``); every shard
    launches each kernel as often as the tp-1 run does; every decode step
    issues 2 × layers reduces. Printed per run: decode tok/s, TTFT p50 / p99,
    launches per shard, reduces per step, weight bytes per shard, the
    stepline's dispatch share; each placement beside the mean of its tp-1
    neighbours. Then, with ``daemon``, the ``serve --tensor-parallel 2``
    daemon over HTTP against the twin (the whole script's
    ``pipeline_daemon`` runs one at 2 stages of 2 shards instead). Returns
    the launches per shard of each placement."""
    import torch

    from llm_sharding_tpu_torch.parallel.pipeline import map_params
    from llm_sharding_tpu_torch.runtime.engine import Engine

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    cfg, host = eng.cfg, map_params(lambda t: t.to("cpu"), eng.params)
    log(f"[d] tensor parallel on {smi}: the 3B ({cfg.num_hidden_layers} layers) copied to the "
        f"host in {time.perf_counter() - t0:.1f}s")
    rec = lambda: inprocess_run(eng, False, record=True)  # noqa: E731 — only on a mismatch
    order = [PARALLEL_BASE]
    for p in PARALLEL_D:
        order += [p, PARALLEL_BASE]
    out, runs, base_counts = {}, [], None
    for k, (name, stages, tp) in enumerate(order):
        t0 = time.perf_counter()
        peng = eng if tp == 1 else Engine(cfg, host, num_stages=stages, tensor_parallel=tp,
                                          devices=[eng.device] * (stages * tp))
        torch.cuda.synchronize()
        staged = time.perf_counter() - t0
        tokens, nums, per, share = parallel_serve(peng, stages, f"3B {name}")
        runs.append(nums)
        hold_to(f"3B {name} (run {k + 1}) vs twin", tokens, paged_twin["tokens"], rec)
        shards = {j: dict(c) for j, c in sorted(per.items())}
        if tp == 1:
            base_counts = base_counts or shards[0]
        else:
            same = tokens == paged_twin["tokens"]
            for j in range(tp):
                for kname in ("flash_attention", "paged_attention", "paged_prefill"):
                    require(shards.get(j, {}).get(kname, 0) > 0,
                            f"phase d 3B {name}: shard {j} never launched {kname}")
                if same:
                    require(shards[j] == base_counts, f"phase d 3B {name}: shard {j} launched "
                            f"{shards[j]}, the tp-1 run {base_counts}")
            out.setdefault(name.replace(" ", ""), shards)
        sizes = shard_bytes(peng)
        log(f"[d] 3B run {k + 1}, {name} (staged in {staged:.2f}s): decode {nums['tok_s']:.1f} "
            f"tok/s, TTFT p50 {nums['p50']:.0f} ms p99 {nums['p99']:.0f} ms; dispatch "
            f"{share:.2f}% of step wall; reduces per decode step {nums['reduces_per_step']:g}; "
            f"launches per shard {shards}; weight bytes per shard "
            f"{[f'{b / 1e9:.3f} GB' for b in sizes]}")
        if peng is not eng:
            del peng
            gc.collect()
            torch.cuda.empty_cache()
    for k in range(1, len(order), 2):
        base = {m: (runs[k - 1][m] + runs[k + 1][m]) / 2 for m in ("tok_s", "p50", "p99")}
        log(f"[d] " + fleet_line(f"3B {order[k][0]}", runs[k], base)
            .replace("the twin's", "the tp-1 runs' mean").replace("(twin", "(tp-1 mean")
            + f"; TTFT p50 {runs[k]['p50'] / base['p50']:.3f}x")
    ones = runs[::2]
    log(f"[d] 3B, the {len(ones)} tp-1 runs in order: decode "
        f"{[round(r['tok_s'], 1) for r in ones]} tok/s, TTFT p50 "
        f"{[round(r['p50']) for r in ones]} ms")
    del host
    gc.collect()
    if daemon:
        tp_daemon(store, eng, paged_twin, rec)
    log(f"[d] 3B tensor parallel took {time.perf_counter() - t_all:.1f}s")
    return out


def tp_daemon(store: str, eng, paged_twin: dict, rec) -> None:
    """``serve --tensor-parallel 2`` as users start it: the standard
    workload over HTTP from two tenants, every request 200, the streams
    held to the in-process twin's (``TIE_ULPS``); SIGTERM drains it."""
    from llm_sharding_tpu_torch import smoke_workload

    args = (["--tensor-parallel", "2", "--device", str(eng.device)]
            + smoke_workload.daemon_args("llama32_3b", False))
    d = Daemon(store, args, write_tenants(store))
    try:
        require(any("2 tensor shards each from" in ln for ln in d.lines),
                f"phase d tp daemon: banner\n{d.tail()}")
        t0 = time.perf_counter()
        runs = http_workload(d.port, paged_twin["prompts"], smoke_workload.MAX_NEW)
        hold_to("3B serve --tensor-parallel 2 daemon vs twin", [r[0] for r in runs],
                paged_twin["tokens"], rec)
        log(f"[d] 3B serve --tensor-parallel 2 daemon: up in {d.startup_s:.1f}s, the workload "
            f"over HTTP in {time.perf_counter() - t0:.1f}s, every request 200")
    except Exception:
        log(f"[d] tp daemon stderr tail:\n{d.tail()}")
        raise
    finally:
        if d.proc.poll() is None:
            d.proc.send_signal(15)
            try:
                d.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                d.kill()


def tp_7b_run(eng, smi: str, base_tokens: list) -> dict:
    """[d] Llama-2-7B at full width and depth over two tensor shards on the
    card (6.5 GB of layers a shard): its standard workload against the
    tp-1 engine's run (``base_tokens``; ``TIE_ULPS``), every shard
    launching each kernel. Returns shard 0's launches."""
    import torch

    from llm_sharding_tpu_torch.parallel.pipeline import map_params
    from llm_sharding_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    host = map_params(lambda t: t.to("cpu"), eng.params)
    peng = Engine(eng.cfg, host, tensor_parallel=2, devices=[eng.device] * 2)
    torch.cuda.synchronize()
    log(f"[d] llama2-7b tp 2 on {smi}: copied to the host and staged over 2 shards in "
        f"{time.perf_counter() - t0:.1f}s; weight bytes per shard "
        f"{[f'{b / 1e9:.3f} GB' for b in shard_bytes(peng)]}")
    del host
    with shard_launches() as per:
        _, tokens = serve_run(peng, "llama2_7b", "llama2-7b tp 2, kv bf16")
    hold_to("llama2-7b tp 2 vs tp 1", tokens, base_tokens,
            lambda: inprocess_run(eng, False, record=True, model="llama2_7b"))
    shards = {j: dict(c) for j, c in sorted(per.items())}
    for j in range(2):
        for k in ("flash_attention", "paged_attention", "paged_prefill"):
            require(shards.get(j, {}).get(k, 0) > 0, f"phase d llama2-7b tp 2: shard {j} never "
                    f"launched {k}")
    log(f"[d] llama2-7b tp 2: launches per shard {shards}")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    return shards[0]


def context_runs(eng, smi: str) -> None:
    """[d] One 8160-token prompt on the 3B bf16 store engine (with its 32 new tokens
    the 8192 positions the model takes): ``context_generate`` at cp 2 and 4
    (the ring prefill, plain f32 PyTorch, then ``decode_from_cache``)
    against ``generate`` (the flash prefill): prefill wall, peak memory,
    and the 32 tokens equal or first different at a near tie of
    ``generate``'s run (``TIE_ULPS``)."""
    import torch

    from llm_sharding_tpu_torch.parallel.context import context_generate, context_prefill_cache
    from llm_sharding_tpu_torch.runtime.generate import generate

    cfg, params, dev = eng.cfg, eng.params, eng.device
    n = 32
    S = cfg.max_position_embeddings - n
    p = np.random.default_rng(12).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    want, _, _ = timed(lambda: generate(cfg, params, p, n))
    _, pre_s, pre_mem = timed(lambda: generate(cfg, params, p, 1))
    w = want.tokens[0, S:].tolist()
    log(f"[d] {S}-token prompt on {smi}: generate (flash prefill) prefill {pre_s * 1e3:.0f} ms, "
        f"peak {pre_mem:.2f} GiB")
    for cp in (2, 4):
        _, pre_s, pre_mem = timed(lambda: context_prefill_cache(cfg, [dev] * cp, params, p))
        got, _, _ = timed(lambda: context_generate(cfg, [dev] * cp, params, p, n))
        g = got.tokens[0, S:].tolist()
        if g != w:
            j = next(j for j in range(n) if g[j] != w[j])
            gap, top = top2_gap_top(cfg, params, np.concatenate([p[0], np.asarray(w[:j])]))
            ulp = bf16_ulp(top)
            log(f"[d] context cp {cp}: first differs from generate at token {j}, top-2 gap "
                f"{gap:.4g} ({gap / ulp:.1f} bf16 ulp)")
            require(gap <= TIE_ULPS * ulp, f"phase d context cp {cp}: differs at token {j}, a "
                    f"gap of {gap / ulp:.1f} ulp")
        log(f"[d] context cp {cp}: ring prefill {pre_s * 1e3:.0f} ms, peak {pre_mem:.2f} GiB; "
            f"first {n} tokens: {sum(a == b for a, b in zip(g, w))} equal to generate's")
        torch.cuda.empty_cache()


def cp_serve(eng, cp: int) -> tuple:
    """The standard workload over 8 rows at one stage, the arena over
    ``cp`` shards (``cp`` 1: the unsharded server), staggered; returns
    ``(tokens, numbers, per-shard launches, all launches, server_cp_combine_
    seconds count and mean)``."""
    import torch

    from llm_sharding_tpu_torch import smoke_workload
    from llm_sharding_tpu_torch.ops import kernels as K
    from llm_sharding_tpu_torch.runtime.server import CP_COMBINE_SECONDS

    w = smoke_workload.WORKLOADS["llama32_3b"]
    hist = CP_COMBINE_SECONDS.labels()
    n0, s0 = hist.count, hist.sum
    srv = eng.serve(capacity=w.capacity, batch_per_slot=smoke_workload.ROWS,
                    kv_block_size=smoke_workload.BLOCK_SIZE, kv_blocks=w.kv_blocks,
                    prefill_chunk=smoke_workload.PREFILL_CHUNK, cp=cp)
    prompts = smoke_workload.prompts(eng.cfg.vocab_size, np.random.default_rng(0), w.lens)
    torch.cuda.synchronize()
    before = K.launch_counts()
    with cp_launches() as (per, register_cp):
        if cp > 1:
            register_cp(srv)
        reqs = smoke_workload.submit_staggered(srv, prompts)
        srv.run_until_idle()
    torch.cuda.synchronize()
    totals = {k: n - before.get(k, 0) for k, n in K.launch_counts().items()}
    for r in reqs:
        require(r.done and r.error is None, f"phase d cp {cp}: request {r.id} failed")
    srv._alloc.check()
    require(srv._alloc.in_use == 0, f"phase d cp {cp}: KV blocks still held")
    srv.close()
    n = hist.count - n0
    return ([list(r.tokens) for r in reqs], fleet_numbers(reqs), per, totals,
            (n, (hist.sum - s0) / max(n, 1)))


def cp_runs(eng, smi: str, paged_twin: dict) -> dict:
    """[d] The 3B bf16 store engine over the standard workload at cp 2 and
    cp 4 (every shard on ``cuda:0``, the weights staged once from a host
    copy), with a cp-1 run (the store engine) before the first and after
    each; every stream equals the twin's or first differs at a near tie
    (``TIE_ULPS``; the shards' merge sums in another order); every shard
    launches the stats mode of both paged kernels and nothing of the normal
    mode. Printed per run: decode tok/s, TTFT p50 / p99, launches per
    shard, ``server_cp_combine_seconds``; each cp run beside the mean of its
    cp-1 neighbours. Returns the cp runs' launch counts, all shards
    summed (``cp2``, ``cp4``) and per shard (``cp2/shards``, ...)."""
    import torch

    from llm_sharding_tpu_torch.parallel.pipeline import map_params

    t_all = time.perf_counter()
    cfg = eng.cfg
    host = map_params(lambda t: t.to("cpu"), eng.params)
    rec = lambda: inprocess_run(eng, False, record=True)  # noqa: E731 — only on a mismatch
    order = [1, 2, 1, 4, 1]
    out, runs = {}, []
    for k, cp in enumerate(order):
        t0 = time.perf_counter()
        peng = eng if cp == 1 else cp_engine(cfg, host, eng.device, cp)
        torch.cuda.synchronize()
        staged = time.perf_counter() - t0
        tokens, nums, per, totals, (ncomb, mcomb) = cp_serve(peng, cp)
        runs.append(nums)
        hold_to(f"3B cp {cp} (run {k + 1}) vs twin", tokens, paged_twin["tokens"], rec)
        shards = {sh: dict(c) for sh, c in sorted(per.items())}
        comb = ""
        if cp > 1:
            stats_only(f"phase d 3B cp {cp}", per, cp)
            out[f"cp{cp}"] = totals
            out[f"cp{cp}/shards"] = shards
            comb = (f"; server_cp_combine_seconds: {ncomb} decode dispatches, mean "
                    f"{mcomb * 1e3:.3f} ms")
            del peng
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[d] 3B run {k + 1}, cp {cp} (staged in {staged:.2f}s) on {smi}: decode "
            f"{nums['tok_s']:.1f} tok/s, TTFT p50 {nums['p50']:.0f} ms p99 {nums['p99']:.0f} ms; "
            f"launches per shard {shards if cp > 1 else totals}{comb}")
    for k in (1, 3):
        base = {m: (runs[k - 1][m] + runs[k + 1][m]) / 2 for m in ("tok_s", "p50", "p99")}
        log(f"[d] 3B cp {order[k]}: decode {runs[k]['tok_s'] / base['tok_s']:.3f}x, TTFT p50 "
            f"{runs[k]['p50'] / base['p50']:.3f}x, p99 {runs[k]['p99'] / base['p99']:.3f}x the "
            "cp-1 runs' mean")
    del host
    gc.collect()
    log(f"[d] 3B context-parallel serving took {time.perf_counter() - t_all:.1f}s")
    return out


def cp_long_run(device, smi: str) -> None:
    """[d] One 8160-token prompt served at cp 2 on Llama-3.2-3B at its
    full 28 layers (random weights made on the card; the positions the
    model takes raised to 16384, within the 131072 of the published
    config, since the admission bucket of 8160 tokens is 8192), with 79
    usable blocks of 64 per shard: the prompt's 129 blocks exceed one
    shard's arena, so cp 1 refuses it (``NeverFits``) and cp 2 admits it,
    its blocks on both shards. Its 32 tokens equal ``generate``'s (the flash
    prefill) or first differ at a near tie (``TIE_ULPS``). Printed: the
    admission wall (submit to first token, 32 chunks through the stats
    kernels), decode tok/s, peak memory, launches per shard."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.generate import generate
    from llm_sharding_tpu_torch.runtime.server import NeverFits

    t_all = time.perf_counter()
    cfg = dataclasses.replace(config.llama32_3b(), max_position_embeddings=16384)
    params = llama.init_params(cfg, seed=3, dtype=torch.bfloat16, device=device)
    n, S = 32, 8160
    p = np.random.default_rng(13).integers(0, cfg.vocab_size, S).astype(np.int32)
    want = generate(cfg, params, p[None], n).tokens[0, S:].tolist()
    ceng = cp_engine(cfg, params, device, 2)
    del params
    torch.cuda.empty_cache()
    kw = dict(capacity=8256, batch_per_slot=1, kv_block_size=64, kv_blocks=80,
              prefill_chunk=256)
    srv1 = ceng.serve(cp=1, **kw)
    try:
        srv1.submit(p, n)
        require(False, "phase d long context: cp 1 admitted a prompt past one shard's arena")
    except NeverFits as e:
        require("KV blocks" in str(e), f"phase d long context: cp 1 refused with {e}")
    srv1.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cp_launches() as (per, register_cp):
        srv = ceng.serve(cp=2, **kw)
        register_cp(srv)
        r = srv.submit(p, n)
        while not r.tokens and not r.done:
            srv.step()
        require(r.error is None, f"phase d long context: the request failed: {r.error!r}")
        owners = {srv._alloc.owner(g) for row in srv._row_blocks for g in row}
        srv.run_until_idle()
    torch.cuda.synchronize()
    require(r.error is None and owners == {0, 1}, f"phase d long context: owners {owners}, "
            f"error {r.error!r}")
    g = list(r.tokens)
    if g != want:
        j = next(j for j in range(n) if g[j] != want[j])
        gap, top = top2_gap_top(cfg, ceng.params, np.concatenate([p, np.asarray(want[:j])]))
        ulp = bf16_ulp(top)
        log(f"[d] long context cp 2: first differs from generate at token {j}, top-2 gap "
            f"{gap:.4g} ({gap / ulp:.1f} bf16 ulp)")
        require(gap <= TIE_ULPS * ulp, f"phase d long context cp 2: differs at token {j}, a gap "
                f"of {gap / ulp:.1f} ulp")
    stats_only("phase d long context cp 2", per, 2)
    admit = r.first_token_at - r.submitted_at
    decode = (len(g) - 1) / (r.finished_at - r.first_token_at)
    log(f"[d] long context on {smi}: {S}-token prompt at cp 2, 28 layers, 79 usable blocks per "
        f"shard (the prompt needs 129): admission {admit * 1e3:.0f} ms, decode {decode:.1f} tok/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches per shard "
        f"{ {sh: dict(c) for sh, c in sorted(per.items())} }; "
        f"{sum(a == b for a, b in zip(g, want))} of {n} tokens equal to generate's; "
        f"took {time.perf_counter() - t_all:.1f}s")
    srv.close()
    del ceng, srv
    gc.collect()
    torch.cuda.empty_cache()


def launch_run(eng, store: str, smi: str) -> None:
    """[d] ``launch --processes 2`` on the card: two worker processes over
    ``gloo``, each loading its half of the 3B store's layers onto
    ``cuda:0`` and passing the hidden state through pinned host memory;
    rank 0's ids must equal the one-process ``generate`` of the same
    store (this engine: ``generate`` command's path). Printed: the launch
    wall and each rank's hops and bytes."""
    n = 16
    p = np.random.default_rng(14).integers(0, eng.cfg.vocab_size, 64).astype(np.int32)
    res = eng.generate_ids(p, n)
    want = " ".join(str(int(t)) for t in res.tokens[0, len(p): int(res.lengths[0])])
    logs = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "llm_sharding_tpu_torch", "launch", store, "--processes", "2",
         "--prompt-ids", ",".join(str(int(t)) for t in p), "--max-new", str(n), "--dtype",
         "bf16", "--device", "cuda", "--log-dir", logs,
         "--timeout", "120"],
        capture_output=True, text=True, timeout=180, cwd=REPO_ROOT,
    )
    wall = time.perf_counter() - t0
    worker = []
    for i in range(2):
        with open(os.path.join(logs, f"worker_{i}.log")) as fh:
            worker += [ln.strip() for ln in fh if "hops" in ln]
    shutil.rmtree(logs, ignore_errors=True)
    require(proc.returncode == 0, f"phase d launch: exit {proc.returncode}: {proc.stderr[-2000:]}")
    require(proc.stdout.strip() == want, f"phase d launch: rank 0 printed {proc.stdout.strip()!r}, "
            f"generate {want!r}")
    log(f"[d] launch --processes 2 on {smi}: {eng.cfg.num_hidden_layers}-layer 3B store, "
        f"{n} tokens equal to the one-process generate; wall {wall:.1f}s; {'; '.join(worker)}")


#: [d]'s profile part: the hop rings measured beside the command's ring
#: of 4, with fewer samples than the command's default 30 (the part's budget)
PROFILE_RINGS, PROFILE_RING_REPEATS = (1, 2), 10


def run_profile_command(argv: list, tag: str) -> tuple:
    """``python -m llm_sharding_tpu_torch profile ARGV`` in this process (so
    its launches count): the printed payload, the flash launches during the
    command, and its seconds."""
    import io

    from llm_sharding_tpu_torch import cli
    from llm_sharding_tpu_torch.ops import kernels as K

    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["profile", *argv])
    secs = time.perf_counter() - t0
    flash = K.launch_counts()["flash_attention"]
    require(rc == 0, f"phase d profile {tag}: exit {rc}")
    return json.loads(buf.getvalue()), flash, secs


def check_profile_payload(tag: str, pay: dict, layers: int, smi: str) -> None:
    """The report's numbers finite and positive, the decode curve strictly
    rising; prints them beside the card's name and power limit."""
    pre, dec, sim = pay["prefill"], pay["decode"], pay["similarity"]
    lat = pre["latencies_s"]
    require(all(np.isfinite(t) and t > 0 for t in lat),
            f"phase d profile {tag}: prefill latencies {lat}")
    for what, c_k in (("prefill", pre["capability_c_k"]), ("decode", dec["capability_c_k"])):
        require(np.isfinite(c_k) and c_k > 0, f"phase d profile {tag}: {what} c_k {c_k}")
    cums = dec["cumulative_s"]
    require(all(b > a for a, b in zip(cums, cums[1:])) and cums[0] > 0,
            f"phase d profile {tag}: decode curve not strictly rising: {cums}")
    require(pre["num_layers_measured"] == layers,
            f"phase d profile {tag}: {pre['num_layers_measured']} layers measured, not {layers}")
    log(f"[d] profile {tag} on {smi}: prefill lengths {pre['lengths']} latencies_ms "
        f"{[round(t * 1e3, 4) for t in lat]}")
    log(f"[d] profile {tag} on {smi}: c_k prefill {pre['capability_c_k']:.6e} decode "
        f"{dec['capability_c_k']:.6e} s/(token*layer); decode cumulative_ms at "
        f"{dec['token_counts']}: {[round(t * 1e3, 3) for t in cums]}")
    for what, rep in (("prefill", pre), ("decode", dec)):
        for kind, fit in sorted(rep["fits"].items()):
            log(f"[d] profile {tag} on {smi}: {what} {kind} fit coeffs {fit['coeffs']} rmse "
                f"{fit['rmse']:.6e} r2 {fit['r2']:.6f}")
    log(f"[d] profile {tag} on {smi}: similarity avg {sim['avg_ratio']:.4f} slope "
        f"{sim['slope_ratio']:.4f} quadratic marginal {sim['quadratic_marginal_ratio']:.4f} "
        f"similar {sim['similar']} (threshold {sim['threshold']})")


def profile_runs(device, store: str, smi: str) -> dict:
    """[d]'s profile part: the ``profile`` command on Llama-3.2-3B at full
    width and depth (28 layers, bf16, random weights made on the card, hop
    ring of 4 stages all on the card), then on the 7-layer 3B store with
    ``--cold-start``; hop rings of 1 and 2 beside the command's. Fails
    unless the numbers are finite and positive, the decode curve rises,
    ``max_layers_fit`` (from the card's memory) is 28, the suggested
    placement covers 28 layers, ``profile.json`` reads back through the
    planner, every prefill forward launched flash once a layer and the
    cold start timed every layer of the store. Returns the flash launches
    of the 3B command (``llama32_3b/profile``)."""
    import torch

    from llm_sharding_tpu_torch.models import config
    from llm_sharding_tpu_torch.profiler.profiler import (
        DEFAULT_PREFILL_LENGTHS, DEFAULT_REPEATS, measure_hop_latency,
    )
    from llm_sharding_tpu_torch.runtime.placement import PlacementPlanner

    t_part = time.perf_counter()
    cfg = config.llama32_3b()
    L = cfg.num_hidden_layers
    out = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        pay, flash, secs = run_profile_command(
            ["--preset", "llama32_3b", "--hops", "4", "--suggest-stages", "2", "--out", out],
            "3B")
        check_profile_payload("3B", pay, L, smi)
        n_len = len(pay["prefill"]["lengths"])
        require(pay["prefill"]["lengths"] == list(DEFAULT_PREFILL_LENGTHS),
                f"phase d profile 3B: lengths {pay['prefill']['lengths']}")
        # two warm-ups, one per length, the timed repeats, then the decode
        # curve's prompt prefill; the curve's one-token steps take no flash
        forwards = 2 + n_len + n_len * DEFAULT_REPEATS + 1
        require(flash == L * forwards,
                f"phase d profile 3B: flash launched {flash} times, not {L} x {forwards}")
        total = torch.cuda.get_device_properties(device).total_memory
        require(pay.get("max_layers_fit") == L,
                f"phase d profile 3B: max_layers_fit {pay.get('max_layers_fit')} != {L}")
        stages = [tuple(s) for s in pay["suggested_placement"]]
        require(len(stages) == 2 and stages[0][0] == 0 and stages[-1][1] == L
                and all(a[1] == b[0] for a, b in zip(stages, stages[1:])),
                f"phase d profile 3B: suggested placement {stages} does not cover {L} layers")
        planner = PlacementPlanner.from_json(out)
        ttft = planner.predict_ttft(512)
        require(np.isfinite(ttft) and ttft > 0, f"phase d profile 3B: predict_ttft {ttft}")
        log(f"[d] profile 3B on {smi}: flash launches {flash} = {L} layers x {forwards} "
            f"prefill forwards (2 warm-ups + {n_len} + {n_len} x {DEFAULT_REPEATS} repeats + "
            f"the decode prompt); max_layers_fit {pay['max_layers_fit']} of {L} on "
            f"{total / 2**30:.3f} GiB; suggested placement {stages}; planner predict_ttft(512) "
            f"{ttft * 1e3:.4f} ms; command {secs:.1f}s")
        hops = {4: (pay["hop_latency"], 30)}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for n in PROFILE_RINGS:
        rep = measure_hop_latency([device] * n, hidden_size=cfg.hidden_size,
                                  repeats=PROFILE_RING_REPEATS)
        hops[n] = (dataclasses.asdict(rep), PROFILE_RING_REPEATS)
    for n, (h, reps) in sorted(hops.items()):
        require(np.isfinite(h["p50_us"]) and h["p99_us"] >= h["p50_us"] >= 0,
                f"phase d profile: hop ring {n}: {h}")
        log(f"[d] profile hop ring of {n} on {smi}: p50 {h['p50_us']:.4f} us p99 "
            f"{h['p99_us']:.4f} us mean {h['mean_us']:.4f} us, {h['bytes_per_hop']} bytes a hop, "
            f"{h['hops_per_sample']} hops a sample, repeats={reps} (an on-card copy, one card)")
    out = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        spay, _, ssecs = run_profile_command(
            ["--shards", store, "--cold-start", "--out", out], f"3B/{D_3B} store")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check_profile_payload(f"3B/{D_3B} store", spay, D_3B, smi)
    cold = spay["cold_start"]
    require(cold["num_layers"] == D_3B and len(cold["per_layer_s"]) == D_3B
            and all(t > 0 for t in cold["per_layer_s"]),
            f"phase d profile store: cold start {cold}")
    log(f"[d] profile 3B/{D_3B} store on {smi}: cold start {cold['total_s'] * 1e3:.3f} ms total, "
        f"per layer ms {[round(t * 1e3, 3) for t in cold['per_layer_s']]}; max_layers_fit "
        f"{spay['max_layers_fit']} of {D_3B}; command {ssecs:.1f}s")
    log(f"[d] profile part took {time.perf_counter() - t_part:.1f}s on {smi}")
    return {"flash_attention": flash}


def phase_profile(device, store_root: str) -> dict:
    """``--profile``: [d]'s profile part alone, on a 3B store of ``D_3B``
    layers written here as [d] writes it."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    store = os.path.join(store_root, "llama32_3b_bf16")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store)
    del params
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return profile_runs(device, store, smi)


def top2_gap_top(cfg, params, ids: np.ndarray) -> tuple:
    """The top-2 logit gap and the top logit of the next token after
    ``ids`` under the port's ``generate`` (one prefill, on the weights'
    device)."""
    import torch

    from llm_sharding_tpu_torch.models.cache import init_cache
    from llm_sharding_tpu_torch.ops.quant import act_dtype
    from llm_sharding_tpu_torch.runtime.generate import prefill

    dev = params["final_norm"].device
    cache = init_cache(cfg, 1, len(ids), dtype=act_dtype(params["embed"]), device=dev)
    last, _ = prefill(cfg, params, np.asarray(ids, np.int32)[None], np.array([len(ids)]), cache)
    top = torch.topk(last[0].float(), 2).values
    return float(top[0] - top[1]), float(top[0])


def segment_runs(eng, smi: str) -> None:
    """[d] ``generate`` on the 3B bf16 store engine with a 200-token prompt and 200
    new tokens at capacity 4096 (rungs 256, 1024: the decode attends over
    the first 256 columns, then 1024) and at capacity 288 (one rung):
    decode tok/s of each (wall less the prefill's), the rungs it ran, and
    the tokens equal."""
    import torch

    from llm_sharding_tpu_torch.runtime.generate import _segment_capacities, generate

    cfg, params = eng.cfg, eng.params
    p = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 200)).astype(np.int32)
    toks = {}
    for cap, n in ((4096, 200), (288, 88)):
        def run(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = generate(cfg, params, p, k, capacity=cap)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        run(2)
        _, pre = run(1)
        res, wall = run(n)
        toks[cap] = res.tokens[0, 200:288].tolist()
        ladder = _segment_capacities(201, cap)
        ran = ladder[: next((i for i, c in enumerate(ladder) if c >= 200 + n), len(ladder) - 1) + 1]
        log(f"[d] segmented generate on {smi}, capacity {cap}: {n} tokens, decode "
            f"{(n - 1) / (wall - pre):.1f} tok/s (wall less the prefill's), rungs run {ran} of "
            f"the ladder {ladder}")
    a, b = toks[4096], toks[288]
    if a != b:  # a rung's shorter view may sum its softmax in another order
        j = next(j for j in range(len(a)) if a[j] != b[j])
        gap, top = top2_gap_top(cfg, params, np.concatenate([p[0], np.asarray(b[:j])]))
        require(gap <= TIE_ULPS * bf16_ulp(top), f"phase d segments: capacity 4096 and 288 "
                f"differ at token {j}, a gap of {gap / bf16_ulp(top):.1f} ulp")
    log(f"[d] segmented generate: of the first 88 tokens at capacity 4096 and 288, "
        f"{sum(x == y for x, y in zip(a, b))} identical")


def phase_parallel(device, store_root: str) -> dict:
    """``--parallel``: [b] the kernels at the shard shapes, [c]'s tensor and
    context checks on the f32 3B at 4 layers, [d] the 3B bf16 (``D_3B`` layers) from a
    port-written store (tp runs, the daemon, the 8160-token context, the
    segmented decode) and Llama-2-7B at tp 2 (random weights on the card,
    no store). Returns the [b] rows with their launches per shard."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    rows = phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=("bfloat16",),
                         tp=True)
    rows += phase_kernels(config.llama2_7b(), device, "llama2_7b", dtypes=("bfloat16",),
                          tp=True)
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    cpu_params = llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    eng, cpu_eng = Engine(cfg, to_device(cpu_params, device)), Engine(cfg, cpu_params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    cpu_want = check_against_generate("3B vs CPU", eng, prompts, lens, 16, oracle=cpu_eng)
    check_parallel("3B", eng, cpu_eng, cpu_params, prompts, lens, 16, cpu_want)
    del eng, cpu_eng, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    t0 = time.perf_counter()
    store = os.path.join(store_root, "llama32_3b_bf16")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store)
    del params
    torch.cuda.empty_cache()
    eng = load_store(store, "3B bf16", device, time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    paged_twin = inprocess_run(eng, False)
    counts = {f"llama32_3b/{k}": v
              for k, v in parallel_runs(eng, store, smi, paged_twin).items()}
    context_runs(eng, smi)
    segment_runs(eng, smi)
    del eng
    shutil.rmtree(store)
    gc.collect()
    torch.cuda.empty_cache()
    lcfg = config.llama2_7b()
    leng = Engine(lcfg, llama.init_params(lcfg, seed=0, dtype=torch.bfloat16, device=device))
    _, ltokens = serve_run(leng, "llama2_7b", "llama2-7b bf16 weights, kv bf16")
    counts["llama2_7b/tp2"] = tp_7b_run(leng, smi, ltokens)
    del leng
    torch.cuda.empty_cache()
    return attach_tp_launches(rows, counts)


def attach_tp_launches(rows: list, counts: dict) -> list:
    """Each tensor-parallel [b] row's launches: shard 0's, from the [d] run
    of its model at its degree (``counts``: ``model/tp2`` etc. → launches
    per shard, or shard 0's alone)."""
    for r in rows:
        per = counts[f"{r['model']}/{r['workload']}"]
        if 0 in per:  # every shard's launches: the row keeps them all
            r["shard_launches"] = {str(j): c.get(r["name"], 0) for j, c in per.items()}
            per = per[0]
        r["launches"] = per.get(r["name"], 0)
    return rows

def attach_cp_launches(rows: list, counts: dict) -> list:
    """Each stats-mode [b] row's launches in the [d] cp-2 run, all shards
    summed, and per shard; a kernel of that run's path that never launched
    fails the script."""
    for r in rows:
        key = f"{r['model']}/{r['workload']}"
        r["launches"] = counts[key].get(r["name"], 0)
        r["shard_launches"] = {str(sh): c.get(r["name"], 0)
                               for sh, c in counts[f"{key}/shards"].items()}
        require(r["launches"] > 0, f"{r['name']}: no launch in the {key} run")
    return rows


def phase_cp(device, store_root: str) -> list:
    """``--cp``: [b] the stats-mode rows, [c]'s context-parallel checks on
    the f32 3B at 4 layers, [d] the 3B bf16 store (``D_3B`` layers) at cp 1
    / 2 / 1 / 4 / 1, the 8160-token prompt on 28 layers at cp 2, and the
    2-rank launch. Returns the [b] rows with their launches."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    t0 = time.perf_counter()
    rows = phase_stats_kernels(config.llama32_3b(), device, "llama32_3b")
    log(f"[e] (b) stats-mode rows took {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=4)
    cpu_params = llama.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    eng, cpu_eng = Engine(cfg, to_device(cpu_params, device)), Engine(cfg, cpu_params)
    rng = np.random.default_rng(7)
    lens = [40, 200, 700, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    card_want = check_against_generate("3B", eng, prompts, lens, 16)
    cpu_want = check_against_generate("3B vs CPU", eng, prompts, lens, 16, oracle=cpu_eng)
    check_cp("3B", eng, cpu_eng, cpu_params, prompts, lens, 16, cpu_want, card_want)
    log(f"[e] (c) took {time.perf_counter() - t0:.0f}s")
    del eng, cpu_eng, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(config.llama32_3b(), num_hidden_layers=D_3B)
    t0 = time.perf_counter()
    store = os.path.join(store_root, "llama32_3b_bf16")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    save_shards(cfg, params, store)
    del params
    torch.cuda.empty_cache()
    eng = load_store(store, "3B bf16", device, time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    paged_twin = inprocess_run(eng, False)
    log(f"[e] (d) store and twin took {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    launch_run(eng, store, smi)
    log(f"[e] (d) launch took {time.perf_counter() - t0:.0f}s")
    counts = {f"llama32_3b/{k}": v for k, v in cp_runs(eng, smi, paged_twin).items()}
    t0 = time.perf_counter()
    cp_long_run(device, smi)
    log(f"[e] (d) long context took {time.perf_counter() - t0:.0f}s")
    del eng
    shutil.rmtree(store)
    return attach_cp_launches(rows, counts)


def match_frac(tokens, base) -> float:
    return float(np.mean([np.mean([a == b for a, b in zip(t, u)]) for t, u in zip(tokens, base)]))


def flash_rows(device) -> list:
    """``--flash``: every [b] flash case alone (each model, the prefix,
    speculative, dense, profiler and shard shapes; f32 where [b] runs it),
    against the plain version and timed beside SDPA."""
    from llm_sharding_tpu_torch.models import config

    fl, bf = "flash_attention", ("bfloat16",)
    rows = []
    for m in ("llama32_3b", "gpt2_small", "gemma_2b"):
        rows += phase_kernels(getattr(config, m)(), device, m, only=fl)
    for m in ("gemma_7b", "llama2_7b"):
        rows += phase_kernels(getattr(config, m)(), device, m, dtypes=bf, only=fl)
    for m in ("llama32_3b", "gemma_2b"):
        rows += phase_kernels(getattr(config, m)(), device, m, prefix=True, only=fl)
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=bf, spec=True, only=fl)
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dense=True, only=fl)
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=bf, profile=True,
                          only=fl)
    for m in ("llama32_3b", "llama2_7b"):
        rows += phase_kernels(getattr(config, m)(), device, m, dtypes=bf, tp=True, only=fl)
    return rows


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

    built = [K.FLASH] if argv[:1] == ["--flash"] else list(K.KERNELS)
    secs = K.build_all(built)
    with open(K.BUILD_DIR / "ptxas.log", "w") as f:
        for k in built:
            f.write(f"=== {k.source}\n{k.build_log}\n")
    for k in built:
        spills = [ln.strip() for ln in k.build_log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        log(f"[a] built {k.source}; non-zero spill lines: {len(spills)}")
    log(f"[a] kernel build: {secs:.1f}s (nvcc, sm_90a, one process per source)")
    ptxas = log_flash_ptxas(K)
    if argv[:1] == ["--flash"]:
        print(json.dumps({"kernels": flash_rows(device), "ptxas": ptxas}))
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--fleet"]:
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            print(json.dumps({"replica_launches": phase_fleet(device, store)}))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--pipeline"]:
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            print(json.dumps({"stage_launches": phase_pipeline(device, store)}))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--parallel"]:
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            print(json.dumps({"kernels": phase_parallel(device, store)}))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--cp"]:
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            print(json.dumps({"kernels": phase_cp(device, store)}))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--profile"]:
        rows = phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=("bfloat16",),
                             profile=True)
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            counts = phase_profile(device, store)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        for r in rows:
            r["launches"] = counts[r["name"]]
        print(json.dumps({"kernels": rows}))
        log(f"[e] total {time.perf_counter() - t_all:.0f}s")
        return 0
    if argv[:1] == ["--kernels"]:
        rows = [r for m in argv[1:]
                for r in phase_kernels(getattr(config, m)(), device, m, dtypes=("bfloat16",))]
        rows += [r for m in argv[1:] if m in ("llama32_3b", "gemma_2b")
                 for r in phase_kernels(getattr(config, m)(), device, m, dtypes=("bfloat16",),
                                        prefix=True)]
        rows += [r for m in argv[1:] if m in ("llama32_3b", "llama2_7b", "gemma_2b")
                 for r in phase_kernels(getattr(config, m)(), device, m, dtypes=("bfloat16",),
                                        spec=True)]
        rows += [r for m in argv[1:] if m == "llama32_3b"
                 for r in phase_kernels(config.llama32_3b(), device, m, dtypes=("bfloat16",),
                                        dense=True)]
        print(json.dumps({"kernels": rows}))
        return 0

    rows = phase_kernels(config.llama32_3b(), device, "llama32_3b")
    rows += phase_kernels(config.gpt2_small(), device, "gpt2_small")
    rows += phase_kernels(config.gemma_2b(), device, "gemma_2b")
    rows += phase_kernels(config.gemma_7b(), device, "gemma_7b", dtypes=("bfloat16",))
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", prefix=True)
    rows += phase_kernels(config.gemma_2b(), device, "gemma_2b", prefix=True)
    rows += phase_kernels(config.llama2_7b(), device, "llama2_7b", dtypes=("bfloat16",))
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=("bfloat16",),
                          spec=True)
    rows += phase_kernels(config.llama2_7b(), device, "llama2_7b", dtypes=("bfloat16",),
                          spec=True)
    rows += phase_kernels(config.gemma_2b(), device, "gemma_2b", dtypes=("bfloat16",), spec=True)
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dense=True)
    rows += phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=("bfloat16",),
                          profile=True)
    tp_rows = phase_kernels(config.llama32_3b(), device, "llama32_3b", dtypes=("bfloat16",),
                            tp=True)
    tp_rows += phase_kernels(config.llama2_7b(), device, "llama2_7b", dtypes=("bfloat16",),
                             tp=True)
    stats_rows = phase_stats_kernels(config.llama32_3b(), device, "llama32_3b")
    log(f"[e] phases (a) and (b) took {time.perf_counter() - t_all:.0f}s")
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        t0 = time.perf_counter()
        f32_counts = phase_token_check(device, store)
        log(f"[e] phase (c) took {time.perf_counter() - t0:.0f}s")
        t0 = time.perf_counter()
        counts = phase_serve(device, store)
        counts["llama32_3b/f32"] = f32_counts
        log(f"[e] phase (d) took {time.perf_counter() - t0:.0f}s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for r in rows:
        run = r["model"] if r["workload"] == "standard" else f"{r['model']}/{r['workload']}"
        r["launches"] = counts[run][r["name"]]
        if run == "llama32_3b":  # the fleet's runs of the same workload, per replica
            r["replica_launches"] = {
                fleet: {rep: c.get(r["name"], 0) for rep, c in sorted(per.items())}
                for fleet, per in counts["llama32_3b/fleet"].items()}
            # the pipeline runs (bf16 arena), per stage
            r["stage_launches"] = {
                run: {str(s): c.get(r["name"], 0) for s, c in per.items()}
                for run, per in counts["llama32_3b/pipeline"].items()}
    rows += attach_tp_launches(tp_rows, counts)
    rows += attach_cp_launches(stats_rows, counts)
    log(f"[e] total {time.perf_counter() - t_all:.0f}s")
    print(json.dumps({"kernels": rows, "flash_ptxas": ptxas}))
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
