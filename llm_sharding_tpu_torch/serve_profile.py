"""Where the time of the paged server goes on one GPU.

    python -m llm_sharding_tpu_torch.serve_profile [--model llama32_3b|gemma_2b|gpt2_small]
        [--weights bf16|int8|int4] [--kv-dtype bf16|int8|fp8]

Serves a workload of ``chip_smoke.py`` phase (d) (``smoke_workload``: 8
staggered requests, 4 short prompts and 4 long ones, 64 new tokens each)
on seeded random weights of the model (full width and depth, bf16, made
on the card; ``--weights int8|int4`` quantizes the layers' matmul
weights), under ``torch.profiler``. Prints the device time per
kernel (top 15), then the total and launch count of each of the port's own
kernels by name (``PORT_KERNELS``, split by KV storage type) beside the
chunked-prefill kernel's operations bound over the workload, the
device-busy share of the run's wall time, and the host wall time of
decode-only steps at 8 live rows. A warm-up request runs first so
first-call costs (kernel build, allocator growth) stay out of the window;
the workload runs once unprofiled (wall and step times) and once under the
profiler (kernel table; the profiler slows the host, so its wall is longer).
``--kv-dtype`` picks the arena (int8 / fp8 run the quantized kernel modes,
whose instantiations name the code type, so the table splits by mode).
Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import smoke_workload


BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
# the port's CUDA kernels by function name (csrc/*.cu); the split merge is
# one kernel, launched by both split paths (decode and tensor-core prefill)
PORT_KERNELS = (
    "flash_wgmma_kernel", "flash_kernel", "split_decode_kernel", "split_merge_kernel",
    "prefill_wgmma_kernel", "paged_prefill_kernel",
)


def port_kernel_totals(per_kernel: dict, calls: dict) -> list:
    """``[name, KV storage, ms, launches]`` of each port kernel present in a
    profile's kernel table (template instantiations summed per KV storage
    type: int8 codes, fp8 codes, or the query dtype)."""
    out = collections.OrderedDict()
    for key, us in per_kernel.items():
        name = next((n for n in PORT_KERNELS if f"{n}<" in key), None)
        if name is None:
            continue
        kv = "int8" if "signed char" in key else "fp8" if "fp8" in key else "-"
        ms, n = out.get((name, kv), (0.0, 0))
        out[(name, kv)] = (ms + us / 1e3, n + calls[key])
    return [[name, kv, ms, n] for (name, kv), (ms, n) in out.items()]


def chunked_prefill_pairs(lens, prefill_chunk: int) -> int:
    """Visible query-key pairs, per layer, of the chunked admissions of
    prompts of ``lens`` tokens, each admitted alone as the server does it:
    a prompt whose bucket exceeds ``prefill_chunk`` runs in chunks of that
    size, each attending every column written up to its end; a query at
    position p sees p + 1 keys, and the padding queries and the prompt's
    final one carry the sentinel position, which sees every such column."""
    from .runtime.server import ADMIT_BUCKETS

    pairs = 0
    for n in lens:
        bucket = next(b for b in ADMIT_BUCKETS if b >= n)
        if bucket <= prefill_chunk:
            continue
        for off in range(0, bucket, prefill_chunk):
            end = off + prefill_chunk
            real = min(max(n - 1 - off, 0), prefill_chunk)
            pairs += real * off + real * (real + 1) // 2 + (prefill_chunk - real) * end
    return pairs


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    from .ops.quant import KV_DTYPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(smoke_workload.WORKLOADS), default="llama32_3b")
    ap.add_argument("--weights", choices=("bf16", "int8", "int4"), default="bf16")
    ap.add_argument("--kv-dtype", choices=KV_DTYPES, default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from .models import config, gpt2, llama
    from .ops import kernels
    from .ops.quant import quantize_params
    from .runtime.engine import Engine

    kernels.build_all()
    dev = torch.device("cuda")
    cfg = getattr(config, args.model)()
    family = gpt2 if cfg.model_type == "gpt2" else llama
    params = family.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    if args.weights != "bf16":
        params = quantize_params(params, bits=8 if args.weights == "int8" else 4)
    eng = Engine(cfg, params)
    srv = smoke_workload.serve(eng, args.model, kv_dtype=args.kv_dtype)
    rng = np.random.default_rng(0)
    srv.result(srv.submit(rng.integers(0, cfg.vocab_size, 300).astype(np.int32), 8))

    lens = smoke_workload.WORKLOADS[args.model].lens
    prompts = smoke_workload.prompts(cfg.vocab_size, rng, lens)

    def workload():
        """The staggered 8-request run; returns (requests, wall ms, host wall
        ms of each decode-only step at 8 live rows)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs, steps = smoke_workload.submit_staggered(srv, prompts), []
        while srv._queue or srv._live_rows():
            decode_only = not srv._queue and len(srv._live_rows()) == smoke_workload.ROWS
            ts = time.perf_counter()
            srv.step()
            if decode_only:
                steps.append((time.perf_counter() - ts) * 1e3)
        torch.cuda.synchronize()
        return reqs, (time.perf_counter() - t0) * 1e3, steps

    reqs, plain_wall_ms, decode_ms = workload()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        reqs, wall_ms, _ = workload()

    per_kernel = collections.Counter()
    calls = collections.Counter()
    for evt in prof.key_averages():
        # kernel events only: an aten op's device time repeats its kernels'
        us = _device_us(evt) if str(evt.device_type).endswith("CUDA") else 0.0
        if us > 0:
            per_kernel[evt.key] += us
            calls[evt.key] += evt.count
    busy_ms = sum(per_kernel.values()) / 1e3
    print(f"{torch.cuda.get_device_name(0)}, {args.model}, weights {args.weights}, kv {args.kv_dtype}: "
          f"unprofiled wall {plain_wall_ms:.1f} ms; "
          f"profiled wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), tokens {sum(len(r.tokens) for r in reqs)}")
    for key, us in per_kernel.most_common(15):
        print(f"  {us / 1e3:9.2f} ms {us / 1e3 / busy_ms:6.1%} {calls[key]:7d}x  {key[:90]}")
    pairs = chunked_prefill_pairs(lens, smoke_workload.PREFILL_CHUNK)
    flops = 4.0 * cfg.num_attention_heads * cfg.head_dim_ * pairs * cfg.num_hidden_layers
    bound_ms = flops / BF16_FLOPS * 1e3
    print(f"chunked-prefill kernel's operations bound over the workload: {bound_ms:.4f} ms "
          f"({pairs} visible query-key pairs per layer, {BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    port = port_kernel_totals(per_kernel, calls)
    print("port kernels (all launches in the window):")
    for name, kv, ms, n in port:
        print(f"  {ms:9.2f} ms {n:7d}x  {name} [{kv}]")
    if decode_ms:
        print(f"decode-only steps at {smoke_workload.ROWS} live rows: {len(decode_ms)}, wall ms p50 "
              f"{np.percentile(decode_ms, 50):.2f} min {min(decode_ms):.2f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps({
        "model": args.model, "weights": args.weights, "kv_dtype": args.kv_dtype, "wall_ms": plain_wall_ms, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "decode_step_ms_p50": float(np.percentile(decode_ms, 50)) if decode_ms else None,
        "top": [[k, us / 1e3, calls[k]] for k, us in per_kernel.most_common(15)],
        "port_kernels": port,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
