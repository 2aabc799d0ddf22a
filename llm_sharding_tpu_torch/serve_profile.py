"""Where the time of the paged server goes on one GPU.

    python -m llm_sharding_tpu_torch.serve_profile

Serves the workload of ``chip_smoke.py`` phase (d) (``smoke_workload``: 8
staggered requests, 4 prompts of 20-200 tokens, 4 of 1024-2048, 64 new
tokens each) on seeded random Llama-3.2-3B weights (all 28 layers, bf16),
made on the card, under ``torch.profiler``. Prints the device time per
kernel (top 15), the
device-busy share of the run's wall time, and the host wall time of
decode-only steps at 8 live rows. A warm-up request runs first so
first-call costs (kernel build, allocator growth) stay out of the window;
the workload runs once unprofiled (wall and step times) and once under the
profiler (kernel table; the profiler slows the host, so its wall is longer).
Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import smoke_workload


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from .models import config, llama
    from .ops import kernels
    from .runtime.engine import Engine

    kernels.build_all()
    dev = torch.device("cuda")
    cfg = config.llama32_3b()
    eng = Engine(cfg, llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev))
    srv = eng.serve(capacity=4096, batch_per_slot=8, kv_block_size=64, kv_blocks=1024,
                    prefill_chunk=256)
    rng = np.random.default_rng(0)
    srv.result(srv.submit(rng.integers(0, cfg.vocab_size, 300).astype(np.int32), 8))

    prompts = smoke_workload.prompts(cfg.vocab_size, rng)

    def workload():
        """The staggered 8-request run; returns (requests, wall ms, host wall
        ms of each decode-only step at 8 live rows)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs, steps = smoke_workload.submit_staggered(srv, prompts), []
        while srv._queue or srv._live_rows():
            decode_only = not srv._queue and len(srv._live_rows()) == 8
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
    print(f"{torch.cuda.get_device_name(0)}: unprofiled wall {plain_wall_ms:.1f} ms; "
          f"profiled wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), tokens {sum(len(r.tokens) for r in reqs)}")
    for key, us in per_kernel.most_common(15):
        print(f"  {us / 1e3:9.2f} ms {us / 1e3 / busy_ms:6.1%} {calls[key]:7d}x  {key[:90]}")
    if decode_ms:
        print(f"decode-only steps at 8 live rows: {len(decode_ms)}, wall ms p50 "
              f"{np.percentile(decode_ms, 50):.2f} min {min(decode_ms):.2f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps({
        "wall_ms": plain_wall_ms, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "decode_step_ms_p50": float(np.percentile(decode_ms, 50)) if decode_ms else None,
        "top": [[k, us / 1e3, calls[k]] for k, us in per_kernel.most_common(15)],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
