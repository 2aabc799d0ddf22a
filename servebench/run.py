"""One run of one cell:

    python -m servebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Set-up draws the weights on the card,
builds the engine and its server with the mix's options, warms the cell's
own shapes, and starts the traffic; the window then drives the server for
``--seconds``. With ``--trace 1`` a stretch after the window is traced (the
device alone, then a short stretch of host and device for the breakdown of
idle gaps) and the per-layer metrics are reported instead of the end-to-end
ones.
After the window the program is freed and a sample of its answers is held
against the plain reference (``check.py``). The last line of standard
output is the result; everything else goes to standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "llm_sharding_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m servebench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build into ``build/kernels`` there already)."""
    base = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class Run:
    """What the metric readers read: the model's sizes (``weights.Dims``), the
    server's options and the whole mix, every request sent (``driver.Rec``),
    the window (``perf_counter`` stamps and its length), the set-up time, the
    server's counters at the window's ends, its step records inside it, and
    the trace with its stretch's stamps (None without ``--trace 1``)."""

    dims: object
    server: dict
    mix: dict
    recs: list
    t_open: float
    t_close: float
    window_s: float
    setup_s: float
    counters_open: dict
    counters_close: dict
    stepline: list
    trace: object = None
    trace_t: tuple = (0.0, 0.0)


def warm_up(srv, mix: dict, high: int, buckets) -> None:
    """The cell's own shapes: one admission per bucket the mix's prompts
    reach, for each kind of sampling it sends, and the decode steps at the
    server's rows."""
    import numpy as np

    from . import gen

    rng = np.random.default_rng(12345)
    s = mix.get("sampling", {})
    kinds = [0.0] + ([float(s["temperature"])] if float(s.get("temperature", 0)) > 0 else [])
    for b in gen.reachable(mix, buckets):
        plen = max(min(b, int(mix["prompt"]["max"])), int(mix["prompt"]["min"]))
        for temp in kinds:
            srv.submit(rng.integers(0, high, plen).astype(np.int32), 2, temperature=temp,
                       seed=1, top_k=int(s.get("top_k", 0)), top_p=float(s.get("top_p", 1.0)))
    srv.run_until_idle()


def run_cell(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda",
             metric_specs: Optional[list] = None, kind: str = "end_to_end",
             notes: Optional[dict] = None, do_check: bool = True) -> tuple:
    """Set-up, window, optional trace, the check: the result (its keys in
    print order, the compared numbers under ``check``, last), the check's
    lines and the compared requests (``check.Item``). ``notes``, if given,
    takes the window's backlog and latencies by half (what a rate sweep
    reads); ``do_check`` False skips the reference (a sweep's runs)."""
    import torch

    from llm_sharding_tpu_torch.models.config import ModelConfig
    from llm_sharding_tpu_torch.runtime import server as port_server
    from llm_sharding_tpu_torch.runtime.engine import Engine

    from . import check, driver, gen, spec, stats, weights
    from .trace import STEP_ANNOTATION, Trace

    clock = time.perf_counter
    dev = torch.device(device)
    d = weights.Dims.of(cfg)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t = clock()
    params = weights.make_params(d, seed, dev)
    eng = Engine(ModelConfig.from_hf_config(cfg), params)
    srv = eng.serve(**mix["server"])
    traffic = gen.Traffic(mix, cfg, seed)
    t_built = clock()
    warm_up(srv, mix, traffic.high, port_server.ADMIT_BUCKETS)
    if on_card:
        torch.cuda.synchronize(dev)
    t_warm = clock()
    drv = driver.Driver(srv, traffic, mix, clock)
    if drv.closed:
        drv.fill(int(mix["clients"]))
        gc.collect()  # set-up's garbage, before the window rather than in it
    else:
        if "cache_fill" in mix:
            fill, server = mix["cache_fill"], mix["server"]
            per_wave = int(fill["wave"]) * int(fill["prompt"]) // int(server["kv_block_size"])
            waves = drv.fill_cache(int(fill["wave"]), int(server["kv_blocks"]) // per_wave + 4)
            log(f"setup: prefix cache filled in {waves} waves of {fill['wave']} x "
                f"{fill['prompt']} tokens, {clock() - t_warm:.3f} s: {srv.prefix_cache_stats()}")
        gc.collect()  # before the first arrival falls due
        t0 = clock()
        drv.start_schedule(t0)
        drv.run_until(t0 + float(mix["lead_seconds"]))
    log(f"setup: weights and server {t_built - t:.3f} s, warm-up {t_warm - t_built:.3f} s, "
        f"traffic start {clock() - t_warm:.3f} s")

    t_open = clock()
    wall_open = time.time()
    drv.mark("open")
    counters_open = srv.counters.snapshot()
    cache_open = srv.prefix_cache_stats()
    drv.read_stepline()
    queued_open = sum(1 for r in drv.recs if r.req.started_at is None)
    drv.run_until(t_open + seconds)
    t_close = clock()
    queued_close = sum(1 for r in drv.recs if r.req.started_at is None)
    wall_close = time.time()
    drv.mark("close")
    counters_close = srv.counters.snapshot()
    cache_close = srv.prefix_cache_stats()
    drv.read_stepline()
    n_window_steps = sum(1 for a, _ in drv.steps if t_open <= a < t_close)

    tr, host_tr, trace_t = None, None, (0.0, 0.0)
    if traced:
        # the device alone for the metrics; then a short stretch with the
        # host's operations too, for the breakdown of idle gaps only
        tr, host_tr = Trace(host=False), Trace(host=True)
        for stretch, key, default in ((tr, "trace_seconds", 2.0),
                                      (host_tr, "breakdown_seconds", 1.0)):
            n_before = len(drv.steps)
            stretch.start()
            if stretch is tr:
                drv.mark("trace_start")
            ta = clock()
            t_end = ta + float(mix.get(key, default))
            while clock() < t_end:
                if stretch.host:
                    with torch.profiler.record_function(STEP_ANNOTATION):
                        drv.step()
                else:
                    drv.step()
            tb = clock()
            stretch.stop()
            if stretch is tr:
                drv.mark("trace_end")
                trace_t = (ta, tb)
            log(f"trace ({'host and device' if stretch.host else 'device'}): {tb - ta:.3f} s "
                f"of serving traced ({len(drv.steps) - n_before} steps), stopped in "
                f"{stretch.stop_s:.3f} s, {stretch.n_events} events read in "
                f"{stretch.read_s:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    run = Run(
        dims=d, server=mix["server"], mix=mix, recs=drv.recs, t_open=t_open, t_close=t_close,
        window_s=t_close - t_open, setup_s=t_open - t_start, counters_open=counters_open,
        counters_close=counters_close,
        stepline=[r for ts, r in sorted(drv.stepline.items()) if wall_open <= ts < wall_close],
        trace=tr, trace_t=trace_t,
    )
    metrics = {}
    for m in metric_specs or []:
        value = spec.reader(kind, m["name"])(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    late = sorted(r.submitted - r.due for r in drv.recs if t_open <= r.due < t_close)
    if late and not drv.closed:
        log(f"generator lateness in the window: p50 {late[len(late) // 2] * 1e3:.3f} ms, "
            f"max {late[-1] * 1e3:.3f} ms over {len(late)} arrivals")
    log(f"window: {run.window_s:.3f} s, {n_window_steps} steps, "
        f"{len(drv.recs)} requests sent, {sum(r.ok for r in drv.recs)} finished; "
        f"waiting for admission at open {queued_open}, at close {queued_close}")
    held = [o[1:] for o in drv.occupancy if t_open <= o[0] < t_close]
    if held:
        rows, toks, blocks = (sorted(c) for c in zip(*held))
        log(f"held in the window ({len(held)} samples, median / max): rows {rows[len(rows) // 2]}"
            f" / {rows[-1]}, live KV tokens {toks[len(toks) // 2]} / {toks[-1]}, reserved blocks "
            f"{blocks[len(blocks) // 2]} / {blocks[-1]} of {mix['server']['kv_blocks']}")
    evicted = None
    if cache_open is not None:
        evicted = driver.evictions(cache_close) - driver.evictions(cache_open)
        log(f"prefix cache: device blocks {cache_open['device_blocks']} at open, "
            f"{cache_close['device_blocks']} at close; {evicted} nodes evicted in the window, "
            f"hit tokens {cache_close['hit_tokens'] - cache_open['hit_tokens']}")
    if notes is not None:
        mid = (t_open + t_close) / 2
        ttft = [(r.req.first_token_at, r.req.first_token_at - r.due, r.plen) for r in drv.recs
                if r.req.first_token_at is not None and t_open <= r.req.first_token_at < t_close]
        halves = ([x for x in ttft if x[0] < mid], [x for x in ttft if x[0] >= mid])
        notes.update(
            queued_open=queued_open, queued_close=queued_close,
            first_tokens=len(ttft),
            ttft_p50_first_half=stats.percentile([x[1] for x in halves[0]], 50),
            ttft_p50_second_half=stats.percentile([x[1] for x in halves[1]], 50),
            prompt_mean_first_half=stats.mean([x[2] for x in halves[0]]),
            prompt_mean_second_half=stats.mean([x[2] for x in halves[1]]),
            evicted_in_window=evicted,
            metrics={k: v["value"] for k, v in metrics.items()},
            lateness_p50=stats.percentile(late, 50),
        )

    attempted = len(drv.recs)
    failed = sum(1 for r in drv.recs if r.req.error is not None)
    finished = [check.Item(r.spec.prompt, list(r.req.tokens), r.spec.temperature, r.spec.top_k,
                           r.spec.top_p) for r in drv.recs if r.ok]
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": host_tr.idle_gaps}
    srv.close()
    del srv, eng, params, drv, run, tr, host_tr
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    if not do_check:
        return {"device": device_info, "metrics": metrics}, [], []
    t = clock()
    items = check.pick(finished, mix["check"], seed)
    numbers = check.gaps(d, seed, items, dev)
    correct, lines = check.verdict(numbers, limits, failed)
    log(f"check: {len(items)} requests, {sum(len(i.tokens) for i in items)} served tokens, "
        f"{sum(len(i.prompt) for i in items)} prompt tokens, reference {clock() - t:.3f} s")
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    checked = {"failed_requests": {"value": failed, "limit": 0}}
    checked.update({k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()})
    result["check"] = checked
    return result, lines, items


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = Path.cwd()
    set_cache_dirs(root)  # before CUDA starts: the driver reads CUDA_CACHE_PATH once
    from . import check, spec

    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"servebench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cfg = spec.config(bench, root, cell["config"])
    mix = spec.traffic(cell["traffic"])
    kind = "per_layer" if args.trace else "end_to_end"
    result, lines, _ = run_cell(
        cfg, mix, check.load_limits(cell["name"]), args.seed, args.seconds,
        bool(args.trace), t_start, metric_specs=spec.metrics(bench, cell["name"], kind), kind=kind,
    )
    bad = forbidden_modules()
    if bad:
        log(f"servebench: JAX or the JAX package was loaded: {bad}")
        return 3
    for ln in lines:  # the compared numbers beside their limits, last on stderr
        log(ln)
    print(json.dumps(result), flush=True)
    return 0
