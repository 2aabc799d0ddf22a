"""The control of a cell's check, run on the chip at the cell's own size:

    python -m servebench.control --workload <cell> --seeds 11,12,13 --seconds 40

For each seed, in one process: a run of the cell as the benchmark makes it
(its window and its check: the program's readings), then the reference with
every matrix in float8 (``reference.qwen2``, ``quant="fp8"``) put in the
program's place at the same positions of the same compared requests (the
control's readings), which the cell's limits then judge as they judge a
run: the control has to come out not correct (``control_correct`` false,
and the verdict's lines on standard error). One JSON line a seed on
standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from . import check, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m servebench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("servebench.control: no CUDA device")
        return 2
    root = Path.cwd()
    run.set_cache_dirs(root)
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, root, cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = check.load_limits(cell["name"])
    from .weights import Dims

    d = Dims.of(cfg)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, lines, items = run.run_cell(
            cfg, mix, limits, seed, args.seconds, False, t0,
            metric_specs=spec.metrics(bench, cell["name"], "end_to_end"),
        )
        t1 = time.perf_counter()
        chosen = check.choices(d, seed, items, dev, "fp8")
        control = check.gaps(d, seed, items, dev, control=chosen)
        control_correct, control_lines = check.verdict(control, limits, 0)
        for ln in control_lines:
            run.log(f"control, seed {seed}: {ln}")
        run.log(f"control, seed {seed}: correct={control_correct}")
        program = {k: v["value"] for k, v in result["check"].items()}
        print(json.dumps({"seed": seed, "correct": result["correct"], "program": program,
                          "control": control, "control_correct": control_correct,
                          "metrics": result["metrics"],
                          "served_tokens": sum(len(i.tokens) for i in items),
                          "control_s": time.perf_counter() - t1}), flush=True)
        del items, chosen
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
