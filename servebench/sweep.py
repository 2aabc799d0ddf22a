"""The rate sweep of an open-loop cell, on the chip, in one process:

    python -m servebench.sweep --workload <cell> --rates 1.5,2,2.5 --seconds 40 --seed 7

For each rate the cell runs as a run does (its mix at that rate, no check),
and one JSON line tells whether the server kept up: requests waiting for
admission at the window's opening and its close, the median first-token
latency in each half of the window, and the end-to-end metrics. The
highest rate at which the backlog does not grow is the cell's knee; its
mix's ``rate`` is set to four fifths of it, as a number."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import check, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m servebench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("servebench.sweep: no CUDA device")
        return 2
    root = Path.cwd()
    run.set_cache_dirs(root)
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, root, cell["config"])
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(spec.traffic(cell["traffic"]), rate=rate)
        notes: dict = {}
        run.run_cell(cfg, mix, check.load_limits(cell["name"]), args.seed,
                     args.seconds, False, time.perf_counter(),
                     metric_specs=spec.metrics(bench, cell["name"], "end_to_end"),
                     notes=notes, do_check=False)
        print(json.dumps({"rate": rate, **notes}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
