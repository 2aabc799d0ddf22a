"""Operator commands of the port (counterpart of ``llm_sharding_tpu/cli.py``).

    python -m llm_sharding_tpu_torch convert MODEL_DIR OUT_DIR \
        [--dtype bf16|f32|int8|int4] [--quantize-head]
    python -m llm_sharding_tpu_torch trace-report FILES... [--top N] [--trace ID] [--json]
    python -m llm_sharding_tpu_torch step-report FILES... [--top N] [--json]

``convert`` turns an HF checkpoint directory into a shard store either
package serves (``cli.py:129-154``, ``:1468-1478``): ``--dtype int8`` /
``int4`` store the layers' matmul weights quantized with bf16 scales
(int4 packs two values per byte on disk), ``--quantize-head`` the vocab
tables too. ``trace-report`` and ``step-report`` (``cli.py:1364``,
``:1402``, parser ``:1899-1944``: the same flags and output) render span
files and step-profiler captures of either package; they need no GPU, no
model and no torch (``obs/report.py``). ``generate`` and ``serve`` need a
tokenizer and come with a later slice.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

# names of torch dtypes: torch is imported by the commands that need it,
# so the report commands run where it is not installed
DTYPES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f32": "float32", "float32": "float32",
    "f16": "float16", "float16": "float16",
}


def _dtype(name: str):
    import torch

    if name not in DTYPES:
        hint = (
            f" ({name} is a convert-time option; {name} stores load with "
            "any compute dtype — pass e.g. --dtype bf16)"
            if name in ("int8", "int4") else ""
        )
        raise SystemExit(f"unknown dtype {name!r}; choose from {sorted(set(DTYPES))}{hint}")
    return getattr(torch, DTYPES[name])


def cmd_convert(args) -> int:
    from .utils.shard_store import convert_hf_checkpoint

    if args.dtype in ("int8", "int4"):
        dtype, quantize = _dtype("bf16"), True
        bits = 8 if args.dtype == "int8" else 4
    else:
        dtype, quantize, bits = _dtype(args.dtype), False, 8
    if args.quantize_head and not quantize:
        raise SystemExit("--quantize-head requires --dtype int8 or int4")
    cfg = convert_hf_checkpoint(
        args.model_dir, args.out_dir, dtype, quantize=quantize,
        quantize_head=args.quantize_head, quant_bits=bits,
    )
    print(
        f"converted {cfg.model_type} ({cfg.num_hidden_layers} layers, "
        f"vocab {cfg.vocab_size}{f', {args.dtype}' if quantize else ''}"
        f"{' incl. head' if args.quantize_head else ''}) "
        f"-> {args.out_dir}"
    )
    return 0


def _expand(patterns) -> list:
    """Command-line files, globs expanded (sorted), the rest as given."""
    paths = []
    for pat in patterns:
        paths.extend(sorted(glob.glob(pat)) if any(c in pat for c in "*?[") else [pat])
    return paths


def cmd_trace_report(args) -> int:
    """Merge JSONL trace files, rebuild the span trees, and print per-phase
    latency attribution (``obs/report.py``; JAX ``cli.py:1364``)."""
    from .obs.report import load_events, render_report, report_json, trace_json

    paths = _expand(args.files)
    if not paths:
        print("no trace files matched", file=sys.stderr)
        return 2
    try:
        events = load_events(paths)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not events:
        print("no span events in the input files", file=sys.stderr)
        return 1
    if args.json and args.trace is not None:
        out = trace_json(events, args.trace)
        print(json.dumps(out, sort_keys=True))
        return 0 if out["found"] else 1
    if args.json:
        print(json.dumps(report_json(events, top=args.top), sort_keys=True))
    else:
        print(render_report(events, top=args.top, trace_id=args.trace))
    return 0


def cmd_step_report(args) -> int:
    """Render step-profiler captures offline: ``/profilez`` bundles,
    ``/debugz`` postmortems and raw record lists merged into the per-phase
    host-time attribution, occupancy timeline and worst device bubbles
    (``obs/report.py``; JAX ``cli.py:1402``)."""
    from .obs.report import load_steps, render_step_report, step_report_json

    paths = [p for p in _expand(args.files) if os.path.exists(p)]
    if not paths:
        print("no capture files matched", file=sys.stderr)
        return 2
    steps = load_steps(paths)
    if not steps:
        print("no step records in the input files", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(step_report_json(steps, top=args.top), sort_keys=True))
    else:
        print(render_step_report(steps, top=args.top))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_sharding_tpu_torch",
        description="PyTorch/CUDA port of llm_sharding_tpu: operator commands",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)
    c = sub.add_parser("convert", help="HF checkpoint dir -> shard store")
    c.add_argument("model_dir")
    c.add_argument("out_dir")
    c.add_argument("--dtype", default="bf16")
    c.add_argument(
        "--quantize-head", action="store_true", dest="quantize_head",
        help="with --dtype int8/int4: also quantize the vocab tables (embed "
        "per-row scales, untied lm_head per-column)",
    )
    c.set_defaults(fn=cmd_convert)

    tr = sub.add_parser(
        "trace-report",
        help="merge JSONL trace files, rebuild span trees, attribute "
        "latency per phase/tenant",
    )
    tr.add_argument(
        "files", nargs="+",
        help="trace files (globs ok): PATH, PATH.r<i>, PATH.router, "
        "PATH.ingress, PATH*.1 rollovers — any subset; spans join by "
        "trace_id",
    )
    tr.add_argument("--top", type=int, default=5,
                    help="how many slowest traces to list (default 5)")
    tr.add_argument("--trace", default=None,
                    help="print one trace's full span tree instead of the summary")
    tr.add_argument("--json", action="store_true",
                    help="machine-readable report (one JSON object)")
    tr.set_defaults(fn=cmd_trace_report)

    sr = sub.add_parser(
        "step-report",
        help="render step-profiler captures (/profilez bundles, /debugz "
        "postmortems, :profile dumps): per-phase host-time attribution, "
        "occupancy timeline, worst device bubbles",
    )
    sr.add_argument(
        "files", nargs="+",
        help="capture JSON files (globs ok): /profilez?steps=N bundles, "
        "/debugz bundles (the recent_steps ring tails), or :profile "
        "output — any mix; records merge sorted by timestamp",
    )
    sr.add_argument("--top", type=int, default=5,
                    help="how many worst device-idle bubbles to list (default 5)")
    sr.add_argument("--json", action="store_true",
                    help="machine-readable report (one JSON object)")
    sr.set_defaults(fn=cmd_step_report)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.fn(args)
