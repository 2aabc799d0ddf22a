"""Operator commands of the port (counterpart of ``llm_sharding_tpu/cli.py``).

    python -m llm_sharding_tpu_torch convert MODEL_DIR OUT_DIR \
        [--dtype bf16|f32|int8|int4] [--quantize-head]

``convert`` turns an HF checkpoint directory into a shard store either
package serves (``cli.py:129-154``, ``:1468-1478``): ``--dtype int8`` /
``int4`` store the layers' matmul weights quantized with bf16 scales
(int4 packs two values per byte on disk), ``--quantize-head`` the vocab
tables too. ``generate`` and ``serve`` need a tokenizer and come with a
later slice.
"""

from __future__ import annotations

import argparse
import logging

import torch

DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
    "f16": torch.float16, "float16": torch.float16,
}


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        hint = (
            f" ({name} is a convert-time option; {name} stores load with "
            "any compute dtype — pass e.g. --dtype bf16)"
            if name in ("int8", "int4") else ""
        )
        raise SystemExit(f"unknown dtype {name!r}; choose from {sorted(set(DTYPES))}{hint}")
    return DTYPES[name]


def cmd_convert(args) -> int:
    from .utils.shard_store import convert_hf_checkpoint

    if args.dtype in ("int8", "int4"):
        dtype, quantize = torch.bfloat16, True
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.fn(args)
