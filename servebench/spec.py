"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its limits, and the reader of each metric, all found by name.

A metric's reader is ``e2e_metrics/<name>.py`` or ``layer_metrics/<name>.py``,
or, for a name with dotted parts, the file of its longest dotted prefix
(``mfu.tok_s`` and ``mfu.ttft`` share ``layer_metrics/mfu.py``). A reader
defines ``read(run, name)``, which returns the number, or None when the run
holds nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
KINDS = {"end_to_end": "e2e_metrics", "per_layer": "layer_metrics"}


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"unknown configuration {name!r}")


def traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def metrics(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` / ``per_layer``): those
    that list it, and those without a list whose ``moves`` the cell
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def reader(kind: str, name: str):
    """The ``read`` function of metric ``name``."""
    folder = PKG / KINDS[kind]
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        path = folder / f"{stem}.py"
        if path.exists():
            mod_name = f"servebench.{KINDS[kind]}.{stem.replace('.', '_')}"
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {folder}")
