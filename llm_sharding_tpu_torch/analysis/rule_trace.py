"""trace-discipline: every span name the port emits appears in the README
span-schema table, and every schema row names a span the port can emit
(the port of ``llm_sharding_tpu/analysis/rule_trace.py``; the port emits
the JAX package's span names, so one table documents both).

``trace-report`` consumers and postmortem tooling navigate by span name;
a span emitted under a name the schema table doesn't list is invisible
documentation-wise, and a schema row with no emitter is a phase the
operator will wait for forever. Span names are collected from literal
first-name arguments of ``emit_span(writer, "<name>", ...)`` and the
``self._span("<name>", ...)`` / ``self._decision("<name>", ...)``
helpers; pass-through helpers forwarding a ``name`` variable are the
helpers themselves and are skipped.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set, Tuple

from . import astutil
from .core import Finding, Package

RULE = "trace-discipline"
DOC = "emit_span names must match the README span-schema table"

_HELPERS = {"_span", "_decision"}
_TOKEN_RE = re.compile(r"`([^`]+)`")


def _code_spans(pkg: Package) -> Dict[str, Tuple[str, int]]:
    spans: Dict[str, Tuple[str, int]] = {}
    for rel, pf in pkg.files.items():
        for call in astutil.walk_calls(pf.tree):
            name = astutil.call_name(call)
            lit = None
            if name == "emit_span" and len(call.args) >= 2:
                lit = astutil.literal_str(call.args[1])
            elif name in _HELPERS and call.args:
                lit = astutil.literal_str(call.args[0])
            if lit is not None:
                spans.setdefault(lit, (rel, call.lineno))
    return spans


def _schema_rows(readme: str) -> List[Tuple[str, int]]:
    """(span name, README line) from the span-schema table (the table
    whose header's first column is ``span``)."""
    rows: List[Tuple[str, int]] = []
    lines = readme.splitlines()
    in_table = False
    for i, line in enumerate(lines, 1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if not in_table:
            if cells and cells[0].lower() == "span":
                in_table = True
            continue
        if cells and set(cells[0]) <= {"-", ":", " "}:
            continue  # the |---|---| separator row
        for tok in _TOKEN_RE.findall(cells[0]):
            if re.match(r"^[a-z_]+$", tok):
                rows.append((tok, i))
    return rows


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    spans = _code_spans(pkg)
    schema = _schema_rows(pkg.readme)
    schema_names: Set[str] = {n for n, _ in schema}
    if not schema_names:
        findings.append(Finding(
            rule=RULE, path="README.md", line=1,
            message=(
                "no span-schema table found in README (a table whose "
                "first header column is `span`) — the span contract is "
                "undocumented"
            ),
            key="no-schema-table",
        ))
        return findings
    for name, (rel, line) in sorted(spans.items()):
        if name not in schema_names:
            findings.append(Finding(
                rule=RULE, path=rel, line=line,
                message=(
                    f"span {name!r} is emitted but missing from the "
                    f"README span-schema table — trace-report consumers "
                    f"cannot discover it"
                ),
                key=f"undocumented:{name}",
            ))
    for name, line in schema:
        if name not in spans:
            findings.append(Finding(
                rule=RULE, path="README.md", line=line,
                message=(
                    f"README span-schema table documents span {name!r} "
                    f"but nothing emits it"
                ),
                key=f"stale:{name}",
            ))
    return findings
