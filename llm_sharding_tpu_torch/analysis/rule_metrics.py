"""metrics-discipline: every metric the port registers has help text, a
row in the README metric tables (and vice versa), and consistent label sets
at every feed site (the port of ``llm_sharding_tpu/analysis/rule_metrics.py``).
The port registers the JAX package's names, so one set of tables documents
both; the rows of JAX-only metrics are named in ``NOT_PORTED``.

The README's metric tables are the operator contract — dashboards and
alerts are written against them. With 65+ ``server_*`` names in play,
drift is inevitable unless machine-checked: a metric registered without a
README row is invisible to operators; a README row without a registration
is a dashboard that silently reads empty; a feed site passing the wrong
label names raises at runtime only on the path that feeds it.

Registration sites are ``REGISTRY.counter/gauge/histogram/state_gauge``
calls anywhere in the package. The one dynamic registration (the
``Counters`` mirror dict in ``runtime/server.py``) is resolved statically
by expanding ``dataclasses.fields(Counters)`` over the dataclass's
annotated fields.

README parsing: any markdown table row whose first cell carries a
backticked ``server_*``/``engine_*``/``spec_*`` token. ``{a,b}`` groups
mid-token expand (``server_requests_{submitted,completed}_total``);
a trailing ``{...}`` group is a label set and strips.
"""

from __future__ import annotations

import ast
import itertools
import re
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, Package

RULE = "metrics-discipline"
DOC = (
    "metric registrations need help text + README rows (and back); "
    "label sets must match at feed sites"
)

_KINDS = {"counter", "gauge", "histogram", "state_gauge"}

#: README rows of metrics the JAX package registers and the port does not,
#: by design (``ROADMAP.md`` §A, "Not ported, by design"), with the reason.
NOT_PORTED = {
    "engine_jit_shape_keys_total": (
        "counts the shape keys of jitted programs; the port compiles none"
    ),
}
_NAME_RE = re.compile(r"^(server|engine|spec)_[a-z0-9_]+$")
_TOKEN_RE = re.compile(r"`([^`]+)`")


class _Reg:
    def __init__(self, name, kind, help_ok, labels, path, line, var):
        self.name = name
        self.kind = kind
        self.help_ok = help_ok
        self.labels = labels          # tuple[str] or None (unknown)
        self.path = path
        self.line = line
        self.var = var                # module-level variable name, if any


def _dataclass_fields(tree: ast.Module, cls_name: str) -> List[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return [
                n.target.id for n in node.body
                if isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)
            ]
    return []


def _expand_dynamic_names(
    call: ast.Call, pf, parents
) -> Optional[List[str]]:
    """``f"server_{f.name}_total"`` inside a comprehension over
    ``dataclasses.fields(Counters)`` → the concrete name list."""
    arg = call.args[0] if call.args else None
    if not isinstance(arg, ast.JoinedStr):
        return None
    parts: List[str] = []
    hole = False
    for v in arg.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        elif isinstance(v, ast.FormattedValue):
            if hole:
                return None
            parts.append("\0")
            hole = True
    if not hole:
        return None
    # find the comprehension iterating dataclasses.fields(<cls>)
    cur = parents.get(call)
    while cur is not None:
        if isinstance(cur, (ast.DictComp, ast.ListComp, ast.SetComp,
                            ast.GeneratorExp)):
            for gen in cur.generators:
                it = gen.iter
                if (
                    isinstance(it, ast.Call)
                    and astutil.call_name(it) == "fields"
                    and it.args
                ):
                    cls = astutil.dotted(it.args[0])
                    if cls is None:
                        return None
                    names = _dataclass_fields(
                        pf.tree, cls.split(".")[-1]
                    )
                    tmpl = "".join(parts)
                    return [tmpl.replace("\0", n) for n in names]
        cur = parents.get(cur)
    return None


def _collect_registrations(pkg: Package) -> List[_Reg]:
    regs: List[_Reg] = []
    for rel, pf in pkg.files.items():
        parents = astutil.parent_map(pf.tree)
        for call in astutil.walk_calls(pf.tree):
            f = call.func
            if not (
                isinstance(f, ast.Attribute) and f.attr in _KINDS
                and astutil.dotted(f.value) is not None
                and astutil.dotted(f.value).split(".")[-1] == "REGISTRY"
            ):
                continue
            kind = f.attr
            help_node = (
                call.args[1] if len(call.args) > 1
                else astutil.kwarg(call, "help")
            )
            help_ok = bool(
                (astutil.literal_str(help_node) or "").strip()
                or isinstance(help_node, ast.JoinedStr)
            )
            labels: Optional[Tuple[str, ...]] = ()
            ln = astutil.kwarg(call, "labels") or (
                call.args[2] if len(call.args) > 2 else None
            )
            if ln is not None:
                try:
                    labels = tuple(ast.literal_eval(ln))
                except ValueError:
                    labels = None
            if kind == "state_gauge":
                labels = ("state",)
            var = None
            parent = parents.get(call)
            if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
                t = parent.targets[0]
                if isinstance(t, ast.Name):
                    var = t.id
            name = astutil.literal_str(call.args[0]) if call.args else None
            if name is not None:
                regs.append(_Reg(
                    name, kind, help_ok, labels, rel, call.lineno, var
                ))
                continue
            expanded = _expand_dynamic_names(call, pf, parents)
            if expanded is not None:
                for n in expanded:
                    regs.append(_Reg(
                        n, kind, help_ok, labels, rel, call.lineno, None
                    ))
            else:
                regs.append(_Reg(
                    None, kind, help_ok, labels, rel, call.lineno, var
                ))
    return regs


def _readme_tokens(readme: str) -> List[Tuple[str, int]]:
    """(metric name, README line) for every metric token in a table row."""
    out: List[Tuple[str, int]] = []
    for i, line in enumerate(readme.splitlines(), 1):
        if not line.lstrip().startswith("|"):
            continue
        # protect escaped pipes (markdown's in-cell `\|`) from the cell
        # split, then restore them inside the token
        guarded = line.replace("\\|", "\0")
        first_cell = guarded.split("|")[1] if "|" in guarded[1:] else ""
        for tok in _TOKEN_RE.findall(first_cell):
            tok = tok.replace("\0", "|")
            for name in _expand_token(tok):
                if _NAME_RE.match(name):
                    out.append((name, i))
    return out


def _expand_token(tok: str) -> List[str]:
    # a trailing {...} is a label set and strips — only the LAST group,
    # so a mid-token {a,b} expansion earlier in the same token survives
    # (`server_requests_{a,b}_total{tenant}` keeps its expansion)
    if tok.endswith("}") and "{" in tok:
        tok = tok[: tok.rindex("{")]
    if "{" not in tok:
        return [tok]
    segments: List[List[str]] = []
    for lit, group in re.findall(r"([^{]*)(?:\{([^}]*)\})?", tok):
        if lit:
            segments.append([lit])
        if group:
            segments.append(group.split(","))
    return ["".join(p) for p in itertools.product(*segments)]


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    regs = _collect_registrations(pkg)

    by_name: Dict[str, _Reg] = {}
    for r in regs:
        if not r.help_ok:
            findings.append(Finding(
                rule=RULE, path=r.path, line=r.line,
                message=(
                    f"metric {r.name or '<dynamic>'} registered without "
                    f"help text — /metrics HELP lines and the README "
                    f"table both need it"
                ),
                key=f"nohelp:{r.name or r.line}",
            ))
        if r.name is None:
            findings.append(Finding(
                rule=RULE, path=r.path, line=r.line,
                message=(
                    "metric registered with a name the analyzer cannot "
                    "resolve statically — use a literal, or an f-string "
                    "over dataclasses.fields(<cls>)"
                ),
                key=f"dynamic:{r.line}",
            ))
            continue
        by_name.setdefault(r.name, r)

    readme_names = _readme_tokens(pkg.readme)
    readme_set = {n for n, _ in readme_names}

    for name, r in sorted(by_name.items()):
        if name not in readme_set:
            findings.append(Finding(
                rule=RULE, path=r.path, line=r.line,
                message=(
                    f"metric {name!r} is registered but has no row in a "
                    f"README metric table — operators cannot discover it"
                ),
                key=f"undocumented:{name}",
            ))
    seen_rows: Set[str] = set()
    for name, line in readme_names:
        if name in by_name or name in seen_rows or name in NOT_PORTED:
            continue
        seen_rows.add(name)
        findings.append(Finding(
            rule=RULE, path="README.md", line=line,
            message=(
                f"README documents metric {name!r} but no registration "
                f"exists — the row reads empty on every deployment"
            ),
            key=f"stale:{name}",
        ))

    # ---- label-set consistency across feed sites ----------------------
    var_labels = {
        r.var: r for r in regs
        if r.var is not None and r.labels is not None
        and r.kind != "state_gauge"
    }
    for rel, pf in pkg.files.items():
        for call in astutil.walk_calls(pf.tree):
            f = call.func
            if not (isinstance(f, ast.Attribute) and f.attr == "labels"):
                continue
            recv = astutil.dotted(f.value)
            if recv is None:
                continue
            r = var_labels.get(recv.split(".")[-1])
            if r is None:
                continue
            if any(kw.arg is None for kw in call.keywords):
                continue  # **kwargs: dynamic, skip
            kw_names = {kw.arg for kw in call.keywords}
            expected = set(r.labels)
            n_given = len(call.args) + len(kw_names)
            ok = (
                n_given == len(r.labels)
                and (not kw_names or kw_names <= expected)
            )
            if not ok:
                findings.append(Finding(
                    rule=RULE, path=rel, line=call.lineno,
                    message=(
                        f"feed site for metric {r.name!r} passes labels "
                        f"({sorted(kw_names) if kw_names else n_given} "
                        f"given) inconsistent with its registration "
                        f"{tuple(r.labels)} at {r.path}:{r.line}"
                    ),
                    key=f"labels:{r.name}:{recv}",
                ))
    return findings
