"""shardlint core for the port: finding/baseline plumbing and the lint
driver (the port of ``llm_sharding_tpu/analysis/core.py``).

The analyzer is a static-analysis pass over the ``llm_sharding_tpu_torch``
package source, pure stdlib ``ast``: no torch import, so it runs first and
fast wherever the files land. Each rule module exposes ``RULE`` (name),
``DOC`` (one-liner) and ``check(pkg) -> list[Finding]``; this module owns
the shared parsed-package view, the baseline gate and the CLI-facing
``run_lint`` driver (``python -m llm_sharding_tpu_torch lint``).

The rules are the JAX package's lock-order, metrics and trace rules. Its
dispatch-statics and donation-safety rules check ``jax.jit`` shape keys
and donated buffers, which the port does not have: asking for them is a
usage error that says so (``JIT_ONLY_RULES``).

Baseline semantics: findings are fingerprinted WITHOUT line numbers (rule +
file + a stable symbol/message core), so unrelated edits above a known
finding don't churn the baseline. ``run_lint`` exits nonzero on any finding
whose fingerprint is not baselined; the committed baseline is empty, so
the gate is strict.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

#: Rule registry, filled by ``_rules()`` on first use (import-cycle-free).
_RULE_MODULES = (
    "rule_lockorder",
    "rule_metrics",
    "rule_trace",
)

#: The JAX package's jit rules, which the port does not carry.
JIT_ONLY_RULES = {
    "dispatch-statics": "the shape keys of jitted programs",
    "donation-safety": "buffers donated to jitted programs",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    #: stable core for fingerprinting: symbol/site identity without line
    #: numbers (defaults to the message when the rule sets nothing better)
    key: str = ""

    @property
    def fingerprint(self) -> str:
        core = self.key or self.message
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{core}".encode()
        ).hexdigest()
        return f"{self.rule}:{os.path.basename(self.path)}:{h[:12]}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class ParsedFile:
    """One source file: path (repo-relative), source text, AST, line list."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        self.lines = source.splitlines()


class Package:
    """The parsed package plus repo-level context the rules share."""

    def __init__(self, root: str, readme: Optional[str] = None):
        #: package directory (the one holding ``__init__.py``)
        self.root = os.path.abspath(root)
        #: repo root (parent of the package dir) — README lives here
        self.repo = os.path.dirname(self.root)
        self.files: Dict[str, ParsedFile] = {}
        self.errors: List[Finding] = []
        pkgname = os.path.basename(self.root)
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__"
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.join(
                    pkgname, os.path.relpath(full, self.root)
                ).replace(os.sep, "/")
                try:
                    with open(full, "r", encoding="utf-8") as f:
                        src = f.read()
                    self.files[rel] = ParsedFile(rel, src)
                except (OSError, SyntaxError) as e:
                    self.errors.append(Finding(
                        rule="parse", path=rel, line=getattr(e, "lineno", 0)
                        or 0, message=f"unparseable source: {e}",
                        key="unparseable",
                    ))
        if readme is None:
            readme = os.path.join(self.repo, "README.md")
        try:
            with open(readme, "r", encoding="utf-8") as f:
                self.readme = f.read()
        except OSError:
            self.readme = ""

    def module(self, relpath: str) -> Optional[ParsedFile]:
        return self.files.get(relpath)


def _rules() -> Dict[str, object]:
    import importlib

    out = {}
    for modname in _RULE_MODULES:
        mod = importlib.import_module(f".{modname}", __package__)
        out[mod.RULE] = mod
    return out


def rule_names() -> List[str]:
    return sorted(_rules())


class Baseline:
    """A committed set of known-finding fingerprints. The gate only fails
    on findings NOT in the set; ``lint --write-baseline`` regenerates it
    (the intended state is empty — fix, don't grandfather)."""

    def __init__(self, fingerprints: Sequence[str] = ()):
        self.fingerprints = set(fingerprints)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return cls(data.get("findings", []))

    @staticmethod
    def write(path: str, findings: Sequence[Finding]) -> None:
        data = {"findings": sorted({f.fingerprint for f in findings})}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def default_package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_rules(
    pkg: Package, only: Optional[Sequence[str]] = None
) -> List[Finding]:
    rules = _rules()
    if only:
        jit = sorted(set(only) & set(JIT_ONLY_RULES))
        if jit:
            raise ValueError(
                f"rule(s) {jit} are not ported: they are specific to jit ("
                + "; ".join(JIT_ONLY_RULES[r] for r in jit)
                + "), which the port does not use"
            )
        unknown = sorted(set(only) - set(rules))
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; available: {sorted(rules)}"
            )
        rules = {k: v for k, v in rules.items() if k in only}
    findings = list(pkg.errors)
    for name in sorted(rules):
        findings.extend(rules[name].check(pkg))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def run_lint(
    root: Optional[str] = None,
    only: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
    as_json: bool = False,
    write_baseline: bool = False,
    out=None,
) -> int:
    """Lint the package and print a report. Returns the process exit code:
    0 = clean (or fully baselined), 1 = new findings, 2 = bad usage."""
    import sys

    out = out or sys.stdout
    root = root or default_package_root()
    pkg = Package(root)
    try:
        findings = run_rules(pkg, only=only)
    except ValueError as e:
        print(f"shardlint: {e}", file=out)
        return 2

    bl_path = baseline_path or default_baseline_path()
    if write_baseline:
        fps = {f.fingerprint for f in findings}
        if only and os.path.exists(bl_path):
            # partial-rule run: keep other rules' accepted fingerprints —
            # rewriting the whole file from a --rule subset would silently
            # discard them (fingerprints lead with "<rule>:")
            kept = {
                fp for fp in Baseline.load(bl_path).fingerprints
                if fp.split(":", 1)[0] not in only
            }
            fps |= kept
        with open(bl_path, "w", encoding="utf-8") as f:
            json.dump({"findings": sorted(fps)}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print(
            f"shardlint: wrote {len(fps)} fingerprint(s) to {bl_path}",
            file=out,
        )
        return 0
    baseline = Baseline()
    if os.path.exists(bl_path):
        baseline = Baseline.load(bl_path)
    new = [f for f in findings if f.fingerprint not in baseline.fingerprints]
    known = len(findings) - len(new)

    if as_json:
        print(json.dumps({
            "findings": [dataclasses.asdict(f) | {
                "fingerprint": f.fingerprint,
                "baselined": f.fingerprint in baseline.fingerprints,
            } for f in findings],
            "new": len(new),
            "baselined": known,
        }, indent=2), file=out)
    else:
        for f in findings:
            suffix = (
                "  (baselined)"
                if f.fingerprint in baseline.fingerprints else ""
            )
            print(f.render() + suffix, file=out)
        print(
            f"shardlint: {len(new)} new finding(s), {known} baselined, "
            f"{len(pkg.files)} file(s) scanned",
            file=out,
        )
    return 1 if new else 0
