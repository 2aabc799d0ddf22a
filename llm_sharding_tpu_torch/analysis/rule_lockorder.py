"""lock-order: the static lock-acquisition graph of the port must respect
the canonical hierarchy in ``analysis.lockorder.ORDER`` (the port of
``llm_sharding_tpu/analysis/rule_lockorder.py``, over the same eleven
modules of the port).

The serving stack holds locks across eleven modules, and a ``_mutex``
holder calling into a foreign lock-holder that can call back is a
deadlock one interleaving away. This rule builds the lock-acquisition
graph statically:

- **lock definitions** come from :func:`analysis.lockorder.named_lock`
  construction sites (the name string IS the identity) or a
  ``# shardlint: lock <name>`` pragma where a lock object is passed in
  (the metric-family children share their family's lock). A raw
  ``threading.Lock()`` in a scoped module is itself a finding — every
  runtime lock must be registered in the hierarchy.
- **acquisitions** are ``with <lock>:`` blocks (and explicit
  ``.acquire()``), resolved through ``self`` attributes (including base
  classes), class attributes and module globals.
- **call effects** propagate transitively: while a ``with`` body holds
  lock L, every call that may acquire lock M — directly or through the
  methods it calls — contributes an edge L → M. Receiver types resolve
  through ``self.attr = ClassName(...)`` assignments, a curated
  attribute-type table (for constructor-injected collaborators like the
  ingress backend), and a method-name hint table for local variables
  (``s.submit(...)`` is a server no matter which replica ``s`` names).

Every edge must be non-decreasing in ``ORDER`` rank (equal rank = another
instance of the same lock class, serialized one level up by design).
Violations and cycles are findings; so is any acquisition of a lock the
hierarchy does not know.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, Package
from .lockorder import ORDER

RULE = "lock-order"
DOC = "static lock graph must match the canonical hierarchy (no cycles)"

_RANK = {name: i for i, name in enumerate(ORDER)}

#: The lock-holding modules the graph covers.
SCOPE = (
    "llm_sharding_tpu_torch/runtime/server.py",
    "llm_sharding_tpu_torch/runtime/replicated.py",
    "llm_sharding_tpu_torch/runtime/disagg.py",
    "llm_sharding_tpu_torch/runtime/ingress.py",
    "llm_sharding_tpu_torch/runtime/autoscale.py",
    "llm_sharding_tpu_torch/runtime/fairness.py",
    "llm_sharding_tpu_torch/runtime/faults.py",
    "llm_sharding_tpu_torch/runtime/engine.py",
    "llm_sharding_tpu_torch/obs/metrics.py",
    "llm_sharding_tpu_torch/obs/trace.py",
    "llm_sharding_tpu_torch/obs/stepline.py",
)

#: Constructor-injected collaborators whose class the AST cannot see.
#: "Class.attr" -> class names whose methods the attribute may dispatch to.
ATTR_TYPES: Dict[str, Tuple[str, ...]] = {
    "IngressServer.backend": ("PipelineServer", "ReplicatedServer"),
    "Autoscaler.target": ("ReplicatedServer", "DisaggServer"),
}

#: Method names that identify their receiver class well enough for the
#: graph when the receiver is a local/parameter (``s.submit(...)``,
#: ``src._fail_request(...)``). Names here must be unambiguous in the
#: scoped modules.
METHOD_HINTS: Dict[str, Tuple[str, ...]] = {
    "submit": ("PipelineServer",),
    "submit_embedding": ("PipelineServer",),
    "prefill_prefix": ("PipelineServer",),
    "extract": ("PipelineServer",),
    "adopt": ("PipelineServer",),
    "_fail_request": ("PipelineServer",),
    "spawn_replica": ("ReplicatedServer",),
    "rebalance": ("DisaggServer",),
}

#: Known leaf effects of the obs API — resolved by callee name so the
#: graph doesn't depend on tracing through the metrics/trace internals at
#: every call site.
FUNC_EFFECTS: Dict[str, Set[str]] = {
    "emit_span": {"obs.trace.ring", "obs.trace.writer"},
    "set_prefill_path": {"obs.metrics.family"},
    "set_replica_state": {"obs.metrics.family"},
    "set_replica_role": {"obs.metrics.family"},
    "set_state": {"obs.metrics.stategauge", "obs.metrics.family"},
}

#: Metric-family mutators: ``X.inc()``, ``X.labels(...).observe(...)``,
#: ``_FIELD_COUNTERS[f].inc()`` — the receiver is a metric family when it
#: is (a subscript of) an ALL_CAPS name or a ``.labels(...)`` result.
_METRIC_METHODS = {"inc", "dec", "set", "observe", "labels"}
_CAPS_RE = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
_LOCKISH_RE = re.compile(r"(lock|mutex|gate|cv|cond)", re.IGNORECASE)


def _is_metric_receiver(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        return astutil.call_name(node) == "labels"
    if isinstance(node, ast.Subscript):
        return _is_metric_receiver(node.value)
    d = astutil.dotted(node)
    if d is None:
        return False
    return bool(_CAPS_RE.match(d.split(".")[-1]))


class _ClassInfo:
    def __init__(self, name: str, rel: str, node: ast.ClassDef):
        self.name = name
        self.rel = rel
        self.node = node
        self.bases: List[str] = [
            b for b in (astutil.dotted(x) for x in node.bases)
            if b is not None
        ]
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: Dict[str, str] = {}   # attr -> lock name
        self.attr_classes: Dict[str, Set[str]] = {}


class _Graph:
    """The package-wide lock model: classes, lock attrs, module locks."""

    def __init__(self, pkg: Package, scope: Tuple[str, ...] = SCOPE):
        self.pkg = pkg
        self.scope = scope
        self.classes: Dict[str, _ClassInfo] = {}
        self.module_locks: Dict[str, Dict[str, str]] = {}  # rel -> {g: name}
        self.module_funcs: Dict[str, Dict[str, ast.AST]] = {}
        self.findings: List[Finding] = []
        self.subclasses: Dict[str, Set[str]] = {}
        self._effects_memo: Dict[Tuple[str, str], Set[str]] = {}
        self._visible_memo: Dict[str, Set[str]] = {}
        for rel in scope:
            pf = pkg.files.get(rel)
            if pf is None:
                continue
            self._index_module(rel, pf)
        for ci in self.classes.values():
            for b in ci.bases:
                base = b.split(".")[-1]
                if base in self.classes:
                    self.subclasses.setdefault(base, set()).add(ci.name)

    # ------------------------------------------------------------ indexing

    def _index_module(self, rel: str, pf) -> None:
        self.module_locks[rel] = {}
        self.module_funcs[rel] = {
            n.name: n for n in pf.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for node in pf.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = _ClassInfo(node.name, rel, node)
                self.classes[node.name] = ci
                self._index_class_locks(rel, pf, ci)
            elif isinstance(node, ast.Assign):
                self._maybe_lock_assign(
                    rel, pf, node, None, self.module_locks[rel]
                )
        # raw threading locks anywhere in the module are findings
        for call in astutil.walk_calls(pf.tree):
            d = astutil.dotted(call.func)
            if d in (
                "threading.Lock", "threading.RLock", "threading.Condition"
            ):
                self.findings.append(Finding(
                    rule=RULE, path=rel, line=call.lineno,
                    message=(
                        f"raw {d}() — runtime locks must be constructed "
                        f"via analysis.lockorder.named_lock(<name>) so "
                        f"they are registered in the canonical hierarchy "
                        f"and tracked under SHARDLINT_LOCK_ORDER=1"
                    ),
                    key=f"raw:{d}:{call.lineno // 1000}",
                ))

    def _maybe_lock_assign(
        self, rel, pf, node: ast.Assign, cls: Optional[_ClassInfo],
        module_map: Optional[Dict[str, str]],
    ) -> None:
        if len(node.targets) != 1:
            return
        target = astutil.dotted(node.targets[0])
        if target is None:
            return
        attr = target.split(".")[-1]
        name = None
        if (
            isinstance(node.value, ast.Call)
            and astutil.call_name(node.value) == "named_lock"
            and node.value.args
        ):
            name = astutil.literal_str(node.value.args[0])
        else:
            line = pf.lines[node.lineno - 1] if (
                node.lineno - 1 < len(pf.lines)
            ) else ""
            m = re.search(r"#\s*shardlint:\s*lock\s+(\S+)", line)
            if m:
                name = m.group(1)
        if name is None:
            return
        if name not in _RANK:
            self.findings.append(Finding(
                rule=RULE, path=rel, line=node.lineno,
                message=(
                    f"lock {name!r} is not in the canonical "
                    f"lockorder.ORDER — add it at its correct rank"
                ),
                key=f"unranked:{name}",
            ))
            return
        if cls is not None:
            cls.lock_attrs[attr] = name
        elif module_map is not None:
            module_map[attr] = name

    def _index_class_locks(self, rel, pf, ci: _ClassInfo) -> None:
        for node in ast.walk(ci.node):
            if isinstance(node, ast.Assign):
                t = astutil.dotted(node.targets[0]) if node.targets else None
                if t is not None and (
                    t.startswith("self.") or "." not in t
                ):
                    self._maybe_lock_assign(rel, pf, node, ci, None)
                    # attr -> constructed class (self.fair = FairQueue(...))
                    if (
                        t.startswith("self.")
                        and isinstance(node.value, ast.Call)
                    ):
                        cname = astutil.call_name(node.value)
                        if cname and (
                            cname in self.classes
                            or cname[0:1].isupper()
                        ):
                            ci.attr_classes.setdefault(
                                t.split(".", 1)[1], set()
                            ).add(cname)

    # ------------------------------------------------------- class lookup

    def _family(self, cls_name: str) -> List[_ClassInfo]:
        """The class plus its bases and (transitive) subclasses — the
        conservative virtual-dispatch set."""
        out: List[_ClassInfo] = []
        seen: Set[str] = set()

        def add(n: str):
            if n in seen or n not in self.classes:
                return
            seen.add(n)
            ci = self.classes[n]
            out.append(ci)
            for b in ci.bases:
                add(b.split(".")[-1])
            for s in self.subclasses.get(n, ()):
                add(s)

        add(cls_name)
        return out

    def lock_of_attr(self, cls_name: str, attr: str) -> Optional[str]:
        for ci in self._family(cls_name):
            if attr in ci.lock_attrs:
                return ci.lock_attrs[attr]
        return None

    def resolve_lock(
        self, expr: ast.AST, rel: str, cls: Optional[_ClassInfo]
    ) -> Optional[str]:
        """``with <expr>:`` → canonical lock name, if ``expr`` is a lock."""
        d = astutil.dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2 and cls:
            return self.lock_of_attr(cls.name, parts[1])
        if len(parts) == 1:
            return self.module_locks.get(rel, {}).get(parts[0])
        if len(parts) == 2 and parts[0] in self.classes:
            return self.lock_of_attr(parts[0], parts[1])
        if len(parts) == 2:
            # foreign receiver (``src._mutex`` on a local server var):
            # unique-attr resolution over the classes this module can see
            visible = self._visible_classes(rel)
            names = {
                ci.lock_attrs[parts[1]]
                for ci in self.classes.values()
                if parts[1] in ci.lock_attrs and (
                    ci.name in visible or ci.rel == rel
                )
            }
            if len(names) == 1:
                return names.pop()
        return None

    def pragma_lock(self, rel: str, lineno: int) -> Optional[str]:
        """``with lock:  # shardlint: lock <name>`` — explicit annotation
        for acquisitions whose receiver the AST cannot type (a lock object
        returned by a helper)."""
        pf = self.pkg.files.get(rel)
        if pf is None or lineno - 1 >= len(pf.lines):
            return None
        m = re.search(
            r"#\s*shardlint:\s*lock\s+(\S+)", pf.lines[lineno - 1]
        )
        if m and m.group(1) in _RANK:
            return m.group(1)
        return None

    def _visible_classes(self, rel: str) -> Set[str]:
        """Class names imported by (or defined in) module ``rel``."""
        cached = self._visible_memo.get(rel)
        if cached is not None:
            return cached
        out: Set[str] = set()
        pf = self.pkg.files.get(rel)
        if pf is not None:
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.ImportFrom):
                    out |= {a.asname or a.name for a in node.names}
                elif isinstance(node, ast.ClassDef):
                    out.add(node.name)
        self._visible_memo[rel] = out
        return out

    # ----------------------------------------------------------- effects

    def _methods_named(
        self, cls_name: str, meth: str
    ) -> List[Tuple[_ClassInfo, ast.AST]]:
        return [
            (ci, ci.methods[meth])
            for ci in self._family(cls_name)
            if meth in ci.methods
        ]

    def effects_of_method(self, cls_name: str, meth: str) -> Set[str]:
        key = (cls_name, meth)
        if key in self._effects_memo:
            return self._effects_memo[key]
        self._effects_memo[key] = set()  # cycle guard
        out: Set[str] = set()
        for ci, fn in self._methods_named(cls_name, meth):
            out |= self._effects_of_body(fn, ci.rel, ci)
        self._effects_memo[key] = out
        return out

    def _effects_of_call(
        self, call: ast.Call, rel: str, cls: Optional[_ClassInfo]
    ) -> Set[str]:
        name = astutil.call_name(call)
        if name is None:
            return set()
        if name in FUNC_EFFECTS:
            return set(FUNC_EFFECTS[name])
        f = call.func
        if isinstance(f, ast.Attribute):
            recv = f.value
            # metric-family mutators
            if name in _METRIC_METHODS and _is_metric_receiver(recv):
                return {"obs.metrics.family"}
            rd = astutil.dotted(recv)
            # calls on a lock object (notify/wait/acquire on a cv) are
            # the lock itself, not an outward call
            if rd is not None and cls is not None:
                pp = rd.split(".")
                if (
                    pp[0] in ("self", "cls") and len(pp) == 2
                    and self.lock_of_attr(cls.name, pp[1]) is not None
                ):
                    return set()
            # self.m() / super().m()
            if rd in ("self", "cls") and cls is not None:
                return self.effects_of_method(cls.name, name)
            if (
                isinstance(recv, ast.Call)
                and astutil.call_name(recv) == "super"
                and cls is not None
            ):
                out: Set[str] = set()
                for b in cls.bases:
                    out |= self.effects_of_method(b.split(".")[-1], name)
                return out
            # self.attr.m() via inferred or curated attr types
            if (
                rd is not None and rd.startswith("self.")
                and cls is not None
            ):
                attr = rd.split(".", 1)[1]
                targets: Set[str] = set()
                for ci in self._family(cls.name):
                    targets |= ci.attr_classes.get(attr, set())
                    targets |= set(
                        ATTR_TYPES.get(f"{ci.name}.{attr}", ())
                    )
                if targets:
                    out = set()
                    for t in targets:
                        out |= self.effects_of_method(t, name)
                    return out
            # local/parameter receiver: method-name hints
            if name in METHOD_HINTS:
                out = set()
                for t in METHOD_HINTS[name]:
                    out |= self.effects_of_method(t, name)
                return out
            return set()
        # bare name: module-level function, else a hinted method ref
        fn = self.module_funcs.get(rel, {}).get(name)
        if fn is not None:
            return self._effects_of_body(fn, rel, cls)
        if name in METHOD_HINTS:
            out = set()
            for t in METHOD_HINTS[name]:
                out |= self.effects_of_method(t, name)
            return out
        return set()

    def _effects_of_body(
        self, fn: ast.AST, rel: str, cls: Optional[_ClassInfo]
    ) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self.resolve_lock(
                        item.context_expr, rel, cls
                    ) or self.pragma_lock(rel, node.lineno)
                    if lk is not None:
                        out.add(lk)
            elif isinstance(node, ast.Call):
                out |= self._effects_of_call(node, rel, cls)
        return out


def check(
    pkg: Package, scope: Tuple[str, ...] = SCOPE
) -> List[Finding]:
    g = _Graph(pkg, scope)
    findings = list(g.findings)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    for rel in scope:
        pf = pkg.files.get(rel)
        if pf is None:
            continue
        parents = astutil.parent_map(pf.tree)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.With):
                continue
            cls = g.classes.get(
                getattr(astutil.enclosing_class(node, parents), "name", "")
            )
            for item in node.items:
                holder = g.resolve_lock(
                    item.context_expr, rel, cls
                ) or g.pragma_lock(rel, node.lineno)
                if holder is None:
                    d = astutil.dotted(item.context_expr)
                    if d is not None and _LOCKISH_RE.search(
                        d.split(".")[-1]
                    ):
                        findings.append(Finding(
                            rule=RULE, path=rel, line=node.lineno,
                            message=(
                                f"`with {d}:` acquires a lock the "
                                f"hierarchy cannot resolve — construct "
                                f"it via named_lock() or annotate the "
                                f"assignment with `# shardlint: lock "
                                f"<name>`"
                            ),
                            key=f"unresolved:{d}",
                        ))
                    continue
                # everything acquired inside the body while holding
                inner: Set[Tuple[str, int, str]] = set()
                for stmt in node.body:
                    for n in ast.walk(stmt):
                        if isinstance(n, ast.With):
                            for it in n.items:
                                lk = g.resolve_lock(
                                    it.context_expr, rel, cls
                                ) or g.pragma_lock(rel, n.lineno)
                                if lk is not None:
                                    inner.add((lk, n.lineno, "with"))
                        elif isinstance(n, ast.Call):
                            cname = astutil.call_name(n) or "?"
                            for lk in g._effects_of_call(n, rel, cls):
                                inner.add((lk, n.lineno, f"{cname}()"))
                for lk, line, via in inner:
                    edges.setdefault(
                        (holder, lk), (rel, line, via)
                    )

    for (holder, acquired), (rel, line, via) in sorted(edges.items()):
        if _RANK[holder] > _RANK[acquired]:
            findings.append(Finding(
                rule=RULE, path=rel, line=line,
                message=(
                    f"holding {holder!r} (rank {_RANK[holder]}) while "
                    f"acquiring {acquired!r} (rank {_RANK[acquired]}) "
                    f"via {via} — violates the canonical order in "
                    f"analysis.lockorder.ORDER (outer locks first)"
                ),
                key=f"edge:{holder}->{acquired}",
            ))

    # cycle report over distinct-name edges (same-name self-edges are the
    # sanctioned multi-instance case)
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
    state: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(n: str):
        state[n] = 1
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if state.get(m, 0) == 1:
                cyc = stack[stack.index(m):] + [m]
                findings.append(Finding(
                    rule=RULE,
                    path=scope[0], line=1,
                    message=(
                        "lock-acquisition cycle: " + " -> ".join(cyc)
                        + " — a deadlock is one unlucky interleaving away"
                    ),
                    key="cycle:" + "->".join(cyc),
                ))
            elif state.get(m, 0) == 0:
                dfs(m)
        stack.pop()
        state[n] = 2

    for n in sorted(adj):
        if state.get(n, 0) == 0:
            dfs(n)
    return findings
