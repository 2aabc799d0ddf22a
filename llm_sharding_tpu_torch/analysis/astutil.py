"""Shared AST plumbing for the port's shardlint rules: the helpers of
``llm_sharding_tpu/analysis/astutil.py`` that the lock-order, metrics and
trace rules use (the jit rules' helpers are not ported with them).

Pure-stdlib ``ast`` work: dotted-path extraction, parent/scope maps,
literal resolution.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """``self.engine.cache_dtype`` → the literal dotted path, or ``None``
    for anything that is not a pure Name/Attribute chain (a call result, a
    subscript, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_name(call: ast.Call) -> Optional[str]:
    """Terminal name of the called thing: ``serve_ops.serve_chunk(...)`` →
    ``serve_chunk``; ``foo(...)`` → ``foo``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing_class(
    node: ast.AST, parents: Dict[ast.AST, ast.AST]
) -> Optional[ast.ClassDef]:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = parents.get(cur)
    return None


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None
