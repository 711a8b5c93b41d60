"""AST-level env-read extraction — the shared scanner behind the E2xx
lint rules and ``python -m anomod_torch.analysis.contracts --env``.

Counterpart of ``anomod/analysis/envscan.py``, copied as is.

The PR-3 gate greps for ``ANOMOD_[A-Z0-9_]+`` tokens, which covers
every constant-key read but has a documented false negative: a
dynamically-built key (``os.environ[f"ANOMOD_{name}"]``,
``os.getenv("ANOMOD_" + name)``) contains no complete token to match.
This module walks the AST instead: it finds every read expression over
``os.environ`` / ``os.getenv`` — including aliased forms
(``from os import environ``, ``env = os.environ``) — and classifies
each key as a resolved constant name or a dynamic read with its
longest static prefix.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional, Set


@dataclasses.dataclass(frozen=True)
class EnvRead:
    line: int
    #: fully-resolved variable name (constant or constant-foldable key)
    name: Optional[str]
    #: for dynamic keys: the leading static prefix ("" when none)
    prefix: Optional[str]


def _resolve_key(node: ast.AST) -> EnvRead:
    line = getattr(node, "lineno", 0)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return EnvRead(line, node.value, None)
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        dynamic = False
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                dynamic = True
                break
        joined = "".join(parts)
        if not dynamic:
            return EnvRead(line, joined, None)
        return EnvRead(line, None, joined)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _resolve_key(node.left)
        if left.name is not None:
            right = _resolve_key(node.right)
            if right.name is not None:
                return EnvRead(line, left.name + right.name, None)
            return EnvRead(line, None, left.name)
        return EnvRead(line, None, left.prefix or "")
    return EnvRead(line, None, "")


def _environ_aliases(nodes) -> tuple:
    """Names bound to ``os.environ`` / ``os.getenv`` in this module."""
    environ: Set[str] = set()
    getenv: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "environ":
                    environ.add(a.asname or a.name)
                elif a.name == "getenv":
                    getenv.add(a.asname or a.name)
        elif isinstance(node, ast.Assign):
            src = _dotted(node.value)
            if src == "os.environ":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        environ.add(t.id)
            elif src == "os.getenv":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        getenv.add(t.id)
    return environ, getenv


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def env_reads(tree: ast.AST, ctx=None) -> List[EnvRead]:
    """Every env-var READ in ``tree`` (writes are not reads; they never
    consume a knob).  ``ctx`` (a ModuleContext) refines module-alias
    resolution (``import os as _os``) and supplies its cached node list
    (one traversal per file); without it plain ``os.`` spelling is
    assumed."""
    nodes = ctx.nodes if ctx is not None else list(ast.walk(tree))
    environ_names, getenv_names = _environ_aliases(nodes)

    def resolve(node: ast.AST) -> Optional[str]:
        if ctx is not None:
            return ctx.resolve(node)
        return _dotted(node)

    def is_environ(node: ast.AST) -> bool:
        name = resolve(node)
        if name == "os.environ":
            return True
        return isinstance(node, ast.Name) and node.id in environ_names

    out: List[EnvRead] = []
    for node in nodes:
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and is_environ(node.value):
            out.append(_resolve_key(node.slice))
        elif isinstance(node, ast.Call):
            fname = resolve(node.func)
            is_read = fname == "os.getenv" or (
                isinstance(node.func, ast.Name)
                and node.func.id in getenv_names)
            if not is_read and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("get", "setdefault") \
                    and is_environ(node.func.value):
                is_read = True
            if is_read and node.args:
                out.append(_resolve_key(node.args[0]))
    return out


def dynamic_anomod_reads(tree: ast.AST, ctx=None) -> List[EnvRead]:
    """Dynamic reads whose static prefix proves an ANOMOD_* key.
    Pass a ModuleContext to also resolve module-aliased spellings
    (``import os as _os``) — the delegating env gate does."""
    return [r for r in env_reads(tree, ctx)
            if r.name is None and r.prefix and "ANOMOD_" in r.prefix]
