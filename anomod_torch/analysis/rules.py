"""AST rule families: determinism, env-contract, seam, lock discipline.

Counterpart of ``anomod/analysis/rules.py``: the same rules, ids and
checks, scoped to the port's files (``anomod_torch/...`` in place of
``anomod/...``), held to it by ``tests/test_torch_contracts.py``.

Each check is a function ``(ModuleContext) -> [Finding]`` registered in
``ALL_CHECKS``; scoping is path-based so tests can lint fixture files
under a pretend canonical/seam path.  The rule ids, synopses and
motivations live in ``anomod_torch.analysis.lint.RULES`` (one catalog).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from anomod_torch.analysis.envscan import env_reads
from anomod_torch.analysis.lint import Finding, ModuleContext

# ---------------------------------------------------------------------------
# scoping — the module sets each contract governs
# ---------------------------------------------------------------------------

#: canonical-plane modules: every decision here must be a function of
#: seed+config alone (the audit-replay contract, PR 9)
def is_canonical(path: str) -> bool:
    return path.startswith("anomod_torch/serve/") or path in (
        "anomod_torch/replay.py", "anomod_torch/obs/flight.py")


#: seam modules: the ONLY homes of pool-plane internals
SEAM_MODULES = ("anomod_torch/replay.py", "anomod_torch/serve/batcher.py")

#: the env contract's one legitimate home (exempt from E2xx)
CONFIG_MODULE = "anomod_torch/config.py"

#: lock-owning modules: classes here guard shared state with self._lock
LOCKED_MODULES = ("anomod_torch/obs/registry.py",
                  "anomod_torch/utils/tracing.py")


# ---------------------------------------------------------------------------
# D1xx — determinism
# ---------------------------------------------------------------------------

#: wall-clock / wall-stall calls with no place in a canonical plane
_WALL_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.sleep", "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

#: the wall-leg naming convention: perf_counter results live in t-vars
#: (t0/t1/t_wall/...) and flow into variant wall fields via `... - t0`
_T_VAR = re.compile(r"^_?t\d*$|^_?t_[a-z0-9_]+$")

#: seeded-RNG surface of numpy.random; anything else is the legacy
#: global-state API
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "BitGenerator"}


def _is_t_var(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return bool(_T_VAR.match(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_T_VAR.match(node.attr))
    return False


def check_determinism(ctx: ModuleContext) -> List[Finding]:
    if not is_canonical(ctx.path):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if name is None:
            continue
        if name in _WALL_CALLS:
            out.append(Finding(
                "D101", ctx.path, node.lineno,
                f"{name}() in a canonical-plane module — decisions "
                "must be functions of seed+config (use the virtual "
                "clock / tick index)"))
        elif name == "time.perf_counter":
            parent = ctx.parents.get(node)
            ok = (isinstance(parent, ast.Assign)
                  and all(_is_t_var(t) for t in parent.targets)) or \
                 (isinstance(parent, ast.BinOp)
                  and isinstance(parent.op, ast.Sub)
                  and parent.left is node and _is_t_var(parent.right))
            if not ok:
                out.append(Finding(
                    "D102", ctx.path, node.lineno,
                    "time.perf_counter() outside wall-leg form — "
                    "assign to a t-var (t0/t_wall) or subtract one "
                    "(`... - t0`); anything else can leak the wall "
                    "clock into a canonical decision"))
        elif name == "numpy.random.default_rng":
            if not node.args and not node.keywords:
                out.append(Finding(
                    "D103", ctx.path, node.lineno,
                    "np.random.default_rng() without a seed — "
                    "canonical-plane RNG must be keyed (seed, tenant, "
                    "window) like the RCA sampler"))
        elif name.startswith("numpy.random."):
            attr = name.rsplit(".", 1)[1]
            if attr not in _NP_RANDOM_OK:
                out.append(Finding(
                    "D103", ctx.path, node.lineno,
                    f"legacy global-state RNG np.random.{attr}() — "
                    "process-global stream, not replayable; use a "
                    "seeded default_rng"))
        elif name.startswith("random."):
            out.append(Finding(
                "D103", ctx.path, node.lineno,
                f"stdlib {name}() draws from the process-global RNG — "
                "not replayable from the flight header"))
        elif name == "id":
            out.append(Finding(
                "D104", ctx.path, node.lineno,
                "id() in a canonical module — memory addresses differ "
                "across processes/replays; key by a stable identity "
                "(tenant id, slot index)"))
    out.extend(_check_set_iteration(ctx))
    return out


def _is_set_expr(ctx: ModuleContext, node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return ctx.resolve(node.func) in ("set", "frozenset")
    return False


def _check_set_iteration(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []

    def trip(node: ast.AST, how: str) -> None:
        out.append(Finding(
            "D105", ctx.path, node.lineno,
            f"set iteration feeding ordered output ({how}) — set "
            "order varies across processes; wrap in sorted()"))

    for node in ctx.nodes:
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and _is_set_expr(ctx, node.iter):
            trip(node.iter, "for-loop over a set")
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp, ast.SetComp)):
            for gen in node.generators:
                # a set-comp DRAINING a set is fine (membership only);
                # list/dict/generator comprehensions keep order
                if not isinstance(node, ast.SetComp) \
                        and _is_set_expr(ctx, gen.iter):
                    trip(gen.iter, "comprehension over a set")
        elif isinstance(node, ast.Call):
            name = ctx.resolve(node.func)
            if name in ("list", "tuple", "enumerate", "iter") \
                    and node.args and _is_set_expr(ctx, node.args[0]):
                trip(node, f"{name}(set(...))")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" and node.args \
                    and _is_set_expr(ctx, node.args[0]):
                trip(node, "str.join over a set")
    return out


# ---------------------------------------------------------------------------
# E2xx — env contract (AST upgrade of scripts/check_env_contract.py)
# ---------------------------------------------------------------------------

def check_env_contract(ctx: ModuleContext) -> List[Finding]:
    if ctx.path == CONFIG_MODULE:
        return []           # the contract's one legitimate home
    out: List[Finding] = []
    for read in env_reads(ctx.tree, ctx):
        if read.name is not None:
            if read.name.startswith("ANOMOD_") \
                    and read.name not in ctx.corpus:
                out.append(Finding(
                    "E201", ctx.path, read.line,
                    f"env read of {read.name} is neither in the Config "
                    "env contract (anomod_torch/config.py) nor documented "
                    "(README.md / docs/*.md)"))
        elif read.prefix and "ANOMOD_" in read.prefix:
            out.append(Finding(
                "E202", ctx.path, read.line,
                f"dynamic ANOMOD_* env read (key built from "
                f"{read.prefix!r}...) — statically unresolvable; "
                "route it through anomod_torch.config or name the full "
                "variable"))
    return out


# ---------------------------------------------------------------------------
# S3xx — seam discipline
# ---------------------------------------------------------------------------

#: the pool-plane private surface: a tenant slot handle, the slot
#: table, and the runner backref PooledStreamReplay reaches its pool by
_SEAM_PRIVATE = {"_slot", "_slots", "_runner"}

#: gather-side functions bound by the always-copy contract
_GATHER_FUNCS = {"gather", "gather_window", "gather_rows", "get_state"}

#: plane attributes whose rows must never leave a gather aliased
_PLANE_ATTRS = {"agg", "hist"}

#: wrappers that materialize a copy (breaking the alias)
_COPYING_CALLS = {"numpy.asarray", "numpy.array",
                  "numpy.ascontiguousarray"}


def check_seam(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    if ctx.path not in SEAM_MODULES:
        # S301: pool internals are the seam modules' business only
        for node in ctx.nodes:
            if isinstance(node, ast.Attribute) \
                    and node.attr in _SEAM_PRIVATE:
                out.append(Finding(
                    "S301", ctx.path, node.lineno,
                    f".{node.attr} touched outside the seam modules "
                    f"({', '.join(SEAM_MODULES)}) — go through "
                    "get_state/set_state/gather (the PR-8 broadcast-"
                    "corruption lesson)"))
        return out
    # S302: inside seam modules, gather-side returns must copy
    for fn in ctx.nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn.name not in _GATHER_FUNCS:
            continue
        for ret in ast.walk(fn):
            if not isinstance(ret, ast.Return) or ret.value is None:
                continue
            for sub in ast.walk(ret.value):
                if not (isinstance(sub, ast.Subscript)
                        and isinstance(sub.value, ast.Attribute)
                        and sub.value.attr in _PLANE_ATTRS):
                    continue
                if not _has_copying_ancestor(ctx, sub, stop=ret):
                    out.append(Finding(
                        "S302", ctx.path, sub.lineno,
                        f"{fn.name}() returns a subscript of "
                        f".{sub.value.attr} without .copy()/"
                        "np.asarray — the gather seam is ALWAYS-COPY "
                        "(an aliased row mutates under the next "
                        "scatter fold)"))
    return out


def _has_copying_ancestor(ctx: ModuleContext, node: ast.AST,
                          stop: ast.AST) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.Call):
            if isinstance(cur.func, ast.Attribute) \
                    and cur.func.attr == "copy":
                return True
            if ctx.resolve(cur.func) in _COPYING_CALLS:
                return True
        cur = ctx.parents.get(cur)
    return False


# ---------------------------------------------------------------------------
# L5xx — lock discipline
# ---------------------------------------------------------------------------

#: method names that mutate their receiver in place
_MUTATORS = {"append", "appendleft", "add", "clear", "extend", "insert",
             "pop", "popleft", "remove", "update", "setdefault",
             "discard"}

#: self.<attr> bases that are thread-private by construction
_THREAD_LOCAL_ATTRS = {"_tls", "_local", "_thread_local"}


def check_lock_discipline(ctx: ModuleContext) -> List[Finding]:
    if ctx.path not in LOCKED_MODULES:
        return []
    out: List[Finding] = []
    for cls in ctx.nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        if not _owns_lock(cls):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__" or fn.name.endswith("_locked"):
                # __init__ predates sharing; *_locked documents
                # caller-holds-lock (Histogram._fold_locked idiom)
                continue
            out.extend(_scan_method(ctx, cls.name, fn))
    return out


def _owns_lock(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "_lock" \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    return True
    return False


def _is_lock_with(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Attribute) and e.attr == "_lock" \
        and isinstance(e.value, ast.Name) and e.value.id == "self"


def _self_attr_of_mutation(node: ast.AST) -> Optional[str]:
    """The mutated ``self.<attr>`` name, if this node mutates one."""
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets = [node.target]
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        targets = [node.func.value]
    flat: List[ast.AST] = []
    for t in targets:
        # self._a, self._b = ... (and starred unpacks) mutate too
        if isinstance(t, (ast.Tuple, ast.List)):
            flat.extend(t.elts)
        else:
            flat.append(t)
    for t in flat:
        if isinstance(t, ast.Starred):
            t = t.value
        while isinstance(t, ast.Subscript):    # self._metrics[k] = v
            t = t.value
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self" \
                and t.attr not in _THREAD_LOCAL_ATTRS:
            return t.attr
    return None


def _scan_method(ctx: ModuleContext, cls_name: str,
                 fn: ast.FunctionDef) -> List[Finding]:
    out: List[Finding] = []

    def walk(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.With):
            inner = locked or any(_is_lock_with(i) for i in node.items)
            for child in node.body:
                walk(child, inner)
            return
        attr = _self_attr_of_mutation(node)
        if attr is not None and not locked and attr != "_lock":
            out.append(Finding(
                "L501", ctx.path, node.lineno,
                f"{cls_name}.{fn.name} mutates self.{attr} outside "
                "`with self._lock` — the PR-5 torn-scrape shape; "
                "take the lock or rename the method *_locked"))
        for child in ast.iter_child_nodes(node):
            # nested defs get their own (unlocked) analysis scope
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                walk(child, False)
            else:
                walk(child, locked)

    for stmt in fn.body:
        walk(stmt, False)
    return out


# ---------------------------------------------------------------------------
# C6xx — the deferred-commit barrier (ANOMOD_SERVE_ASYNC_COMMIT)
# ---------------------------------------------------------------------------

#: state the deferred commit's barrier tail mutates or publishes:
#: reading any of these while issued work is still in flight observes
#: PRE-commit state — the exact leak the async-parity contract forbids
_DEFER_STATE_ATTRS = {"_tenant_det", "_tenant_replay", "_rca_queue",
                      "rca_verdicts"}

#: engine methods that read or publish committed scoring state (the
#: barrier tail itself runs them AFTER the drain)
_DEFER_READ_CALLS = {"alerts_for", "report", "_perf_drain",
                     "_census_drain", "_flight_tick", "_policy_step",
                     "_rca_step"}

#: the one sanctioned barrier
_BARRIER_CALL = "_commit_deferred"


def _iter_inline(node: ast.AST):
    """Walk a statement's subtree SKIPPING nested function/lambda
    bodies — a closure defined inside the window executes later (the
    shard-worker submit idiom), so its reads are not window reads.  A
    statement that IS a def is wholly inert."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        return
    stack = list(ast.iter_child_nodes(node))
    yield node
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _opens_defer_window(node: ast.AST) -> bool:
    """A dispatch issued with ``defer=True``, or ``self._deferred``
    armed with a live payload."""
    for sub in _iter_inline(node):
        if isinstance(sub, ast.Call):
            for kw in sub.keywords:
                if kw.arg == "defer" \
                        and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
        elif isinstance(sub, ast.Assign):
            if isinstance(sub.value, ast.Constant) \
                    and sub.value.value is None:
                continue
            for t in sub.targets:
                if isinstance(t, ast.Attribute) \
                        and t.attr == "_deferred" \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    return True
    return False


def _closes_defer_window(node: ast.AST) -> bool:
    for sub in _iter_inline(node):
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == _BARRIER_CALL:
            return True
    return False


def _defer_window_reads(node: ast.AST) -> List[tuple]:
    reads = []
    for sub in _iter_inline(node):
        if isinstance(sub, ast.Attribute) \
                and sub.attr in _DEFER_STATE_ATTRS \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "self" \
                and isinstance(sub.ctx, ast.Load):
            reads.append((sub.lineno, f"self.{sub.attr}"))
        elif isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _DEFER_READ_CALLS:
            reads.append((sub.lineno, f"{sub.func.attr}()"))
    return reads


def check_commit_barrier(ctx: ModuleContext) -> List[Finding]:
    """C601: inside a function that issues deferred-commit work, no
    statement between the issue and the next ``_commit_deferred()``
    barrier may read scoring-committed state.  Function-local by
    design (the window legitimately stays open across the tick
    boundary; cross-function reads are the parity tests' job) — what
    this catches is the easy regression: someone adding a report/
    flight/RCA read into the issue half of the async tail."""
    if not ctx.path.startswith("anomod_torch/serve/"):
        return []
    out: List[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == _BARRIER_CALL:
            continue               # the barrier's own tail reads freely
        window_open = False
        for stmt in node.body:
            if window_open:
                # barrier-first within one compound statement is the
                # legit commit-then-read pattern, so closes win ties
                if _closes_defer_window(stmt):
                    window_open = False
                else:
                    for line, what in _defer_window_reads(stmt):
                        out.append(Finding(
                            "C601", ctx.path, line,
                            f"{node.name} reads {what} between the "
                            "deferred dispatch and the commit barrier "
                            "— the result observes PRE-commit state; "
                            "move the read after _commit_deferred()"))
            if _opens_defer_window(stmt):
                window_open = True
    return out


ALL_CHECKS = (check_determinism, check_env_contract, check_seam,
              check_lock_discipline, check_commit_barrier)
