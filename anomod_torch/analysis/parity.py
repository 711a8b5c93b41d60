"""Parity-surface auditor (P4xx): the variant lists stay exact.

Counterpart of ``anomod/analysis/parity.py``, over the port's engine
(``anomod_torch/serve/engine.py``) and flight recorder
(``anomod_torch/obs/flight.py``).  The roles map so: the JAX engine's
``SHARD_VARIANT_REPORT_FIELDS`` (the report fields that may differ
across shard counts, pipeline depths and fusion) is the port's wider
``VARIANT_REPORT_FIELDS``, which the P401 / P402 audit reads.  The
port's ``FLIGHT_REPORT_FIELDS`` names the report fields the flight
recorder adds (equal at every shard count, so canonical, as the JAX
package keeps them): it is no variant list and the audit does not read
it.  The flight-record audit (P403 / P404) reads ``PLANES`` and
``FLIGHT_VARIANT_KEYS`` from the recorder, as in the JAX package.

The shard-determinism and flight-journal contracts both carve the
world into a CANONICAL surface (pinned byte-identical across shard
counts, pipeline depths, residencies, recoveries) and a declared
VARIANT surface (``SHARD_VARIANT_REPORT_FIELDS``,
``FLIGHT_VARIANT_KEYS``).  The hole this audit closes: a NEW
``ServeReport`` field or flight-record key lands, someone adds it to
the variant list (or forgets a test), and the parity surface silently
narrows — nothing fails until a real divergence ships.

The audit is fully static (pure ``ast`` over the source — no
engine import), so it runs wherever the linter runs:

- every ``ServeReport`` field must be on the variant list or NAMED by
  some test under ``tests/`` (P401) — adding a field forces either a
  conscious variant declaration or a test that pins it (the canonical
  field inventory in tests/test_analysis.py is that forcing function);
- every variant entry must name a real field (P402 — a stale exclusion
  hides the day a real field takes the name);
- every key of the engine's flight tick record must be a declared
  plane, a declared variant key, or the tick spine (P403), and every
  declared plane/variant key must be present in the record (P404 —
  the every-record-carries-every-tier contract).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

from anomod_torch.analysis.lint import Finding, repo_root

#: per-tick keys that are neither plane nor variant: the tick/virtual-
#: time spine audit diff compares as "clock", plus the final-record mark
FLIGHT_SPINE = ("tick", "now_s", "final")

_ENGINE = "anomod_torch/serve/engine.py"
_FLIGHT = "anomod_torch/obs/flight.py"
#: the engine's tuple in the JAX ``SHARD_VARIANT_REPORT_FIELDS`` role
VARIANT_TUPLE = "VARIANT_REPORT_FIELDS"


def _parse(root: Path, rel: str) -> ast.Module:
    return ast.parse((root / rel).read_text(errors="replace"))


def _tuple_assign(tree: ast.Module, name: str) -> Optional[Tuple[str, ...]]:
    """The literal value of a module-level ``NAME = ("a", "b", ...)``
    (AnnAssign or Assign)."""
    for node in tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value = node.target.id, node.value
        if target == name:
            return tuple(ast.literal_eval(value))
    return None


def serve_report_fields(root: Optional[Path] = None) -> Tuple[str, ...]:
    """ServeReport's dataclass fields, read off the AST."""
    tree = _parse(root or repo_root(), _ENGINE)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "ServeReport":
            return tuple(st.target.id for st in node.body
                         if isinstance(st, ast.AnnAssign)
                         and isinstance(st.target, ast.Name))
    raise ValueError(f"ServeReport not found in {_ENGINE}")


def shard_variant_fields(root: Optional[Path] = None) -> Tuple[str, ...]:
    """The engine's variant report fields (:data:`VARIANT_TUPLE`)."""
    got = _tuple_assign(_parse(root or repo_root(), _ENGINE), VARIANT_TUPLE)
    if got is None:
        raise ValueError(f"{VARIANT_TUPLE} not found in {_ENGINE}")
    return got


def flight_contract(root: Optional[Path] = None
                    ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    tree = _parse(root or repo_root(), _FLIGHT)
    planes = _tuple_assign(tree, "PLANES")
    variant = _tuple_assign(tree, "FLIGHT_VARIANT_KEYS")
    if planes is None or variant is None:
        raise ValueError(f"PLANES/FLIGHT_VARIANT_KEYS not in {_FLIGHT}")
    return planes, variant


def flight_record_keys(root: Optional[Path] = None) -> Tuple[str, ...]:
    """The keys the engine actually writes into a flight tick record:
    the ``rec = {...}`` literal plus every ``rec["k"] = ...`` in the
    SAME function — read off the AST, so the audit sees the record
    shape the moment it changes, without running an engine.

    Scoped to the one function that hands ``rec`` to ``.record(...)``
    (the FlightRecorder publish site): an unrelated local dict that
    happens to be named ``rec`` elsewhere in engine.py must neither
    pollute the audited key set (spurious P403) nor satisfy P404 for a
    plane the real tick record no longer carries."""
    tree = _parse(root or repo_root(), _ENGINE)
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        publishes = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "record" and n.args
            and isinstance(n.args[0], ast.Name) and n.args[0].id == "rec"
            for n in ast.walk(fn))
        if not publishes:
            continue
        keys: List[str] = []
        found = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and t.id == "rec" \
                        and isinstance(node.value, ast.Dict):
                    found = True
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            keys.append(k.value)
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "rec" \
                        and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    keys.append(t.slice.value)
        if found:
            # dict-literal order, dedup preserving first occurrence
            seen: Set[str] = set()
            return tuple(k for k in keys
                         if not (k in seen or seen.add(k)))
    raise ValueError(
        f"flight tick-record builder (rec = {{...}} handed to "
        f".record(rec)) not found in {_ENGINE}")


def tests_corpus(root: Optional[Path] = None) -> str:
    root = root or repo_root()
    tdir = root / "tests"
    if not tdir.is_dir():
        return ""
    return "\n".join(p.read_text(errors="replace")
                     for p in sorted(tdir.glob("*.py")))


# ---------------------------------------------------------------------------
# the audits (injectable inputs so tests can feed synthetic surfaces)
# ---------------------------------------------------------------------------

def audit_serve_report(fields: Sequence[str], variant: Sequence[str],
                       test_corpus: str,
                       path: str = _ENGINE) -> List[Finding]:
    out: List[Finding] = []
    vset = set(variant)
    for f in fields:
        if f in vset:
            continue
        if re.search(rf"\b{re.escape(f)}\b", test_corpus):
            continue
        out.append(Finding(
            "P401", path, 0,
            f"ServeReport.{f} is neither in {VARIANT_TUPLE} nor named "
            "by any test — declare it variant "
            "(consciously widening the variant surface) or pin it in "
            "a parity/schema test"))
    fset = set(fields)
    for v in variant:
        if v not in fset:
            out.append(Finding(
                "P402", path, 0,
                f"{VARIANT_TUPLE} entry {v!r} names no "
                "ServeReport field — stale exclusion; remove it"))
    return out


def audit_flight_record(record_keys: Sequence[str],
                        planes: Sequence[str],
                        variant: Sequence[str],
                        path: str = _ENGINE) -> List[Finding]:
    out: List[Finding] = []
    allowed = set(planes) | set(variant) | set(FLIGHT_SPINE)
    for k in record_keys:
        if k not in allowed:
            out.append(Finding(
                "P403", path, 0,
                f"flight tick-record key {k!r} is neither a canonical "
                "plane (PLANES), a declared variant key "
                "(FLIGHT_VARIANT_KEYS) nor the tick spine — audit "
                "diff would never compare it"))
    kset = set(record_keys)
    for k in (*planes, *variant):
        if k not in kset:
            out.append(Finding(
                "P404", path, 0,
                f"declared flight key {k!r} is missing from the "
                "engine's tick record — every record carries every "
                "tier (the self-describing-shape contract)"))
    return out


def run_parity_audit(root: Optional[Path] = None) -> List[Finding]:
    """The port's full parity-surface audit (what ``lint`` and the
    ``anomod_torch.analysis.contracts`` gate run).  A tree missing the audited sources
    (a fixture root) degrades to ONE finding naming what is missing,
    never a traceback — the gate's verdict must always be a verdict."""
    root = Path(root) if root is not None else repo_root()
    try:
        planes, fvariant = flight_contract(root)
        return (audit_serve_report(serve_report_fields(root),
                                   shard_variant_fields(root),
                                   tests_corpus(root))
                + audit_flight_record(flight_record_keys(root), planes,
                                      fvariant))
    except (OSError, ValueError, SyntaxError) as e:
        return [Finding("P401", _ENGINE, 0,
                        f"parity-surface audit could not read its "
                        f"sources under {root}: {e}")]
