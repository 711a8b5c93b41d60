"""The port's contract gates: ``python -m anomod_torch.analysis.contracts``.

Counterpart of ``scripts/check_contracts.py`` (no flag) and
``scripts/check_env_contract.py`` (``--env``), over the port's tree; it
lives in the package so that the JAX gates' scan of ``scripts/`` stays
as it was.  Both print one JSON line and keep the scripts' exit
contract: 0 when clean, 1 with the violations in that line (and on
stderr).

- No flag: the contract linter and the parity-surface audit
  (:func:`anomod_torch.analysis.lint.run_gate`, the one composition
  ``lint`` and ``validate`` share), against the port's baseline.
- ``--env``: every ``ANOMOD_*`` token in ``anomod_torch/**/*.py`` and
  ``chip_smoke.py`` must be covered by ``anomod_torch/config.py``,
  ``README.md`` or ``docs/*.md``; a dynamic ``ANOMOD_*`` read (an
  f-string or concatenated key), which no token grep sees, is a
  violation of its own (``dynamic``).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Optional

from anomod_torch.analysis.lint import (ModuleContext, env_corpus,
                                        repo_root, run_gate, scan_files)

_VAR = re.compile(r"ANOMOD_[A-Z0-9_]+")


def referenced_vars(root: Path) -> dict:
    """Every ``ANOMOD_*`` token in the scan set -> the files naming it.
    Tokens ending in ``_`` are glob-style prefixes in prose, not reads."""
    out: dict = {}
    for p in scan_files(root):
        for m in _VAR.finditer(p.read_text(errors="replace")):
            name = m.group(0)
            if not name.endswith("_"):
                out.setdefault(name, set()).add(
                    p.relative_to(root).as_posix())
    return out


def dynamic_reads(root: Path) -> dict:
    """Dynamic ``ANOMOD_*`` env reads over the scan set: file ->
    ``[[line, static_prefix]]``; the Config module is exempt."""
    from anomod_torch.analysis.envscan import dynamic_anomod_reads
    from anomod_torch.analysis.rules import CONFIG_MODULE
    out: dict = {}
    for p in scan_files(root):
        rel = p.relative_to(root).as_posix()
        if rel == CONFIG_MODULE:
            continue
        try:
            ctx = ModuleContext(p.read_text(errors="replace"), rel)
        except SyntaxError:
            continue
        got = dynamic_anomod_reads(ctx.tree, ctx)
        if got:
            out[rel] = [[r.line, r.prefix] for r in got]
    return out


def env_gate(root: Path) -> dict:
    """The env-contract document (``status`` ``ok`` or
    ``uncovered-env-vars``)."""
    refs = referenced_vars(root)
    corpus = env_corpus(root)
    missing = {name: sorted(files) for name, files in sorted(refs.items())
               if name not in corpus}
    dynamic = dynamic_reads(root)
    out = {"check": "env_contract", "n_vars": len(refs),
           "n_missing": len(missing), "n_dynamic": len(dynamic),
           "status": ("ok" if not (missing or dynamic)
                      else "uncovered-env-vars")}
    if missing:
        out["missing"] = missing
    if dynamic:
        out["dynamic"] = dynamic
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m anomod_torch.analysis.contracts",
        description="the port's contract gate (lint + parity audit), or "
                    "with --env its env contract")
    ap.add_argument("--env", action="store_true",
                    help="check the ANOMOD_* env contract instead")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: this checkout)")
    args = ap.parse_args(argv)
    root = Path(args.root) if args.root is not None else repo_root()
    if args.env:
        doc = env_gate(root)
        print(json.dumps(doc))
        for name, files in doc.get("missing", {}).items():
            print(f"contracts --env: {name} (read in {', '.join(files)}) "
                  "is neither in anomod_torch/config.py nor documented "
                  "(README.md / docs/*.md)", file=sys.stderr)
        for fname, sites in doc.get("dynamic", {}).items():
            for line, prefix in sites:
                print(f"contracts --env: {fname}:{line} reads a DYNAMIC "
                      f"ANOMOD_* env var (key built from {prefix!r}...)",
                      file=sys.stderr)
        return 0 if doc["status"] == "ok" else 1
    doc, _ = run_gate(root)
    print(json.dumps(doc))
    for line in doc["new"]:
        print(f"contracts: {line}", file=sys.stderr)
    return 0 if doc["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
