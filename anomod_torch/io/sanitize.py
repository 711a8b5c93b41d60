"""Sanitizer smoke of the port's host library (counterpart of
``scripts/native_sanitize_smoke.py``).

    python -m anomod_torch.io.sanitize [--sanitizer tsan|asan|both]

Builds the whole of ``csrc/native.cpp`` with ``-fsanitize=thread`` (or
``address``) together with ``csrc/sanitize_hammer.cpp`` and runs the
program: N worker threads stage into their own scratch slots
(``atn_stage_lanes``), drive ``atn_sfq_drain`` / ``atn_sfq_victim``
against an O(n^2) oracle, and call ``atn_scan_log_mt`` and
``atn_rt_summarize_logs`` on one shared pool, each call held byte for
byte to its single-threaded result.  A sanitized library cannot be
loaded into an uninstrumented Python, hence a program of its own.

The program builds into ``build/anomod_torch_native/`` beside the
package as the library does (keyed by a hash of the sources, the
compiler and the flags, published by an atomic rename); its log files
go to a temporary directory.  One JSON verdict a leg on stdout:

- ``ok``: built with the sanitizer and ran clean; exit 0;
- ``skip``: the compiler cannot build a sanitized program (none on
  ``PATH``, or the ``-fsanitize`` probe failed), with the reason; exit 0;
- ``fail``: the sanitizer reported an error, a result differed from its
  oracle, or the build or run failed or timed out; the report on
  stderr; exit 1.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

from anomod_torch.io.native import SOURCE, compile_once

HAMMER = SOURCE.with_name("sanitize_hammer.cpp")
_FLAGS = {"tsan": "thread", "asan": "address"}
_RUN_ENV = {"tsan": {"TSAN_OPTIONS": "halt_on_error=1 exitcode=66"},
            "asan": {"ASAN_OPTIONS": "halt_on_error=1"}}
SAN_FLAGS = ("-O1", "-g", "-std=c++17", "-pthread", "-Wall", "-Wextra")


def _cxx(cxx: Optional[str]) -> list:
    """The compiler command: ``cxx``, else ``$CXX``, else ``g++``."""
    return (cxx or (os.environ.get("CXX") or "").strip() or "g++").split()


def probe(sanitizer: str, cxx: Optional[str] = None) -> dict:
    """``{"ok", "reason"}``: whether the compiler (the command the build
    will use) builds and links a threaded program with
    ``-fsanitize=<sanitizer>``; the reason is what a skip carries."""
    parts = _cxx(cxx)
    if shutil.which(parts[0]) is None:
        return {"ok": False,
                "reason": f"no C++ compiler ({parts[0]}) on PATH"}
    flag = _FLAGS.get(sanitizer, sanitizer)
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "probe.cpp"
        src.write_text("#include <thread>\n"
                       "int main(){std::thread t([]{}); t.join();}\n")
        try:
            r = subprocess.run(
                [*parts, f"-fsanitize={flag}", "-pthread", str(src),
                 "-o", str(Path(td) / "probe")],
                capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            return {"ok": False,
                    "reason": f"-fsanitize={flag} probe timed out"}
    if r.returncode != 0:
        tail = (r.stderr or r.stdout).strip().splitlines()[-1:]
        return {"ok": False,
                "reason": f"-fsanitize={flag} probe failed: "
                          f"{' '.join(tail) or 'compiler error'}"}
    return {"ok": True, "reason": ""}


def build(sanitizer: str, cxx: Optional[str] = None,
          build_dir: Optional[Path] = None) -> Path:
    """The sanitized hammer program, built unless built already
    (:func:`anomod_torch.io.native.compile_once`).  Raises
    ``RuntimeError`` with the compiler's output, ``TimeoutExpired`` past
    300 s."""
    cmd = (*_cxx(cxx), *SAN_FLAGS, f"-fsanitize={_FLAGS[sanitizer]}")
    return compile_once(f"hammer_{sanitizer}", (SOURCE, HAMMER), cmd,
                        build_dir, timeout=300)


def run(sanitizer: str = "tsan", workers: int = 4, iters: int = 40,
        cxx: Optional[str] = None) -> dict:
    """Build and run the sanitized hammer; the verdict document (a skip
    or a failure is a verdict, not an exception)."""
    if sanitizer not in _FLAGS:
        raise ValueError(f"unknown sanitizer {sanitizer!r}")
    out = {"check": "native_sanitize_smoke", "sanitizer": sanitizer}
    p = probe(sanitizer, cxx)
    if not p["ok"]:
        out.update(status="skip", reason=p["reason"])
        return out
    try:
        exe = build(sanitizer, cxx)
    except subprocess.TimeoutExpired:
        out.update(status="fail", reason="sanitized build timed out")
        return out
    except RuntimeError as e:
        # the probe built a sanitized program, so this is the sources'
        # fault, not a missing toolchain
        out.update(status="fail",
                   reason="sanitized build failed (the probe passed, so "
                          "the sources are at fault, not the toolchain)",
                   detail=str(e)[-2000:])
        return out
    env = dict(os.environ, **_RUN_ENV[sanitizer])
    with tempfile.TemporaryDirectory() as td:
        try:
            r = subprocess.run([str(exe), str(workers), str(iters), td],
                               capture_output=True, text=True, timeout=300,
                               env=env)
        except subprocess.TimeoutExpired:
            out.update(status="fail",
                       reason="sanitized hammer timed out (possible "
                              "deadlock in the pool or the staging path)")
            return out
    out["exit_code"] = r.returncode
    if r.returncode == 0:
        out.update(status="ok", workers=workers, iters=iters)
    elif r.returncode == 2:
        out.update(status="fail", reason="byte-parity oracle failed "
                   "under the sanitized build")
    else:
        out.update(status="fail",
                   reason=f"{sanitizer} reported an error "
                          f"(exit {r.returncode})",
                   detail=r.stderr.strip()[-2000:])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m anomod_torch.io.sanitize",
        description="Build the port's host library with a sanitizer and "
                    "hammer it from several threads.")
    ap.add_argument("--sanitizer", choices=["tsan", "asan", "both"],
                    default="tsan")
    ap.add_argument("--workers", type=int, default=4,
                    help="worker threads of each kind")
    ap.add_argument("--iters", type=int, default=40,
                    help="calls a worker (the wide-slot and scan passes "
                         "run iters/8 + 1, the summaries iters/4 + 1)")
    args = ap.parse_args(argv)
    legs = ["tsan", "asan"] if args.sanitizer == "both" \
        else [args.sanitizer]
    rc = 0
    for leg in legs:
        out = run(leg, workers=args.workers, iters=args.iters)
        print(json.dumps(out))
        if out["status"] == "fail":
            print(f"sanitize: {leg} FAILED — {out.get('reason')}",
                  file=sys.stderr)
            if out.get("detail"):
                print(out["detail"], file=sys.stderr)
            rc = 1
        elif out["status"] == "skip":
            print(f"sanitize: {leg} SKIP — {out.get('reason')}",
                  file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
