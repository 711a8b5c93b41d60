"""Machine-readable capture provenance (counterpart of
``anomod/provenance.py``).

Every measurement the port writes down (the replay kernel's roofline
probe, a ``stream --all`` quality sweep) is kept as one JSON record under
``bench_runs/``: the measured value, the device string (so a card's
record is told apart from a CPU run by its file name), the torch and CUDA
versions, a UTC timestamp and the git SHA of the tree that produced it.

Writes are best-effort: a measurement never fails because the directory
is read-only or git is absent; every failure returns ``None``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_runs")


def git_sha(cwd: Optional[str] = None) -> str:
    """HEAD SHA of the measured tree ('' if unavailable), suffixed
    ``-dirty`` when a tracked file has uncommitted changes: a record that
    cites a clean SHA must be reproducible from it."""
    cwd = cwd or os.path.dirname(DEFAULT_DIR)
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                           capture_output=True, timeout=10)
        if r.returncode != 0:
            return ""
        sha = r.stdout.decode().strip()
        # -uno: the record being written is itself untracked; only
        # modified tracked files make the measured code unreproducible
        s = subprocess.run(["git", "status", "--porcelain", "-uno"], cwd=cwd,
                           capture_output=True, timeout=10)
        if s.returncode == 0 and s.stdout.strip():
            sha += "-dirty"
        return sha
    except Exception:
        return ""


def capture_record(metric: str, value: float, unit: str, **extra) -> dict:
    """One self-describing record: the measurement, then the environment
    (timestamp, git SHA, ``torch_version``, ``cuda_version`` — None on a
    CPU-only build of torch), then ``extra`` (device, shapes, rates...)."""
    import torch
    rec = {
        "metric": metric,
        "value": value,
        "unit": unit,
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    rec.update(extra)
    return rec


def device_class(device: str) -> str:
    """``tpu``, ``gpu`` (a device string naming NVIDIA or CUDA), ``cpu``
    or ``dev``: the last part of a capture's file name."""
    d = device.upper()
    if "TPU" in d:
        return "tpu"
    if "NVIDIA" in d or "CUDA" in d:
        return "gpu"
    return "cpu" if "CPU" in d else "dev"


def write_capture(record: dict, outdir: Optional[str] = None) -> Optional[str]:
    """Write one record as ``{ts}_{metric}_{class}.json`` under ``outdir``
    (default ``$ANOMOD_BENCH_RUNS_DIR``, else ``bench_runs/``); return its
    path, or None (never raises) when the filesystem refuses."""
    outdir = outdir or os.environ.get("ANOMOD_BENCH_RUNS_DIR", DEFAULT_DIR)
    try:
        os.makedirs(outdir, exist_ok=True)
        devclass = device_class(str(record.get("device", "unknown")))
        ts = record.get("timestamp_utc", "").replace(":", "").replace("-", "")
        stem = f"{ts}_{record.get('metric', 'capture')}_{devclass}"
        # O_EXCL and a counter suffix: two captures of one metric within a
        # second never overwrite each other
        for i in range(1000):
            path = os.path.join(
                outdir, f"{stem}.json" if i == 0 else f"{stem}_{i}.json")
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w") as f:
                json.dump(record, f, indent=1, sort_keys=True)
                f.write("\n")
            return path
        return None
    except Exception:
        return None
