"""Metric CSV loaders → MetricBatch (counterpart of
``anomod/io/metrics.py``; the TT CSV's numeric columns through the C++
scanner of :mod:`anomod_torch.io.native` unless ``ANOMOD_NATIVE=off``).

Two reference shapes:
  - SN per-query CSVs (one file per PromQL query, collect_metric.sh:24-125):
    columns ``timestamp,value,metric,<label cols>``
    (fetch_prometheus_metrics.py:57-66); timestamp is a wall-clock string.
  - TT single long CSV (metric_collector.py:431-443): columns
    ``metric_name,timestamp,datetime,value,<label cols>``; timestamp is epoch
    seconds.
"""

from __future__ import annotations

import csv
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch.io.lfs import is_lfs_pointer
from anomod_torch.schemas import MetricBatch

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the metric entries.
LOADER_VERSION = 1

_SERVICE_LABELS = ("service", "name", "pod", "container", "app")


def _parse_ts(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        pass
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S"):
        try:
            return datetime.strptime(s.split(".")[0], fmt).timestamp()
        except ValueError:
            continue
    return 0.0


def _service_of(labels: Dict[str, str], services: Dict[str, int]) -> int:
    for key in _SERVICE_LABELS:
        v = labels.get(key, "")
        if v:
            # normalize pod name -> service name (strip replicaset hash)
            parts = v.split("-")
            while parts and (parts[-1].isalnum() and len(parts[-1]) in (5, 9, 10)
                             and any(c.isdigit() for c in parts[-1])):
                parts = parts[:-1]
            name = "-".join(parts) if parts else v
            return services.setdefault(name, len(services))
    return -1


def _build(rows: List[Tuple[str, float, float, Dict[str, str]]]) -> MetricBatch:
    metric_names: Dict[str, int] = {}
    series_keys: Dict[str, int] = {}
    services: Dict[str, int] = {}
    series_service: List[int] = []
    n = len(rows)
    metric_c = np.zeros(n, np.int32)
    series_c = np.zeros(n, np.int32)
    t_c = np.zeros(n, np.float64)
    v_c = np.zeros(n, np.float64)
    for i, (mname, ts, val, labels) in enumerate(rows):
        metric_c[i] = metric_names.setdefault(mname, len(metric_names))
        key = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        if key not in series_keys:
            series_keys[key] = len(series_keys)
            series_service.append(_service_of(labels, services))
        series_c[i] = series_keys[key]
        t_c[i] = ts
        v_c[i] = val
    return MetricBatch(
        metric=metric_c, series=series_c, t_s=t_c, value=v_c,
        metric_names=tuple(metric_names), series_keys=tuple(series_keys),
        series_service=np.array(series_service or [0], np.int32)[:len(series_keys)],
        services=tuple(services),
    )


def load_sn_metric_dir(exp_dir: Path) -> Optional[MetricBatch]:
    """Load every per-query CSV in an SN metric experiment dir."""
    exp_dir = Path(exp_dir)
    rows: List[Tuple[str, float, float, Dict[str, str]]] = []
    found = False
    for p in sorted(exp_dir.glob("*.csv")):
        if is_lfs_pointer(p):
            continue
        metric_name = p.stem
        with open(p, newline="") as f:
            for rec in csv.DictReader(f):
                if "value" not in rec or "timestamp" not in rec:
                    break
                found = True
                labels = {k: v for k, v in rec.items()
                          if k not in ("timestamp", "value", "metric") and v}
                try:
                    val = float(rec["value"])
                except (TypeError, ValueError):
                    val = float("nan")
                rows.append((metric_name, _parse_ts(rec["timestamp"]), val, labels))
    return _build(rows) if found else None


def load_tt_metric_csv(path: Path) -> Optional[MetricBatch]:
    """Load the TT long-format experiment CSV.

    Numeric fast path: when the header is the canonical TT layout
    (metric_name,timestamp,datetime,value,...; metric_collector.py:431-443)
    and ``ANOMOD_NATIVE`` is not ``off``, the timestamp and value columns
    are parsed by the C++ CSV scanner (``strtod``); Python keeps the
    string columns.  The scanner is line-based, so its rows are trusted
    only if their count equals the csv module's record count and the
    first record's timestamp and value equal Python's parse; else the
    whole file takes the Python route, as in the JAX package."""
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    num = None
    raw = path.read_bytes()
    header = raw.split(b"\n", 1)[0].decode(errors="replace").strip().split(",")
    if header[:4] == ["metric_name", "timestamp", "datetime", "value"]:
        from anomod_torch.io import native
        if native.enabled():
            num = native.scan_csv_columns(raw, [1, 3])
    if num is not None:
        with open(path, newline="") as f:
            n_rec = sum(1 for r in csv.reader(f) if r) - 1  # minus header
        if num.shape[1] != n_rec:
            num = None
    if num is not None and num.shape[1] > 0:
        with open(path, newline="") as f:
            first = next(csv.DictReader(f), None)
        if first is not None:
            py_t = _parse_ts(first.get("timestamp", "0"))
            try:
                py_v = float(first["value"]) if first.get("value") \
                    else float("nan")
            except (TypeError, ValueError):
                py_v = float("nan")
            nat_t = float(num[0, 0])
            nat_t = 0.0 if np.isnan(nat_t) else nat_t
            nat_v = float(num[1, 0])
            if nat_t != py_t or not (nat_v == py_v
                                     or (np.isnan(nat_v) and np.isnan(py_v))):
                num = None
    rows: List[Tuple[str, float, float, Dict[str, str]]] = []
    with open(path, newline="") as f:
        for i, rec in enumerate(csv.DictReader(f)):
            labels = {k: v for k, v in rec.items()
                      if k not in ("metric_name", "timestamp", "datetime", "value") and v}
            if num is not None and i < num.shape[1]:
                t = float(num[0, i])
                t = 0.0 if np.isnan(t) else t
                val = float(num[1, i])
            else:
                try:
                    val = float(rec["value"]) if rec.get("value") else float("nan")
                except (TypeError, ValueError):
                    val = float("nan")
                t = _parse_ts(rec.get("timestamp", "0"))
            rows.append((rec.get("metric_name", ""), t, val, labels))
    return _build(rows) if rows else None


def find_tt_metric_artifact(exp_dir: Path) -> Optional[Path]:
    cands = sorted(Path(exp_dir).glob("*_metrics_*.csv"))
    return cands[-1] if cands else None


def write_metric_batch_tt_csv(batch: MetricBatch, path: Path) -> None:
    """Materialize a MetricBatch in the TT long-CSV shape (for synth trees)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric_name", "timestamp", "datetime", "value", "labels"])
        for i in range(batch.n_samples):
            ts = batch.t_s[i]
            w.writerow([
                batch.metric_names[int(batch.metric[i])], ts,
                datetime.fromtimestamp(ts).isoformat(),
                batch.value[i], batch.series_keys[int(batch.series[i])],
            ])
