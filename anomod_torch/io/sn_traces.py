"""SN / Jaeger trace loaders → SpanBatch (JSON and flattened CSV)
(counterpart of ``anomod/io/sn_traces.py``).

JSON: the merged Jaeger API dump ``all_traces.json`` — ``{"data": [{traceID,
processes{pid:{serviceName}}, spans[{spanID, processID, operationName,
startTime(µs), duration(µs), references[{refType:CHILD_OF, spanID}], tags}]}]}``
(collect_trace.sh:40-70 produces it; jaeger_to_csv.py:20-74 is the flattener).

CSV: ``all_traces.csv`` with the 13-column contract of jaeger_to_csv.py:76-90.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from anomod_torch.io.lfs import is_lfs_pointer
from anomod_torch.schemas import (KIND_ENTRY, KIND_EXIT, KIND_LOCAL,
                                  SpanBatch, empty_span_batch)

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the SN trace entries.
LOADER_VERSION = 1

_JKIND = {"server": KIND_ENTRY, "client": KIND_EXIT, "consumer": KIND_ENTRY,
          "producer": KIND_EXIT}


def load_jaeger_json(path: Path) -> Optional[SpanBatch]:
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return spans_from_jaeger(doc)


def spans_from_jaeger(doc: dict) -> SpanBatch:
    data = doc.get("data", [])
    n = sum(len(t.get("spans", [])) for t in data)
    if n == 0:
        return empty_span_batch()

    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}
    trace_c = np.zeros(n, np.int32)
    service_c = np.zeros(n, np.int32)
    endpoint_c = np.zeros(n, np.int32)
    start_c = np.zeros(n, np.int64)
    dur_c = np.zeros(n, np.int64)
    err_c = np.zeros(n, np.bool_)
    status_c = np.zeros(n, np.int16)
    kind_c = np.zeros(n, np.int8)
    parent_c = np.full(n, -1, np.int32)

    row_of: Dict[tuple, int] = {}
    pending = []
    r = 0
    for t in data:
        tid = t.get("traceID", "")
        t_idx = trace_ids.setdefault(tid, len(trace_ids))
        proc_svc = {pid: info.get("serviceName", "")
                    for pid, info in (t.get("processes") or {}).items()}
        for sp in t.get("spans", []):
            row_of[(t_idx, sp.get("spanID", ""))] = r
            trace_c[r] = t_idx
            svc = proc_svc.get(sp.get("processID", ""), "")
            service_c[r] = services.setdefault(svc, len(services))
            endpoint_c[r] = endpoints.setdefault(sp.get("operationName", ""),
                                                 len(endpoints))
            start_c[r] = int(sp.get("startTime", 0))
            dur_c[r] = int(sp.get("duration", 0))
            kind = KIND_LOCAL
            status = 0
            err = False
            for tag in sp.get("tags", []):
                k, v = tag.get("key", ""), tag.get("value", "")
                if k == "http.status_code":
                    try:
                        status = int(v)
                    except (TypeError, ValueError):
                        status = 0
                elif k == "span.kind":
                    kind = _JKIND.get(str(v), KIND_LOCAL)
                elif k == "error":
                    err = bool(v) and str(v).lower() != "false"
            err_c[r] = err or status >= 500
            status_c[r] = status
            kind_c[r] = kind
            # parent: first CHILD_OF reference (jaeger_to_csv.py:35-38)
            for ref in sp.get("references", []):
                if ref.get("refType") == "CHILD_OF":
                    pending.append((r, t_idx, ref.get("spanID", "")))
                    break
            r += 1

    for row, t_idx, psid in pending:
        parent_c[row] = row_of.get((t_idx, psid), -1)

    return SpanBatch(
        trace=trace_c, parent=parent_c, service=service_c, endpoint=endpoint_c,
        start_us=start_c, duration_us=dur_c, is_error=err_c, status=status_c,
        kind=kind_c,
        services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def load_jaeger_csv(path: Path) -> Optional[SpanBatch]:
    """Load the 13-column flattened CSV (jaeger_to_csv.py:76-90)."""
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}
    rows = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            rows.append(rec)
    if not rows:
        return empty_span_batch()
    n = len(rows)
    trace_c = np.zeros(n, np.int32)
    service_c = np.zeros(n, np.int32)
    endpoint_c = np.zeros(n, np.int32)
    start_c = np.zeros(n, np.int64)
    dur_c = np.zeros(n, np.int64)
    err_c = np.zeros(n, np.bool_)
    status_c = np.zeros(n, np.int16)
    kind_c = np.full(n, KIND_LOCAL, np.int8)
    parent_c = np.full(n, -1, np.int32)
    row_of: Dict[tuple, int] = {}
    for r, rec in enumerate(rows):
        t_idx = trace_ids.setdefault(rec.get("trace_id", ""), len(trace_ids))
        trace_c[r] = t_idx
        row_of[(t_idx, rec.get("span_id", ""))] = r
        service_c[r] = services.setdefault(rec.get("service", ""), len(services))
        endpoint_c[r] = endpoints.setdefault(rec.get("operation", ""), len(endpoints))
        # start_time is a wall string; CSV keeps duration_us authoritative
        dur_c[r] = int(float(rec.get("duration_us") or 0))
        try:
            status_c[r] = int(float(rec.get("http_status_code") or 0))
        except ValueError:
            status_c[r] = 0
        err_c[r] = status_c[r] >= 500
    for r, rec in enumerate(rows):
        psid = rec.get("parent_span_id", "")
        if psid:
            parent_c[r] = row_of.get((int(trace_c[r]), psid), -1)
    # synthesize monotone start order from file order (CSV drops µs epoch)
    start_c[:] = np.arange(n, dtype=np.int64)
    return SpanBatch(
        trace=trace_c, parent=parent_c, service=service_c, endpoint=endpoint_c,
        start_us=start_c, duration_us=dur_c, is_error=err_c, status=status_c,
        kind=kind_c, services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def find_trace_artifact(exp_dir: Path) -> Optional[Path]:
    """SN layout: all_traces.{json,csv} (collect_trace.sh:40-70)."""
    for name in ("all_traces.json", "all_traces.csv"):
        p = Path(exp_dir) / name
        if p.is_file():
            return p
    return None


_CSV_COLUMNS = ("trace_id", "span_id", "parent_span_id", "service", "operation",
                "start_time", "duration_us", "http_status_code", "http_method",
                "http_url", "component", "tags", "logs")


def write_jaeger_csv(batch: SpanBatch, path: Path) -> None:
    """Flatten a SpanBatch to the reference's 13-column CSV
    (jaeger_to_csv.py:76-90) — the jaeger_to_csv flattener equivalent."""
    from datetime import datetime, timezone
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_CSV_COLUMNS)
        for i in range(batch.n_spans):
            par = int(batch.parent[i])
            start = datetime.fromtimestamp(
                batch.start_us[i] / 1e6, tz=timezone.utc
            ).strftime("%Y-%m-%d %H:%M:%S.%f")
            status = int(batch.status[i])
            w.writerow([
                batch.trace_ids[int(batch.trace[i])], f"s{i:08x}",
                f"s{par:08x}" if par >= 0 else "",
                batch.services[int(batch.service[i])],
                batch.endpoints[int(batch.endpoint[i])],
                start, int(batch.duration_us[i]),
                status if status else "", "", "", "thrift",
                json.dumps({"error": bool(batch.is_error[i])}), "",
            ])
