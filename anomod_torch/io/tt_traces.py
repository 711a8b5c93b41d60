"""TT / SkyWalking trace JSON loader → SpanBatch
(counterpart of ``anomod/io/tt_traces.py``).

Consumes the collector artifact schema (trace_collector.py:552-584):
``{"metadata": {...}, "traces": [{"trace_id", "span_count",
"services_involved", "root_span_node_ids", "spans": [span_dict...]}]}``
with span dicts per the ``to_dict`` contract (trace_collector.py:86-123):
``node_id="segment:span"``, ``parent_span_id`` (same-segment) and cross-segment
``refs[{parentSegmentId, parentSpanId}]`` — re-implemented here as vectorized
columnar resolution (the reference builds the graph per-span in Python,
trace_collector.py:401-481).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from anomod_torch.io.lfs import is_lfs_pointer
from anomod_torch.schemas import (KIND_ENTRY, KIND_EXIT, KIND_LOCAL,
                                  SpanBatch, empty_span_batch)

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the TT trace entries.
LOADER_VERSION = 1

_KIND = {"Entry": KIND_ENTRY, "Exit": KIND_EXIT, "Local": KIND_LOCAL}


def load_skywalking_json(path: Path) -> Optional[SpanBatch]:
    """Load one collector JSON artifact; None if missing/LFS stub."""
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return spans_from_skywalking(doc)


def spans_from_skywalking(doc: dict) -> SpanBatch:
    traces = doc.get("traces", [])
    if not traces:
        return empty_span_batch()

    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}

    # First pass: flatten spans, record (segment_id, span_id) -> row.
    n = sum(len(t.get("spans", [])) for t in traces)
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
    pending: List[tuple] = []  # (row, parent_segment, parent_span)

    r = 0
    for t in traces:
        tid = t.get("trace_id") or (t.get("summary", {}).get("trace_ids") or [""])[0]
        t_idx = trace_ids.setdefault(tid, len(trace_ids))
        for sp in t.get("spans", []):
            seg = sp.get("segment_id", "")
            sid = int(sp.get("span_id", 0))
            row_of[(seg, sid)] = r
            trace_c[r] = t_idx
            service_c[r] = services.setdefault(sp.get("service_code", ""), len(services))
            endpoint_c[r] = endpoints.setdefault(sp.get("endpoint_name") or "", len(endpoints))
            start_ms = int(sp.get("start_timestamp_ms", 0))
            end_ms = int(sp.get("end_timestamp_ms", start_ms))
            start_c[r] = start_ms * 1000
            dur_c[r] = max(0, end_ms - start_ms) * 1000
            err_c[r] = bool(sp.get("is_error", False))
            tags = sp.get("tags_map") or {}
            try:
                status_c[r] = int(tags.get("http.status_code", 0) or 0)
            except (TypeError, ValueError):
                status_c[r] = 0
            kind_c[r] = _KIND.get(sp.get("type", "Local"), KIND_LOCAL)
            # parent: same-segment parent_span_id >= 0, else refs[0]
            psid = sp.get("parent_span_id", -1)
            if psid is not None and int(psid) >= 0:
                pending.append((r, seg, int(psid)))
            else:
                refs = sp.get("refs") or []
                if refs:
                    ref = refs[0]
                    pending.append((r, ref.get("parentSegmentId", ""),
                                    int(ref.get("parentSpanId", -1))))
            r += 1

    for row, pseg, psid in pending:
        parent = row_of.get((pseg, psid), -1)
        parent_c[row] = parent

    return SpanBatch(
        trace=trace_c, parent=parent_c, service=service_c, endpoint=endpoint_c,
        start_us=start_c, duration_us=dur_c, is_error=err_c, status=status_c,
        kind=kind_c,
        services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def find_trace_artifact(exp_dir: Path) -> Optional[Path]:
    """TT layout: <exp>/<exp>_skywalking_traces_<ts>.json (T-Dataset/README.md:13)."""
    cands = sorted(Path(exp_dir).glob("*skywalking_traces*.json"))
    return cands[-1] if cands else None
