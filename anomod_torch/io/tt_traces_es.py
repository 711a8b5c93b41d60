"""TT enhanced (Elasticsearch) trace collector schema → SpanBatch
(counterpart of ``anomod/io/tt_traces_es.py``).

The reference's alternative trace path queries SkyWalking's ``sw_segment-*``
indices directly and emits segment-level records
(enhanced_trace_collector.py:102-163: trace_id, segment_id, base64-encoded
``service_id``, endpoint_name, start/end ms, latency, is_error) as a
``detailed_traces_<ts>.{json,csv}`` pair (:168-213).  Segments carry no
parent refs in this export, so parents resolve to -1 (segment-level view).
"""

from __future__ import annotations

import base64
import csv
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from anomod_torch.io.lfs import is_lfs_pointer
from anomod_torch.schemas import KIND_ENTRY, SpanBatch, empty_span_batch


def decode_service_id(service_id: str) -> str:
    """``dHMtdHJhdmVsLXNlcnZpY2U=.1`` -> ``ts-travel-service``
    (enhanced_trace_collector.py:131-148)."""
    if not service_id:
        return "unknown"
    b64 = service_id.split(".")[0]
    try:
        return base64.b64decode(b64, validate=True).decode("utf-8")
    except Exception:
        return b64


def _records_to_batch(records: List[dict]) -> SpanBatch:
    if not records:
        return empty_span_batch()
    n = len(records)
    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}
    trace_c = np.zeros(n, np.int32)
    service_c = np.zeros(n, np.int32)
    endpoint_c = np.zeros(n, np.int32)
    start_c = np.zeros(n, np.int64)
    dur_c = np.zeros(n, np.int64)
    err_c = np.zeros(n, np.bool_)
    for r, rec in enumerate(records):
        trace_c[r] = trace_ids.setdefault(str(rec.get("trace_id", "")), len(trace_ids))
        svc = rec.get("service_name") or decode_service_id(str(rec.get("service_id", "")))
        service_c[r] = services.setdefault(svc, len(services))
        endpoint_c[r] = endpoints.setdefault(str(rec.get("endpoint_name", "")),
                                             len(endpoints))
        start_ms = int(float(rec.get("start_time", 0) or 0))
        latency = rec.get("latency", 0)
        end_ms = int(float(rec.get("end_time", 0) or 0))
        start_c[r] = start_ms * 1000
        dur_c[r] = int(float(latency or 0)) * 1000 if latency else \
            max(0, end_ms - start_ms) * 1000
        err_c[r] = bool(int(float(rec.get("is_error", 0) or 0)))
    return SpanBatch(
        trace=trace_c, parent=np.full(n, -1, np.int32), service=service_c,
        endpoint=endpoint_c, start_us=start_c, duration_us=dur_c,
        is_error=err_c, status=np.zeros(n, np.int16),
        kind=np.full(n, KIND_ENTRY, np.int8),
        services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def load_detailed_traces_json(path: Path) -> Optional[SpanBatch]:
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return _records_to_batch(doc.get("traces", []))


def load_detailed_traces_csv(path: Path) -> Optional[SpanBatch]:
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    with open(path, newline="") as f:
        return _records_to_batch(list(csv.DictReader(f)))


def analyze_trace_patterns(batch: SpanBatch) -> dict:
    """Aggregate trace-pattern summary, schema-matched to the reference's
    ``analyze_trace_patterns`` (enhanced_trace_collector.py:216-296):
    total count, distinct services/endpoints, per-service and per-endpoint
    call counts, error-trace count, latency min/max/avg over positive
    latencies, and the [earliest, latest] start-time window with ISO
    datetime renderings.

    Computed vectorized over the SpanBatch columns (bincount + reductions)
    instead of the reference's per-record Python loop; latencies are
    reported in ms (the ES export's unit — the batch stores µs)."""
    import datetime

    if batch.n_spans == 0:
        return {
            "total_traces": 0,
            "unique_services": [],
            "unique_endpoints": [],
            "error_traces": 0,
            "service_call_counts": {},
            "endpoint_call_counts": {},
            "latency_stats": None,
            "time_range": {"earliest": None, "latest": None},
        }
    svc_counts = np.bincount(batch.service, minlength=len(batch.services))
    ep_counts = np.bincount(batch.endpoint, minlength=len(batch.endpoints))
    lat_ms = batch.duration_us.astype(np.float64) / 1000.0
    pos = lat_ms[lat_ms > 0]
    start_ms = batch.start_us.astype(np.int64) // 1000
    analysis = {
        "total_traces": int(batch.n_spans),
        "unique_services": list(batch.services),
        "unique_endpoints": list(batch.endpoints),
        "error_traces": int(batch.is_error.sum()),
        "service_call_counts": {s: int(c) for s, c
                                in zip(batch.services, svc_counts)},
        "endpoint_call_counts": {e: int(c) for e, c
                                 in zip(batch.endpoints, ep_counts)},
        "latency_stats": ({
            "min": float(pos.min()),
            "max": float(pos.max()),
            "avg": float(pos.mean()),
            "count": int(pos.size),
        } if pos.size else None),
        "time_range": {
            "earliest": int(start_ms.min()),
            "latest": int(start_ms.max()),
        },
    }
    # datetime renderings ride alongside the raw ms timestamps, added only
    # when truthy — the reference's exact conditional (:286-294).  Rendered
    # in UTC (naive format, like the reference's local-time strings) so the
    # artifact bytes don't depend on the host timezone.
    for key in ("earliest", "latest"):
        ms = analysis["time_range"][key]
        if ms:
            dt = datetime.datetime.fromtimestamp(
                ms / 1000, tz=datetime.timezone.utc).replace(tzinfo=None)
            analysis["time_range"][f"{key}_datetime"] = dt.isoformat()
    return analysis


def format_analysis_report(analysis: dict, hours_back: int = 24,
                           top_n: int = 10) -> str:
    """The human-readable analysis report the reference prints after a
    collect-and-analyze run (enhanced_trace_collector.py:326-357): header,
    totals, error rate, latency stats, and the top-N service/endpoint
    call-count rankings."""
    bar = "=" * 80
    lines = [bar, "Train-Ticket Trace Analysis Report", bar,
             f"Time window: last {hours_back} hours",
             f"Total traces: {analysis['total_traces']:,}",
             f"Distinct services: {len(analysis['unique_services'])}",
             f"Distinct endpoints: {len(analysis['unique_endpoints'])}",
             f"Error traces: {analysis['error_traces']}"]
    if analysis["total_traces"] > 0:
        rate = analysis["error_traces"] / analysis["total_traces"] * 100
        lines.append(f"Error rate: {rate:.2f}%")
    else:
        lines.append("Error rate: N/A (no traces collected)")
    if analysis["latency_stats"]:
        ls = analysis["latency_stats"]
        lines += ["", "Latency statistics:",
                  f"  Min latency: {ls['min']} ms",
                  f"  Max latency: {ls['max']} ms",
                  f"  Avg latency: {ls['avg']:.2f} ms"]
    for title, counts in (("services", analysis["service_call_counts"]),
                          ("endpoints", analysis["endpoint_call_counts"])):
        ranked = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)
        lines += ["", f"Top {title} ({top_n}):"]
        lines += [f"  {i:2d}. {name}: {count:,} calls"
                  for i, (name, count) in enumerate(ranked[:top_n], 1)]
    lines.append(bar)
    return "\n".join(lines)


def write_trace_analysis(batch: SpanBatch, out_dir: Path,
                         timestamp: str = "00000000_000000") -> Path:
    """Materialize the ``trace_analysis_<ts>.json`` artifact
    (enhanced_trace_collector.py:316-323's envelope: timestamp,
    collection_time, analysis) plus the printed report as a sibling
    ``trace_analysis_<ts>.txt``.  ``timestamp`` is caller-supplied (the
    campaign's experiment clock) so artifacts are reproducible."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    analysis = analyze_trace_patterns(batch)
    path = out_dir / f"trace_analysis_{timestamp}.json"
    with open(path, "w") as f:
        json.dump({"timestamp": timestamp,
                   "collection_time": timestamp,
                   "analysis": analysis}, f, indent=2, ensure_ascii=False)
    (out_dir / f"trace_analysis_{timestamp}.txt").write_text(
        format_analysis_report(analysis) + "\n")
    return path


def load_trace_analysis(path: Path) -> Optional[dict]:
    """Load a ``trace_analysis_<ts>.json`` artifact; returns the envelope
    dict (or None for missing/LFS-stub files, like the other loaders)."""
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    with open(path) as f:
        return json.load(f)
