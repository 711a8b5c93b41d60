"""API-response JSONL loader → ApiBatch
(counterpart of ``anomod/io/api.py``).

Record contract (enhanced_openapi_monitor.py:155-169): one JSON object per
line with ``timestamp`` (ISO), ``endpoint``, ``method``, ``status_code``,
``latency_ms``, ``content_length``, ...  SN layout:
``<exp>/openapi_responses.jsonl``; TT layout: ``<exp>/<YYYYMMDD>/api_responses.jsonl``.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from anomod_torch.io.lfs import is_lfs_pointer
from anomod_torch.schemas import ApiBatch

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the api entries.
LOADER_VERSION = 1


def _ts(s) -> float:
    if isinstance(s, (int, float)):
        return float(s)
    try:
        return datetime.fromisoformat(str(s)).timestamp()
    except ValueError:
        return 0.0


def load_api_jsonl(path: Path) -> Optional[ApiBatch]:
    path = Path(path)
    if not path.is_file() or is_lfs_pointer(path):
        return None
    endpoints: Dict[str, int] = {}
    ep_c: List[int] = []
    t_c: List[float] = []
    st_c: List[int] = []
    lat_c: List[float] = []
    cl_c: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            ep_c.append(endpoints.setdefault(str(rec.get("endpoint", "")), len(endpoints)))
            t_c.append(_ts(rec.get("timestamp", 0)))
            st_c.append(int(rec.get("status_code", 0) or 0))
            lat_c.append(float(rec.get("latency_ms", 0) or 0))
            cl_c.append(int(rec.get("content_length", 0) or 0))
    if not ep_c:
        return None
    return ApiBatch(
        endpoint=np.array(ep_c, np.int32), t_s=np.array(t_c, np.float64),
        status=np.array(st_c, np.int16), latency_ms=np.array(lat_c, np.float32),
        content_length=np.array(cl_c, np.int32), endpoints=tuple(endpoints))


def find_api_artifact(exp_dir: Path) -> Optional[Path]:
    exp_dir = Path(exp_dir)
    p = exp_dir / "openapi_responses.jsonl"           # SN
    if p.is_file():
        return p
    cands = sorted(exp_dir.glob("*/api_responses.jsonl"))  # TT date subdir
    return cands[-1] if cands else None


def _endpoint_method(endpoint: str) -> str:
    """Endpoints recorded as "METHOD /path" carry their method; bare paths
    default to GET (the monitor's probe default)."""
    head = endpoint.split(" ", 1)[0]
    return head if head.isupper() and head.isalpha() else "GET"


def write_api_jsonl(batch: ApiBatch, path: Path) -> None:
    """Materialize an ApiBatch in the reference JSONL shape."""
    methods = [_endpoint_method(e) for e in batch.endpoints]
    with open(path, "w") as f:
        for i in range(batch.n_records):
            f.write(json.dumps({
                "timestamp": datetime.fromtimestamp(float(batch.t_s[i])).isoformat(),
                "endpoint": batch.endpoints[int(batch.endpoint[i])],
                "method": methods[int(batch.endpoint[i])],
                "status_code": int(batch.status[i]),
                "latency_ms": round(float(batch.latency_ms[i]), 2),
                "content_length": int(batch.content_length[i]),
            }) + "\n")


def analyze_api_batch(batch: ApiBatch) -> dict:
    """Traffic analysis over an ApiBatch — the analyzer analog of
    analyze_http_traffic.py (tshark post-processor: request/status/method
    distributions) and the monitor's endpoint_performance.json
    (enhanced_openapi_monitor.py:318-397)."""
    lat = batch.latency_ms.astype(float)
    status_counts = {int(c): int((batch.status == c).sum())
                     for c in np.unique(batch.status)}
    per_endpoint = {}
    methods: Dict[str, int] = {}
    counts = np.bincount(batch.endpoint, minlength=len(batch.endpoints))
    for i, ep in enumerate(batch.endpoints):
        methods[_endpoint_method(ep)] = (
            methods.get(_endpoint_method(ep), 0) + int(counts[i]))
        m = batch.endpoint == i
        if not m.any():
            continue
        el = lat[m]
        per_endpoint[ep] = {
            "requests": int(m.sum()),
            "error_rate": float((batch.status[m] >= 400).mean()),
            "avg_latency_ms": float(el.mean()),
            "p95_latency_ms": float(np.percentile(el, 95)),
            "p99_latency_ms": float(np.percentile(el, 99)),
        }
    return {
        "total_requests": int(batch.n_records),
        "status_distribution": status_counts,
        "method_distribution": methods,
        "error_rate": float((batch.status >= 400).mean()),
        "avg_latency_ms": float(lat.mean()) if len(lat) else 0.0,
        "endpoint_performance": per_endpoint,
    }


def write_api_artifact_family(batch: ApiBatch, adir: Path) -> None:
    """Materialize the full SN api_responses artifact family
    (enhanced_openapi_monitor.py:272,359,364,390 + the orchestrator's
    traffic_analysis.json, collect_openapi_response.sh:117-142):
    openapi_responses.jsonl, response_summary.json, endpoint_performance.json,
    status_code_distribution.csv, traffic_analysis.json."""
    adir = Path(adir)
    adir.mkdir(parents=True, exist_ok=True)
    write_api_jsonl(batch, adir / "openapi_responses.jsonl")
    lat = batch.latency_ms
    (adir / "response_summary.json").write_text(json.dumps({
        "total_requests": int(batch.n_records),
        "status_codes": {str(c): int((batch.status == c).sum())
                         for c in np.unique(batch.status)},
        "avg_latency_ms": float(lat.mean()) if len(lat) else 0.0,
        "p95_latency_ms": float(np.percentile(lat, 95)) if len(lat) else 0.0,
        "p99_latency_ms": float(np.percentile(lat, 99)) if len(lat) else 0.0,
    }))
    analysis = analyze_api_batch(batch)
    (adir / "traffic_analysis.json").write_text(json.dumps(analysis))
    (adir / "endpoint_performance.json").write_text(
        json.dumps(analysis["endpoint_performance"]))
    with open(adir / "status_code_distribution.csv", "w") as f:
        f.write("status_code,count\n")
        for c in np.unique(batch.status):
            f.write(f"{int(c)},{int((batch.status == c).sum())}\n")
