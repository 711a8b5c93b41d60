"""The columnar modal IR (counterpart of ``anomod/schemas.py``).

``SpanBatch`` unifies the two reference trace schemas (Jaeger spans for SN,
SkyWalking segments for TT) behind fixed-dtype numpy columns plus interned
string side tables; ``MetricBatch``, ``LogBatch``, ``ApiBatch`` and
``CoverageBatch`` do the same for the other four modalities, and
``Experiment`` bundles the five.  The port keeps every batch on the host:
only the staged replay columns (``anomod_torch.replay.stage_columns``) go
to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# Span kinds (TT "type" field; SN spans are all RPC ~ Entry/Exit mix).
KIND_ENTRY = 0
KIND_EXIT = 1
KIND_LOCAL = 2
KIND_NAMES = ("Entry", "Exit", "Local")

LOG_INFO, LOG_WARN, LOG_ERROR, LOG_OTHER = 0, 1, 2, 3

_ROW_FIELDS = ("trace", "parent", "service", "endpoint", "start_us",
               "duration_us", "is_error", "status", "kind")


class SpanBatch(NamedTuple):
    """Columnar batch of spans — the unified span IR.

    All arrays share length ``n_spans``.  ``parent`` holds the *global row
    index* of the parent span within the same batch (-1 for roots).
    """

    trace: np.ndarray      # int32  — index into `trace_ids` table
    parent: np.ndarray     # int32  — global row index of parent, -1 = root
    service: np.ndarray    # int32  — index into `services`
    endpoint: np.ndarray   # int32  — index into `endpoints`
    start_us: np.ndarray   # int64  — epoch microseconds
    duration_us: np.ndarray  # int64
    is_error: np.ndarray   # bool_
    status: np.ndarray     # int16  — HTTP status code, 0 if absent
    kind: np.ndarray       # int8   — KIND_ENTRY/EXIT/LOCAL

    services: Tuple[str, ...]
    endpoints: Tuple[str, ...]
    trace_ids: Tuple[str, ...]

    @property
    def n_spans(self) -> int:
        return int(self.trace.shape[0])

    @property
    def n_traces(self) -> int:
        return len(self.trace_ids)

    @property
    def n_services(self) -> int:
        return len(self.services)

    def validate(self) -> "SpanBatch":
        n = self.n_spans
        for name in _ROW_FIELDS:
            arr = getattr(self, name)
            if arr.shape != (n,):
                raise ValueError(f"SpanBatch.{name}: shape {arr.shape} != ({n},)")
        if n:
            if self.parent.max(initial=-1) >= n:
                raise ValueError("SpanBatch.parent out of range")
            if self.service.max(initial=0) >= len(self.services):
                raise ValueError("SpanBatch.service id out of range")
            if self.trace.max(initial=0) >= len(self.trace_ids):
                raise ValueError("SpanBatch.trace id out of range")
        return self


def empty_span_batch() -> SpanBatch:
    z = lambda dt: np.zeros((0,), dtype=dt)  # noqa: E731
    return SpanBatch(
        trace=z(np.int32), parent=z(np.int32), service=z(np.int32),
        endpoint=z(np.int32), start_us=z(np.int64), duration_us=z(np.int64),
        is_error=z(np.bool_), status=z(np.int16), kind=z(np.int8),
        services=(), endpoints=(), trace_ids=(),
    )


def concat_span_batches(batches: Sequence[SpanBatch]) -> SpanBatch:
    """Concatenate batches, re-interning the string tables."""
    batches = [b for b in batches if b.n_spans]
    if not batches:
        return empty_span_batch()
    services: Dict[str, int] = {}
    endpoints: Dict[str, int] = {}
    trace_ids: Dict[str, int] = {}
    cols = {k: [] for k in _ROW_FIELDS}
    offset = 0
    for b in batches:
        svc_map = np.array([services.setdefault(s, len(services)) for s in b.services]
                           or [0], dtype=np.int32)
        ep_map = np.array([endpoints.setdefault(e, len(endpoints)) for e in b.endpoints]
                          or [0], dtype=np.int32)
        tr_map = np.array([trace_ids.setdefault(t, len(trace_ids)) for t in b.trace_ids]
                          or [0], dtype=np.int32)
        cols["service"].append(svc_map[b.service])
        cols["endpoint"].append(ep_map[b.endpoint])
        cols["trace"].append(tr_map[b.trace])
        par = b.parent.copy()
        par[par >= 0] += offset
        cols["parent"].append(par)
        for k in ("start_us", "duration_us", "is_error", "status", "kind"):
            cols[k].append(getattr(b, k))
        offset += b.n_spans
    return SpanBatch(
        **{k: np.concatenate(v) for k, v in cols.items()},
        services=tuple(services), endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    ).validate()


def take_spans(batch: SpanBatch, idx) -> SpanBatch:
    """Row-subset of a SpanBatch (boolean mask, index array or slice).

    Side tables are kept whole so service/endpoint/trace ids stay valid;
    ``parent`` is NOT remapped — callers that need parent edges resolve
    them on the full batch first (``stream.resolve_parent_services``).
    """
    return batch._replace(**{k: getattr(batch, k)[idx] for k in _ROW_FIELDS})


# ---------------------------------------------------------------------------
# Metric IR — long-format samples, matching both reference CSV shapes:
#   SN per-query CSVs:  timestamp,value,metric,<label cols>
#     (fetch_prometheus_metrics.py:57-66)
#   TT single long CSV: metric_name,timestamp,datetime,value,<label cols>
#     (metric_collector.py:431-443)
# ---------------------------------------------------------------------------

class MetricBatch(NamedTuple):
    metric: np.ndarray      # int32 — index into `metric_names`
    series: np.ndarray      # int32 — index into `series_keys` (label-set id)
    t_s: np.ndarray         # float64 — epoch seconds
    value: np.ndarray       # float64 (NaN allowed)
    metric_names: Tuple[str, ...]
    series_keys: Tuple[str, ...]   # rendered label strings k="v",...
    series_service: np.ndarray     # int32 per series — service id or -1
    services: Tuple[str, ...]

    @property
    def n_samples(self) -> int:
        return int(self.t_s.shape[0])


# ---------------------------------------------------------------------------
# Log IR — per (service, window) line/error/warn counts, matching the
# reference summaries (collect_log.sh:101-137; log_collector.py report).
# Raw lines stay on host; only counts go to device.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogSummary:
    service: str
    n_lines: int
    n_error: int
    n_warn: int
    n_info: int = 0
    size_bytes: int = 0


class LogBatch(NamedTuple):
    service: np.ndarray    # int32
    t_s: np.ndarray        # float64 — line timestamp (bucketed ok)
    level: np.ndarray      # int8: 0=info 1=warn 2=error 3=other
    services: Tuple[str, ...]

    @property
    def n_lines(self) -> int:
        return int(self.t_s.shape[0])


# ---------------------------------------------------------------------------
# API-response IR — one record per probed request, matching the JSONL contract
# (enhanced_openapi_monitor.py:155-169: timestamp, endpoint, method,
#  status_code, latency_ms, content_length, ...).
# ---------------------------------------------------------------------------

class ApiBatch(NamedTuple):
    endpoint: np.ndarray     # int32
    t_s: np.ndarray          # float64
    status: np.ndarray       # int16
    latency_ms: np.ndarray   # float32
    content_length: np.ndarray  # int32
    endpoints: Tuple[str, ...]

    @property
    def n_records(self) -> int:
        return int(self.t_s.shape[0])


# ---------------------------------------------------------------------------
# Coverage IR — per (service, file) line-coverage counters, unifying
# gcov text (SN) and JaCoCo XML LINE counters (TT, coverage_summary.py:97-125).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FileCoverage:
    service: str
    path: str
    lines_total: int
    lines_covered: int

    @property
    def ratio(self) -> float:
        return self.lines_covered / self.lines_total if self.lines_total else 0.0


class CoverageBatch(NamedTuple):
    service: np.ndarray       # int32, per file
    lines_total: np.ndarray   # int32
    lines_covered: np.ndarray  # int32
    services: Tuple[str, ...]
    paths: Tuple[str, ...]

    def service_ratio(self) -> np.ndarray:
        """Per-service covered/total line ratio."""
        n = len(self.services)
        tot = np.zeros(n, np.int64)
        cov = np.zeros(n, np.int64)
        np.add.at(tot, self.service, self.lines_total)
        np.add.at(cov, self.service, self.lines_covered)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(tot > 0, cov / np.maximum(tot, 1), 0.0)


def coverage_batch_from_files(files: Sequence[FileCoverage]) -> CoverageBatch:
    services: Dict[str, int] = {}
    svc_idx = np.array([services.setdefault(f.service, len(services)) for f in files],
                       dtype=np.int32) if files else np.zeros((0,), np.int32)
    return CoverageBatch(
        service=svc_idx,
        lines_total=np.array([f.lines_total for f in files], np.int32),
        lines_covered=np.array([f.lines_covered for f in files], np.int32),
        services=tuple(services),
        paths=tuple(f.path for f in files),
    )


# ---------------------------------------------------------------------------
# Experiment bundle — the five synchronized modalities for one experiment,
# joined by the shared experiment name key (T-Dataset/README.md:19).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Experiment:
    name: str                       # e.g. "Lv_P_CPU_preserve_20251103T140939Z_em"
    testbed: str                    # "SN" | "TT"
    spans: Optional[SpanBatch] = None
    metrics: Optional[MetricBatch] = None
    logs: Optional[LogBatch] = None
    log_summaries: Optional[List[LogSummary]] = None
    api: Optional[ApiBatch] = None
    coverage: Optional[CoverageBatch] = None
    synthetic: bool = False
