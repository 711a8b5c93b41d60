"""Data-quality validation — the reference's embedded collector checks.

Counterpart of ``anomod/validate.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_contracts.py``.

The reference validates as it collects: non-empty log check + retry
(collect_log.sh:91-99,154-165), empty-Prometheus-query warnings
(fetch_prometheus_metrics.py:40-42), trace dedup by traceID
(collect_trace.sh:52-58; trace_collector.py:358-360), endpoint connectivity
pre-checks (enhanced_openapi_monitor.py:82-96), and exec-file presence
summaries (collect_coverage_reports.sh:176-191).  This module applies the
same checks to loaded Experiment bundles and emits a JSON-able collection
report in the spirit of log_collector.py:179-200.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from anomod_torch.schemas import Experiment, LOG_ERROR, SpanBatch


@dataclasses.dataclass
class ValidationIssue:
    severity: str        # "warn" | "error"
    modality: str
    message: str


@dataclasses.dataclass
class ValidationReport:
    experiment: str
    testbed: str
    synthetic: bool
    counts: Dict[str, int]
    issues: List[ValidationIssue]

    @property
    def ok(self) -> bool:
        return not any(i.severity == "error" for i in self.issues)

    def to_dict(self) -> dict:
        return {
            "experiment": self.experiment, "testbed": self.testbed,
            "synthetic": self.synthetic, "ok": self.ok, "counts": self.counts,
            "issues": [dataclasses.asdict(i) for i in self.issues],
        }


def dedup_traces(batch: SpanBatch) -> SpanBatch:
    """Drop exact duplicate spans from re-paginated collections: the columnar
    analog of the reference's jq/set() traceID dedup.  A duplicate is a row
    whose (trace, service, endpoint, start, duration) quintuple repeats."""
    if batch.n_spans == 0:
        return batch
    key = np.stack([batch.trace.astype(np.int64), batch.service.astype(np.int64),
                    batch.endpoint.astype(np.int64), batch.start_us,
                    batch.duration_us], axis=1)
    _, first_idx = np.unique(key, axis=0, return_index=True)
    if first_idx.shape[0] == batch.n_spans:
        return batch
    keep = np.sort(first_idx)
    remap = np.full(batch.n_spans, -1, np.int32)
    remap[keep] = np.arange(keep.shape[0], dtype=np.int32)
    parent = batch.parent[keep]
    parent = np.where(parent >= 0, remap[np.clip(parent, 0, None)], -1)
    return batch._replace(
        trace=batch.trace[keep], parent=parent.astype(np.int32),
        service=batch.service[keep], endpoint=batch.endpoint[keep],
        start_us=batch.start_us[keep], duration_us=batch.duration_us[keep],
        is_error=batch.is_error[keep], status=batch.status[keep],
        kind=batch.kind[keep])


def validate_experiment(exp: Experiment) -> ValidationReport:
    issues: List[ValidationIssue] = []
    counts: Dict[str, int] = {}

    def warn(mod, msg):
        issues.append(ValidationIssue("warn", mod, msg))

    def error(mod, msg):
        issues.append(ValidationIssue("error", mod, msg))

    # traces
    if exp.spans is None or exp.spans.n_spans == 0:
        error("traces", "no spans collected")
        counts["spans"] = 0
    else:
        counts["spans"] = exp.spans.n_spans
        counts["traces"] = exp.spans.n_traces
        deduped = dedup_traces(exp.spans)
        if deduped.n_spans < exp.spans.n_spans:
            warn("traces", f"{exp.spans.n_spans - deduped.n_spans} duplicate "
                 "spans (re-paginated collection?)")
        orphan = ((exp.spans.parent < -1)
                  | (exp.spans.parent >= exp.spans.n_spans)).sum()
        if orphan:
            error("traces", f"{orphan} out-of-range parent references")
        if (exp.spans.duration_us < 0).any():
            error("traces", "negative span durations")
        # parent-resolution rate: the call-graph, edge-attribution, and
        # per-edge featurization planes all key spans by caller — a
        # collection whose parentSpanId join mostly failed silently
        # degrades every edge view to node evidence
        resolved = float((exp.spans.parent >= 0).mean())
        counts["parent_resolution_rate"] = round(resolved, 4)
        if resolved < 0.5:
            warn("traces", f"only {resolved:.0%} of spans have a resolved "
                 "parent — edge-keyed planes (stream edge attribution, "
                 "per-edge percentiles) degrade toward node evidence")

    # metrics
    if exp.metrics is None or exp.metrics.n_samples == 0:
        error("metrics", "no metric samples")
        counts["metric_samples"] = 0
    else:
        counts["metric_samples"] = exp.metrics.n_samples
        nan_frac = float(np.isnan(exp.metrics.value).mean())
        if nan_frac > 0.2:
            warn("metrics", f"{nan_frac:.0%} NaN samples")
        empty = [m for i, m in enumerate(exp.metrics.metric_names)
                 if not (exp.metrics.metric == i).any()]
        for m in empty:
            warn("metrics", f"query '{m}' returned no data")  # fetcher :40-42

    # logs — the reference's empty-log + "only tracing statements" checks
    if exp.logs is None or exp.logs.n_lines == 0:
        warn("logs", "no log lines")
        counts["log_lines"] = 0
    else:
        counts["log_lines"] = exp.logs.n_lines
        per_svc = np.bincount(exp.logs.service,
                              minlength=len(exp.logs.services))
        for i, svc in enumerate(exp.logs.services):
            if per_svc[i] == 0:
                warn("logs", f"{svc}: log file not generated")

    # api
    if exp.api is None or exp.api.n_records == 0:
        warn("api", "no API response records")
        counts["api_records"] = 0
    else:
        counts["api_records"] = exp.api.n_records
        reachable = int((exp.api.status > 0).sum())
        if reachable == 0:
            error("api", "no endpoint reachable (connectivity pre-check)")

    # coverage — exec/report presence summary
    if exp.coverage is None or len(exp.coverage.paths) == 0:
        warn("coverage", "no coverage artifacts")
        counts["coverage_files"] = 0
    else:
        counts["coverage_files"] = len(exp.coverage.paths)
        if int(exp.coverage.lines_total.sum()) == 0:
            error("coverage", "coverage artifacts have zero executable lines")

    return ValidationReport(experiment=exp.name, testbed=exp.testbed,
                            synthetic=exp.synthetic, counts=counts,
                            issues=issues)


def corpus_summary(testbed: str, reports: List[ValidationReport],
                   cache_stats: Optional[dict] = None) -> dict:
    """The corpus-level validation document the CLI emits.

    ``cache_stats`` (anomod_torch.io.cache hit/miss/store/error counters for
    the
    load that produced the corpus) rides along when the corpus came from
    the archived tree — an all-miss load on a supposedly warm cache is
    itself a data-pipeline quality signal worth surfacing."""
    out = {
        "testbed": testbed,
        "ok": all(r.ok for r in reports),
        "reports": [r.to_dict() for r in reports],
    }
    if cache_stats is not None:
        out["ingest_cache"] = dict(cache_stats)
    return out
