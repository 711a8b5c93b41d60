"""The reference's complete metric catalogs, level-keyed, plus window rules
(counterpart of ``anomod/metrics_catalog.py``, of which it is a copy).

Two catalogs, kept name-identical to the reference so artifact trees and
detector features line up file-for-file:

- **SN**: the 24 per-query CSV families written by
  ``SN_collection-scripts/Dataset/metric_data/collect_metric.sh:20-125``
  (one ``<name>.csv`` per PromQL range query; 15 s step, 24 h window,
  ``collect_metric.sh:4-5``).
- **TT**: the anomaly-level-keyed metric groups of
  ``TT_collection-scripts/T-Dataset/metric_collector.py:37-104``
  (performance / service / database categories; entries may be raw metric
  names or ``rate(<name>[5m])`` wrappers) plus the TT-specific kube-state
  queries of ``collect_train_ticket_specific_metrics`` (``:283-303``).

Also implements the reference's experiment-window semantics
(``metric_collector.py:480-525``): app start = earliest pod start time,
clamped to 24 h; 2 h safe window when discovery fails; 1 h on error.

The parity tests (tests/test_metrics_catalog.py for the JAX package,
tests/test_torch_data.py for this copy) hold these constants to the
reference scripts and to each other name for name.
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# SN: per-query CSV families (file stem == CSV name in the artifact tree).
# Grouped exactly like collect_metric.sh's section banners.
# ---------------------------------------------------------------------------

SN_METRIC_FILES: Tuple[str, ...] = (
    # ===== Microservice KPIs (collect_metric.sh:20-41)
    "microservice_request_rate",
    "microservice_latency_p95",
    "microservice_error_rate",
    "post_creation_rate",
    "timeline_read_rate",
    # ===== Container resource usage (:44-59)
    "socialnet_container_cpu",
    "socialnet_container_memory",
    "socialnet_container_network_receive",
    "socialnet_container_network_transmit",
    # ===== Database and cache metrics (:61-73)
    "mongodb_latency_p95",
    "redis_memory_used",
    "redis_command_rate",
    # ===== Jaeger tracing metrics (:75-83)
    "jaeger_spans_rate",
    "jaeger_sampling_rate",
    # ===== Host-level indicators (:85-101)
    "system_cpu_usage",
    "system_memory_usage_percent",
    "system_load1",
    "system_network_errors",
    # ===== Extended performance indicators (:103-125)
    "system_disk_io_time",
    "system_disk_read_bytes",
    "system_disk_write_bytes",
    "system_network_receive_bytes",
    "system_network_transmit_bytes",
    "system_disk_usage_percent",
)

# Families whose PromQL groups by the compose service label — these carry
# per-service fault signal and get one series per service in synth.
SN_PER_SERVICE_FILES: Tuple[str, ...] = (
    "microservice_request_rate", "microservice_latency_p95",
    "microservice_error_rate", "socialnet_container_cpu",
    "socialnet_container_memory", "socialnet_container_network_receive",
    "socialnet_container_network_transmit",
)

# ---------------------------------------------------------------------------
# TT: level-keyed categories — raw entries exactly as the reference lists
# them (metric_collector.py:37-104), including rate() wrappers and the
# deliberate overlaps (node_filesystem_* in performance AND database,
# process_open_fds in service AND database).
# ---------------------------------------------------------------------------

TT_METRIC_CATEGORIES: Dict[str, Tuple[str, ...]] = {
    "performance": (
        "node_cpu_seconds_total",
        "container_cpu_usage_seconds_total",
        "rate(node_cpu_seconds_total[5m])",
        "node_load5",
        "node_memory_MemAvailable_bytes",
        "node_memory_MemTotal_bytes",
        "node_memory_MemFree_bytes",
        "container_memory_usage_bytes",
        "container_memory_working_set_bytes",
        "container_spec_memory_limit_bytes",
        "node_filesystem_avail_bytes",
        "node_filesystem_size_bytes",
        "rate(node_disk_read_bytes_total[5m])",
        "rate(node_disk_written_bytes_total[5m])",
        "node_disk_io_time_seconds_total",
        "node_network_receive_bytes_total",
        "node_network_transmit_bytes_total",
        "node_network_receive_drop_total",
        "node_network_transmit_drop_total",
        "node_network_receive_errs_total",
        "node_network_transmit_errs_total",
        "container_network_receive_errors_total",
        "container_network_transmit_errors_total",
    ),
    "service": (
        "up",
        "http_requests_total",
        "process_open_fds",
        "process_cpu_seconds_total",
        "process_resident_memory_bytes",
        "container_processes",
        "container_memory_failcnt",
        "container_cpu_cfs_throttled_periods_total",
    ),
    "database": (
        "node_filesystem_avail_bytes",
        "node_filesystem_size_bytes",
        "volume_manager_total_volumes",
        "process_open_fds",
        "process_max_fds",
    ),
}

# TT-specific kube-state queries (metric_collector.py:283-303).
TT_SPECIFIC_QUERIES: Tuple[str, ...] = (
    'kube_pod_status_phase{namespace="default"}',
    'rate(container_cpu_usage_seconds_total{namespace="default"}[5m])',
    'container_memory_usage_bytes{namespace="default"}',
    'rate(container_network_receive_bytes_total{namespace="default"}[5m])',
    'rate(container_network_transmit_bytes_total{namespace="default"}[5m])',
    'kube_pod_container_status_restarts_total{namespace="default"}',
    'kubelet_volume_stats_used_bytes{namespace="default"}',
    'up{job="kubernetes-pods"}',
)

_WRAP_RE = re.compile(r"^rate\((?P<name>[A-Za-z_:][\w:]*)"
                      r"(?:\{[^}]*\})?\[[^\]]+\]\)$")
_SELECTOR_RE = re.compile(r"^(?P<name>[A-Za-z_:][\w:]*)(?:\{[^}]*\})?$")


def normalize_metric_name(entry: str) -> str:
    """Catalog entry -> base metric name: strips rate(...[5m]) wrappers and
    {label} selectors, so 'rate(node_cpu_seconds_total[5m])' and
    'node_cpu_seconds_total' key the same long-CSV series family."""
    m = _WRAP_RE.match(entry) or _SELECTOR_RE.match(entry)
    if not m:
        raise ValueError(f"unparseable catalog entry: {entry!r}")
    return m.group("name")


def _dedup(seq) -> Tuple[str, ...]:
    seen: Dict[str, None] = {}
    for s in seq:
        seen.setdefault(s)
    return tuple(seen)


#: Deduped union of base names across the three level groups — what the
#: experiment-mode long CSV carries one series family per
#: (metric_collector.py:400-478 iterates the category lists).
TT_METRIC_NAMES: Tuple[str, ...] = _dedup(
    normalize_metric_name(e)
    for group in TT_METRIC_CATEGORIES.values() for e in group)

#: Base names of the TT-specific kube-state mode.
TT_SPECIFIC_METRICS: Tuple[str, ...] = _dedup(
    normalize_metric_name(q) for q in TT_SPECIFIC_QUERIES)

#: Everything the TT synth/loader plane models: level groups + kube-state.
TT_ALL_METRIC_NAMES: Tuple[str, ...] = _dedup(
    (*TT_METRIC_NAMES, *TT_SPECIFIC_METRICS))

#: Deduped RAW query strings (rate() wrappers and selectors intact) across
#: the level groups + kube-state — what a live collection actually sends to
#: Prometheus (metric_collector.py:421-425 iterates these, and each row's
#: ``metric_name`` is the raw query).
TT_ALL_QUERIES: Tuple[str, ...] = _dedup(
    (*(e for group in TT_METRIC_CATEGORIES.values() for e in group),
     *TT_SPECIFIC_QUERIES))

# Per-service (per-pod/container) TT families — carry per-service series.
TT_PER_SERVICE_METRICS: Tuple[str, ...] = (
    "container_cpu_usage_seconds_total", "container_memory_usage_bytes",
    "container_memory_working_set_bytes", "container_spec_memory_limit_bytes",
    "container_network_receive_errors_total",
    "container_network_transmit_errors_total",
    "up", "http_requests_total", "process_open_fds",
    "process_cpu_seconds_total", "process_resident_memory_bytes",
    "container_processes", "container_memory_failcnt",
    "container_cpu_cfs_throttled_periods_total", "process_max_fds",
    "kube_pod_status_phase", "kube_pod_container_status_restarts_total",
    "container_network_receive_bytes_total",
    "container_network_transmit_bytes_total",
    "kubelet_volume_stats_used_bytes",
)


def metrics_for_level(level: str) -> Tuple[str, ...]:
    """Normalized metric names for one anomaly level ('performance' /
    'service' / 'database') — the level-keyed grouping the detector's
    per-level metric features use."""
    return _dedup(normalize_metric_name(e)
                  for e in TT_METRIC_CATEGORIES[level])


# SN level grouping (by collect_metric.sh section): the detector's per-level
# features need the same keying on SN artifacts.
SN_LEVEL_FILES: Dict[str, Tuple[str, ...]] = {
    "performance": (
        "socialnet_container_cpu", "socialnet_container_memory",
        "system_cpu_usage", "system_memory_usage_percent", "system_load1",
        "system_disk_io_time", "system_disk_read_bytes",
        "system_disk_write_bytes", "system_network_receive_bytes",
        "system_network_transmit_bytes", "system_network_errors",
        "system_disk_usage_percent",
    ),
    "service": (
        "microservice_request_rate", "microservice_latency_p95",
        "microservice_error_rate", "post_creation_rate",
        "timeline_read_rate", "socialnet_container_network_receive",
        "socialnet_container_network_transmit", "jaeger_spans_rate",
        "jaeger_sampling_rate",
    ),
    "database": (
        "mongodb_latency_p95", "redis_memory_used", "redis_command_rate",
    ),
}


def level_metric_names(testbed: str, level: str) -> Tuple[str, ...]:
    return (SN_LEVEL_FILES[level] if testbed == "SN"
            else metrics_for_level(level))


def experiment_window(pod_start_times: Optional[Sequence[float]],
                      now_s: float,
                      discovery_failed: bool = False) -> Tuple[float, float]:
    """(start_s, end_s) of the metric collection window — the reference's
    app-start discovery + clamp semantics (metric_collector.py:480-525):

    - earliest pod start time, clamped to at most 24 h before now;
    - a 2 h "safe window" when discovery returns nothing;
    - a 1 h fallback on discovery error (``discovery_failed=True``).
    """
    if discovery_failed:
        return now_s - 3600.0, now_s
    if not pod_start_times:
        return now_s - 2 * 3600.0, now_s
    start = min(float(t) for t in pod_start_times)
    start = max(start, now_s - 24 * 3600.0)
    return start, now_s


def fmt_window(start_s: float, end_s: float) -> str:
    """Human-readable window line for metadata.txt artifacts."""
    f = lambda t: datetime.datetime.fromtimestamp(t).isoformat()
    return f"{f(start_s)} .. {f(end_s)}"
