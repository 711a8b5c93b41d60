"""anomod_torch.obs: the port's self-scraping telemetry plane
(counterpart of ``anomod/obs``).

A process-wide metrics registry (Counter / Gauge / host t-digest
Histogram, :mod:`anomod_torch.obs.registry`), two exporters (Prometheus
text and the port's own MetricBatch / TT-CSV, :mod:`~.export`), the
dogfood loop that scores a run's own telemetry through the detector
stack (:mod:`~.selfscrape`) and the localhost ``/metrics`` endpoint
(:mod:`~.http`).

Instrumented call sites use the module-level helpers::

    from anomod_torch import obs
    obs.counter("anomod_ingest_cache_hits_total").inc()
    obs.gauge("anomod_serve_backlog_spans").set(depth)
    obs.histogram("anomod_serve_tick_seconds").observe(wall)

Handles are memoized by (name, labels); with ``ANOMOD_OBS_ENABLED=0``
every helper returns a shared no-op handle.
"""

from anomod_torch.obs.registry import (NULL, Counter, Gauge, Histogram,
                                       Registry, get_registry, render_labels,
                                       set_registry, subsystem_of)

__all__ = ["NULL", "Counter", "Gauge", "Histogram", "Registry",
           "get_registry", "set_registry", "render_labels", "subsystem_of",
           "counter", "gauge", "histogram", "scrape"]


def counter(name: str, **labels) -> Counter:
    return get_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return get_registry().gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return get_registry().histogram(name, **labels)


def scrape(now_s=None) -> int:
    return get_registry().scrape(now_s)
