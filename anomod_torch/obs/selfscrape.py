"""Self-scrape scoring: the port's telemetry through its own detector
(counterpart of ``anomod/obs/selfscrape.py``).

A run's registry journal exports to TT-CSV (``anomod_torch.obs.export``),
loads back through ``load_tt_metric_csv`` and scores through the
unchanged ``OnlineDetector``: each metric subsystem (``serve``,
``ingest``, ``stream``, ``prefetch``...) plays a monitored service, and a
serve-plane stall surfaces the way a slow microservice would: its
latency-shaped samples jump, the subsystem's z_latency crosses the
threshold, and an alert names ``serve``.  The detector's chunk fold is
the dense replay kernel on the card (``device``, ``cuda`` unless the
caller asks for ``cpu``).

The metric->span mapping (:func:`spans_from_metrics`), the JAX
package's:

- service  = the metric name's subsystem token,
- endpoint = the metric name,
- duration = the sample value, first differenced per series for
  cumulative ``*_total`` / ``_count`` / ``_sum`` streams, then normalized
  to each series' own early-sample scale (one subsystem pools metrics
  whose magnitudes span orders).

Flat telemetry is not evidence: what alerts is change.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from anomod_torch.device import DeviceLike
from anomod_torch.obs.registry import Registry, set_registry, subsystem_of
from anomod_torch.schemas import KIND_LOCAL, SpanBatch, empty_span_batch


def spans_from_metrics(batch) -> SpanBatch:
    """Synthesize a SpanBatch from a telemetry MetricBatch.

    One span per (finite-valued) sample; see the module docstring for the
    field mapping.  Returns an empty batch when nothing maps.
    """
    n = batch.n_samples
    if n == 0:
        return empty_span_batch()
    names = batch.metric_names
    subsystems: Dict[str, int] = {}
    svc_of_metric = np.zeros(len(names), np.int32)
    counter_like = np.zeros(len(names), bool)
    for i, name in enumerate(names):
        svc_of_metric[i] = subsystems.setdefault(
            subsystem_of(name), len(subsystems))
        # cumulative shapes (counters + histogram count/sum streams)
        counter_like[i] = name.endswith(("_total", "_count", "_sum"))
    finite = np.isfinite(batch.value)
    value = np.where(finite, batch.value, 0.0).astype(np.float64)
    keep = finite.copy()
    # cumulative counters -> per-scrape deltas, per (metric, series) run
    # (journal rows are appended in scrape order, so a stable sort by
    # series+metric keeps each run's time order)
    combo = batch.series.astype(np.int64) * len(names) + batch.metric
    if counter_like.any():
        order = np.argsort(combo, kind="stable")
        cv = combo[order]
        vals = value[order]
        is_ctr = counter_like[batch.metric[order]]
        first = np.ones(len(order), bool)
        first[1:] = cv[1:] != cv[:-1]
        delta = np.empty_like(vals)
        delta[0] = vals[0]
        delta[1:] = vals[1:] - vals[:-1]
        new_vals = np.where(is_ctr, np.maximum(delta, 0.0), vals)
        drop_first = is_ctr & first      # no previous sample to diff from
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        value = new_vals[inv]
        keep &= ~drop_first[inv]
    if not keep.any():
        return empty_span_batch()
    m_idx = batch.metric[keep]
    vals_k = value[keep].copy()
    combo_k = combo[keep]
    # Per-series scale normalization: one subsystem pools metrics whose
    # absolute magnitudes span orders (bytes vs seconds vs counts), and
    # the detector's pooled per-service log-latency variance would
    # swallow any single series' shift.  Each series is rescaled to the
    # median of its first few samples — a healthy series sits near
    # 1e6 "µs" and a 30x stall is a 30x jump on a near-constant
    # baseline, which is exactly the shape z_latency is built for.
    # A series whose early samples are all ~0 (e.g. shed counters before
    # overload) keeps its raw value against the 1e6 anchor: any later
    # activity is then a large positive shift, which is the right read.
    for cv in np.unique(combo_k):
        rows = np.nonzero(combo_k == cv)[0]
        scale = float(np.median(np.abs(vals_k[rows[:5]])))
        vals_k[rows] = vals_k[rows] / scale if scale > 1e-12 \
            else vals_k[rows]
    dur = np.maximum(np.round(vals_k * 1e6), 0.0).astype(np.int64)
    start = np.round(batch.t_s[keep] * 1e6).astype(np.int64)
    order = np.argsort(start, kind="stable")
    n_k = int(keep.sum())
    return SpanBatch(
        trace=np.arange(n_k, dtype=np.int32)[order],
        parent=np.full(n_k, -1, np.int32),
        service=svc_of_metric[m_idx][order],
        endpoint=m_idx.astype(np.int32)[order],
        start_us=start[order], duration_us=dur[order],
        is_error=np.zeros(n_k, np.bool_),
        status=np.zeros(n_k, np.int16),
        kind=np.full(n_k, KIND_LOCAL, np.int8),
        services=tuple(subsystems), endpoints=tuple(names),
        trace_ids=tuple(f"t{i:06x}" for i in range(n_k)),
    ).validate()


def score_self_scrape(source, window_s: float = 5.0,
                      baseline_windows: int = 4, z_threshold: float = 4.0,
                      min_count: float = 3.0, n_windows: int = 64,
                      consecutive: int = 1, device: DeviceLike = None,
                      **detector_kw) -> dict:
    """Score a self-scrape capture with the port's own detector on
    ``device``.

    ``source`` is a TT-CSV path (loaded through ``load_tt_metric_csv``,
    the round-trip contract) or a MetricBatch.  ``detector_kw`` reach the
    detector (``replay_factory`` swaps its chunk fold).  Returns a
    JSON-able report: per-subsystem alert timeline + verdict.
    """
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.stream import stream_experiment
    if isinstance(source, (str, Path)):
        from anomod_torch.io.metrics import load_tt_metric_csv
        batch = load_tt_metric_csv(Path(source))
        if batch is None:
            raise ValueError(f"not a loadable TT metric CSV: {source}")
    else:
        batch = source
    spans = spans_from_metrics(batch)
    out = {
        "n_samples": int(batch.n_samples),
        "n_metrics": len(batch.metric_names),
        "subsystems": list(spans.services),
        "window_seconds": window_s,
        "n_alerts": 0,
        "alerted_subsystems": [],
        "alerts": [],
    }
    if spans.n_spans == 0:
        return out
    cfg = ReplayConfig(n_services=spans.n_services, n_windows=n_windows,
                       window_us=int(window_s * 1e6), chunk_size=1024)
    # telemetry spans carry no parent links — the edge plane would only
    # triple the replay rows for zero evidence
    det = stream_experiment(spans, cfg=cfg, slice_s=window_s,
                            baseline_windows=baseline_windows,
                            z_threshold=z_threshold, min_count=min_count,
                            consecutive=consecutive,
                            edge_attribution=False, device=device,
                            **detector_kw)
    alerted = sorted({a.service_name for a in det.alerts})
    out.update(
        n_alerts=len(det.alerts),
        alerted_subsystems=alerted,
        ranked_subsystems=det.ranked_services()[:5],
        alerts=[{"window": a.window, "subsystem": a.service_name,
                 "score": round(a.score, 3),
                 "z_latency": round(a.z_latency, 3),
                 "z_drop_cum": round(a.z_drop_cum, 3),
                 "evidence": a.evidence} for a in det.alerts[:50]])
    return out


def stalled_registry(stall_after_s: float = 140.0, end_s: float = 200.0,
                     registry=None):
    """The self-scrape's known-answer input (the JAX package's
    injected-stall timeline): one scrape a second of healthy serve
    telemetry, then tick walls, admit-to-scored latency and queue depth
    30x and the served counter flat from ``stall_after_s`` on.  Fills
    ``registry`` (a fresh enabled one when None) and returns it; scored
    with ``window_s=10`` it alerts on ``serve`` alone, at or after the
    stall's window."""
    reg = registry if registry is not None else \
        Registry(enabled=True, max_samples=100_000)
    tick = reg.histogram("anomod_serve_tick_seconds")
    lat = reg.histogram("anomod_serve_admit_to_scored_seconds")
    backlog = reg.gauge("anomod_serve_backlog_spans")
    served = reg.counter("anomod_serve_served_spans_total")
    rng = np.random.default_rng(7)
    for t in range(int(end_s)):
        scale = 30.0 if t >= stall_after_s else 1.0
        tick.observe(float(rng.uniform(0.009, 0.011) * scale))
        lat.observe(float(rng.uniform(0.4, 0.6) * scale))
        backlog.set(float(rng.uniform(900, 1100) * scale))
        served.inc(0 if t >= stall_after_s else 500)
        reg.scrape(now_s=float(t))
    return reg


def report_gap(got: dict, want: dict) -> Optional[float]:
    """How far two self-scrape reports are apart: None when any field
    but the alerts' ``score`` / ``z_latency`` / ``z_drop_cum`` differs
    (the alert windows, subsystems and evidence included), else the
    largest gap of those values, relative to ``max(|want|, 1)``.  A
    near-constant series' log-latency variance is a small difference of
    f32 moment sums, so folds that add the same rows in another order
    agree on every alert but move its z-score."""
    def strip(r):
        return {k: v for k, v in r.items() if k != "alerts"}

    def key(a):
        return (a["window"], a["subsystem"], a["evidence"])
    if strip(got) != strip(want) or \
            [key(a) for a in got["alerts"]] != [key(a) for a in want["alerts"]]:
        return None
    return max((abs(a[f] - b[f]) / max(abs(b[f]), 1.0)
                for a, b in zip(got["alerts"], want["alerts"])
                for f in ("score", "z_latency", "z_drop_cum")), default=0.0)


def self_exercise(duration_s: float = 20.0, n_tenants: int = 24,
                  capacity_spans_per_s: float = 4000.0, seed: int = 0,
                  registry=None, tracer=None, device: DeviceLike = None):
    """Drive a short seeded serve run on ``device`` with telemetry on and
    return the registry that observed it: the ``obs`` CLI's way to
    produce a snapshot or export from a fresh process.  Swaps the given
    (or a fresh, force-enabled) registry in as the process default for
    the run, then restores the previous one.  ``tracer`` (when given)
    rides the engine, so the same exercise feeds the span exporters."""
    reg = registry if registry is not None else Registry(enabled=True)
    prev = set_registry(reg)
    try:
        from anomod_torch.serve.engine import run_power_law
        run_power_law(n_tenants=n_tenants, n_services=8,
                      capacity_spans_per_s=capacity_spans_per_s,
                      overload=1.5, duration_s=duration_s, tick_s=0.5,
                      seed=seed, window_s=5.0, baseline_windows=2,
                      fault_tenants=1, tracer=tracer, device=device)
    finally:
        set_registry(prev)
    return reg
