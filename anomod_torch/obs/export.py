"""Registry exporters: the Prometheus text format and the port's own
shapes (counterpart of ``anomod/obs/export.py``; byte-equal output for a
registry driven by the same calls).

- :func:`to_prometheus_text` renders the point-in-time state in the
  Prometheus exposition format (``# HELP`` / ``# TYPE`` a family;
  t-digest histograms as summaries with ``quantile`` labels).
- :func:`to_metric_batch` / :func:`export_tt_csv` materialize the scrape
  JOURNAL as the port's ``MetricBatch`` / TT long-CSV shapes
  (``write_metric_batch_tt_csv`` out, ``load_tt_metric_csv`` back), which
  closes the dogfood loop (:mod:`anomod_torch.obs.selfscrape`).

Both file exports publish atomically (same-directory tmp +
``os.replace``), so a killed run never leaves a truncated capture.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from anomod_torch.obs.registry import Registry, subsystem_of


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render bare."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def escape_label_value(value: str) -> str:
    """Label-value escaping per the exposition-format grammar: inside
    the double quotes, backslash, double-quote and line-feed must render
    as ``\\\\``, ``\\"`` and ``\\n`` — in that order (escaping the
    escape character first, or a value containing ``\\n`` literally
    would round-trip as a newline)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def escape_help_text(text: str) -> str:
    """HELP-line escaping: only backslash and line-feed (the grammar
    leaves double quotes alone outside label position)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def render_prom_labels(labels: Dict[str, str]) -> str:
    """Labels rendered for the exposition format — the escaping twin of
    :func:`anomod_torch.obs.registry.render_labels` (which stays unescaped on
    purpose: its output is the registry's internal series key and the
    TT-CSV export's label string, where a ``\\n`` is just a character).
    Only the text format has a grammar that ``\\``/``"``/newline can
    break out of, so only this renderer escapes."""
    return ",".join(f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))


def _help_for(m) -> str:
    """One HELP line per metric family: the subsystem token plus the
    kind — derived, so every family (including ones added after this
    writing) gets a parseable, truthful HELP line without a hand-kept
    catalog that would rot."""
    return escape_help_text(
        f"anomod {subsystem_of(m.name)}-subsystem {m.kind}")


def to_prometheus_text(registry: Registry) -> str:
    """Point-in-time registry state in the Prometheus text format
    (``# HELP`` + ``# TYPE`` per family, label values escaped per the
    exposition-format grammar)."""
    lines: List[str] = []
    seen: set = set()
    for m in sorted(registry.metrics(),
                    key=lambda m: (m.name, render_prom_labels(m.labels))):
        base = render_prom_labels(m.labels)
        brace = f"{{{base}}}" if base else ""
        # HELP/TYPE are once per metric FAMILY (the grammar allows one
        # each per name): label variants of one name — e.g. the
        # shard-labeled gauge twins — share the header their sorted
        # grouping puts first
        if m.name not in seen:
            seen.add(m.name)
            lines.append(f"# HELP {m.name} {_help_for(m)}")
            lines.append(f"# TYPE {m.name} "
                         f"{'summary' if m.kind == 'histogram' else m.kind}")
        if m.kind == "histogram":
            # t-digest histograms export as Prometheus SUMMARIES: the
            # sketch stores quantiles, not cumulative bucket counts
            p50 = m.quantile(0.5)
            if p50 is not None:
                for q, v in (("0.5", p50), ("0.99", m.quantile(0.99))):
                    ql = render_prom_labels({**m.labels, "quantile": q})
                    lines.append(f"{m.name}{{{ql}}} {_fmt(v)}")
            lines.append(f"{m.name}_sum{brace} {_fmt(m.sum)}")
            lines.append(f"{m.name}_count{brace} {_fmt(m.count)}")
        else:
            lines.append(f"{m.name}{brace} {_fmt(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_metric_batch(registry: Registry):
    """The scrape journal as a ``MetricBatch``.

    Services are the metric-name subsystems (``anomod_serve_...`` ->
    ``serve``) and every series key carries a ``service="<subsystem>"``
    label alongside the metric's own labels, so the batch drops straight
    into ``MultimodalDetector.push_metrics`` with correct per-service
    attribution — no re-derivation needed on the direct (non-CSV) path.
    """
    return rows_to_metric_batch(registry.journal())


def rows_to_metric_batch(rows):
    """Journal-shaped rows ``(t_s, sample_name, labels_str, value)`` ->
    ``MetricBatch``: the row-level core of :func:`to_metric_batch`, shared
    by the live feed (:mod:`anomod_torch.serve.feed`) for rows scraped
    off an endpoint."""
    from anomod_torch.schemas import MetricBatch
    metric_names: Dict[str, int] = {}
    series_keys: Dict[str, int] = {}
    services: Dict[str, int] = {}
    series_service: List[int] = []
    n = len(rows)
    metric_c = np.zeros(n, np.int32)
    series_c = np.zeros(n, np.int32)
    t_c = np.zeros(n, np.float64)
    v_c = np.zeros(n, np.float64)
    for i, (t_s, name, labels_str, value) in enumerate(rows):
        metric_c[i] = metric_names.setdefault(name, len(metric_names))
        sub = subsystem_of(name)
        key = f'service="{sub}"' + (f",{labels_str}" if labels_str else "")
        if key not in series_keys:
            series_keys[key] = len(series_keys)
            series_service.append(
                services.setdefault(sub, len(services)))
        series_c[i] = series_keys[key]
        t_c[i] = t_s
        v_c[i] = value
    return MetricBatch(
        metric=metric_c, series=series_c, t_s=t_c, value=v_c,
        metric_names=tuple(metric_names), series_keys=tuple(series_keys),
        series_service=np.asarray(series_service or [0],
                                  np.int32)[:len(series_keys)],
        services=tuple(services))


def export_prometheus_text(registry: Registry, path) -> int:
    """Write the point-in-time Prometheus text view (atomic publish);
    returns the number of metrics rendered."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        tmp.write_text(to_prometheus_text(registry))
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return len(registry.metrics())


def export_tt_csv(registry: Registry, path) -> int:
    """Write the scrape journal in the TT long-CSV shape (atomic publish);
    returns the number of samples written.

    The file round-trips through
    ``anomod_torch.io.metrics.load_tt_metric_csv``, the self-scrape
    contract the scorer (:mod:`anomod_torch.obs.selfscrape`) relies on."""
    from anomod_torch.io.metrics import write_metric_batch_tt_csv
    batch = to_metric_batch(registry)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        write_metric_batch_tt_csv(batch, tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return batch.n_samples
