"""Offline anomaly detection + root-cause ranking (counterpart of
``anomod/detect.py``).

Per-service p99-latency inflation fused with span, log and API error
rates, metric levels and coverage shift, scored against the normal
baseline; top-k hit-rate of the culprit service over a testbed's fault
experiments, plus experiment-level detection accuracy.

Feature extraction runs on the host.  The score is one expression over
two ``[S, F]`` feature matrices, written twice: :func:`service_scores_numpy`
(the oracle, BASELINE.json config 1) and :func:`service_scores` (torch, on
the card by default).  :func:`evaluate_corpus` runs the torch version on
``cuda`` and the numpy oracle when the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from anomod_torch import labels as labels_mod
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.graph import service_stats
from anomod_torch.metrics_catalog import level_metric_names
from anomod_torch.schemas import LOG_ERROR, Experiment


class ServiceFeatures(NamedTuple):
    """Per-service feature matrix for one experiment — fixed [S, F] shape."""
    services: Tuple[str, ...]
    x: np.ndarray  # float32 [S, F]


FEATURES = ("lat_p99_log", "lat_p50_log", "err_rate", "log_err_rate",
            "span_count_log", "lat_mean_log", "metric_level_log",
            "api_err_rate", "api_lat_log", "coverage_ratio",
            # level-keyed metric features: mean log-level of the series
            # whose metric family belongs to each anomaly-level group
            "metric_perf_log", "metric_service_log", "metric_db_log")

_LEVEL_FEATURES = ("performance", "service", "database")  # cols 10..12


def extract_features(exp: Experiment,
                     services: Tuple[str, ...]) -> ServiceFeatures:
    """[S, F] features over all five modalities: spans, logs, metrics, API
    responses (per-endpoint stats attributed to the owning service via the
    gateway route tables), and code coverage (per-service line ratio)."""
    S = len(services)
    svc_index = {s: i for i, s in enumerate(services)}
    st = service_stats(exp.spans, services) if exp.spans is not None else None
    x = np.zeros((S, len(FEATURES)), np.float32)
    if st is not None:
        x[:, 0] = np.log1p(st.lat_p99_us)
        x[:, 1] = np.log1p(st.lat_p50_us)
        x[:, 2] = st.err_rate
        x[:, 4] = np.log1p(st.count)
        x[:, 5] = np.log1p(st.lat_mean_us)
    if exp.logs is not None:
        remap = np.array([svc_index.get(s, -1) for s in exp.logs.services]
                         or [-1], np.int32)
        svc = remap[exp.logs.service]
        keep = svc >= 0
        tot = np.zeros(S, np.int64)
        err = np.zeros(S, np.int64)
        np.add.at(tot, svc[keep], 1)
        np.add.at(err, svc[keep],
                  (exp.logs.level[keep] == LOG_ERROR).astype(np.int64))
        with np.errstate(invalid="ignore"):
            x[:, 3] = np.where(tot > 0, err / np.maximum(tot, 1), 0.0)
    if exp.metrics is not None and len(exp.metrics.services):
        m = exp.metrics
        # mean log-level of all series attributed to each service
        series_to_svc = np.array(
            [svc_index.get(m.services[s] if s >= 0 else "", -1)
             for s in m.series_service], np.int32)
        sample_svc = series_to_svc[m.series]
        keep = (sample_svc >= 0) & np.isfinite(m.value)
        logv = np.log1p(np.abs(np.where(np.isfinite(m.value), m.value, 0.0)))
        tot = np.zeros(S, np.float64)
        cnt = np.zeros(S, np.int64)
        np.add.at(tot, sample_svc[keep], logv[keep])
        np.add.at(cnt, sample_svc[keep], 1)
        with np.errstate(invalid="ignore"):
            x[:, 6] = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)
        # level-keyed means over the catalog's anomaly-level groups
        for li, level in enumerate(_LEVEL_FEATURES):
            names = set(level_metric_names(exp.testbed, level))
            in_level = np.array([n in names for n in m.metric_names], np.bool_)
            keep_l = keep & in_level[m.metric]
            tot_l = np.zeros(S, np.float64)
            cnt_l = np.zeros(S, np.int64)
            np.add.at(tot_l, sample_svc[keep_l], logv[keep_l])
            np.add.at(cnt_l, sample_svc[keep_l], 1)
            with np.errstate(invalid="ignore"):
                x[:, 10 + li] = np.where(cnt_l > 0,
                                         tot_l / np.maximum(cnt_l, 1), 0.0)
    if exp.api is not None and exp.api.n_records:
        from anomod_torch.suite import endpoint_owner
        owner = np.array([svc_index.get(endpoint_owner(e, exp.testbed), -1)
                          for e in exp.api.endpoints], np.int32)
        rec_svc = owner[exp.api.endpoint]
        keep = rec_svc >= 0
        tot = np.zeros(S, np.int64)
        err = np.zeros(S, np.int64)
        lat = np.zeros(S, np.float64)
        np.add.at(tot, rec_svc[keep], 1)
        np.add.at(err, rec_svc[keep],
                  (exp.api.status[keep] >= 500).astype(np.int64))
        np.add.at(lat, rec_svc[keep], np.log1p(exp.api.latency_ms[keep]))
        with np.errstate(invalid="ignore"):
            x[:, 7] = np.where(tot > 0, err / np.maximum(tot, 1), 0.0)
            x[:, 8] = np.where(tot > 0, lat / np.maximum(tot, 1), 0.0)
    if exp.coverage is not None and len(exp.coverage.services):
        ratio = exp.coverage.service_ratio()
        for ci, svc in enumerate(exp.coverage.services):
            si = svc_index.get(svc, -1)
            if si >= 0:
                x[si, 9] = ratio[ci]
    return ServiceFeatures(services=services, x=x)


# Score weights: latency inflation, error-rate delta, log-error delta,
# per-service metric level rise, API error/latency deltas, coverage shift.
_W_LAT, _W_ERR, _W_LOG, _W_MET = 1.0, 4.0, 2.0, 0.5
_W_API_ERR, _W_API_LAT, _W_COV = 2.0, 0.5, 1.0


def service_scores_numpy(feat: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Anomaly score per service vs the normal-baseline feature matrix
    (the numpy oracle; float32 in, float32 out).

    score = conf * (w_lat * log-p99 inflation + w_err * d_err_rate)
            + w_log * d_log_err + w_met * (d_metric + d_level_metrics)
            + w_api_err * d_api_err + w_api_lat * d_api_lat
            + w_cov * |d_coverage|

    ``conf = n / (n + 20)`` shrinks the span evidence of a service with
    few spans (``n`` from feature column 4, log1p of the span count).  The
    API latency and coverage columns are absolute levels, so each is gated
    on its modality being present in BOTH matrices.
    """
    feat = np.asarray(feat)
    base = np.asarray(base)
    lat_infl = np.clip(feat[:, 0] - base[:, 0], 0.0, None)
    d_err = np.clip(feat[:, 2] - base[:, 2], 0.0, None)
    d_log = np.clip(feat[:, 3] - base[:, 3], 0.0, None)
    d_met = np.clip(feat[:, 6] - base[:, 6], 0.0, None)
    has_api = (np.max(feat[:, 8]) > 0) & (np.max(base[:, 8]) > 0)
    has_cov = (np.max(feat[:, 9]) > 0) & (np.max(base[:, 9]) > 0)
    d_api_err = np.clip(feat[:, 7] - base[:, 7], 0.0, None) * has_api
    d_api_lat = np.clip(feat[:, 8] - base[:, 8], 0.0, None) * has_api
    d_cov = np.abs(feat[:, 9] - base[:, 9]) * has_cov
    d_lvl = np.sum(np.clip(feat[:, 10:13] - base[:, 10:13], 0.0, None),
                   axis=-1)
    n = np.expm1(feat[:, 4])
    conf = n / (n + 20.0)
    return (conf * (_W_LAT * lat_infl + _W_ERR * d_err)
            + _W_LOG * d_log + _W_MET * d_met + _W_MET * d_lvl
            + _W_API_ERR * d_api_err + _W_API_LAT * d_api_lat
            + _W_COV * d_cov)


def service_scores(feat, base, device: DeviceLike = None) -> torch.Tensor:
    """:func:`service_scores_numpy`'s expression in torch, on ``device``
    (``cuda`` unless the caller passes ``cpu``): float32 ``[S]``."""
    dev = resolve_device(device)
    feat = torch.as_tensor(np.asarray(feat, np.float32), device=dev)
    base = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    lat_infl = (feat[:, 0] - base[:, 0]).clamp(min=0.0)
    d_err = (feat[:, 2] - base[:, 2]).clamp(min=0.0)
    d_log = (feat[:, 3] - base[:, 3]).clamp(min=0.0)
    d_met = (feat[:, 6] - base[:, 6]).clamp(min=0.0)
    has_api = (feat[:, 8].max() > 0) & (base[:, 8].max() > 0)
    has_cov = (feat[:, 9].max() > 0) & (base[:, 9].max() > 0)
    d_api_err = (feat[:, 7] - base[:, 7]).clamp(min=0.0) * has_api
    d_api_lat = (feat[:, 8] - base[:, 8]).clamp(min=0.0) * has_api
    d_cov = (feat[:, 9] - base[:, 9]).abs() * has_cov
    d_lvl = (feat[:, 10:13] - base[:, 10:13]).clamp(min=0.0).sum(dim=-1)
    n = torch.expm1(feat[:, 4])
    conf = n / (n + 20.0)
    return (conf * (_W_LAT * lat_infl + _W_ERR * d_err)
            + _W_LOG * d_log + _W_MET * d_met + _W_MET * d_lvl
            + _W_API_ERR * d_api_err + _W_API_LAT * d_api_lat
            + _W_COV * d_cov)


def experiment_score(scores) -> float:
    """Experiment-level anomaly score = max service score."""
    if torch.is_tensor(scores):
        scores = scores.cpu().numpy()
    return float(np.max(scores)) if np.size(scores) else 0.0


@dataclasses.dataclass
class DetectionResult:
    experiment: str
    is_anomaly_true: bool
    score: float
    ranked_services: List[str]       # descending culprit likelihood
    target_service: str

    def hit(self, k: int) -> Optional[bool]:
        if not self.target_service:
            return None  # host-level fault: no single culprit service
        return self.target_service in self.ranked_services[:k]


@dataclasses.dataclass
class EvalSummary:
    top1: float
    top3: float
    top5: float
    detection_accuracy: float
    n_rca_cases: int
    results: List[DetectionResult]


def evaluate_corpus(experiments: Sequence[Experiment],
                    device: DeviceLike = None,
                    threshold: float = 0.35) -> EvalSummary:
    """Run the detector over a testbed's corpus; evaluate against the chaos
    labels.  Scores come from :func:`service_scores` on ``device``
    (``cuda`` by default) or, with ``device="cpu"``, from the numpy oracle
    :func:`service_scores_numpy`."""
    dev = resolve_device(device)
    normal = next(e for e in experiments
                  if labels_mod.label_for(e.name).anomaly_level == "normal")
    # pinned service set: union across corpus, stable order
    services: Dict[str, None] = {}
    for e in experiments:
        if e.spans is not None:
            for s in e.spans.services:
                services.setdefault(s)
    services = tuple(services)

    base = extract_features(normal, services).x
    results: List[DetectionResult] = []
    for e in experiments:
        label = labels_mod.label_for(e.name)
        feat = extract_features(e, services).x
        if dev.type == "cpu":
            scores = service_scores_numpy(feat, base)
        else:
            scores = service_scores(feat, base, dev).cpu().numpy()
        order = np.argsort(-scores, kind="stable")
        results.append(DetectionResult(
            experiment=e.name,
            is_anomaly_true=label.is_anomaly,
            score=experiment_score(scores),
            ranked_services=[services[i] for i in order],
            target_service=label.target_service,
        ))

    det_correct = sum((r.score > threshold) == r.is_anomaly_true
                      for r in results)
    rca = [r for r in results if r.is_anomaly_true and r.target_service]

    def rate(k: int) -> float:
        return (sum(bool(r.hit(k)) for r in rca) / len(rca)) if rca else 0.0
    return EvalSummary(top1=rate(1), top3=rate(3), top5=rate(5),
                       detection_accuracy=det_correct / len(results),
                       n_rca_cases=len(rca), results=results)


def per_level_breakdown(summary: EvalSummary) -> Dict[str, Dict[str, float]]:
    """Top-1/top-3 hit-rates split by anomaly level (performance/service/
    database/code) — the granularity of the fault taxonomy."""
    out: Dict[str, Dict[str, float]] = {}
    for level in ("performance", "service", "database", "code"):
        rs = [r for r in summary.results
              if r.is_anomaly_true and r.target_service
              and labels_mod.label_for(r.experiment).anomaly_level == level]
        if not rs:
            continue
        out[level] = {
            "n": len(rs),
            "top1": sum(bool(r.hit(1)) for r in rs) / len(rs),
            "top3": sum(bool(r.hit(3)) for r in rs) / len(rs),
        }
    return out
