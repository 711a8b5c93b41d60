"""The port's multimodal online detector against the JAX package's, on
the CPU.

Same experiment bundles (the generators are byte-identical), same slices:
``(window, service, evidence)`` alert lists, ranked services, first-alert
windows and the per-(caller, callee) pair accumulators are identical,
alert scores within ``rtol=1e-4`` (the span planes are f32 sums in
another order; the modality planes are the same host numpy).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from anomod import labels as jlabels
from anomod import stream as jstream
from anomod import synth as jsynth
from anomod_torch import labels as tlabels
from anomod_torch import stream as tstream
from anomod_torch import synth as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_detector(tdet, jdet):
    key = [(a.window, a.service, a.evidence) for a in jdet.alerts]
    assert [(a.window, a.service, a.evidence) for a in tdet.alerts] == key
    np.testing.assert_allclose([a.score for a in tdet.alerts],
                               [a.score for a in jdet.alerts], rtol=1e-4)
    assert tdet.ranked_services() == jdet.ranked_services()
    assert tdet.first_alert_window() == jdet.first_alert_window()
    assert tdet._pair_base == jdet._pair_base
    assert tdet._pair_anom == jdet._pair_anom
    assert tdet.n_spans_in == jdet.n_spans_in


@pytest.mark.parametrize("name,n_traces", [
    ("Svc_Kill_Media", 300), ("Normal_Baseline", 300),     # the JAX pins
    ("Lv_D_CONNECTION_POOL_exhaustion", 120),               # TT database
    ("Lv_C_exception_injection", 120),                      # TT code
    ("DB_Redis_CacheLimit_SocialGraph", 120),               # SN database
    ("Code_Stop_UserService", 120)])                        # SN code
def test_multimodal_matches_jax(name, n_traces):
    jexp = jsynth.generate_experiment(jlabels.label_for(name),
                                      n_traces=n_traces, seed=0)
    texp = tsynth.generate_experiment(tlabels.label_for(name),
                                      n_traces=n_traces, seed=0)
    jdet = jstream.stream_experiment_multimodal(jexp)
    tdet = tstream.stream_experiment_multimodal(texp, device="cpu")
    _assert_same_detector(tdet, jdet)
    assert not tdet.batch_scorable
    if name == "Svc_Kill_Media":
        # the sparse kill the span planes cannot see: metric / log / api
        # evidence names it
        assert tdet.ranked_services()[0] == "media-service"
        assert any(a.evidence in ("metric", "log", "api")
                   for a in tdet.alerts if a.service_name == "media-service")
    elif name == "Normal_Baseline":
        assert len(tdet.alerts) <= 2
    else:
        assert tdet.alerts                     # the comparison has teeth


@pytest.mark.parametrize("testbed,names", [
    ("SN", ["Normal_Baseline", "Svc_Kill_UserTimeline",
            "Svc_Kill_SocialGraph", "Code_Stop_MediaService"]),
    ("TT", ["Lv_S_HTTPABORT_preserve", "Lv_D_TRANSACTION_timeout",
            "Lv_C_security_check", "Lv_C_travel_detail_failure"])])
def test_stream_quality_hard_multimodal_matches_jax(testbed, names,
                                                    monkeypatch):
    """``stream_quality(multimodal=True, severity=0.3, noise=0.5,
    n_confounders=2)``: every shared row key equal.  The SN subset reaches
    both concentration verdicts (spread and concentrated) and the TT
    subset the edge-dominant ranking with no pair verdict."""
    verdicts = []
    orig = tstream.OnlineDetector._pair_verdict

    def spy(self, p):
        verdicts.append(orig(self, p))
        return verdicts[-1]
    monkeypatch.setattr(tstream.OnlineDetector, "_pair_verdict", spy)
    kw = dict(multimodal=True, severity=0.3, noise=0.5, n_confounders=2,
              experiments=names)
    jrows = jstream.stream_quality(testbed, 120, **kw)
    trows = tstream.stream_quality(testbed, 120, device="cpu", **kw)
    assert [r["experiment"] for r in trows] == \
        [r["experiment"] for r in jrows] and len(trows) == 4
    for t, j in zip(trows, jrows):
        shared = set(t) & set(j)
        assert {"n_alerts", "target_service"} <= shared
        assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
        assert t["ranked"][:3] == j["ranked_top3"]
    kinds = {None if v is None else v[0] for v in verdicts}
    if testbed == "SN":
        assert {"spread", "concentrated"} <= kinds
    else:
        assert kinds == {None}


def test_span_only_default_generates_spans_only(monkeypatch):
    """With every knob at its default and ``multimodal=False`` the quality
    table generates spans alone (and still equals the JAX rows)."""
    def no_bundle(*a, **k):
        raise AssertionError("generated a full experiment bundle")
    monkeypatch.setattr(tsynth, "generate_experiment", no_bundle)
    names = ["Lv_P_CPU_preserve", "Normal_case"]
    trows = tstream.stream_quality("TT", 80, experiments=names, device="cpu")
    jrows = jstream.stream_quality("TT", 80, experiments=names)
    for t, j in zip(trows, jrows):
        assert {k: t[k] for k in set(t) & set(j)} == \
            {k: j[k] for k in set(t) & set(j)}


def _uniform_batch(n_per_window, n_windows, n_services=2,
                   window_us=60_000_000):
    """Healthy constant-rate, constant-latency stream (the JAX tests'
    helper, on the port's SpanBatch)."""
    from anomod_torch.schemas import SpanBatch
    rng = np.random.default_rng(0)
    rows = n_per_window * n_windows * n_services
    start = np.repeat(np.arange(n_windows, dtype=np.int64),
                      n_per_window * n_services) * window_us
    start = start + rng.integers(0, window_us, rows)
    return SpanBatch(
        trace=np.arange(rows, dtype=np.int32) % 100,
        parent=np.full(rows, -1, np.int32),
        service=np.tile(np.arange(n_services, dtype=np.int32),
                        rows // n_services),
        endpoint=np.zeros(rows, np.int32), start_us=np.sort(start),
        duration_us=rng.integers(900, 1100, rows).astype(np.int64),
        is_error=np.zeros(rows, np.bool_),
        status=np.full(rows, 200, np.int16), kind=np.zeros(rows, np.int8),
        services=tuple(f"svc{i}" for i in range(n_services)),
        endpoints=("ep",), trace_ids=tuple(f"t{i}" for i in range(100)),
    ).validate()


def test_multimodal_state_stays_bounded():
    """Per-window modality planes are pruned as scoring advances: a long
    stream keeps O(ring) host state."""
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.schemas import LogBatch
    cfg = ReplayConfig(n_services=2, n_windows=16, chunk_size=512)
    det = tstream.MultimodalDetector(("svc0", "svc1"), cfg, t0_us=0,
                                     testbed="TT", device="cpu")
    for w in range(40):
        spans = _uniform_batch(n_per_window=20, n_windows=1)
        spans = spans._replace(start_us=spans.start_us + w * 60_000_000)
        t = np.full(10, w * 60.0 + 5.0)
        det.push_logs(LogBatch(service=np.zeros(10, np.int32), t_s=t,
                               level=np.zeros(10, np.int8),
                               services=("svc0", "svc1")))
        det.push(spans)
    det.finish()
    assert len(det._log_tot) <= 4        # pruned, not 40


def test_metric_counter_rateification():
    """A healthy monotone counter must not drift into a false alert:
    baseline-detected counters are scored on window diffs."""
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.schemas import MetricBatch
    cfg = ReplayConfig(n_services=2, n_windows=32, chunk_size=512)
    spans = _uniform_batch(n_per_window=20, n_windows=20)
    det = tstream.MultimodalDetector(spans.services, cfg, t0_us=0,
                                     testbed="TT", device="cpu")
    t = np.arange(0, 20 * 60, 15, dtype=np.float64)
    det.push_metrics(MetricBatch(
        metric=np.zeros(t.shape[0], np.int32),
        series=np.zeros(t.shape[0], np.int32),
        t_s=t, value=np.cumsum(np.full(t.shape[0], 60.0)),
        metric_names=("http_requests_total",), series_keys=('svc="svc0"',),
        series_service=np.array([0], np.int32), services=spans.services))
    det.push(spans)
    det.finish()
    assert det.alerts == []
    assert det._mm_base["met"]['http_requests_total|svc="svc0"']["counter"]


def test_cli_stream_multimodal_single_experiment():
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "stream", "Svc_Kill_Media",
         "--multimodal", "--traces", "120", "--severity", "0.5",
         "--noise", "0.2", "--confounders", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    row, summary = lines[0], lines[-1]["summary"]
    want = jstream.stream_quality("SN", 120, multimodal=True, severity=0.5,
                                  noise=0.2, n_confounders=1,
                                  experiments=["Svc_Kill_Media"])[0]
    assert row["ranked"][:3] == want["ranked_top3"]
    assert row["n_alerts"] == want["n_alerts"]
    assert summary["n_experiments"] == 1
    assert summary["top1"] == float(want["top1_hit"])


def test_log_batch_fields_are_the_row_fields():
    """``_take_nt`` slices exactly the sample-axis fields."""
    from anomod_torch.schemas import ApiBatch, LogBatch, MetricBatch
    for cls in (LogBatch, MetricBatch, ApiBatch):
        assert set(tstream._ROW_FIELDS[cls.__name__]) <= set(cls._fields)
    assert tstream._ROW_FIELDS == jstream._ROW_FIELDS
    exp = tsynth.generate_experiment(tlabels.label_for("Svc_Kill_Media"),
                                     n_traces=10)
    m = exp.metrics.t_s < exp.metrics.t_s.min() + 300.0
    part = tstream._take_nt(exp.metrics, m)
    assert part.n_samples == int(m.sum())
    assert part.series_keys == exp.metrics.series_keys
    assert 0 < part.n_samples < exp.metrics.n_samples
