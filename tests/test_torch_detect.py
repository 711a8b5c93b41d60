"""The port's offline detector (``graph``, ``detect``) against the JAX
package's, on the same synthetic experiments (the two generators are
byte-identical).

Tolerance: the service graph, the service statistics and the feature
matrices are host numpy in both packages and must be byte-identical; the
numpy score is the same float32 expression and must be equal; the torch
score (run here on the CPU) agrees with it to ``rtol=1e-6``; evaluation
rows (scores, rankings, hits) and the per-level breakdown must be equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from anomod import detect as jdetect
from anomod import graph as jgraph
from anomod import labels as jlabels
from anomod import synth as jsynth
from anomod_torch import detect as tdetect
from anomod_torch import graph as tgraph
from anomod_torch import labels as tlabels
from anomod_torch import synth as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LABELS = [("TT", "Normal_case"), ("TT", "Lv_S_KILLPOD_preserve"),
          ("SN", "Normal_Baseline"), ("SN", "DB_Redis_CacheLimit_UserTimeline")]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _experiments(name, n_traces=40, seed=0):
    return (jsynth.generate_experiment(jlabels.label_for(name),
                                       n_traces=n_traces, seed=seed),
            tsynth.generate_experiment(tlabels.label_for(name),
                                       n_traces=n_traces, seed=seed))


@pytest.mark.parametrize("testbed,name", LABELS)
def test_graph_and_stats_byte_identical(testbed, name):
    jexp, texp = _experiments(name)
    services = tsynth.TT_SERVICES if testbed == "TT" else tsynth.SN_SERVICES
    for pinned in (None, tuple(services)):
        jg = jgraph.build_service_graph(jexp.spans, services=pinned)
        tg = tgraph.build_service_graph(texp.spans, services=pinned)
        assert tg.services == jg.services and tg.n_edges == jg.n_edges > 0
        for f in jg._fields[1:]:
            _same(getattr(tg, f), getattr(jg, f))
        js = jgraph.service_stats(jexp.spans, pinned)
        ts = tgraph.service_stats(texp.spans, pinned)
        assert ts.services == js.services
        for f in js._fields[1:]:
            _same(getattr(ts, f), getattr(js, f))
    _same(tgraph.depths(texp.spans), jgraph.depths(jexp.spans))
    for a, b in zip(tgraph.service_edges(texp.spans),
                    jgraph.service_edges(jexp.spans)):
        _same(a, b)


@pytest.mark.parametrize("missing", [None, "logs", "metrics", "api",
                                     "coverage", "spans"])
@pytest.mark.parametrize("name", ["Lv_D_cachelimit", "Svc_Kill_Media"])
def test_extract_features_and_scores_equal(name, missing):
    """All 13 columns, API and coverage included; a modality dropped from
    the experiment on one side of the score (the baseline keeps it) gates
    its level columns in both packages alike."""
    jexp, texp = _experiments(name)
    testbed = tlabels.label_for(name).testbed
    normal = "Normal_case" if testbed == "TT" else "Normal_Baseline"
    jbase, tbase = _experiments(normal)
    services = tuple(tsynth.TT_SERVICES if testbed == "TT"
                     else tsynth.SN_SERVICES)
    if missing:
        jexp = dataclasses.replace(jexp, **{missing: None})
        texp = dataclasses.replace(texp, **{missing: None})
    jf = jdetect.extract_features(jexp, services)
    tf = tdetect.extract_features(texp, services)
    assert tf.services == jf.services and tdetect.FEATURES == jdetect.FEATURES
    _same(tf.x, jf.x)
    if missing in (None, "api", "coverage"):
        col = {None: 8, "api": 8, "coverage": 9}[missing]
        assert (tf.x[:, col] > 0).any() == (missing is None)
    fb = tdetect.extract_features(tbase, services).x
    _same(fb, jdetect.extract_features(jbase, services).x)
    want = np.asarray(jdetect.service_scores(jf.x, fb, backend="cpu"))
    _same(tdetect.service_scores_numpy(tf.x, fb), want)
    got = tdetect.service_scores(tf.x, fb, device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tdetect.experiment_score(want) == jdetect.experiment_score(want)


@pytest.mark.parametrize("testbed", ["TT", "SN"])
def test_evaluate_corpus_rows_equal(testbed):
    jc = [jsynth.generate_experiment(l, n_traces=40)
          for l in jlabels.labels_for_testbed(testbed)]
    tc = [tsynth.generate_experiment(l, n_traces=40)
          for l in tlabels.labels_for_testbed(testbed)]
    js = jdetect.evaluate_corpus(jc, backend="cpu")
    ts = tdetect.evaluate_corpus(tc, device="cpu")
    assert (ts.top1, ts.top3, ts.top5, ts.detection_accuracy,
            ts.n_rca_cases) == (js.top1, js.top3, js.top5,
                                js.detection_accuracy, js.n_rca_cases)
    assert [dataclasses.asdict(r) for r in ts.results] == \
        [dataclasses.asdict(r) for r in js.results]
    assert tdetect.per_level_breakdown(ts) == jdetect.per_level_breakdown(js)
    assert len(ts.results) == 13 and ts.n_rca_cases > 0


def test_evaluate_corpus_needs_a_card_unless_cpu_is_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    tc = [tsynth.generate_experiment(l, n_traces=10)
          for l in tlabels.labels_for_testbed("SN")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdetect.evaluate_corpus(tc)


def test_cli_detect_prints_the_jax_keys():
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "detect", "--device", "cpu",
         "--testbed", "SN", "--traces", "30"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert set(out) == {"testbed", "backend", "top1", "top3", "top5",
                        "detection_accuracy", "n_rca_cases", "per_level",
                        "per_experiment"}
    assert out["backend"] == "cpu" and len(out["per_experiment"]) == 13
