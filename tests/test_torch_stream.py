"""The port's streaming plane and online detector against the JAX ones.

Same corpus, same micro-batches: planes agree as in the batch replay
(exact count / err / 5xx / histogram, moments within ``rtol=1e-5,
atol=1e-3``); alert ``(window, service, evidence)`` lists, ranked
services and first-alert windows are identical, alert scores within
``rtol=1e-4``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from anomod import labels as jlabels
from anomod import replay as jreplay
from anomod import stream as jstream
from anomod import synth as jsynth
from anomod.schemas import take_spans as jtake
from anomod_torch import replay as treplay
from anomod_torch import stream as tstream
from anomod_torch.io.dataset import load_bench_corpus
from anomod_torch.schemas import take_spans
from anomod_torch.state import from_numpy_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_planes(agg, hist, ref_agg, ref_hist):
    agg, ref_agg = np.asarray(agg), np.asarray(ref_agg)
    np.testing.assert_array_equal(agg[:, :3], ref_agg[:, :3])
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref_hist))
    np.testing.assert_allclose(agg[:, 3:], ref_agg[:, 3:], rtol=1e-5,
                               atol=1e-3)


@pytest.fixture(scope="module")
def sorted_corpus():
    batch = load_bench_corpus("TT", 30)
    order = np.argsort(batch.start_us, kind="stable")
    return take_spans(batch, order)


def _push_both(batch, cuts, window_us=60_000_000, n_windows=32):
    t0 = int(batch.start_us.min())
    tcfg = treplay.ReplayConfig(n_services=batch.n_services,
                                chunk_size=2048, window_us=window_us,
                                n_windows=n_windows)
    jcfg = jreplay.ReplayConfig(n_services=batch.n_services,
                                chunk_size=2048, window_us=window_us,
                                n_windows=n_windows)
    tr = tstream.StreamReplay(tcfg, t0, device="cpu")
    jr = jstream.StreamReplay(jcfg, t0)
    for lo, hi in zip(cuts, cuts[1:]):
        assert tr.push(take_spans(batch, slice(lo, hi))) == \
            jr.push(jtake(batch, slice(lo, hi)))
    return tr, jr


def test_stream_replay_uneven_pushes_match_jax(sorted_corpus):
    b = sorted_corpus
    tr, jr = _push_both(b, [0, 1000, 1001, 5000, b.n_spans])
    assert tr.n_spans == jr.n_spans == b.n_spans
    _assert_planes(tr.state.agg.numpy(), tr.state.hist.numpy(),
                   jr.state.agg, jr.state.hist)
    np.testing.assert_array_equal(tr.agg_plane()[..., :3],
                                  jr.agg_plane()[..., :3])


def test_ring_rolls_past_the_grid(sorted_corpus):
    """10 s windows on an 8-window ring: the 1800 s corpus rolls the ring
    many times; offsets, anchors and planes follow the JAX ring."""
    b = sorted_corpus
    cuts = list(range(0, b.n_spans, 700)) + [b.n_spans]
    tr, jr = _push_both(b, cuts, window_us=10_000_000, n_windows=8)
    assert tr.window_offset == jr.window_offset > 100
    assert tr.t0_us == jr.t0_us
    _assert_planes(tr.state.agg.numpy(), tr.state.hist.numpy(),
                   jr.state.agg, jr.state.hist)
    st = tstream.roll_ring_state(tr.state, tr.cfg, 3)
    want = jstream.roll_ring_state(jr.state, jr.cfg, 3)
    _assert_planes(st.agg.numpy(), st.hist.numpy(), want.agg, want.hist)


@pytest.mark.parametrize("name", ["Normal_case", "Lv_P_CPU_preserve",
                                  "Lv_S_KILLPOD_preserve",
                                  "Lv_C_security_check"])
def test_stream_experiment_matches_jax(name):
    spans = jsynth.generate_spans(jlabels.label_for(name), n_traces=120)
    jdet = jstream.stream_experiment(spans)
    tdet = tstream.stream_experiment(spans, device="cpu")
    key = [(a.window, a.service, a.evidence) for a in jdet.alerts]
    assert [(a.window, a.service, a.evidence) for a in tdet.alerts] == key
    np.testing.assert_allclose([a.score for a in tdet.alerts],
                               [a.score for a in jdet.alerts], rtol=1e-4)
    assert tdet.ranked_services() == jdet.ranked_services()
    assert tdet.first_alert_window() == jdet.first_alert_window()
    assert tdet.n_spans_in == jdet.n_spans_in
    if name != "Normal_case":
        assert jdet.alerts                       # the comparison has teeth


def test_state_carried_from_jax_stream(sorted_corpus):
    """Half a corpus through the JAX plane, its state moved into the port,
    the rest through the port == the whole corpus through the port."""
    b = sorted_corpus
    half = b.n_spans // 2
    t0 = int(b.start_us.min())
    jcfg = jreplay.ReplayConfig(n_services=b.n_services, chunk_size=2048)
    tcfg = treplay.ReplayConfig(n_services=b.n_services, chunk_size=2048)
    jr = jstream.StreamReplay(jcfg, t0)
    jr.push(jtake(b, slice(0, half)))
    carried = tstream.StreamReplay(tcfg, t0, device="cpu")
    carried.set_state(from_numpy_state(np.asarray(jr.state.agg),
                                       np.asarray(jr.state.hist),
                                       device="cpu"))
    carried.push(take_spans(b, slice(half, b.n_spans)))
    alone = tstream.StreamReplay(tcfg, t0, device="cpu")
    alone.push(take_spans(b, slice(0, half)))
    alone.push(take_spans(b, slice(half, b.n_spans)))
    _assert_planes(carried.state.agg.numpy(), carried.state.hist.numpy(),
                   alone.state.agg.numpy(), alone.state.hist.numpy())


def test_batched_scoring_matches_sequential():
    from anomod_torch import labels, synth
    dets = []
    for seq in (True, False):
        row = []
        for name in ("Lv_P_CPU_preserve", "Normal_case"):
            spans = synth.generate_spans(labels.label_for(name),
                                         n_traces=80)
            det = tstream.stream_experiment(spans, device="cpu",
                                            edge_attribution=False)
            row.append(det)
        dets.append(row)
    # rescoring from scratch: sequential vs batched on fresh state
    for d in dets[0] + dets[1]:
        d.alerts, d._scored_through = [], -1
        d._streak[:] = 0
        d._cusum[:] = 0.0
        d._cusum_k[:] = 0
    for d in dets[0]:
        d.finish()
    work = [(d,) + d.scoring_window_range(d._max_seen) for d in dets[1]]
    planes = [d.replay.agg_plane() for d, _, _ in work]
    n = tstream.score_closed_windows_batched(
        work, lambda items: np.stack([planes[i][:, c] for i, c in items]))
    assert n == sum(len(d.alerts) for d in dets[0]) > 0
    for a, b in zip(dets[0], dets[1]):
        assert a.alerts == b.alerts
        assert a._scored_through == b._scored_through


def test_cli_replay_prints_one_json_line():
    r = subprocess.run(
        [sys.executable, "-m", "anomod_torch", "replay", "--device", "cpu",
         "--kernel", "numpy", "--traces", "30"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["kernel"] == "numpy" and out["n_spans"] > 0
    assert out["spans_per_sec"] > 0
