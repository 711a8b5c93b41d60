"""The port's quality sweep (``quality``), ``stream_quality(shift=...)``
and the ``quality`` / ``stream --shift`` / ``rca --model`` commands
against the JAX package's, on the CPU, on SN at a small size (one eval
seed, 20 traces, two severities).

The z-score and stream rows need no training, so they must equal the
JAX rows exactly; so must the learned rows' stacked, re-padded and
standardized host batches, byte for byte.  The learned rows themselves
are held per family by ``tests/test_torch_models.py`` and on the card by
``chip_smoke.py`` (phases 18-19).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomod import quality as jquality
from anomod import stream as jstream
from anomod import synth as jsynth
from anomod_torch import quality as tquality
from anomod_torch import stream as tstream
from anomod_torch import synth as tsynth
from anomod_torch.cli import main

SMALL = dict(eval_seeds=[100], n_traces=20)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; one intra-op thread
    a worker keeps torch's CPU thread pools from oversubscribing the
    cores (the models here are small enough to gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(points):
    return [dataclasses.asdict(p) for p in points]


def test_severity_sweep_training_free_rows_match_jax():
    kw = dict(model_names=("zscore", "stream"), severities=(1.0, 0.12),
              **SMALL)
    want = jquality.severity_sweep("SN", **kw)
    got = tquality.severity_sweep("SN", device="cpu", **kw)
    assert _rows(got) == _rows(want)
    assert [p.model for p in got] == ["zscore"] * 2 + ["stream"] * 2
    assert tquality.render_markdown(got) == jquality.render_markdown(want)


def test_shift_sweep_training_free_rows_match_jax():
    kw = dict(model_names=("zscore", "stream"), shifts=("bursty",), **SMALL)
    want = jquality.shift_sweep("SN", **kw)
    got = tquality.shift_sweep("SN", device="cpu", **kw)
    assert _rows(got) == _rows(want)
    assert {p.shift for p in got} == {"bursty"}
    assert tquality.render_shift_markdown(got) == \
        jquality.render_shift_markdown(want)


def test_constants_and_renderers_match_jax():
    assert tquality.SEVERITIES == jquality.SEVERITIES
    assert tquality.HARD_POINT == jquality.HARD_POINT
    assert tquality.SHIFTS == jquality.SHIFTS
    assert [f.name for f in dataclasses.fields(tquality.QualityPoint)] == \
        [f.name for f in dataclasses.fields(jquality.QualityPoint)]
    rng = np.random.default_rng(0)
    cells = [("gcn", 1.0, "in-dist"), ("gcn", 0.4, "bursty"),
             ("moe", 1.0, "in-dist"), ("zscore", 0.05, "edge-locus")]
    values = [rng.random(3).tolist() for _ in cells]
    t, j = ([cls(m, sev, 0.5, 2, *v, 9, shift=sh)
             for (m, sev, sh), v in zip(cells, values)]
            for cls in (tquality.QualityPoint, jquality.QualityPoint))
    assert tquality.render_markdown(t) == jquality.render_markdown(j)
    assert tquality.render_shift_markdown(t) == \
        jquality.render_shift_markdown(j)


def _jax_batches(monkeypatch, edge_aware):
    """The JAX sweep's training batch and eval batches, read where its
    learned row hands them on (no training)."""
    seen = {"eval": []}

    def train_model(name, train, epochs=150, lr=3e-3):
        seen["train"] = train
        return None, None

    def apply_model(name, model, params, batch):
        seen["eval"].append({k: np.asarray(v) for k, v in batch.items()})
        return jnp.zeros(batch["x"].shape[:2])

    monkeypatch.setattr(jquality, "_train_model", train_model)
    monkeypatch.setattr(jquality, "_apply_model", apply_model)
    jquality.shift_sweep("SN", model_names=("gcn",),
                         shifts=("in-dist", "edge-locus"),
                         train_seeds=range(3), edge_aware=edge_aware,
                         **SMALL)
    return seen["train"], seen["eval"]


@pytest.mark.parametrize("edge_aware", [False, True],
                         ids=["node", "edge_aware"])
def test_eval_grid_batches_byte_equal_to_jax(monkeypatch, edge_aware):
    jtrain, jeval = _jax_batches(monkeypatch, edge_aware)
    modes = {name: tsynth.HardMode(severity=0.3, noise=0.5,
                                   **tquality.SHIFTS[name])
             for name in ("in-dist", "edge-locus")}
    train, evals = tquality._grid_batches(
        "SN", modes, range(3), [100], 20, 0.5, 2,
        edge_features=edge_aware,
        train_loci=("node", "edge") if edge_aware else ("node",))
    assert ("edge_x" in train) == edge_aware
    for got, want in [(train, jtrain)] + list(zip(evals.values(), jeval)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_stream_quality_shift_matches_jax():
    names = ["Normal_Baseline", "Perf_CPU_Contention", "Svc_Kill_Media"]
    want = jstream.stream_quality("SN", 60, experiments=names,
                                  shift="bursty")
    got = tstream.stream_quality("SN", 60, experiments=names,
                                 shift="bursty", device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("experiment", "target_service", "n_alerts", "top1_hit",
                    "top3_hit", "first_culprit_alert_window",
                    "detection_latency_windows"):
            assert g.get(key) == w.get(key), key
        assert g["ranked"][:3] == w["ranked_top3"]
    assert jsynth.HardMode(**jquality.SHIFTS["bursty"]).fault_profile == \
        tsynth.HardMode(**tquality.SHIFTS["bursty"]).fault_profile


def test_cli_quality_json_prints_the_jax_keys(capsys, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("ANOMOD_BENCH_RUNS_DIR", str(tmp_path))
    assert main(["quality", "--device", "cpu", "--testbed", "SN",
                 "--models", "zscore", "--severities", "1.0", "0.12",
                 "--eval-seeds", "1", "--traces", "20", "--json"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert len(lines) == 2
    assert set(lines[0]) == {f.name for f in dataclasses.fields(
        jquality.QualityPoint)}
    capture = out.err.strip().split("capture: ")[-1]
    rec = json.loads(open(capture).read())
    assert rec["metric"] == "quality_severity_sweep"
    assert rec["device"] == "cpu" and len(rec["points"]) == 2
    # a flag of the other sweep kind is refused, as the JAX CLI refuses it
    for argv in (["--sweep", "shift", "--severities", "0.5"],
                 ["--shift-severity", "0.5"], ["--edge-aware"],
                 ["--models", "zscore", "mlp"]):
        with pytest.raises(SystemExit) as e:
            main(["quality", "--device", "cpu"] + argv)
        assert e.value.code == 2


def test_cli_stream_shift_needs_all(capsys):
    with pytest.raises(SystemExit) as e:
        main(["stream", "Perf_CPU_Contention", "--device", "cpu",
              "--shift", "bursty"])
    assert e.value.code == 2
    assert "--shift applies to --all" in capsys.readouterr().err


def test_cli_rca_temporal_runs_end_to_end(capsys):
    assert main(["rca", "--device", "cpu", "--testbed", "SN", "--model",
                 "temporal", "--epochs", "3", "--train-seeds", "1",
                 "--eval-seeds", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["model"] == "temporal" and out["n_eval"] > 0
    assert 0.0 <= out["top1"] <= 1.0
