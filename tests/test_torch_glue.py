"""The port's serve env contract and small CLI surface against the JAX
package's, on the CPU.

- ``ServeReport`` carries every field of the JAX report plus the port's
  ``device``; the observatories' ten fields stand in the JAX order.
- Every serve-plane and observatory knob (``ANOMOD_SERVE_PIPELINE``,
  ``_FUSE``, ``_STATE``, ``_BUCKETS``, ``_LANE_BUCKETS``, ``_MAX_BACKLOG``,
  ``_NATIVE_DRAIN``, ``ANOMOD_NATIVE``, ``ANOMOD_SEED``, ``ANOMOD_PERF*``,
  ``ANOMOD_CENSUS*``) accepts the JAX package's values into equal
  settings and raises on the same bad ones; the engine resolves its
  defaults from them as the JAX engine does.
- ``list`` and ``synth`` print what the JAX CLI prints; ``ingest
  --warm-cache`` makes a second load warm; ``logscan`` gives the JAX
  summary of a fixture tree; ``stream`` with each new flag gives the JAX
  stream's alerts (window, service and evidence equal, scores within
  ``rtol=1e-4``, the stream tests' tolerance); ``ANOMOD_RANK_TIER=0``
  changes a multimodal ranking exactly as in the JAX package, and
  ``ANOMOD_EDGE_DEBUG`` prints the JAX package's lines.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import anomod.config as jconfig
import anomod_torch.config as pconfig


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs (the plain lane
    fold's ``index_add_`` contends under torch's thread pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_configs():
    """Both packages' settings re-read from the environment by ``load``
    and restored afterwards."""
    jold, pold = jconfig.get_config(), pconfig.get_config()

    def load():
        jconfig.set_config(jconfig.Config())
        pconfig.set_config(pconfig.Config())
        return jconfig.get_config(), pconfig.get_config()
    yield load
    jconfig.set_config(jold)
    pconfig.set_config(pold)


def test_serve_report_has_every_jax_field():
    from anomod.serve.engine import ServeReport as JReport
    from anomod_torch.serve.engine import ServeReport
    jax = [f.name for f in dataclasses.fields(JReport)]
    port = [f.name for f in dataclasses.fields(ServeReport)]
    assert set(port) - set(jax) == {"device"}
    assert set(jax) <= set(port)
    # the observatories' ten fields, in the JAX report's order
    new = ("perf_enabled", "perf_events_recorded", "overlap_headroom_s",
           "fold_wait_s", "bubble_fractions", "census_enabled",
           "census_ticks", "census_hot_set", "census_resident_bytes",
           "census_wall_s")
    assert [f for f in port if f in new] == [f for f in jax if f in new] \
        == list(new)


#: knob -> (field, accepted values, rejected values)
KNOBS = {
    "ANOMOD_SERVE_PIPELINE": ("serve_pipeline", ["1", "8", "64"],
                              ["0", "65", "two"]),
    "ANOMOD_SERVE_FUSE": ("serve_fuse", ["0", "off", "1", "yes"], []),
    "ANOMOD_SERVE_STATE": ("serve_state", ["auto", "host", "DEVICE"],
                           ["pool", "gpu"]),
    "ANOMOD_SERVE_BUCKETS": ("serve_buckets", ["64,256", " 8 , 16 "],
                             ["256,64", "0,8", "a,b"]),
    "ANOMOD_SERVE_LANE_BUCKETS": ("serve_lane_buckets", ["1,2", "4"],
                                  ["2,1", "-1", "x"]),
    "ANOMOD_SERVE_MAX_BACKLOG": ("serve_max_backlog", ["1", "5000"],
                                 ["0", "-3", "lots"]),
    "ANOMOD_SERVE_NATIVE_DRAIN": ("serve_native_drain",
                                  ["auto", "on", "1", "off", "no"],
                                  ["numpy", "maybe"]),
    "ANOMOD_NATIVE": ("native", ["auto", "on", "true", "off", "0"],
                      ["fast"]),
    "ANOMOD_SEED": ("seed", ["1", "42"], ["seven"]),
    "ANOMOD_PERF": ("perf", ["1", "on", "0", "off"], []),
    "ANOMOD_PERF_MAX_EVENTS": ("perf_max_events", ["1", "1024"],
                               ["0", "zero", "100000001"]),
    "ANOMOD_PERF_NOISE_FLOOR": ("perf_noise_floor", ["0.2", "0", "10"],
                                ["lots", "-1", "11"]),
    "ANOMOD_CENSUS": ("census", ["1", "yes", "0"], []),
    "ANOMOD_CENSUS_EVERY": ("census_every", ["1", "8", "1000000"],
                            ["0", "x", "1000001"]),
    "ANOMOD_CENSUS_DECAY_TICKS": ("census_decay_ticks", ["4,16", "2"],
                                  ["16,4", "0,4", "a"]),
    "ANOMOD_CENSUS_SWEEP": ("census_sweep", ["10,100", "1,2,3"],
                            ["100", "100,10", "x,y"]),
    "ANOMOD_CENSUS_COLDEST_K": ("census_coldest_k", ["1", "4096"],
                                ["0", "4097", "k"]),
}


@pytest.mark.parametrize("var", sorted(KNOBS))
def test_knob_validates_as_jax(var, monkeypatch, fresh_configs):
    field, good, bad = KNOBS[var]
    for val in good:
        monkeypatch.setenv(var, val)
        jcfg, pcfg = fresh_configs()
        assert getattr(pcfg, field) == getattr(jcfg, field), (var, val)
    for val in bad:
        monkeypatch.setenv(var, val)
        with pytest.raises(ValueError):
            jconfig.Config()
        with pytest.raises(ValueError):
            pconfig.Config()
    monkeypatch.delenv(var)
    jcfg, pcfg = fresh_configs()
    assert getattr(pcfg, field) == getattr(jcfg, field)


def test_engine_resolves_the_knobs_as_jax(monkeypatch, fresh_configs):
    from anomod.serve.engine import ServeEngine as JServeEngine
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    from anomod_torch.serve.traffic import PowerLawTraffic
    tr = PowerLawTraffic(n_tenants=4, total_rate_spans_per_s=100,
                         n_services=4)
    cfg = serve_plane_cfg(4, 5.0, 16)
    for env in ({"ANOMOD_SERVE_PIPELINE": "1", "ANOMOD_SERVE_FUSE": "0",
                 "ANOMOD_SERVE_STATE": "host",
                 "ANOMOD_SERVE_BUCKETS": "32,128",
                 "ANOMOD_SERVE_LANE_BUCKETS": "1,8",
                 "ANOMOD_SERVE_MAX_BACKLOG": "777",
                 "ANOMOD_SERVE_NATIVE_DRAIN": "off", "ANOMOD_NATIVE": "off",
                 "ANOMOD_PERF": "1", "ANOMOD_CENSUS": "1",
                 "ANOMOD_CENSUS_EVERY": "3"},
                {"ANOMOD_SERVE_STATE": "auto"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        fresh_configs()
        eng = ServeEngine(tr.specs, tr.services, cfg, device="cpu")
        jeng = JServeEngine(tr.specs, tr.services, cfg)
        for attr in ("fuse", "pipeline", "serve_state", "max_backlog",
                     "perf", "census", "census_every"):
            assert getattr(eng, attr) == getattr(jeng, attr), attr
        for attr in ("buckets", "lane_buckets", "native_stage"):
            assert getattr(eng.runner, attr) == getattr(jeng.runner, attr)
        assert (eng.admission.drain_engine == "heap") \
            == (jeng.admission.drain_engine == "heap")
        eng.close()
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("argv", [["list"], ["list", "--testbed", "SN"],
                                  ["synth", "Lv_P_CPU_preserve", "--traces",
                                   "12"],
                                  ["synth", "Perf_CPU_Contention"]])
def test_list_and_synth_print_the_jax_cli_output(argv, capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert jmain(argv) == 0
    assert got == capsys.readouterr().out and got


def test_ingest_warm_cache_makes_a_second_load_warm(tmp_path, capsys):
    from anomod_torch.cli import main
    argv = ["ingest", "--warm-cache", "--cache-dir", str(tmp_path / "c"),
            "--testbed", "SN", "--traces", "10", "--bench-traces", "10"]
    assert main(argv) == 0
    cold = json.loads(capsys.readouterr().out)
    assert cold["misses"] > 0 and cold["stores"] > 0 and cold["entries"] > 0
    assert main(argv) == 0
    warm = json.loads(capsys.readouterr().out)
    assert warm["misses"] == 0 and warm["hits"] == cold["misses"]
    assert warm["entries"] == cold["entries"]
    assert main(["ingest", "--clear", "--cache-dir",
                 str(tmp_path / "c")]) == 0
    cleared = json.loads(capsys.readouterr().out)
    assert cleared["cleared"] >= cold["entries"] and cleared["entries"] == 0


def test_logscan_equals_the_jax_summary(tmp_path, capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    rng = np.random.default_rng(4)
    levels = ["INFO", "WARN", "ERROR", "DEBUG"]
    for svc in ("ts-order-service", "ts-user-service", "nginx-web"):
        d = tmp_path / svc
        d.mkdir()
        lines = [f"2024-01-01 00:00:{i % 60:02d} {levels[k]} {svc} msg {i}"
                 for i, k in enumerate(rng.integers(0, 4, 40))]
        (d / f"{svc}_0.log").write_text("\n".join(lines) + "\n")
    (tmp_path / "stub.log").write_text(
        "version https://git-lfs.github.com/spec/v1\n"
        "oid sha256:" + "0" * 64 + "\nsize 123\n")
    assert main(["logscan", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(["logscan", str(tmp_path)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got.pop("native") == want.pop("native")
    assert got == want and got["n_files"] == 3 and got["n_lfs_stubs"] == 1
    assert main(["logscan", str(tmp_path / "missing")]) == 1


def _jax_alerts(name, kw, testbed="SN", traces=60):
    from anomod import synth as jsynth
    from anomod.quality import SHIFTS
    from anomod.rca import experiment_stream
    from anomod.stream import stream_experiment
    hard = jsynth.HardMode(severity=1.0, noise=0.0, **SHIFTS["in-dist"])
    (_, exp), = experiment_stream(testbed, 0, n_traces=traces, hard=hard,
                                  experiments=[name])
    return stream_experiment(exp.spans, **kw).alerts


def _assert_alerts(got, want):
    assert [(a["window"], a["service"], a["evidence"]) for a in got] \
        == [(a.window, a.service, a.evidence) for a in want]
    np.testing.assert_allclose([a["score"] for a in got],
                               [a.score for a in want], rtol=1e-4)


@pytest.mark.parametrize("flags,kw", [
    (["--slice-seconds", "30"], dict(slice_s=30.0)),
    (["--threshold", "3.0"], dict(z_threshold=3.0)),
    (["--baseline-windows", "6"], dict(baseline_windows=6)),
    (["--consecutive", "2"], dict(consecutive=2)),
    (["--no-edge-attribution"], dict(edge_attribution=False))])
def test_stream_flags_give_the_jax_alerts(flags, kw, capsys):
    from anomod_torch.cli import main
    name = "Perf_CPU_Contention"
    assert main(["stream", name, "--device", "cpu", "--traces", "60",
                 *flags]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[0])
    want = _jax_alerts(name, kw)
    _assert_alerts(row["alerts"], want)
    assert want                              # the comparison has teeth


def test_stream_from_data_gives_the_jax_alerts(monkeypatch, fresh_configs,
                                               capsys):
    from anomod.io import dataset as jdataset
    from anomod.stream import stream_experiment
    from anomod_torch.cli import main
    monkeypatch.setenv("ANOMOD_CACHE_DIR", "off")
    monkeypatch.setenv("ANOMOD_DATA_ROOT", "{UNSET}")
    fresh_configs()
    name = "Perf_CPU_Contention"
    assert main(["stream", name, "--device", "cpu", "--traces", "60",
                 "--from-data"]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[0])
    exp = jdataset.load_experiment(name, modalities=["traces"],
                                   n_synth_traces=60)
    want = stream_experiment(exp.spans).alerts
    _assert_alerts(row["alerts"], want)
    assert want and "detection_latency_windows" not in row
    with pytest.raises(SystemExit):
        main(["stream", "--all", "--from-data", "--device", "cpu"])


def test_rank_tier_and_edge_debug_equal_jax(monkeypatch, capsys):
    """At TT, 60 traces, seed 0, multimodal, two confounders: the
    edge-dominant reorder moves this experiment's top three, in both
    packages alike."""
    from anomod.stream import stream_quality as jstream_quality
    from anomod_torch.stream import stream_quality
    kw = dict(seed=0, experiments=["Lv_D_CONNECTION_POOL_exhaustion"],
              multimodal=True, n_confounders=2)
    ranked = {}
    for tier in ("1", "0"):
        monkeypatch.setenv("ANOMOD_RANK_TIER", tier)
        debug = tier == "1"
        if debug:
            monkeypatch.setenv("ANOMOD_EDGE_DEBUG", "1")
        capsys.readouterr()
        got = stream_quality("TT", 60, device="cpu", **kw)[0]["ranked"]
        port_lines = capsys.readouterr().out
        want = jstream_quality("TT", 60, **kw)[0]["ranked_top3"]
        jax_lines = capsys.readouterr().out
        assert got[:3] == want, tier
        ranked[tier] = got
        if debug:
            assert port_lines == jax_lines and "[edge] w" in port_lines
            monkeypatch.delenv("ANOMOD_EDGE_DEBUG")
        else:
            assert port_lines == jax_lines == ""
    assert ranked["1"][:3] != ranked["0"][:3]


def test_serve_cli_native_and_perf_flags(capsys):
    from anomod_torch.cli import main
    argv = ["serve", "--device", "cpu", "--tenants", "4", "--services", "4",
            "--duration", "6", "--capacity", "1000", "--buckets", "64,256",
            "--lane-buckets", "1,2", "--state", "auto"]
    assert main(argv + ["--no-native", "--native-drain", "off",
                        "--perf"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["native_staging"] is False and rep["perf_enabled"] is True
    assert rep["serve_state"] == "device" and rep["perf_events_recorded"] > 0
    assert main(argv) == 0
    base = json.loads(capsys.readouterr().out)
    assert base["native_staging"] is True and base["perf_enabled"] is False
    for key in ("served_spans", "shed_spans", "latency", "n_alerts"):
        assert rep[key] == base[key], key
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu", "--from-live", "self", "--perf"])
