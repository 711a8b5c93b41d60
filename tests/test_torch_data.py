"""The port's multimodal data layer against the JAX package's, on the CPU.

- Every ``synth`` generator and exporter equals ``anomod.synth``'s byte
  for byte, on TT and SN labels, easy and under a ``HardMode``.
- Each parser equals its JAX twin on fixture trees the test writes into
  ``tmp_path`` with the synth exporters.
- ``load_experiment`` / ``load_corpus`` equal the JAX loaders with the
  synth fallback and over a fixture tree, serial and pooled.
- The ingest cache: warm == cold, a source change, a loader or generator
  version bump and a corrupt entry each force a reparse, and the keys
  equal the JAX cache's for the same parts.
- The settings read the same variables with the JAX validation.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

from anomod import metrics_catalog as jcatalog
from anomod import synth as jsynth
from anomod.config import Config as JConfig
from anomod.io import api as japi
from anomod.io import cache as jcache
from anomod.io import coverage as jcov
from anomod.io import dataset as jdataset
from anomod.io import lfs as jlfs
from anomod.io import logs as jlogs
from anomod.io import metrics as jmet
from anomod.io import sn_traces as jsn
from anomod.io import tt_traces as jtt
from anomod_torch import labels, metrics_catalog, synth
from anomod_torch.config import Config
from anomod_torch.io import api, cache, dataset, lfs
from anomod_torch.io import coverage as cov
from anomod_torch.io import logs as logs_io
from anomod_torch.io import metrics as met
from anomod_torch.io import sn_traces, tt_traces

TT_LABELS = ("Normal_case", "Lv_P_CPU_preserve", "Lv_D_cachelimit",
             "Lv_C_exception_injection")
SN_LABELS = ("Normal_Baseline", "Perf_CPU_Contention", "Svc_Kill_Media",
             "DB_Redis_CacheLimit_HomeTimeline")
STAMP = {"TT": "_20251103T185917Z_em", "SN": "_20251103_140939_x"}


def assert_same(a, b, ctx=""):
    """Equal batches (arrays by dtype and bytes), tuples of batches,
    summary lists and plain values."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), ctx
    elif isinstance(a, list):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{ctx}[{i}]")
    elif hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, ctx
        for f in a._fields:
            assert_same(getattr(a, f), getattr(b, f), f"{ctx}.{f}")
    elif isinstance(a, tuple):
        assert len(a) == len(b) and all(
            assert_same(x, y, f"{ctx}[{i}]") is None
            for i, (x, y) in enumerate(zip(a, b))), ctx
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        assert a.tobytes() == b.tobytes(), ctx
    else:
        assert a == b, ctx


def assert_same_experiment(a, b):
    assert (a.name, a.testbed, a.synthetic) == (b.name, b.testbed,
                                                b.synthetic)
    for f in ("spans", "metrics", "logs", "log_summaries", "api",
              "coverage"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert_same(x, y, f"{a.name}.{f}")


# -- synth -----------------------------------------------------------------

HARD = dict(severity=0.3, noise=0.5, confounders=("ts-station-service",
                                                  "user-service"),
            effect_shape="tail", fault_profile="bursty", fault_locus="edge")


@pytest.mark.parametrize("name", TT_LABELS + SN_LABELS)
@pytest.mark.parametrize("hard", [False, True])
def test_generators_byte_identical(name, hard):
    tl, jl = labels.label_for(name), jsynth.labels_mod.label_for(name)
    kw = {}
    if hard:
        kw = dict(hard=synth.HardMode(**HARD))
        jkw = dict(hard=jsynth.HardMode(**HARD))
    else:
        jkw = {}
    assert_same(synth.generate_metrics(tl, duration_s=300, **kw),
                jsynth.generate_metrics(jl, duration_s=300, **jkw), "metrics")
    assert_same(synth.generate_logs(tl, lines_per_service=40, **kw),
                jsynth.generate_logs(jl, lines_per_service=40, **jkw), "logs")
    assert_same(synth.generate_api(tl, n_records=80, **kw),
                jsynth.generate_api(jl, n_records=80, **jkw), "api")
    assert_same(synth.generate_coverage(tl, **kw),
                jsynth.generate_coverage(jl, **jkw), "coverage")
    spans = synth.generate_spans(tl, n_traces=8, **kw)
    assert json.dumps(synth.spans_to_skywalking_json(spans, name)) == \
        json.dumps(jsynth.spans_to_skywalking_json(spans, name))
    assert json.dumps(synth.spans_to_jaeger_json(spans)) == \
        json.dumps(jsynth.spans_to_jaeger_json(spans))


@pytest.mark.parametrize("name", ["Lv_S_KILLPOD_preserve", "Svc_Kill_Media"])
def test_generate_experiment_byte_identical(name):
    assert_same_experiment(synth.generate_experiment(name, n_traces=12),
                           jsynth.generate_experiment(name, n_traces=12))


@pytest.mark.parametrize("testbed", ["TT", "SN"])
def test_generate_corpus_byte_identical(testbed):
    got = synth.generate_corpus(testbed, n_traces=6)
    want = jsynth.generate_corpus(testbed, n_traces=6)
    assert len(got) == len(want) == 13
    for a, b in zip(got, want):
        assert_same_experiment(a, b)


def test_catalog_and_constants_equal():
    for mod, ref in ((metrics_catalog, jcatalog), (synth, jsynth)):
        names = [n for n in vars(ref) if n.isupper() and not n.startswith("_")]
        for n in names:
            if n in vars(mod):
                assert getattr(mod, n) == getattr(ref, n), n
    assert {n for n in vars(jcatalog) if n.isupper()} <= set(
        vars(metrics_catalog))
    assert synth.SYNTH_VERSION == jsynth.SYNTH_VERSION
    for testbed in ("TT", "SN"):
        for level in ("performance", "service", "database"):
            assert metrics_catalog.level_metric_names(testbed, level) == \
                jcatalog.level_metric_names(testbed, level)
    from anomod.suite import endpoint_owner
    from anomod_torch import suite
    for e in synth.SN_API_ENDPOINTS + ("/api/v1/orderservice",
                                       "/api/v1/nope"):
        for tb in ("SN", "TT"):
            assert suite.endpoint_owner(e, tb) == endpoint_owner(e, tb)


# -- fixture trees ------------------------------------------------------------

def _level_word(lvl):
    return ("INFO", "WARN", "ERROR", "DEBUG")[int(lvl)]


def _log_lines(batch, svc_idx):
    rows = np.flatnonzero(batch.service == svc_idx)
    import datetime
    out = []
    for i in rows[:60]:
        ts = datetime.datetime.fromtimestamp(
            float(batch.t_s[i]), datetime.timezone.utc)
        out.append(f"{ts:%Y-%m-%d %H:%M:%S} {_level_word(batch.level[i])} "
                   f"request {i} handled")
    return "\n".join(out) + "\n"


def _series_labels(key):
    return dict(re.findall(r'(\w+)="([^"]*)"', key))


def write_tree(root, testbed, name, n_traces=10):
    """One experiment's five modality dirs, written from the generators
    in the reference artifact formats."""
    label = labels.label_for(name)
    base = root / f"{testbed}_data"
    d = lambda sub: base / sub / (name + STAMP[testbed])  # noqa: E731
    spans = synth.generate_spans(label, n_traces=n_traces)
    metrics = synth.generate_metrics(label, duration_s=90)
    logs, _ = synth.generate_logs(label, lines_per_service=30)
    api_b = synth.generate_api(label, n_records=40)
    cov_b = synth.generate_coverage(label, files_per_service=2)
    if testbed == "TT":
        p = d("trace_data")
        p.mkdir(parents=True)
        (p / f"{name}_skywalking_traces_1.json").write_text(
            json.dumps(synth.spans_to_skywalking_json(spans, name)))
        p = d("metric_data")
        p.mkdir(parents=True)
        met.write_metric_batch_tt_csv(metrics, p / "exp_metrics_1.csv")
        p = d("log_data")
        for s, svc in enumerate(logs.services[:4]):
            pod = p / f"{svc}-86d6f7876-99bhf"
            pod.mkdir(parents=True)
            (pod / "app.log").write_text(_log_lines(logs, s))
            (pod / "app_previous_1.log").write_text("ERROR skipped\n")
        p = d("api_responses") / "20251103"
        p.mkdir(parents=True)
        api.write_api_jsonl(api_b, p / "api_responses.jsonl")
        p = d("coverage_report")
        for i, svc in enumerate(cov_b.services[:3]):
            sd = p / svc
            sd.mkdir(parents=True)
            if i == 0:
                (sd / "coverage-summary.txt").write_text(
                    "TOTAL Lines 500 Cover 43%\n")
                continue
            rows = np.flatnonzero(cov_b.service == i)
            files = "".join(
                f'<sourcefile name="F{r}.java"><counter type="LINE" '
                f'missed="{cov_b.lines_total[r] - cov_b.lines_covered[r]}" '
                f'covered="{cov_b.lines_covered[r]}"/></sourcefile>'
                for r in rows)
            (sd / "coverage.xml").write_text(
                f'<report><package name="org/{svc}">{files}</package>'
                f'</report>')
    else:
        p = d("trace_data")
        p.mkdir(parents=True)
        if name.startswith("Svc"):
            sn_traces.write_jaeger_csv(spans, p / "all_traces.csv")
        else:
            (p / "all_traces.json").write_text(
                json.dumps(synth.spans_to_jaeger_json(spans)))
        p = d("metric_data")
        p.mkdir(parents=True)
        for m, mname in enumerate(metrics.metric_names[:5]):
            rows = np.flatnonzero(metrics.metric == m)
            lab = sorted({k for r in rows for k in _series_labels(
                metrics.series_keys[metrics.series[r]])})
            with open(p / f"{mname}.csv", "w") as f:
                f.write(",".join(["timestamp", "value", "metric"] + lab)
                        + "\n")
                for r in rows:
                    sl = _series_labels(metrics.series_keys[metrics.series[r]])
                    f.write(",".join([repr(float(metrics.t_s[r])),
                                      repr(float(metrics.value[r])), mname]
                                     + [sl.get(k, "") for k in lab]) + "\n")
        p = d("log_data")
        p.mkdir(parents=True)
        for s, svc in enumerate(logs.services[:3]):
            (p / f"{svc}_20251103.log").write_text(_log_lines(logs, s))
        if name.startswith("Perf"):
            (p / "summary.txt").write_text(
                "- ComposePostService: 124K (1001 lines) | errors=200, "
                "warnings=3\n- UserService: 2M (40 lines) | errors=1, "
                "warnings=0\n")
        p = d("api_responses")
        p.mkdir(parents=True)
        api.write_api_jsonl(api_b, p / "openapi_responses.jsonl")
        p = d("coverage_data")
        for s, svc in enumerate(cov_b.services[:3]):
            sd = p / svc
            sd.mkdir(parents=True)
            for r in np.flatnonzero(cov_b.service == s):
                lines = [f"        1:{k + 1}:x();"
                         if k < cov_b.lines_covered[r]
                         else f"    #####:{k + 1}:y();"
                         for k in range(int(cov_b.lines_total[r]) % 50)]
                (sd / f"src#f{r}.cpp.gcov").write_text(
                    "        -:    0:Source:f.cpp\n" + "\n".join(lines))
    # an LFS pointer stub beside the real artifacts of one modality
    stub = d("log_data") / "stub.log"
    stub.parent.mkdir(parents=True, exist_ok=True)
    stub.write_text("version https://git-lfs.github.com/spec/v1\n"
                    "oid sha256:deadbeef\nsize 12345\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for name in TT_LABELS[1:3]:
        write_tree(root, "TT", name)
    for name in SN_LABELS[1:3]:
        write_tree(root, "SN", name)
    return root


def _dirs(root, testbed, sub):
    return sorted((root / f"{testbed}_data" / sub).iterdir())


PARSERS = [
    ("TT", "trace_data", lambda m, d: m.load_skywalking_json(
        m.find_trace_artifact(d)), (tt_traces, jtt)),
    ("SN", "trace_data", lambda m, d: (
        m.load_jaeger_json if m.find_trace_artifact(d).suffix == ".json"
        else m.load_jaeger_csv)(m.find_trace_artifact(d)),
     (sn_traces, jsn)),
    ("TT", "metric_data", lambda m, d: m.load_tt_metric_csv(
        m.find_tt_metric_artifact(d)), (met, jmet)),
    ("SN", "metric_data", lambda m, d: m.load_sn_metric_dir(d), (met, jmet)),
    ("TT", "log_data", lambda m, d: m.load_tt_log_dir(d), (logs_io, jlogs)),
    ("SN", "log_data", lambda m, d: m.load_sn_log_dir(d), (logs_io, jlogs)),
    ("TT", "api_responses", lambda m, d: m.load_api_jsonl(
        m.find_api_artifact(d)), (api, japi)),
    ("SN", "api_responses", lambda m, d: m.load_api_jsonl(
        m.find_api_artifact(d)), (api, japi)),
    ("TT", "coverage_report", lambda m, d: m.load_tt_coverage_report(d),
     (cov, jcov)),
    ("SN", "coverage_data", lambda m, d: m.load_sn_coverage_dir(d),
     (cov, jcov)),
]


@pytest.mark.parametrize("testbed,sub,load,mods", PARSERS,
                         ids=[f"{t}-{s}" for t, s, _, _ in PARSERS])
def test_parser_equals_jax(tree, testbed, sub, load, mods):
    mine, ref = mods
    for d in _dirs(tree, testbed, sub):
        got, want = load(mine, d), load(ref, d)
        assert got is not None
        if isinstance(got, tuple) and not hasattr(got, "_fields"):
            assert got[0] is not None
        assert_same(got, want, d.name)


def test_lfs_and_small_parsers_equal(tmp_path):
    for i, text in enumerate(["", "version https://git-lfs.github.com/spec/"
                              "v1\noid sha256:ab\nsize 7\n", "plain\n"]):
        p = tmp_path / f"f{i}"
        p.write_text(text)
        for f in ("is_lfs_pointer", "lfs_real_size", "read_text_or_none"):
            assert getattr(lfs, f)(p) == getattr(jlfs, f)(p), (f, text)
    text = ("2025-11-03 22:02:28 INFO ok\nWARN x\n2025-11-03T22:02:29 "
            "java.lang.Exception: boom\nnothing\n")
    assert_same(logs_io.parse_log_lines(text, 3, 7.0),
                jlogs.parse_log_lines(text, 3, 7.0))
    for pod in ("ts-order-service-86d6f7876-99bhf", "redis-0", "x"):
        assert logs_io.pod_to_service(pod) == jlogs.pod_to_service(pod)


# -- loaders ------------------------------------------------------------------

def _cfgs(tmp_path, data_root=None, cache_on=True):
    jroot = data_root if data_root is not None else tmp_path / "none"
    return (Config(data_root=data_root,
                       cache_dir=tmp_path / "tc" if cache_on else None),
            JConfig(data_root=jroot,
                    cache_dir=tmp_path / "jc" if cache_on else None))


@pytest.mark.parametrize("name", [TT_LABELS[1], SN_LABELS[1], SN_LABELS[2],
                                  TT_LABELS[0]])
def test_load_experiment_over_tree_equals_jax(tree, tmp_path, name):
    tc, jc = _cfgs(tmp_path, tree)
    got = dataset.load_experiment(name, cfg=tc, n_synth_traces=8)
    want = jdataset.load_experiment(name, cfg=jc, n_synth_traces=8)
    assert_same_experiment(got, want)
    assert [e.name for e in dataset.discover(labels.label_for(name).testbed,
                                             tc)] == \
        [e.name for e in jdataset.discover(labels.label_for(name).testbed, jc)]


@pytest.mark.parametrize("testbed", ["TT", "SN"])
def test_load_corpus_equals_jax_synth_fallback(tmp_path, testbed):
    tc, jc = _cfgs(tmp_path, cache_on=False)
    got = dataset.load_corpus(testbed, cfg=tc, n_synth_traces=6, workers=0)
    want = jdataset.load_corpus(testbed, cfg=jc, n_synth_traces=6, workers=0)
    assert len(got) == 13 and all(e.synthetic for e in got)
    for a, b in zip(got, want):
        assert_same_experiment(a, b)


def test_parallel_load_equals_serial_and_jax(tree, tmp_path):
    tc, jc = _cfgs(tmp_path, tree)
    serial = dataset.load_corpus("SN", cfg=tc, n_synth_traces=6, workers=0)
    cache.reset_stats()
    pooled = dataset.load_corpus("SN", cfg=tc, n_synth_traces=6, workers=2)
    assert cache.stats().hits >= 60          # merged back from the workers
    want = jdataset.load_corpus("SN", cfg=jc, n_synth_traces=6, workers=0)
    for a, b, c in zip(serial, pooled, want):
        assert_same_experiment(a, b)
        assert_same_experiment(a, c)
    assert not all(e.synthetic for e in serial)


def test_load_bench_corpus_through_the_cache(tmp_path):
    tc, jc = _cfgs(tmp_path)
    want, _ = jdataset.load_bench_corpus("TT", 7, jc)
    assert dataset.bench_cache_status("TT", 7, tc) == (0, 1)
    cold = dataset.load_bench_corpus("TT", 7, tc)
    assert dataset.bench_cache_status("TT", 7, tc) == (1, 1)
    cache.reset_stats()
    warm = dataset.load_bench_corpus("TT", 7, tc)
    assert cache.stats().hits == 1
    assert_same(cold, want)
    assert_same(warm, want)
    assert dataset.bench_cache_status("TT", 7,
                                      Config(cache_dir=None)) == (0, 1)


# -- the cache ------------------------------------------------------------------

def test_cache_warm_equals_cold(tmp_path):
    tc, _ = _cfgs(tmp_path)
    cold = dataset.load_experiment("Lv_P_CPU_preserve", cfg=tc,
                                   n_synth_traces=10)
    cache.reset_stats()
    warm = dataset.load_experiment("Lv_P_CPU_preserve", cfg=tc,
                                   n_synth_traces=10)
    assert dataclasses.astuple(cache.stats()) == (5, 0, 0, 0)
    assert_same_experiment(cold, warm)


def test_cache_source_change_and_version_bumps(tree, tmp_path, monkeypatch):
    import shutil
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    tc, _ = _cfgs(tmp_path, root)
    name = TT_LABELS[1]
    load = lambda: dataset.load_experiment(  # noqa: E731
        name, cfg=tc, modalities=["metrics", "traces"], n_synth_traces=8)
    first = load()
    cache.reset_stats()
    load()
    assert cache.stats().hits == 2 and cache.stats().misses == 0
    # a source change: the artifact rewritten with shifted values
    art = next((root / "TT_data" / "metric_data").glob("*/*.csv"))
    m = first.metrics._replace(value=first.metrics.value + 100.0)
    met.write_metric_batch_tt_csv(m, art)
    os.utime(art, ns=(1, 1))
    cache.reset_stats()
    changed = load()
    assert cache.stats().misses == 1 and cache.stats().hits == 1
    assert np.nanmean(changed.metrics.value) > \
        np.nanmean(first.metrics.value) + 50
    # a loader version bump
    monkeypatch.setattr(met, "LOADER_VERSION", met.LOADER_VERSION + 1)
    cache.reset_stats()
    load()
    assert cache.stats().misses == 1
    # a generator version bump invalidates the synth-filled entries
    tc2, _ = _cfgs(tmp_path / "b")
    dataset.load_experiment(name, cfg=tc2, modalities=["api"])
    monkeypatch.setattr(synth, "SYNTH_VERSION", synth.SYNTH_VERSION + 1)
    cache.reset_stats()
    dataset.load_experiment(name, cfg=tc2, modalities=["api"])
    assert cache.stats().misses == 1 and cache.stats().hits == 0


def test_corrupt_entry_is_reparsed(tmp_path):
    tc, _ = _cfgs(tmp_path)
    cold = dataset.load_experiment("Svc_Kill_Media", cfg=tc,
                                   n_synth_traces=9)
    payloads = sorted((tmp_path / "tc").glob("*/*.npc"))
    assert len(payloads) == 5
    payloads[0].write_bytes(b"garbage")
    for p in payloads[1:]:
        p.write_bytes(p.read_bytes()[: p.stat().st_size // 3])
    cache.reset_stats()
    again = dataset.load_experiment("Svc_Kill_Media", cfg=tc,
                                    n_synth_traces=9)
    assert cache.stats().errors == 5 and cache.stats().hits == 0
    assert_same_experiment(cold, again)
    cache.reset_stats()
    dataset.load_experiment("Svc_Kill_Media", cfg=tc, n_synth_traces=9)
    assert cache.stats().hits == 5


def test_cache_keys_equal_jax(tree, tmp_path):
    parts = {"source": "parse", "modality": "logs", "n": 3,
             "nested": [1, "a", {"b": 2.5}], "path": tmp_path}
    assert cache.cache_key(parts) == jcache.cache_key(parts)
    assert cache.full_key("spans", parts) == jcache.full_key("spans", parts)
    for d in _dirs(tree, "SN", "log_data") + [tmp_path / "missing"]:
        assert cache.dir_fingerprint(d) == jcache.dir_fingerprint(d)
    label = labels.label_for("Lv_D_cachelimit")
    jl = jsynth.labels_mod.label_for("Lv_D_cachelimit")
    tc, jc = _cfgs(tmp_path)
    for mod in ("traces", "metrics"):
        assert dataset.synth_key_parts(mod, label, 10, tc) == \
            jdataset.synth_key_parts(mod, jl, 10, jc)
    assert dataset.bench_corpus_key_parts("SN", 40) == \
        jdataset.bench_corpus_key_parts("SN", 40)
    # an entry the port stores, the JAX cache reads back equal
    b = synth.generate_api(label, n_records=30)
    key = cache.full_key("api", parts)
    assert cache.store(tmp_path / "k", key, "api", b)
    assert_same(jcache.load(tmp_path / "k", key, "api")[0], b)


# -- settings -------------------------------------------------------------------

@pytest.mark.parametrize("env,field,want", [
    ({"ANOMOD_CACHE_DIR": "off"}, "cache_dir", None),
    ({"ANOMOD_CACHE_DIR": "None"}, "cache_dir", None),
    ({"ANOMOD_CACHE_DIR": "0"}, "cache_dir", None),
    ({"ANOMOD_CACHE_DIR": "/tmp/somewhere"}, "cache_dir", "/tmp/somewhere"),
    ({"ANOMOD_INGEST_WORKERS": "4"}, "ingest_workers", 4),
    ({"ANOMOD_INGEST_WORKERS": " 2 "}, "ingest_workers", 2),
    ({"ANOMOD_INGEST_WORKERS": "{WORKERS}"}, "ingest_workers", 0),
    ({"ANOMOD_SYNTH_ON_LFS": "0"}, "synth_on_lfs", False),
    ({"ANOMOD_SYNTH_ON_LFS": "false"}, "synth_on_lfs", False),
    ({"ANOMOD_SYNTH_ON_LFS": "yes"}, "synth_on_lfs", True),
    ({"ANOMOD_DATA_ROOT": "/data/anomod"}, "data_root", "/data/anomod"),
])
def test_settings_read_the_env_as_jax_does(monkeypatch, env, field, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, ref = getattr(Config(), field), getattr(JConfig(), field)
    got = str(got) if isinstance(got, os.PathLike) else got
    ref = str(ref) if isinstance(ref, os.PathLike) else ref
    assert got == ref == want


@pytest.mark.parametrize("raw", ["many", "-2", "1.5"])
def test_bad_ingest_workers_raise_as_jax(monkeypatch, raw):
    monkeypatch.setenv("ANOMOD_INGEST_WORKERS", raw)
    with pytest.raises(ValueError, match="ANOMOD_INGEST_WORKERS") as got:
        Config()
    with pytest.raises(ValueError) as want:
        JConfig()
    assert str(got.value) == str(want.value)


def test_unset_settings_stay_inside_the_checkout(monkeypatch):
    for k in ("ANOMOD_CACHE_DIR", "ANOMOD_DATA_ROOT"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(cfg.cache_dir).startswith(os.path.join(repo, "build"))
    assert cfg.data_root is None and cfg.tt_data is None
    assert dataset.discover("TT", cfg) == []
