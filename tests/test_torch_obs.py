"""The port's telemetry plane (``anomod_torch.obs``, ``utils.tracing``)
against the JAX package's, on the CPU.

Registries driven by the same calls must hold the same values and export
byte-equal Prometheus text and TT-CSV; the self-scrape mapping and its
detector reports must equal the JAX package's; a seeded serve run must
record the same counters, and the same rows on the virtual clock for
every series that does not read a wall clock.  The tracer round-trips
through Jaeger and Chrome, and the localhost endpoint answers.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from anomod.obs import export as jexport
from anomod.obs.registry import Registry as JRegistry
from anomod.obs.registry import delta_nbytes as jdelta_nbytes
from anomod.obs.registry import get_registry as jget_registry
from anomod.obs.registry import set_registry as jset_registry
from anomod.obs.selfscrape import score_self_scrape as jscore
from anomod.obs.selfscrape import spans_from_metrics as jspans
from anomod_torch.obs import export
from anomod_torch.obs.registry import (NULL, Registry, delta_nbytes,
                                       get_registry, set_registry)
from anomod_torch.obs.selfscrape import (report_gap, score_self_scrape,
                                         spans_from_metrics, stalled_registry)
from anomod_torch.replay import stage_planes
from anomod_torch.stream import StreamReplay
from anomod_torch.utils.tracing import Tracer, profile_to, spans_from_chrome
from test_obs import _simulated_stalled_run as jstalled


@pytest.fixture
def registry():
    """A fresh force-enabled registry installed as the port's process
    default, restored afterwards."""
    reg = Registry(enabled=True, max_samples=200_000)
    prev = get_registry()
    set_registry(reg)
    yield reg
    set_registry(prev)


def _drive(reg, seed=0):
    """The same calls into either package's registry: counters, gauges
    (plain and with adversarial labels), histograms by observe and by
    merged digests, scraped on a clock."""
    rng = np.random.default_rng(seed)
    c = reg.counter("anomod_serve_served_spans_total")
    g = reg.gauge("anomod_serve_backlog_spans")
    h = reg.histogram("anomod_serve_tick_seconds")
    lab = reg.gauge("anomod_test_evil", path='C:\\temp\n"quoted",comma')
    reg.gauge("anomod_test_evil", path="plain").set(8)
    reg.counter("anomod_ingest_cache_hits_total", reason="a\\b").inc(2)
    for t in range(40):
        c.inc(int(rng.integers(0, 500)))
        g.set(float(rng.uniform(900, 1100)))
        lab.set(float(t))
        for v in rng.uniform(0.009, 0.011, 20):
            h.observe(float(v))
        reg.scrape(now_s=float(t))
    return reg


# -- registry semantics -----------------------------------------------------

def test_counter_gauge_histogram_match_jax(registry):
    reg, jreg = _drive(registry), _drive(JRegistry(enabled=True,
                                                   max_samples=200_000))
    assert reg.snapshot() == jreg.snapshot()
    assert reg.journal() == jreg.journal()
    h = registry.histogram("anomod_serve_tick_seconds")
    assert h.count == 800 and h.quantile(0.5) == pytest.approx(0.01,
                                                                rel=0.05)
    c = registry.counter("anomod_test_events_total")
    with pytest.raises(ValueError):
        c.inc(-1)                       # counters are monotone
    g = registry.gauge("anomod_test_depth")
    g.set(7)
    g.inc(2)
    g.dec()
    assert g.value == 8
    assert registry.counter("anomod_test_events_total") is c
    with pytest.raises(ValueError, match="already registered"):
        registry.gauge("anomod_test_events_total")


def test_disabled_registry_is_noop():
    reg = Registry(enabled=False, max_samples=100)
    assert reg.counter("anomod_x_total") is NULL
    reg.counter("anomod_x_total").inc()
    reg.histogram("anomod_x_seconds").observe(1.0)
    reg.histogram("anomod_x_seconds").merge_digest(None)
    assert reg.scrape(now_s=0.0) == 0
    assert reg.snapshot() == {} and reg.n_samples == 0
    assert reg.fold_from(Registry(enabled=True, max_samples=10), {}) is None


def test_counter_thread_safety(registry):
    c = registry.counter("anomod_test_threads_total")

    def work():
        for _ in range(5_000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 40_000


def test_scrape_vs_record_hammer(registry):
    """Worker threads record while the main thread scrapes: every scraped
    histogram ``_count`` equals its ``_sum`` (each observation is 1.0),
    so no scrape journals a torn snapshot."""
    h = registry.histogram("anomod_test_hammer_seconds")
    c = registry.counter("anomod_test_hammer_total")
    n_threads, n_obs = 4, 10_000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def record():
        for _ in range(n_obs):
            h.observe(1.0)
            c.inc()

    threads = [threading.Thread(target=record) for _ in range(n_threads)]
    try:
        for t in threads:
            t.start()
        scrapes = 0
        while any(t.is_alive() for t in threads):
            registry.scrape(now_s=float(scrapes))
            scrapes += 1
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(prev)
    assert h.count == c.value == n_threads * n_obs
    rows = {}
    for t_s, name, _, val in registry.journal():
        rows.setdefault(t_s, {})[name] = val
    checked = 0
    for r in rows.values():
        if "anomod_test_hammer_seconds_count" in r:
            assert r["anomod_test_hammer_seconds_count"] == \
                r["anomod_test_hammer_seconds_sum"]
            checked += 1
    assert checked >= 2


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_fold_from_matches_jax(mode):
    """The shard seam: counters fold as deltas, gauges land on shard-
    labeled twins, histograms merge once at final and drain; the deltas
    and the folded registry equal the JAX package's."""
    out = []
    for R in (Registry, JRegistry):
        dst, src = R(enabled=True, max_samples=1000), \
            R(enabled=True, max_samples=1000)
        state, deltas = {}, []
        c = src.counter("anomod_serve_fused_dispatches_total")
        g = src.gauge("anomod_serve_lane_pad_waste_fraction")
        h = src.histogram("anomod_serve_fused_lanes")
        c.inc(3)
        g.set(0.25)
        for v in (1.0, 2.0, 4.0):
            h.observe(v)
        deltas.append(dst.fold_from(src, state, shard="0", mode=mode))
        c.inc(2)
        deltas.append(dst.fold_from(src, state, shard="0", mode=mode))
        deltas.append(dst.fold_from(src, state, shard="0", final=True,
                                    mode=mode))
        deltas.append(dst.fold_from(src, state, shard="0", final=True,
                                    mode=mode))
        h.observe(8.0)
        deltas.append(dst.fold_from(src, state, shard="0", final=True,
                                    mode=mode))
        out.append((dst.snapshot(), [repr(d) for d in deltas],
                    [(delta_nbytes if R is Registry else jdelta_nbytes)(d)
                     for d in deltas]))
    assert out[0] == out[1]
    snap = out[0][0]
    assert snap["anomod_serve_fused_dispatches_total"]["value"] == 5
    assert snap["anomod_serve_fused_lanes"]["count"] == 4
    assert snap['anomod_serve_lane_pad_waste_fraction{shard="0"}'][
        "value"] == 0.25


def test_histogram_merge_digest_matches_jax(registry):
    from anomod.ops.tdigest import tdigest_build as jbuild
    from anomod_torch.ops.tdigest import tdigest_build
    vals = np.linspace(1.0, 3.0, 512).astype(np.float32)
    jreg = JRegistry(enabled=True, max_samples=10)
    h, jh = registry.histogram("anomod_x_seconds"), \
        jreg.histogram("anomod_x_seconds")
    for _ in range(2):
        h.merge_digest(tdigest_build(vals, k=32))
        jh.merge_digest(jbuild(vals, k=32))
    assert h.count == jh.count == 1024
    assert h.sum == jh.sum
    assert h.quantile(0.5) == jh.quantile(0.5) == pytest.approx(2.0,
                                                                rel=0.05)
    assert h.samples() == jh.samples()


def test_scrape_journal_bound_and_batch(registry):
    g = registry.gauge("anomod_serve_backlog_spans")
    for t in range(10):
        g.set(t)
        registry.scrape(now_s=float(t))
    batch = export.to_metric_batch(registry)
    assert batch.n_samples == 10
    assert batch.metric_names == ("anomod_serve_backlog_spans",)
    assert batch.services == ("serve",)
    assert 'service="serve"' in batch.series_keys[0]
    small = Registry(enabled=True, max_samples=5)
    c = small.counter("anomod_x_total")
    for t in range(20):
        c.inc()
        small.scrape(now_s=float(t))
    assert small.n_samples == 5
    assert [r[3] for r in small.journal()] == [16.0, 17.0, 18.0, 19.0, 20.0]


# -- exporters: byte-equal to the JAX package's ------------------------------

def test_prometheus_text_byte_equal(registry):
    jreg = _drive(JRegistry(enabled=True, max_samples=200_000))
    text = export.to_prometheus_text(_drive(registry))
    assert text == jexport.to_prometheus_text(jreg)
    assert "# TYPE anomod_serve_tick_seconds summary" in text
    assert 'anomod_serve_tick_seconds{quantile="0.99"}' in text
    assert text.count("# HELP anomod_test_evil ") == 1
    assert '\\n' in text and '\\"' in text and "\\\\" in text


def test_tt_csv_byte_equal_and_loads_back(registry, tmp_path):
    from anomod_torch.io.metrics import load_tt_metric_csv
    jreg = _drive(JRegistry(enabled=True, max_samples=200_000))
    _drive(registry)
    n = export.export_tt_csv(registry, tmp_path / "port.csv")
    jn = jexport.export_tt_csv(jreg, tmp_path / "jax.csv")
    assert n == jn == registry.n_samples
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert load_tt_metric_csv(tmp_path / "port.csv").n_samples == n
    assert export.export_prometheus_text(registry, tmp_path / "m.prom") \
        == len(registry.metrics())
    assert (tmp_path / "m.prom").read_text() == \
        export.to_prometheus_text(registry)
    assert list(tmp_path.glob("*.tmp")) == []


# -- self-scrape: equal to the JAX package's ----------------------------------

def test_spans_from_metrics_matches_jax():
    batch = export.to_metric_batch(stalled_registry())
    jbatch = jexport.to_metric_batch(jstalled())
    got, want = spans_from_metrics(batch), jspans(jbatch)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    # counter streams contribute rates, not their cumulative values
    reg = Registry(enabled=True, max_samples=10_000)
    c = reg.counter("anomod_serve_served_spans_total")
    for t in range(50):
        c.inc(100)
        reg.scrape(now_s=float(t))
    spans = spans_from_metrics(export.to_metric_batch(reg))
    assert spans.n_spans == 49
    assert set(spans.duration_us.tolist()) == {1_000_000}


#: the port's self-scrape z-scores against the JAX package's: a series
#: held near one value has a log-latency variance that is a small
#: difference of two f32 moment sums (E[x^2] - E[x]^2), so the order of
#: the adds moves z.  The port's dense fold, like the JAX CPU chunk step,
#: sums a moment's bf16 hi and lo halves apart and adds the two sums after
#: the fold, so the reports are equal: measured gap 0 on the stall
#: registry (all six alerts) and on the healthy one.  (When the fold added
#: ``hi + lo`` a row, the stall registry's gap was 0.0508.)
RTOL_SELFSCRAPE_JAX = 0.0

_SCORE_KW = dict(window_s=10.0, baseline_windows=4, z_threshold=4.0)


def _score_both(tmp_path, reg, stall_after_s, **port_kw):
    """One timeline through each package's TT-CSV export and self-scrape
    scoring (``reg`` holds the port's): (port report, JAX report)."""
    export.export_tt_csv(reg, tmp_path / "port.csv")
    jexport.export_tt_csv(jstalled(stall_after_s=stall_after_s),
                          tmp_path / "jax.csv")
    return (score_self_scrape(tmp_path / "port.csv", device="cpu",
                              **_SCORE_KW, **port_kw),
            jscore(tmp_path / "jax.csv", **_SCORE_KW))


@pytest.mark.parametrize("stall_after_s", [140.0, 1e9],
                         ids=["stall", "healthy"])
def test_self_scrape_report_matches_jax(tmp_path, stall_after_s):
    """registry -> TT-CSV -> load_tt_metric_csv -> the detector: the
    stall localizes to ``serve`` after its onset, the healthy run stays
    quiet, and both reports equal the JAX package's (the alerts' scores
    within :data:`RTOL_SELFSCRAPE_JAX`)."""
    reg = stalled_registry(stall_after_s=stall_after_s)
    got, want = _score_both(tmp_path, reg, stall_after_s)
    gap = report_gap(got, want)
    assert gap is not None, (got, want)
    assert gap <= RTOL_SELFSCRAPE_JAX
    if stall_after_s < 1e9:
        assert got["alerted_subsystems"] == ["serve"]
        assert got["n_alerts"] > 0
        assert all(a["window"] >= 14 for a in got["alerts"])
        assert got["ranked_subsystems"][0] == "serve"
    else:
        assert got["n_alerts"] == 0
    # the direct MetricBatch path scores the same
    assert score_self_scrape(export.to_metric_batch(reg), device="cpu",
                             **_SCORE_KW) == got


class _JaxOrderReplay(StreamReplay):
    """The stream plane with a chunk fold that adds in the JAX CPU
    scatter step's order (``anomod/replay.py`` ``_scatter_rhs`` /
    ``_split_acc``): the bf16 hi and lo halves of each moment summed
    apart over the chunk, then added to each other and to the state."""

    def __init__(self, cfg, t0_us, device=None, with_hll=False):
        super().__init__(cfg, t0_us, device=device, with_hll=with_hll)
        SW, H = cfg.sw, cfg.n_hist_buckets

        def step(state, chunk):
            sid, planes = stage_planes(chunk, xp=torch)
            exact = planes[0:3].to(torch.bfloat16).float()
            hi = planes[3:6].to(torch.bfloat16).float()
            lo = (planes[3:6] - hi).to(torch.bfloat16).float()
            bucket = planes[4].to(torch.int64).clamp(0, H - 1)
            onehot = torch.nn.functional.one_hot(bucket, H).T * exact[0]
            rows = torch.cat([exact, hi, lo, onehot]).T.contiguous()
            acc = torch.zeros((SW + 1, rows.shape[1])).index_add_(
                0, sid.long(), rows)[:SW]
            agg = torch.cat([acc[:, :3], acc[:, 3:6] + acc[:, 6:9]], 1)
            return state._replace(agg=state.agg + agg,
                                  hist=state.hist + acc[:, 9:])
        self._step = step


@pytest.mark.parametrize("stall_after_s", [140.0, 1e9],
                         ids=["stall", "healthy"])
def test_jax_order_fold_reproduces_jax_reports(tmp_path, stall_after_s):
    """Why :data:`RTOL_SELFSCRAPE_JAX` is 0: the port's detector with a
    chunk fold written out in the JAX order gives the JAX reports to the
    last printed digit, and so does the port's own fold."""
    reg = stalled_registry(stall_after_s=stall_after_s)
    got, want = _score_both(tmp_path, reg, stall_after_s,
                            replay_factory=_JaxOrderReplay)
    assert got == want
    assert score_self_scrape(tmp_path / "port.csv", device="cpu",
                             **_SCORE_KW) == want


# -- instrumented layers --------------------------------------------------------

_SERVE_KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1200,
                 overload=1.5, duration_s=12, tick_s=1.0, seed=5,
                 window_s=4.0, baseline_windows=2, fault_tenants=0)

#: series on the virtual clock that read no wall clock
_WALL_SERIES = ("_seconds_total", "anomod_serve_tick_seconds")


def _virtual_rows(reg, names):
    return {(t, n, lab): v for t, n, lab, v in reg.journal()
            if n.split("_count")[0].split("_sum")[0].split("_p50")[0]
            .split("_p99")[0].split("_max")[0] in names
            and not any(w in n for w in _WALL_SERIES)}


def test_serve_registry_wiring_matches_jax(registry):
    """A small seeded serve run: counters equal to the report and to the
    JAX engine's registry, and equal virtual-clock rows for every series
    that does not read a wall clock; the tracer is on by default."""
    from anomod.serve.engine import run_power_law as jrun
    from anomod_torch.serve.engine import run_power_law
    jreg = JRegistry(enabled=True, max_samples=200_000)
    prev = jget_registry()
    jset_registry(jreg)
    try:
        _, jrep = jrun(flight=True, **_SERVE_KW)
    finally:
        jset_registry(prev)
    eng, rep = run_power_law(device="cpu", flight=True, **_SERVE_KW)
    assert registry.counter("anomod_serve_served_spans_total").value \
        == rep.served_spans == jrep.served_spans > 0
    assert registry.counter("anomod_serve_offered_spans_total").value \
        == rep.offered_spans
    assert registry.counter("anomod_serve_ticks_total").value == rep.ticks
    lat = registry.histogram("anomod_serve_admit_to_scored_seconds")
    assert lat.count == sum(s.n_samples for s in eng._slo.values())
    assert registry.counter("anomod_serve_live_rows_total").value \
        == rep.served_spans
    assert registry.counter("anomod_serve_compile_total").value == 4
    assert registry.counter("anomod_serve_fused_compile_total").value == 24
    # every series the port emits, compared where it reads no wall clock
    names = {m.name for m in registry.metrics()}
    jnames = {m.name for m in jreg.metrics()}
    assert names <= jnames
    for m in registry.metrics():
        if m.kind == "histogram" or any(w in m.name for w in _WALL_SERIES):
            continue
        assert m.value == jreg._metrics[(m.name, m.rendered)].value, m.name
    rows = _virtual_rows(registry, names)
    assert rows and rows == _virtual_rows(jreg, names)
    assert max(t for t, _, _ in rows) <= 13.0
    assert eng.tracer is not None
    assert {s["name"] for s in spans_from_chrome(eng.tracer.to_chrome())} \
        == {"serve.run", "serve.admit", "serve.drain", "serve.score_fused",
            "serve.score_shard"}


def test_serve_telemetry_off_keeps_decisions():
    """Registry off: no metric, no tracer, the same decisions."""
    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
    off = Registry(enabled=False, max_samples=10)
    prev = get_registry()
    set_registry(off)
    try:
        e_off, r_off = run_power_law(device="cpu", **_SERVE_KW)
    finally:
        set_registry(prev)
    assert e_off.tracer is None and off.n_samples == 0
    on = Registry(enabled=True, max_samples=10_000)
    prev = get_registry()
    set_registry(on)
    try:
        e_on, r_on = run_power_law(device="cpu", **_SERVE_KW)
    finally:
        set_registry(prev)
    assert on.n_samples > 0
    skip = set(VARIANT_REPORT_FIELDS)
    assert {k: v for k, v in r_off.to_dict().items() if k not in skip} == \
        {k: v for k, v in r_on.to_dict().items() if k not in skip}
    for tid in e_on._tenant_det:
        assert e_on.alerts_for(tid) == e_off.alerts_for(tid)


def test_cache_instrumentation_mirrors_stats(tmp_path, registry):
    import dataclasses

    from anomod_torch.config import Config
    from anomod_torch.io import cache
    from anomod_torch.schemas import ApiBatch
    cfg = dataclasses.replace(Config(), cache_dir=tmp_path / "cache")
    value = ApiBatch(endpoint=np.zeros(2, np.int32),
                     t_s=np.array([1.0, 2.0]),
                     status=np.array([200, 200], np.int16),
                     latency_ms=np.array([1.0, 2.0]),
                     content_length=np.zeros(2, np.int64),
                     endpoints=("/a",))
    cache.cached("api", {"k": 1}, lambda: value, cfg=cfg)
    cache.cached("api", {"k": 1}, lambda: value, cfg=cfg)
    for event in ("misses", "hits", "stores"):
        assert registry.counter(
            f"anomod_ingest_cache_{event}_total").value >= 1
    assert registry.counter(
        "anomod_ingest_cache_written_bytes_total").value > 0
    assert registry.counter(
        "anomod_ingest_cache_read_bytes_total").value > 0


def test_prefetch_stream_replay_instrumentation(registry):
    from anomod_torch import labels, synth
    from anomod_torch.io.prefetch import Pipeline
    from anomod_torch.replay import ReplayConfig, measure_throughput
    from anomod_torch.stream import stream_experiment
    assert list(Pipeline(range(10), lambda x: x * 2, depth=2)) == \
        [2 * i for i in range(10)]
    assert registry.histogram("anomod_prefetch_stage_seconds").count == 10
    spans = synth.generate_spans(labels.labels_for_testbed("TT")[0],
                                 n_traces=20)
    cfg = ReplayConfig(n_services=spans.n_services, chunk_size=1024)
    stream_experiment(spans, cfg=cfg, device="cpu")
    assert registry.histogram("anomod_stream_push_seconds").count > 0
    assert registry.counter("anomod_stream_compile_total").value >= 1
    measure_throughput(spans, cfg, repeats=2, kernel="cuda", device="cpu")
    assert registry.histogram("anomod_replay_dispatch_seconds",
                              kernel="cuda").count == 2
    assert registry.counter("anomod_replay_compile_total",
                            kernel="cuda").value == 1


# -- the endpoint ---------------------------------------------------------------

def test_http_endpoint_metrics_healthz_flight(registry):
    from anomod_torch.obs.http import PROM_CONTENT_TYPE, ObsHttpServer
    registry.counter("anomod_serve_ticks_total").inc(3)
    with ObsHttpServer(registry=registry, port=0) as srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"] == PROM_CONTENT_TYPE
            assert r.read().decode() == export.to_prometheus_text(registry)
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["status"] == "ok" and doc["registry"]["n_metrics"] == 1
        for path, want in (("/flight", "no flight recorder attached"),
                           ("/nope", "no route /nope")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.url + path, timeout=10)
            assert e.value.code == 404
            assert json.loads(e.value.read())["error"] == want
        req = urllib.request.Request(srv.url + "/metrics", method="HEAD")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200 and r.read() == b""


# -- env knobs --------------------------------------------------------------------

@pytest.mark.parametrize("env,field", [
    ({"ANOMOD_OBS_ENABLED": "0"}, "obs_enabled"),
    ({"ANOMOD_OBS_ENABLED": "off"}, "obs_enabled"),
    ({}, "obs_enabled"),
    ({"ANOMOD_OBS_MAX_SAMPLES": "77"}, "obs_max_samples"),
    ({"ANOMOD_OBS_HTTP": "yes"}, "obs_http"),
    ({"ANOMOD_OBS_HTTP_PORT": "0"}, "obs_http_port"),
    ({}, "obs_http_port"),
])
def test_obs_knobs_read_the_env_as_jax_does(monkeypatch, env, field):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert getattr(Config(), field) == getattr(JConfig(), field)


@pytest.mark.parametrize("var,bad", [
    ("ANOMOD_OBS_MAX_SAMPLES", "nope"), ("ANOMOD_OBS_MAX_SAMPLES", "0"),
    ("ANOMOD_OBS_HTTP", "maybe"), ("ANOMOD_OBS_HTTP_PORT", "70000"),
    ("ANOMOD_OBS_HTTP_PORT", "x")])
def test_bad_obs_knobs_raise_as_jax(monkeypatch, var, bad):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    monkeypatch.setenv(var, bad)
    with pytest.raises(ValueError, match=var) as got:
        Config()
    with pytest.raises(ValueError) as want:
        JConfig()
    assert str(got.value) == str(want.value)


# -- the tracer -------------------------------------------------------------------

def test_tracer_thread_local_stacks():
    tr = Tracer("anomod-test")
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            with tr.span("worker.stage"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    with tr.span("main.pipeline"):
        for t in threads:
            t.start()
        for _ in range(200):
            with tr.span("main.step"):
                pass
        stop.set()
        for t in threads:
            t.join()
    doc = tr.to_jaeger()["data"][0]
    by_id = {s["spanID"]: s for s in doc["spans"]}
    for s in doc["spans"]:
        if s["operationName"] == "main.step":
            assert by_id[s["references"][0]["spanID"]]["operationName"] \
                == "main.pipeline"
        elif s["operationName"] == "worker.stage":
            assert s["references"] == []


def test_tracer_jaeger_roundtrip_and_dump(tmp_path):
    import time

    from anomod_torch.io.sn_traces import spans_from_jaeger
    tr = Tracer("anomod-test")
    with tr.span("pipeline", phase="bench"):
        with tr.span("load"):
            time.sleep(0.01)
        with tr.span("detect") as sp:
            sp.event("windows-scored", n=7)
    batch = spans_from_jaeger(tr.to_jaeger())
    names = [batch.endpoints[int(e)] for e in batch.endpoint]
    root = names.index("pipeline")
    assert batch.n_spans == 3 and batch.services == ("anomod-test",)
    assert int(batch.parent[names.index("load")]) == root
    assert int(batch.parent[names.index("detect")]) == root
    assert int(batch.duration_us[names.index("load")]) >= 10_000
    spans = tr.to_jaeger()["data"][0]["spans"]
    assert {"key": "phase", "value": "bench"} in next(
        s for s in spans if s["operationName"] == "pipeline")["tags"]
    assert next(s for s in spans
                if s["operationName"] == "detect")["logs"][0]["fields"]
    path = tmp_path / "trace.json"
    path.write_text('{"stale": true}')
    tr.dump(path)
    assert json.loads(path.read_text()) == tr.to_jaeger()
    assert list(tmp_path.glob("*.tmp")) == []


def test_tracer_chrome_roundtrip(tmp_path):
    tr = Tracer("anomod-test")
    with tr.span("pipeline", phase="bench"):
        with tr.span("load"):
            pass
        with tr.span("detect"):
            pass
    events = tr.to_chrome()
    assert all(e["ph"] == "X" and isinstance(e["ts"], int) for e in events)
    shuffled = sorted(events, key=lambda e: e["ts"], reverse=True)
    spans = spans_from_chrome([{"ph": "M", "name": "process_name"}]
                              + shuffled)
    assert [s["name"] for s in spans] == ["pipeline", "load", "detect"]
    assert spans[0]["parent"] is None
    assert spans[1]["parent"] == spans[2]["parent"] == 0
    assert spans[0]["tags"] == {"phase": "bench"}
    path = tmp_path / "trace_chrome.json"
    tr.dump_chrome(path)
    assert json.loads(path.read_text()) == events


def test_profile_to_writes_a_chrome_trace(tmp_path):
    import torch
    with profile_to(None):
        pass
    with profile_to(str(tmp_path / "prof")):
        torch.ones(64).sum()
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]


# -- the CLI ------------------------------------------------------------------------

def test_obs_cli_export_chrome_and_score(tmp_path, capsys):
    from anomod_torch.cli import main
    out = tmp_path / "serve_trace.json"
    assert main(["obs", "export", "--format", "chrome", "--out", str(out),
                 "--serve-seconds", "4", "--tenants", "4", "--capacity",
                 "1000", "--device", "cpu"]) == 0
    names = {s["name"] for s in spans_from_chrome(json.loads(
        out.read_text()))}
    assert "serve.run" in names and "serve.admit" in names
    csv = tmp_path / "self.csv"
    assert main(["obs", "export", "--out", str(csv), "--serve-seconds", "4",
                 "--tenants", "4", "--capacity", "1000",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["obs", "score", "--from", str(csv), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    # the self-exercise serves with the flight recorder on, as the JAX
    # package's does: its series form a second subsystem
    assert report["subsystems"] == ["serve", "flight"] \
        and report["n_samples"] > 0
    with pytest.raises(SystemExit):
        main(["obs", "export"])                 # needs --out


def test_pooled_loader_instrumentation(tmp_path, registry):
    """The spawn pool's per-experiment wall and pending depth."""
    import dataclasses

    from anomod_torch.config import Config
    from anomod_torch.io import dataset
    cfg = dataclasses.replace(Config(), cache_dir=None, data_root=None)
    exps = dataset.load_corpus("SN", cfg=cfg, n_synth_traces=4,
                               modalities=["traces"], workers=2)
    assert len(exps) == 13
    assert registry.histogram(
        "anomod_ingest_pool_experiment_seconds").count == 13
    assert registry.gauge("anomod_ingest_pool_pending").value == 0
