"""The port's live feed (``anomod_torch.serve.feed``), the multimodal serve
sidecar and their CLI against the JAX package's, on the CPU.

- The exposition parser gives the JAX parser's rows on the adversarial
  label scrape (``tests/test_feed.py``) and on a rendered registry.
- Wire journals cross between the packages: the JAX dogfood run's
  journal (``tests/test_feed.py``'s sizes) replayed by the port gives the
  JAX replay's canonical flight journal byte for byte, with equal states,
  alerts, latency and shed; a journal the port records loads and replays
  in the JAX package.
- A Prometheus-and-Jaeger stub feed at a pinned ``t0_wall_s``, recorded
  live by both packages, gives equal wire entries, gap counts and
  canonical journals; the watermarks never redeliver, and
  ``ReplayTransport`` fails loud.
- The sidecar at ``tests/test_serve.py``'s run (``Svc_Kill_UserTimeline``,
  100 traces) gives the JAX engine's alerts and ``modality_events`` and
  the port's sequential ``MultimodalDetector``'s alerts; each of its four
  refusals raises on request in the JAX words and turns itself off under
  the defaults.
- ``serve --from-live self`` / ``--live-replay`` and ``audit replay`` of
  a live-feed journal end to end, with the JAX CLI's checks.

Tolerance 0 throughout: every comparison is byte or value equality.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
from torch_http_stub import JsonStub

from anomod.obs.http import ObsHttpServer as JObsHttpServer
from anomod.obs.registry import Registry as JRegistry
from anomod.obs.registry import set_registry as jset_registry
from anomod.serve import feed as jfeed
from anomod_torch import labels, synth
from anomod_torch.obs.export import to_prometheus_text
from anomod_torch.obs.flight import load_journal
from anomod_torch.obs.http import ObsHttpServer
from anomod_torch.obs.registry import (Registry, get_registry,
                                       render_labels, set_registry)
from anomod_torch.serve import feed
from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg

#: ``tests/test_feed.py``'s dogfood run
DOGFOOD = dict(capacity_spans_per_s=2000.0, duration_s=6.0, tick_s=1.0,
               window_s=2.0, baseline_windows=2, buckets=(64,),
               n_windows=16, flight=True, flight_digest_every=2)
#: the stub feed's pinned wall anchor (epoch s)
T0_WALL = 1_700_000_000.0


@contextlib.contextmanager
def fresh_registries():
    """A fresh enabled registry in each package for the block."""
    prev = get_registry()
    set_registry(Registry(enabled=True))
    jprev = jset_registry(JRegistry(enabled=True))
    try:
        yield
    finally:
        set_registry(prev)
        jset_registry(jprev)


def _agg(replay):
    a = replay.state.agg
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def assert_same_run(a, b):
    """Two (engine, report) runs agree on every decision plane: states,
    alerts, latency, shed, served spans and the canonical journal."""
    (ea, ra), (eb, rb) = a, b
    assert (ra.served_spans, ra.shed_fraction, ra.latency) \
        == (rb.served_spans, rb.shed_fraction, rb.latency)
    assert sorted(ea._tenant_replay) == sorted(eb._tenant_replay)
    for t in ea._tenant_replay:
        np.testing.assert_array_equal(_agg(ea._tenant_replay[t]),
                                      _agg(eb._tenant_replay[t]))
    assert sorted(ea._tenant_det) == sorted(eb._tenant_det)
    for t in ea._tenant_det:
        assert [dataclasses.asdict(x) for x in ea.alerts_for(t)] \
            == [dataclasses.asdict(x) for x in eb.alerts_for(t)]
    assert ea.flight_recorder.canonical_bytes() \
        == eb.flight_recorder.canonical_bytes()


# -- the exposition parser ---------------------------------------------------

def test_parser_equals_jax_on_adversarial_and_rendered_scrapes():
    reg = Registry(enabled=True)
    nasty = 'multi\nline "quoted" back\\slash'
    reg.gauge("anomod_serve_backlog_spans", pod=nasty, plain="ok").set(42.5)
    reg.counter("anomod_ingest_rows_total").inc(3)
    reg.histogram("anomod_serve_tick_seconds").observe(0.25)
    with ObsHttpServer(registry=reg, port=0) as srv:
        text = feed.HttpTransport(timeout=5.0).request_text(
            f"{srv.url}/metrics")
    assert text == to_prometheus_text(reg)
    rows = feed.parse_prometheus_text(text)
    assert rows == jfeed.parse_prometheus_text(text)
    want = {(m.name, render_labels(m.labels), m.value)
            for m in reg.metrics() if m.kind != "histogram"}
    assert want <= set(rows)
    extra = ('# HELP x y\n\nbad_value{a="1"} NaNx\nbare 7\n'
             'esc{a="\\q\\n"} 2 1700000000\n')
    assert feed.parse_prometheus_text(extra) \
        == jfeed.parse_prometheus_text(extra)
    for broken in ('m{a="1" 2', 'm{a=1} 2', 'm{a="1} 2'):
        with pytest.raises(ValueError) as got:
            feed.parse_prometheus_text(broken)
        with pytest.raises(ValueError) as want_e:
            jfeed.parse_prometheus_text(broken)
        assert str(got.value) == str(want_e.value)


# -- the wire journal across the packages --------------------------------------

@pytest.fixture(scope="module")
def dogfood(tmp_path_factory):
    """The JAX dogfood run recorded live and replayed, the port's replay
    of that journal, and a port-recorded dogfood run with its replay."""
    root = tmp_path_factory.mktemp("wire")
    out = {"jax_wire": root / "jax.json", "port_wire": root / "port.json"}
    with fresh_registries():
        with JObsHttpServer(port=0) as srv:
            j_live = jfeed.run_live_feed(
                scrape_url=f"{srv.url}/metrics", n_tenants=4, n_services=4,
                journal=out["jax_wire"], **DOGFOOD)
        out["jax_live"] = j_live
        out["jax_replay"] = jfeed.run_live_feed(replay=out["jax_wire"],
                                                **DOGFOOD)
        out["port_of_jax"] = feed.run_live_feed(
            replay=out["jax_wire"], device="cpu", **DOGFOOD)
    with fresh_registries():
        with ObsHttpServer(port=0) as srv:
            out["port_live"] = feed.run_live_feed(
                scrape_url=f"{srv.url}/metrics", n_tenants=4, n_services=4,
                journal=out["port_wire"], device="cpu", **DOGFOOD)
        out["port_replay"] = feed.run_live_feed(
            replay=out["port_wire"], device="cpu", **DOGFOOD)
        out["jax_of_port"] = jfeed.run_live_feed(replay=out["port_wire"],
                                                 **DOGFOOD)
    return out


def test_jax_wire_journal_replays_in_the_port(dogfood):
    jeng, jrep, jf = dogfood["jax_replay"]
    eng, rep, f = dogfood["port_of_jax"]
    doc = jfeed.load_feed_journal(dogfood["jax_wire"])
    assert feed.load_feed_journal(dogfood["jax_wire"]) == doc
    assert isinstance(f.transport, feed.ReplayTransport)
    assert f.transport.n_served == len(doc["entries"]) == jf.n_polls
    assert (f.n_polls, f.n_samples, f.n_spans, f.n_gaps) \
        == (jf.n_polls, jf.n_samples, jf.n_spans, jf.n_gaps)
    assert rep.served_spans > 0
    assert_same_run((eng, rep), (jeng, jrep))
    # the JAX live run is its own replay's twin, so the port's too
    assert eng.flight_recorder.canonical_bytes() \
        == dogfood["jax_live"][0].flight_recorder.canonical_bytes()
    # the header sizes the replay fleet
    assert f.n_tenants == 4 and len(f.services) == 4
    run = eng.flight_recorder.header["run"]
    jrun = jeng.flight_recorder.header["run"]
    assert run == jrun and run["traffic"] == "live_feed"


def test_port_wire_journal_loads_and_replays_in_jax(dogfood):
    eng, rep, f = dogfood["port_live"]
    doc = jfeed.load_feed_journal(dogfood["port_wire"])
    assert doc["feed_format"] == feed.FEED_WIRE_FORMAT == 1
    assert doc["header"] == f.header() and doc["header"]["n_tenants"] == 4
    assert doc["entries"] == f.journal_entries()
    assert len(doc["entries"]) == f.n_polls == 6
    assert [e["kind"] for e in doc["entries"]] == ["text"] * 6
    assert rep.served_spans > 0
    assert_same_run(dogfood["port_replay"][:2], (eng, rep))
    jeng, jrep, _ = dogfood["jax_of_port"]
    assert_same_run((eng, rep), (jeng, jrep))


# -- a Prometheus-and-Jaeger stub at a pinned anchor ----------------------------

def _stub_route(method, path, params, body):
    """Prometheus ``query_range`` and Jaeger REST over one synthetic
    minute after :data:`T0_WALL`.  ``late_q`` and ``svc-late`` deliver
    only what is 4 s older than the window's end: stragglers the bridge
    clamps forward (gap-fill).  Every answer is a function of the request
    alone."""
    if path == "/api/v1/query_range":
        lo, hi = float(params["start"]), float(params["end"])
        q = params["query"]
        if q == "late_q":
            hi -= 4.0
        ts = [T0_WALL + 0.5 * i for i in range(-4, 120)]
        vals = [[t, str(round(10 + 3 * np.sin(t) + (t - T0_WALL) * 0.1, 4))]
                for t in ts if lo <= t <= hi]
        name = {"up": "anomod_serve_up", "late_q": "anomod_ingest_rows",
                "rate_q": "anomod_replay_rate"}[q]
        return 200, {"status": "success", "data": {
            "resultType": "matrix",
            "result": [{"metric": {"__name__": name, "pod": "p0"},
                        "values": vals}] if vals else []}}
    if path == "/api/services":
        return 200, {"data": ["svc-b", "svc-a", "svc-late"]}
    if path == "/api/traces":
        lo, hi = int(params["start"]), int(params["end"])
        svc = params["service"]
        if svc == "svc-late":
            hi -= 4_000_000
        step = {"svc-a": 250_000, "svc-b": 400_000,
                "svc-late": 500_000}[svc]
        t0_us = int(T0_WALL * 1e6)
        data = []
        for i in range(-8, 240):
            start = t0_us + i * step
            if not lo <= start <= hi:
                continue
            data.append({"traceID": f"{svc}-{i}", "spans": [
                {"startTime": start, "duration": 1000 + 37 * (i % 11),
                 "operationName": f"op{i % 3}",
                 "tags": ([{"key": "error", "value": True}]
                          if i % 13 == 0 else [])},
                {"startTime": start + 100, "duration": 400 + (i % 5)}]})
        return 200, {"data": data}
    return 404, {}


def _drive(pkg, engine_cls, f, **kw):
    """Serve a feed the way ``run_live_feed`` builds its engine."""
    cfg = serve_plane_cfg(len(f.services), DOGFOOD["window_s"],
                          DOGFOOD["n_windows"])
    eng = engine_cls(f.specs, f.services, cfg,
                     capacity_spans_per_s=DOGFOOD["capacity_spans_per_s"],
                     tick_s=DOGFOOD["tick_s"], buckets=DOGFOOD["buckets"],
                     baseline_windows=DOGFOOD["baseline_windows"],
                     flight=True,
                     flight_digest_every=DOGFOOD["flight_digest_every"],
                     **kw)
    rep = eng.run(f, duration_s=12.0)
    return eng, rep


@pytest.fixture(scope="module")
def stub_feeds():
    from anomod.serve.engine import ServeEngine as JServeEngine
    stub = JsonStub(_stub_route)
    src = dict(prom_url=stub.base_url, prom_queries=("up", "late_q",
                                                     "rate_q"),
               jaeger_url=stub.base_url, n_tenants=4, n_services=4,
               lag_s=2.0, t0_wall_s=T0_WALL)
    try:
        with fresh_registries():
            pf = feed.LiveFeed(**src)
            port = _drive(feed, ServeEngine, pf, device="cpu")
            jf = jfeed.LiveFeed(**src)
            jax = _drive(jfeed, JServeEngine, jf)
            rf = feed.LiveFeed.from_journal(
                {"header": pf.header(), "entries": pf.journal_entries()})
            replay = _drive(feed, ServeEngine, rf, device="cpu")
    finally:
        stub.close()
    return dict(pf=pf, jf=jf, rf=rf, port=port, jax=jax, replay=replay)


def test_stub_feed_recorded_live_equals_jax(stub_feeds):
    pf, jf = stub_feeds["pf"], stub_feeds["jf"]
    assert pf.journal_entries() == jf.journal_entries()
    assert (pf.n_polls, pf.n_samples, pf.n_spans, pf.n_gaps) \
        == (jf.n_polls, jf.n_samples, jf.n_spans, jf.n_gaps)
    # three queries and three services a tick, the service list once
    assert pf.n_polls == 12 * 6 and pf.n_gaps > 0 and pf.n_spans > 0
    assert pf._tokens == jf._tokens and pf._endpoints == jf._endpoints
    assert_same_run(stub_feeds["port"], stub_feeds["jax"])
    assert_same_run(stub_feeds["replay"], stub_feeds["port"])
    rf = stub_feeds["rf"]
    assert rf.transport.n_served == len(pf.journal_entries())
    assert rf.n_gaps == pf.n_gaps


def test_watermarks_never_redeliver(stub_feeds):
    pf = stub_feeds["pf"]
    assert len(pf._jspans) == len(set(pf._jspans))
    stamps = {}
    for _, name, labels_, _v in pf._mrows:
        stamps.setdefault(name, 0)
        stamps[name] += 1
    # each query's samples arrive once: the stub's grid up to the last
    # poll's ceiling (``late_q`` 4 s behind it)
    ceiling = T0_WALL + 12.0 - pf.lag_s
    grid = [T0_WALL + 0.5 * i for i in range(-4, 120)]
    mark0 = T0_WALL - pf.lag_s
    assert stamps["anomod_serve_up"] == sum(mark0 < t <= ceiling
                                            for t in grid)
    assert stamps["anomod_ingest_rows"] == sum(mark0 < t <= ceiling - 4
                                               for t in grid)
    marks = [int(e["params"].get("start", -1)) for e in pf.journal_entries()
             if e["path"] == "/api/traces"
             and e["params"]["service"] == "svc-a"]
    assert marks == sorted(marks)            # monotone watermarks


def test_replay_transport_fails_loud_and_foreign_docs_refused(tmp_path):
    rt = feed.ReplayTransport([{"kind": "text", "path": "/metrics",
                                "params": {}, "payload": None,
                                "body": "x 1\n"}])
    with pytest.raises(feed.TransportError, match="divergence"):
        rt.request_json("http://h/other")
    assert rt.request_text("http://elsewhere:1/metrics") == "x 1\n"
    with pytest.raises(feed.TransportError, match="exhausted"):
        rt.request_text("http://h/metrics")
    p = tmp_path / "not_feed.json"
    p.write_text(json.dumps({"flight_format": 1}))
    with pytest.raises(ValueError) as got:
        feed.load_feed_journal(p)
    with pytest.raises(ValueError) as want:
        jfeed.load_feed_journal(p)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one source"):
        feed.LiveFeed()
    with pytest.raises(ValueError, match="prom_queries"):
        feed.LiveFeed(prom_url="http://h")


def test_gap_fill_clamps_stragglers_to_the_tick_edge():
    stub = JsonStub(lambda *a: (200, {"status": "success", "data": {
        "resultType": "matrix", "result": [{"metric": {"__name__": "up"},
                                            "values": [[T0_WALL - 1.5,
                                                        "1"]]}]}}))
    try:
        with fresh_registries():
            f = feed.LiveFeed(prom_url=stub.base_url, prom_queries=("up",),
                              n_tenants=2, n_services=2, lag_s=2.0,
                              t0_wall_s=T0_WALL)
            f.arrivals(5.0, 6.0)
            gaps = get_registry().counter("anomod_feed_gaps_total").value
    finally:
        stub.close()
    assert f.n_gaps == 1 and gaps == 1
    assert [r[0] for r in f._mrows] == [5.0]        # clamped, not dropped
    assert f.modality_arrivals(5.0, 6.0) == []


def test_feed_knobs_validated_as_jax_does(monkeypatch, tmp_path):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    monkeypatch.setenv("ANOMOD_SERVE_FEED_LAG_S", "3.5")
    monkeypatch.setenv("ANOMOD_FEED_JOURNAL", str(tmp_path / "w.json"))
    cfg, jcfg = Config(), JConfig()
    assert (cfg.serve_feed_lag_s, cfg.feed_journal) \
        == (jcfg.serve_feed_lag_s, jcfg.feed_journal) \
        == (3.5, tmp_path / "w.json")
    for raw in ("off", "none", ""):
        monkeypatch.setenv("ANOMOD_FEED_JOURNAL", raw)
        assert Config().feed_journal is JConfig().feed_journal is None
    for bad in ("slow", "-1", "3600.5"):
        monkeypatch.setenv("ANOMOD_SERVE_FEED_LAG_S", bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
    monkeypatch.delenv("ANOMOD_SERVE_FEED_LAG_S")
    assert Config().serve_feed_lag_s == JConfig().serve_feed_lag_s == 2.0


# -- the multimodal sidecar ----------------------------------------------------

def _sidecar_inputs():
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.queues import TenantSpec
    from anomod_torch.serve.traffic import ScriptedTraffic
    label = labels.label_for("Svc_Kill_UserTimeline")
    exp = synth.generate_experiment(label, n_traces=100, seed=0)
    t0 = int(exp.spans.start_us.min())
    cfg = ReplayConfig(n_services=len(exp.spans.services), chunk_size=4096)
    specs = [TenantSpec(tenant_id=0, name="t0")]
    traffic = ScriptedTraffic({0: exp.spans}, specs, t0,
                              experiments={0: exp})
    return label, exp, t0, cfg, specs, traffic


SIDECAR_KW = dict(capacity_spans_per_s=10_000_000, tick_s=60.0,
                  buckets=(256, 1024), max_backlog=10_000_000,
                  baseline_windows=8)


@pytest.fixture(scope="module")
def sidecar():
    label, exp, t0, cfg, specs, traffic = _sidecar_inputs()
    duration = traffic.end_s() + 60.0
    with fresh_registries():
        eng = ServeEngine(specs, exp.spans.services, cfg, t0_us=t0,
                          multimodal=True, testbed=label.testbed,
                          device="cpu", **SIDECAR_KW)
        rep = eng.run(traffic, duration_s=duration)
    return eng, rep, traffic, duration


def test_sidecar_equals_jax_and_the_sequential_detector(sidecar):
    from anomod import labels as jlabels
    from anomod import synth as jsynth
    from anomod.replay import ReplayConfig as JReplayConfig
    from anomod.serve.engine import ServeEngine as JServeEngine
    from anomod.serve.queues import TenantSpec as JTenantSpec
    from anomod.serve.traffic import ScriptedTraffic as JScriptedTraffic
    from anomod_torch.stream import MultimodalDetector, StreamReplay
    eng, rep, traffic, duration = sidecar
    assert min(rep.modality_events[k] for k in ("logs", "metrics", "api")) > 0
    label = jlabels.label_for("Svc_Kill_UserTimeline")
    exp = jsynth.generate_experiment(label, n_traces=100, seed=0)
    t0 = int(exp.spans.start_us.min())
    jspecs = [JTenantSpec(tenant_id=0, name="t0")]
    with fresh_registries():
        jeng = JServeEngine(jspecs, exp.spans.services,
                            JReplayConfig(n_services=len(exp.spans.services),
                                          chunk_size=4096),
                            t0_us=t0, multimodal=True, testbed=label.testbed,
                            **SIDECAR_KW)
        jrep = jeng.run(JScriptedTraffic({0: exp.spans}, jspecs, t0,
                                         experiments={0: exp}),
                        duration_s=duration)
    alerts = [dataclasses.asdict(a) for a in eng.alerts_for(0)]
    assert alerts == [dataclasses.asdict(a) for a in jeng.alerts_for(0)]
    assert rep.modality_events == jrep.modality_events
    assert eng.flight_recorder.canonical_bytes() \
        == jeng.flight_recorder.canonical_bytes()
    assert eng.flight_recorder.header["engine"]["multimodal"] is True
    # the port's own sequential detector, fed the same one-clock slices
    solo = MultimodalDetector(eng.services, eng.cfg, eng.t0_us,
                              testbed=eng.testbed,
                              replay=StreamReplay(eng.cfg, eng.t0_us,
                                                  device="cpu"),
                              baseline_windows=8)
    t = 0.0
    while t < duration:
        for _, kind, mb in traffic.modality_arrivals(t, t + 60.0):
            getattr(solo, f"push_{kind}")(mb)
        for _, mb in traffic.arrivals(t, t + 60.0):
            solo.push(mb)
        t += 60.0
    solo.finish()
    assert solo.alerts
    assert alerts == [dataclasses.asdict(a) for a in solo.alerts]


@pytest.mark.parametrize("mode", [dict(shards=2), dict(async_commit=True),
                                  dict(fuse=False)],
                         ids=["2-shards", "deferred", "unfused"])
def test_sidecar_equals_the_inline_run_in_every_tick_mode(sidecar, mode):
    """The sidecar rides thread shards, the deferred commit and the unfused
    path unchanged: alerts, ``modality_events`` and the canonical journal
    equal the inline run's."""
    eng, rep, _, duration = sidecar
    label, exp, t0, cfg, specs, traffic = _sidecar_inputs()
    with fresh_registries():
        other = ServeEngine(specs, exp.spans.services, cfg, t0_us=t0,
                            multimodal=True, testbed=label.testbed,
                            device="cpu", **{**SIDECAR_KW, **mode})
        orep = other.run(traffic, duration_s=duration)
    assert [dataclasses.asdict(a) for a in other.alerts_for(0)] \
        == [dataclasses.asdict(a) for a in eng.alerts_for(0)]
    assert orep.modality_events == rep.modality_events
    assert other.flight_recorder.canonical_bytes() \
        == eng.flight_recorder.canonical_bytes()


def test_offer_modality_checks():
    label, exp, t0, cfg, specs, _ = _sidecar_inputs()
    plain = ServeEngine(specs, exp.spans.services, cfg, t0_us=t0,
                        device="cpu", ckpt_every=0)
    with pytest.raises(ValueError, match="multimodal=True"):
        plain.offer_modality(0, "logs", exp.logs)
    eng = ServeEngine(specs, exp.spans.services, cfg, t0_us=t0,
                      multimodal=True, testbed=label.testbed, device="cpu")
    with pytest.raises(ValueError, match="unknown modality kind"):
        eng.offer_modality(0, "coverage", exp.logs)
    eng.offer_modality(0, "logs", exp.logs)
    assert eng.modality_events == {"logs": exp.logs.n_lines}
    assert plain.report().modality_events == {}


#: each refused plane: its explicit request, its env knob and value, and
#: how to read that the plane is off
REFUSALS = {
    "policy": (dict(policy="auto"), ("ANOMOD_SERVE_POLICY", "auto"),
               lambda e: e.policy is None),
    "tiering": (dict(tier_hot=4), ("ANOMOD_SERVE_TIER_HOT", "4"),
                lambda e: e.tier_hot == 0 and e._tier is None),
    "supervision": (dict(ckpt_every=8), ("ANOMOD_SERVE_CKPT_EVERY", "8"),
                    lambda e: e.ckpt_every == 0 and e._supervisor is None),
    "process": (dict(worker="process"), ("ANOMOD_SERVE_WORKER", "process"),
                lambda e: e.worker_mode == "thread"),
}


@pytest.mark.parametrize("plane", sorted(REFUSALS))
def test_sidecar_refusals_as_jax(plane, monkeypatch):
    from anomod.replay import ReplayConfig as JReplayConfig
    from anomod.serve.engine import ServeEngine as JServeEngine
    from anomod.serve.queues import TenantSpec as JTenantSpec
    from anomod_torch.config import Config, set_config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.queues import TenantSpec
    request, (var, val), off = REFUSALS[plane]
    cfg = ReplayConfig(n_services=2, n_windows=8, window_us=5_000_000,
                       chunk_size=1024)
    specs = [TenantSpec(tenant_id=0, name="t0")]
    with pytest.raises(ValueError) as got:
        ServeEngine(specs, ["a", "b"], cfg, multimodal=True, device="cpu",
                    **request)
    with pytest.raises(ValueError) as want:
        JServeEngine([JTenantSpec(tenant_id=0, name="t0")], ["a", "b"],
                     JReplayConfig(n_services=2, n_windows=8,
                                   window_us=5_000_000, chunk_size=1024),
                     multimodal=True, **request)
    assert str(got.value) == str(want.value)
    assert "multimodal sidecar" in str(got.value)
    monkeypatch.setenv(var, val)
    prev = set_config(Config())
    try:
        eng = ServeEngine(specs, ["a", "b"], cfg, multimodal=True,
                          device="cpu")
        assert off(eng)
        # without the sidecar the plane stays on
        assert not off(ServeEngine(specs, ["a", "b"], cfg, device="cpu"))
    finally:
        set_config(prev)
    if plane == "process":
        assert ServeEngine(specs, ["a", "b"], cfg, multimodal=True,
                           device="cpu")._process_blockers()[0] \
            == "the multimodal sidecar planes share coordinator memory"


# -- the CLI --------------------------------------------------------------------

LIVE_ARGS = ["--duration", "6", "--tenants", "4", "--services", "4",
             "--capacity", "2000", "--window-seconds", "2",
             "--baseline-windows", "2", "--buckets", "64", "--device", "cpu"]


def test_cli_serve_from_live_self_then_live_replay(tmp_path, capsys):
    from anomod_torch.cli import main
    wire = tmp_path / "wire.json"
    with fresh_registries():
        assert main(["serve", "--from-live", "self", "--feed-journal",
                     str(wire), "--feed-lag", "1.5"] + LIVE_ARGS) == 0
    live = json.loads(capsys.readouterr().out)
    doc = feed.load_feed_journal(wire)
    assert doc["header"]["lag_s"] == 1.5 and doc["header"]["n_tenants"] == 4
    assert live["served_spans"] > 0 and live["device"] == "cpu"
    with fresh_registries():
        assert main(["serve", "--live-replay", str(wire)] + LIVE_ARGS) == 0
    replay = json.loads(capsys.readouterr().out)
    for k in ("served_spans", "shed_fraction", "latency", "n_alerts",
              "offered_spans", "dispatches_by_width"):
        assert replay[k] == live[k], k


@pytest.mark.parametrize("argv, words", [
    (["--from-live", "self", "--live-replay", "x"], "contradicts"),
    (["--from-live", "localhost:9"], "a URL (or 'self')"),
    (["--from-live", "self", "--chaos", "crash@2:shard=0"], "--chaos"),
    (["--from-live", "self", "--rca"], "--rca"),
    (["--from-live", "self", "--policy", "auto"], "--policy"),
    (["--live-replay", "x", "--async-commit"], "--async-commit"),
    (["--live-replay", "x", "--worker", "process"], "--worker"),
    (["--live-replay", "x", "--fold", "dense"], "--fold"),
    (["--live-replay", "x", "--state", "host"], "--state"),
    (["--live-replay", "x", "--ckpt-every", "4"], "--ckpt-every"),
    (["--live-replay", "x", "--trace-out", "t.json"], "--trace-out"),
])
def test_cli_serve_live_refusals(argv, words, capsys):
    from anomod_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["serve", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert words in capsys.readouterr().err


def test_cli_audit_replays_a_live_feed_journal(dogfood, tmp_path, capsys):
    from anomod_torch.cli import main
    eng = dogfood["port_live"][0]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    eng.flight_recorder.dump(a)
    assert load_journal(a)["header"]["run"]["feed_journal"] \
        == str(dogfood["port_wire"])
    with fresh_registries():
        assert main(["audit", "replay", str(a), "--out", str(b),
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["seed"] is None and got["ticks"] == 7
    assert main(["audit", "diff", str(a), str(b)]) == 0
    assert json.loads(capsys.readouterr().out)["identical"] is True
    with pytest.raises(SystemExit):
        main(["audit", "replay", str(a), "--out", str(b), "--state", "host",
              "--device", "cpu"])
    assert "--state applies to power-law journals" in capsys.readouterr().err
    doc = load_journal(a)
    doc["header"]["run"]["feed_journal"] = str(tmp_path / "gone.json")
    c = tmp_path / "c.json"
    c.write_text(json.dumps(doc))
    with pytest.raises(SystemExit):
        main(["audit", "replay", str(c), "--out", str(b), "--device", "cpu"])
    assert "wire journal is missing" in capsys.readouterr().err
