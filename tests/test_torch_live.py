"""The port's live-transport clients (``anomod_torch.io.live``) and the ES
trace loader (``anomod_torch.io.tt_traces_es``) against the JAX
package's: each port client and its JAX twin, pointed at the same
in-process stub on ``127.0.0.1`` (``tests/test_live.py``'s routes and
sizes), send the same request sequence and write byte-identical
artifacts, which load through the port's loaders to the JAX loaders'
batches; the retry / backoff schedule and the errors are equal; and
``collect``'s four HTTP kinds print the JAX CLI's ``CollectReport``.
"""

import base64
import json
from pathlib import Path

import pytest
from torch_http_stub import JsonStub

from anomod.io import live as jlive
from anomod.io import metrics as jmet
from anomod.io import sn_traces as jsn
from anomod.io import tt_traces as jtt
from anomod.io import tt_traces_es as jes
from anomod_torch import labels, synth
from anomod_torch.io import live, metrics, sn_traces, tt_traces
from anomod_torch.io import tt_traces_es as es
from test_torch_data import assert_same

T0 = 1_700_000_000


@pytest.fixture
def stub_factory():
    stubs = []

    def make(route):
        s = JsonStub(route)
        stubs.append(s)
        return s

    yield make
    for s in stubs:
        s.close()


def _transports():
    """A port and a JAX transport that record their sleeps."""
    slept = ([], [])
    return ((live.HttpTransport(timeout=5.0, sleep=slept[0].append),
             jlive.HttpTransport(timeout=5.0, sleep=slept[1].append)),
            slept)


def _both(stub, make, call):
    """``call(client)`` on the port client, then on the JAX twin, against
    one stub: both results and both request sequences."""
    (tp, jtp), _ = _transports()
    got = call(make(live)(stub.base_url, transport=tp))
    reqs = stub.take()
    want = call(make(jlive)(stub.base_url, transport=jtp))
    return got, want, reqs, stub.take()


def _report(rep, root):
    """A CollectReport as JSON, its files relative to ``root``."""
    d = rep.to_json()
    d["files"] = [str(Path(f).relative_to(root)) for f in d["files"]]
    return d


# -- the transport ----------------------------------------------------------

def test_retry_schedule_and_errors_equal_jax(stub_factory):
    calls = {"n": 0}

    def flaky(method, path, params, body):
        calls["n"] += 1
        return (500, {"err": "boom"}) if calls["n"] % 2 else (200, {"ok": 1})

    (tp, jtp), slept = _transports()
    stub = stub_factory(flaky)
    assert tp.request_json(stub.base_url + "/x") == {"ok": 1}
    assert jtp.request_json(stub.base_url + "/x") == {"ok": 1}
    assert slept == ([3.0], [3.0])           # min(3 * attempt, 10)
    assert len(stub.take()) == 4

    dead = stub_factory(lambda *a: (500, {}))
    (tp, jtp), slept = _transports()
    errs = []
    for t in (tp, jtp):
        with pytest.raises((live.TransportError,
                            jlive.TransportError)) as e:
            t.request_json(dead.base_url + "/x")
        errs.append(str(e.value))
    assert type(e.value) is jlive.TransportError
    assert slept == ([3.0, 6.0], [3.0, 6.0]) and len(dead.take()) == 6
    assert errs[0] == errs[1]

    # a 4xx is permanent: no retry, the server's body in the message
    bad = stub_factory(lambda *a: (400, {"error": "parse error at 3"}))
    (tp, jtp), slept = _transports()
    msgs = []
    for t in (tp, jtp):
        with pytest.raises(Exception) as e:
            t.request_text(bad.base_url + "/q", params={"a": 1})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "parse error at 3" in msgs[0]
    assert slept == ([], []) and len(bad.take()) == 2


# -- Prometheus --------------------------------------------------------------

def _prom_payload(series):
    return {"status": "success",
            "data": {"resultType": "matrix",
                     "result": [{"metric": labels_, "values": values}
                                for labels_, values in series]}}


def _sn_route(method, path, params, body):
    assert path == "/api/v1/query_range"
    if params["query"] == "microservice_request_rate":
        return 200, _prom_payload([
            ({"service": "nginx-web-server", "job": "prom"},
             [[T0 + 15 * i, str(1.5 + i)] for i in range(4)]),
            ({"service": "compose-post-service", "job": "prom"},
             [[T0 + 15 * i, str(9.0 + i)] for i in range(4)])])
    if params["query"] == "system_cpu_usage":
        return 200, _prom_payload([({"instance": "node0"}, [[T0, "0.93"]])])
    return 200, {"status": "success", "data": {"result": []}}


def _tt_route(method, path, params, body):
    if params["query"] == "rate(node_cpu_seconds_total[5m])":
        return 200, _prom_payload([
            ({"__name__": "node_cpu_seconds_total",
              "pod": "ts-order-service-7f9b5"},
             [[T0, "0.4"], [T0 + 15, "0.5"]])])
    if params["query"] == "up":
        return 200, _prom_payload([({"pod": "ts-travel-service-x1y2z"},
                                    [[T0, "1"]])])
    return 200, {"status": "success", "data": {"result": []}}


def test_prometheus_sn_artifacts_equal_jax(stub_factory, tmp_path):
    queries = {n: n for n in ("microservice_request_rate",
                              "system_cpu_usage", "redis_memory_used")}
    got, want, reqs, jreqs = _both(
        stub_factory(_sn_route), lambda m: m.PrometheusClient,
        lambda c: c.collect_sn(queries, tmp_path / c.__module__,
                               T0, T0 + 60))
    assert reqs == jreqs and len(reqs) == 3
    a, b = tmp_path / live.__name__, tmp_path / jlive.__name__
    assert _report(got, a) == _report(want, b)
    assert got.n_skipped == 1 and len(got.files) == 2
    for f in got.files:
        assert Path(f).read_bytes() == (b / Path(f).name).read_bytes()
    port = metrics.load_sn_metric_dir(a)
    assert port.n_samples == 9
    assert_same(port, jmet.load_sn_metric_dir(b))


def test_prometheus_tt_long_csv_equal_jax(stub_factory, tmp_path):
    queries = ["rate(node_cpu_seconds_total[5m])", "up", "node_load5"]
    got, want, reqs, jreqs = _both(
        stub_factory(_tt_route), lambda m: m.PrometheusClient,
        lambda c: c.collect_tt(queries, tmp_path / c.__module__ / "m.csv",
                               T0, T0 + 60))
    assert reqs == jreqs
    a, b = tmp_path / live.__name__, tmp_path / jlive.__name__
    assert _report(got, a) == _report(want, b)
    assert (got.n_records, got.n_skipped) == (3, 1)
    assert (a / "m.csv").read_bytes() == (b / "m.csv").read_bytes()
    assert_same(metrics.load_tt_metric_csv(a / "m.csv"),
                jmet.load_tt_metric_csv(b / "m.csv"))


def test_prometheus_error_and_watermark_equal_jax(stub_factory):
    err = stub_factory(lambda *a: (200, {"status": "error",
                                         "error": "bad query"}))
    msgs = []
    for mod in (live, jlive):
        with pytest.raises(Exception, match="bad query") as e:
            mod.PrometheusClient(err.base_url).query_range("x", 0, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

    def route(method, path, params, body):
        return 200, _prom_payload([({"__name__": "up", "pod": "a"},
                                    [[T0 + 15 * i, str(i)]
                                     for i in range(4)])])

    def poll_twice(c):
        fresh, mark = c.query_range_since("up", T0 + 10, T0 + 60)
        return (fresh, mark) + c.query_range_since("up", mark, T0 + 60)

    got, want, reqs, jreqs = _both(stub_factory(route),
                                   lambda m: m.PrometheusClient, poll_twice)
    assert got == want and reqs == jreqs
    assert [ts for ts, _, _ in got[0]] == [T0 + 15, T0 + 30, T0 + 45]
    assert got[1] == got[3] == T0 + 45 and got[2] == []   # no redelivery


# -- Jaeger ------------------------------------------------------------------

def _jaeger_route(doc):
    svc_names = sorted({p["serviceName"] for tr in doc["data"]
                        for p in tr["processes"].values()})

    def route(method, path, params, body):
        if path == "/api/services":
            return 200, {"data": svc_names}
        if path == "/api/traces":
            svc = params["service"]
            return 200, {"data": [tr for tr in doc["data"]
                                  if any(p["serviceName"] == svc
                                         for p in tr["processes"].values())]}
        return 404, {}

    return route


def _no_window(reqs):
    """Requests without ``collect_all``'s wall-clock window."""
    return [(m, p, {k: v for k, v in q.items() if k not in ("start", "end")},
             b) for m, p, q, b in reqs]


def test_jaeger_collect_all_equal_jax(stub_factory, tmp_path):
    batch = synth.generate_spans(labels.label_for("Perf_CPU_Contention"),
                                 n_traces=25, seed=7)
    doc = synth.spans_to_jaeger_json(batch)
    stub = stub_factory(_jaeger_route(doc))
    got, want, reqs, jreqs = _both(
        stub, lambda m: m.JaegerClient,
        lambda c: c.collect_all(tmp_path / c.__module__ / "all.json"))
    assert _no_window(reqs) == _no_window(jreqs)
    a, b = tmp_path / live.__name__, tmp_path / jlive.__name__
    assert _report(got, a) == _report(want, b)
    assert got.n_records == len(doc["data"]) and got.n_skipped > 0
    assert (a / "all.json").read_bytes() == (b / "all.json").read_bytes()
    port = sn_traces.load_jaeger_json(a / "all.json")
    assert port.n_spans == batch.n_spans
    assert_same(port, jsn.load_jaeger_json(b / "all.json"))
    # a pinned window is the same request, start and end included
    got, want, reqs, jreqs = _both(
        stub, lambda m: m.JaegerClient,
        lambda c: c.traces(next(iter(doc["data"][0]["processes"].values()))
                           ["serviceName"], now_s=float(T0)))
    assert got == want and reqs == jreqs


def test_jaeger_since_watermark_equal_jax(stub_factory):
    t0_us = T0 * 1_000_000

    def route(method, path, params, body):
        return 200, {"data": [
            {"spans": [{"startTime": t0_us + 1_000_000, "duration": 50}]},
            {"spans": [{"startTime": t0_us + 2_000_000, "duration": 60}]}]}

    def poll_twice(c):
        fresh, mark = c.traces_since("svc", t0_us + 1_500_000,
                                     t0_us + 9_000_000)
        return (fresh, mark) + c.traces_since("svc", mark, t0_us + 9_000_000)

    got, want, reqs, jreqs = _both(stub_factory(route),
                                   lambda m: m.JaegerClient, poll_twice)
    assert got == want and reqs == jreqs
    assert len(got[0]) == 1 and got[2] == []
    assert got[1] == got[3] == t0_us + 2_000_000


# -- SkyWalking GraphQL --------------------------------------------------------

def _sw_route(artifact, dup=True):
    summaries, spans_by_tid = [], {}
    for t in artifact["traces"]:
        summaries.append({"traceIds": [t["trace_id"]],
                          "duration": t["summary"]["duration"], "start": 0,
                          "isError": t["summary"]["is_error"],
                          "endpointNames": []})
        spans_by_tid[t["trace_id"]] = [{
            "traceId": sp["trace_id"], "segmentId": sp["segment_id"],
            "spanId": sp["span_id"], "parentSpanId": sp["parent_span_id"],
            "serviceCode": sp["service_code"],
            "startTime": sp["start_timestamp_ms"],
            "endTime": sp["end_timestamp_ms"],
            "endpointName": sp["endpoint_name"], "type": sp["type"],
            "peer": sp["peer"], "component": sp["component"],
            "isError": sp["is_error"], "layer": sp["layer"],
            "tags": sp["tags"], "refs": sp["refs"]} for sp in t["spans"]]
    if dup:
        summaries.append(summaries[0])       # exercises trace-id dedup

    def route(method, path, params, body):
        q = body["query"]
        if "queryBasicTraces" in q:
            paging = body["variables"]["condition"]["paging"]
            n, size = paging["pageNum"], paging["pageSize"]
            return 200, {"data": {"data": {
                "total": len(summaries),
                "traces": summaries[(n - 1) * size:n * size]}}}
        if "queryTrace" in q:
            tid = body["variables"]["traceId"]
            return 200, {"data": {"trace": {
                "spans": spans_by_tid.get(tid, [])}}}
        return 400, {"errors": [{"message": "unknown query"}]}

    return route


def test_skywalking_collect_equal_jax(stub_factory, tmp_path):
    name = "Lv_D_TRANSACTION_timeout"
    batch = synth.generate_spans(labels.label_for(name), n_traces=9, seed=3)
    artifact = synth.spans_to_skywalking_json(batch, name)
    stub = stub_factory(_sw_route(artifact))
    got, want, reqs, jreqs = _both(
        stub, lambda m: (lambda url, transport: m.SkyWalkingClient(
            url + "/graphql", transport=transport)),
        lambda c: c.collect(tmp_path / type(c).__module__ / "sw.json",
                            experiment=name, page_size=4,
                            now_s=float(T0)))
    assert reqs == jreqs
    assert len([r for r in reqs if "queryBasicTraces" in r[3]["query"]]) \
        == 3                                  # ceil((9 + 1) / 4) pages
    a, b = tmp_path / live.__name__, tmp_path / jlive.__name__
    assert _report(got, a) == _report(want, b)
    assert got.n_records == batch.n_spans
    assert (a / "sw.json").read_bytes() == (b / "sw.json").read_bytes()
    port = tt_traces.load_skywalking_json(a / "sw.json")
    assert_same(port, jtt.load_skywalking_json(b / "sw.json"))
    assert_same(port, tt_traces.spans_from_skywalking(artifact))

    err = stub_factory(lambda *a: (200, {"errors": [{"message": "nope"}]}))
    msgs = []
    for mod in (live, jlive):
        with pytest.raises(Exception, match="graphql error") as e:
            mod.SkyWalkingClient(err.base_url).trace_spans("t1")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="limit must be >= 1"):
        live.SkyWalkingClient(err.base_url).trace_summaries(limit=0)


# -- Elasticsearch and the detailed_traces loader -----------------------------

def _b64(name):
    return base64.b64encode(name.encode()).decode() + ".1"


ES_SOURCES = [
    {"trace_id": "t-1", "segment_id": "seg-a",
     "service_id": _b64("ts-order-service"), "endpoint_name": "/order",
     "start_time": 1_700_000_000_000, "end_time": 1_700_000_000_120,
     "latency": 120, "is_error": 0},
    {"trace_id": "t-1", "segment_id": "seg-b",
     "service_id": _b64("ts-travel-service"), "endpoint_name": "/travel",
     "start_time": 1_700_000_000_050, "end_time": 1_700_000_000_090,
     "latency": 40, "is_error": 1},
    {"trace_id": "t-2", "segment_id": "seg-c",
     "service_id": _b64("ts-order-service"), "endpoint_name": "/order",
     "start_time": 1_700_000_001_000, "end_time": 1_700_000_001_030,
     "latency": 30, "is_error": 0},
]


def _es_route(method, path, params, body):
    assert method == "POST" and path == "/sw_segment-*/_search"
    return 200, {"hits": {"hits": [{"_source": s} for s in ES_SOURCES]}}


def test_es_collect_and_loader_equal_jax(stub_factory, tmp_path):
    got, want, reqs, jreqs = _both(
        stub_factory(_es_route), lambda m: m.ElasticsearchClient,
        lambda c: c.collect(tmp_path / c.__module__ / "dt.json", size=500,
                            hours_back=2.0, now_s=float(T0 + 100)))
    assert reqs == jreqs and reqs[0][3]["size"] == 500
    a, b = tmp_path / live.__name__, tmp_path / jlive.__name__
    assert _report(got, a) == _report(want, b) and got.n_records == 3
    assert (a / "dt.json").read_bytes() == (b / "dt.json").read_bytes()
    port = es.load_detailed_traces_json(a / "dt.json")
    assert set(port.services) == {"ts-order-service", "ts-travel-service"}
    assert sorted(port.duration_us.tolist()) == [30_000, 40_000, 120_000]
    assert_same(port, jes.load_detailed_traces_json(b / "dt.json"))
    # the loader's CSV route, its analysis document and report
    csv_path = tmp_path / "dt.csv"
    csv_path.write_text("trace_id,service_id,endpoint_name,start_time,"
                        "end_time,latency,is_error\n" + "".join(
                            f"{s['trace_id']},{s['service_id']},"
                            f"{s['endpoint_name']},{s['start_time']},"
                            f"{s['end_time']},{s['latency']},"
                            f"{s['is_error']}\n" for s in ES_SOURCES))
    assert_same(es.load_detailed_traces_csv(csv_path),
                jes.load_detailed_traces_csv(csv_path))
    assert es.decode_service_id("") == jes.decode_service_id("") \
        == "unknown"
    assert es.decode_service_id("!!.1") == jes.decode_service_id("!!.1")
    empty = es.analyze_trace_patterns(es._records_to_batch([]))
    assert empty == jes.analyze_trace_patterns(jes._records_to_batch([]))
    analysis = es.analyze_trace_patterns(port)
    assert analysis == jes.analyze_trace_patterns(
        jes.load_detailed_traces_json(b / "dt.json"))
    assert es.format_analysis_report(analysis) \
        == jes.format_analysis_report(analysis)
    pa = es.write_trace_analysis(port, tmp_path / "pa")
    ja = jes.write_trace_analysis(
        jes.load_detailed_traces_json(b / "dt.json"), tmp_path / "ja")
    assert pa.read_bytes() == ja.read_bytes()
    assert pa.with_suffix(".txt").read_bytes() \
        == ja.with_suffix(".txt").read_bytes()
    assert es.load_trace_analysis(pa) == jes.load_trace_analysis(ja)
    assert es.load_detailed_traces_json(tmp_path / "missing.json") is None


# -- collect through the CLI ----------------------------------------------------

def _cli_case(kind, tmp_path):
    """(route, argv, report loader-check) for one collect kind."""
    if kind == "prometheus-SN":
        def route(method, path, params, body):
            if params["query"] in ("system_load1", "redis_command_rate"):
                return 200, _prom_payload([({"instance": "n0"},
                                            [[T0, "2.5"]])])
            return 200, {"status": "success", "data": {"result": []}}
        return route, ["prometheus", "--testbed", "SN"], "metric_data"
    if kind == "prometheus-TT":
        return _tt_route, ["prometheus", "--testbed", "TT"], "m.csv"
    if kind == "jaeger":
        batch = synth.generate_spans(labels.label_for("Perf_CPU_Contention"),
                                     n_traces=6, seed=1)
        return (_jaeger_route(synth.spans_to_jaeger_json(batch)),
                ["jaeger"], "all.json")
    if kind == "skywalking":
        batch = synth.generate_spans(labels.label_for("Lv_P_CPU_preserve"),
                                     n_traces=4, seed=2)
        return (_sw_route(synth.spans_to_skywalking_json(
            batch, "Lv_P_CPU_preserve"), dup=False),
            ["skywalking", "--experiment", "Lv_P_CPU_preserve"], "sw.json")
    return _es_route, ["es", "--limit", "500"], "dt.json"


@pytest.mark.parametrize("kind", ["prometheus-SN", "prometheus-TT",
                                  "jaeger", "skywalking", "es"])
def test_cli_collect_prints_the_jax_report(kind, stub_factory, tmp_path,
                                           capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    route, argv, out = _cli_case(kind, tmp_path)
    stub = stub_factory(route)
    url = stub.base_url + ("/graphql" if kind == "skywalking" else "")
    docs = []
    for run, root in ((main, tmp_path / "port"), (jmain, tmp_path / "jax")):
        assert run(["collect"] + argv + ["--url", url,
                                         "--out", str(root / out)]) == 0
        d = json.loads(capsys.readouterr().out)
        d["files"] = [str(Path(f).relative_to(root)) for f in d["files"]]
        docs.append(d)
    assert docs[0] == docs[1] and docs[0]["n_records"] > 0
    for f in docs[0]["files"]:
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes()
    with pytest.raises(SystemExit):
        main(["collect", argv[0], "--out", str(tmp_path / "x")])
