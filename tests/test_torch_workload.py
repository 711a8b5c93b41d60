"""The port's workload planes (``workload``, ``seeder``, ``scenario``,
``openapi``, ``monitor``, ``suite``) and its ``chaos``, ``deploy``,
``scenario`` and ``monitor`` subcommands, held to the JAX package with no
tolerance at the JAX tests' inputs
(``tests/test_{workload,seeder,scenario,openapi,monitor,suite}.py``): the
same numpy code on the same seeds, so request programs, sampled wrk2
mixes, ``ApiBatch`` and ``SpanBatch`` arrays, the monitor's artifact
trees byte for byte and every subcommand's exit code, stdout and stderr
are equal.  Also: ``chip_smoke.FAULT_PLANE_DIGESTS`` is the JAX package's
digest table of phase 28's outputs, the four subcommands start no probe
of the card and import no PyYAML, and the helpers the port's ``synth``
once kept a copy of each have one home."""

import contextlib
import hashlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import anomod.chaos
import anomod.labels
import anomod.recovery
from anomod import monitor as jmonitor
from anomod import openapi as jopenapi
from anomod import scenario as jscenario
from anomod import seeder as jseeder
from anomod import suite as jsuite
from anomod import workload as jworkload
from anomod.cli import main as jmain
import anomod_torch
import anomod_torch.chaos
import anomod_torch.labels
import anomod_torch.recovery
from anomod_torch import monitor, openapi, scenario, seeder, suite, workload
from anomod_torch.cli import main as pmain
from torch_plain import plain

REPO = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "fixtures" / "tt_openapi_small.json"
J = SimpleNamespace(chaos=anomod.chaos, monitor=jmonitor, openapi=jopenapi,
                    scenario=jscenario, seeder=jseeder, suite=jsuite,
                    workload=jworkload)
P = SimpleNamespace(chaos=anomod_torch.chaos, monitor=monitor,
                    openapi=openapi, scenario=scenario, seeder=seeder,
                    suite=suite, workload=workload)


def _outcome(fn, pkg):
    try:
        return ["ok", plain(fn(pkg))]
    except (ValueError, RuntimeError, KeyError) as e:
        return ["raised", type(e).__name__, str(e)]


def same(fn):
    """``fn(pkg)`` on both packages: equal results, or the same error."""
    want = _outcome(fn, J)
    got = _outcome(fn, P)
    assert got == want
    return got


def _tree(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(root.rglob("*")) if f.is_file()}


# -- workload -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3])
def test_wrk2_content_model_equal(seed):
    def run(p):
        W = p.workload
        rng = np.random.default_rng(seed)
        bodies = [W.compose_post_body(rng) for _ in range(40)]
        rng = np.random.default_rng(seed)
        reqs = [W.sample_wrk2_request(rng) for _ in range(300)]
        return (bodies, reqs, [r.content_length for r in reqs],
                W.timeline_query(np.random.default_rng(seed)),
                W.sample_compose_lengths(np.random.default_rng(seed), 600))
    same(run)


def test_workload_helpers_equal():
    same(lambda p: [p.workload.SN_REQUEST_MIX,
                    p.workload.compose_length_bounds(),
                    {k: v for k, v in vars(p.workload).items()
                     if k.startswith("WRK2_")}])
    same(lambda p: [p.workload.resolve_location(loc, tpl) for loc, tpl in (
        ("", "http://h:1/a/{id}"), ("http://x:2/b?q=1", "http://h:1/a"),
        ("/c/3?z=9", "http://h:1/a"), ("d/4", "https://h/a"))])
    same(lambda p: [p.workload.is_valid_uri_or_empty(u) for u in (
        "", "http://h/a", "/rel/p?q=1", "mailto:", "a b", "x\x01", "http:",
        "ftp://h", "://x")])


# -- seeder -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(seed=2),
                                dict(n_users=50, n_edges=120),
                                dict(n_users=30, n_edges=40),
                                dict(n_users=100, n_edges=300)],
                         ids=["reed98", "seed2", "50x120", "30x40",
                              "100x300"])
def test_seeder_equal(kw):
    def run(p):
        S = p.seeder
        g = S.generate_graph(**kw)
        out = [g, g.n_edges, g.follower_counts(), S.timeline_weights(g)]
        if g.n_users <= 100:    # the programs of the JAX tests' graphs
            ops = S.seeding_program(g, compose=True)
            out += [ops, S.seeding_program(g),
                    [list(b) for b in S.waves(ops, 32)]]
        return out
    same(run)


# -- scenario -----------------------------------------------------------------

def test_scenario_routes_and_flows_equal():
    same(lambda p: [p.scenario.route(x) for x in (
        "/api/v1/orderservice/order/refresh",
        "/api/v1/orderOtherService/orderOther/refresh",
        "/api/v1/users/login", "/api/v1/travelservice/trips/left",
        "/api/v1/nosuchservice/x", "/", "")])

    def flows(p):
        d = p.scenario.ScenarioDriver(seed=1)
        out = [d.core_business_flow(), d.auxiliary_flow(), d.admin_flow(),
               d.extended_flow(), d.complete_business_flow()]
        d = p.scenario.ScenarioDriver()
        its = [d.iteration() for _ in range(20)]
        out += [its, p.scenario.services_covered(its[0]),
                p.scenario.ScenarioDriver(seed=5).run(3)]
        return out
    same(flows)


@pytest.mark.parametrize("iterations,seed,fault", [
    (1, 0, None), (2, 7, None), (2, 8, None), (3, 3, None),
    (3, 3, "Lv_S_HTTPABORT_preserve"), (2, 0, "Lv_P_CPU_preserve"),
    (2, 1, "Lv_D_TRANSACTION_timeout")])
def test_run_scenario_batches_equal(iterations, seed, fault):
    def run(p):
        ctl = None
        if fault:
            ctl = p.chaos.ChaosController()
            ctl.create(fault)
        gw = p.scenario.SyntheticGateway(seed=seed, controller=ctl)
        gw.execute(p.scenario.ScenarioDriver(seed=seed).run(iterations))
        return (p.scenario.run_scenario(iterations=iterations, seed=seed,
                                        controller=ctl),
                gw.rows, gw.last_row, gw.to_api_batch())
    same(run)


# -- openapi ------------------------------------------------------------------

def test_openapi_spec_pipeline_equal(tmp_path):
    same(lambda p: p.openapi.load_spec(FIXTURE))
    same(lambda p: p.openapi.parse_spec(p.openapi.load_spec(FIXTURE)))
    same(lambda p: [p.openapi.endpoint_pool_from_spec(
        p.openapi.load_spec(FIXTURE), seed=s) for s in (0, 4)])
    doc = {
        "openapi": "3.0.1",
        "paths": {"/api/v1/foodservice/foods/{date}": {
            "get": {"parameters": [
                {"name": "date", "in": "path", "required": True,
                 "schema": {"type": "string", "format": "date"}}]},
            "post": {"requestBody": {"content": {"application/json": {
                "schema": {"$ref": "#/components/schemas/FoodOrder"}}}}}}},
        "components": {"schemas": {"FoodOrder": {
            "type": "object",
            "properties": {"orderId": {"type": "string"},
                           "price": {"type": "number"}}}}},
    }

    def oas3(p):
        eps = p.openapi.parse_spec(doc)
        rng = np.random.default_rng(0)
        return eps, [p.openapi.instantiate(doc, e, rng) for e in eps], \
            p.openapi.endpoint_pool_from_spec(doc, seed=1)
    same(oas3)
    stub = tmp_path / "spec.json"
    stub.write_text("version https://git-lfs.github.com/spec/v1\n"
                    "oid sha256:abcd\nsize 42\n")
    assert same(lambda p: p.openapi.load_spec(stub))[0] == "raised"


# -- monitor ------------------------------------------------------------------

def test_monitor_programs_equal():
    same(lambda p: p.monitor.SN_ENDPOINTS)
    same(lambda p: [p.monitor.synthesize_body(path, i)
                    for i, (_, path, _) in enumerate(p.monitor.SN_ENDPOINTS)])

    def monitors(p):
        M = p.monitor
        out = [M.ActiveMonitor(seed=0).run(cycles=5),
               M.PassiveMonitor(seed=0).run(cycles=4),
               M.ActiveMonitor(seed=3).run(cycles=3)]
        ctl = p.chaos.ChaosController()
        ctl.create("Svc_Kill_UserTimeline")
        out.append(M.ActiveMonitor(seed=1, controller=ctl).run(cycles=30))
        gw = p.scenario.SyntheticGateway(seed=0)
        M.run_wrk2_workload(gw, 300, seed=4)
        out.append(gw.to_api_batch())
        return out
    same(monitors)


@pytest.mark.parametrize("kw", [
    dict(mode="active", cycles=4, seed=0),
    dict(mode="active", cycles=2, wrk2_requests=50),
    dict(mode="passive", cycles=3, seed=2),
    dict(mode="active", cycles=3, seed=1, chaos="Svc_Kill_UserTimeline",
         wrk2_requests=7)], ids=["active", "wrk2", "passive", "chaos"])
def test_capture_artifact_trees_equal(kw, tmp_path):
    """The report and the api_responses artifact family, file by file."""
    want = plain(jmonitor.capture_openapi_responses(tmp_path / "j", **kw))
    got = plain(monitor.capture_openapi_responses(tmp_path / "p", **kw))
    assert got == want
    tree = _tree(tmp_path / "p")
    assert tree == _tree(tmp_path / "j")
    assert "collection_report.json" in tree and len(tree) == 6


# -- suite --------------------------------------------------------------------

def test_suite_generation_equal():
    same(lambda p: [p.suite.n_tests_for_budget(tb, b) for tb in ("SN", "TT")
                    for b in (1, 60, 120, 300, 600, 6000)])
    same(lambda p: [p.suite.generate_suite("SN"),
                    p.suite.generate_suite("TT"),
                    p.suite.generate_suite("TT", budget_s=300),
                    p.suite.generate_suite("TT", seed=4),
                    p.suite.generate_suite("TT", n_tests=5000).covered_targets,
                    p.suite.generate_suite("TT", n_tests=21, seed=2,
                                           spec=p.openapi.load_spec(FIXTURE))])
    same(lambda p: p.suite.generate_suite("XX"))
    same(lambda p: [p.suite.endpoint_owner(e, tb) for tb in ("SN", "TT")
                    for e in ("http://10.0.0.5:30001/wrk2-api/user/login",
                              "/wrk2-api/post/compose", "/nope",
                              "/api/v1/preserveservice",
                              "/api/v1/unknownthing", "/api/v1/orderservice/")])
    same(lambda p: p.suite.SN_ROUTE)


@pytest.mark.parametrize("testbed,n_tests,iterations,seed,fault", [
    ("TT", 20, 3, 2, None), ("SN", 12, 1, 0, None),
    ("TT", 40, 2, 5, "Lv_S_HTTPABORT_preserve"),
    ("SN", 13, 2, 1, "Svc_Kill_Media")])
def test_run_suite_equal(testbed, n_tests, iterations, seed, fault):
    def run(p):
        s = p.suite.generate_suite(testbed, n_tests=n_tests)
        ctl = p.chaos.ChaosController()
        if fault:
            ctl.create(fault)
        r = p.suite.run_suite(s, iterations=iterations, seed=seed,
                              controller=ctl)
        return (r, r.pass_rate, p.suite.traces_for_run(r.spans, s.run_id),
                p.suite.traces_for_run(r.spans, "em-nope"))
    same(run)


def test_suite_from_spec_run_equal():
    def run(p):
        s = p.suite.generate_suite("TT", n_tests=21, seed=2,
                                   spec=p.openapi.load_spec(FIXTURE))
        return p.suite.run_suite(s, iterations=2, seed=0)
    same(run)


# -- the four subcommands -----------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


CLI_ARGVS = (
    [["chaos", lab.experiment, "--format", fmt]
     for lab in anomod.labels.ALL_LABELS for fmt in ("yaml", "json")]
    + [["chaos", "NoSuchExperiment"]]
    + [["deploy"] + a for a in (
        [], ["--all"], ["--independent-db"],
        ["--with-monitoring", "--with-tracing"], ["--secrets"],
        ["--secrets", "--independent-db"], ["--testbed", "SN"],
        ["--testbed", "SN", "--down"], ["--testbed", "SN", "--secrets"])]
    + [["scenario"] + a for a in (
        [], ["--iterations", "2", "--seed", "3"],
        ["--iterations", "2", "--chaos", "Lv_P_CPU_preserve"],
        ["--iterations", "2", "--chaos", "Lv_C_security_check"],
        ["--chaos", "Perf_CPU_Contention"], ["--chaos", "Nope"],
        ["--iterations", "0"])]
    + [["monitor"] + a for a in (
        ["--cycles", "2"], ["--mode", "passive", "--cycles", "2"],
        ["--cycles", "3", "--chaos", "Svc_Kill_Media",
         "--wrk2-requests", "9"])])


@pytest.mark.parametrize("argv", CLI_ARGVS, ids=" ".join)
def test_subcommand_output_equal(argv, monkeypatch):
    """Exit code, stdout and stderr, the port's with ``yaml`` blocked."""
    want = _cli(jmain, argv)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _cli(pmain, argv) == want


def test_subcommand_refusals_equal():
    for argv in (["chaos"], ["deploy", "--testbed", "XX"],
                 ["monitor", "--mode", "loud"], ["scenario", "--seed", "x"]):
        want = _cli(jmain, argv)
        got = _cli(pmain, argv)
        assert got[0] == want[0] == 2
        # argparse names the program: the usage lines differ only there
        assert got[2].split("error:")[1] == want[2].split("error:")[1]


def test_monitor_out_tree_equal(tmp_path):
    argv = ["monitor", "--cycles", "10", "--wrk2-requests", "50", "--out"]
    rc_j, out_j, _ = _cli(jmain, argv + [str(tmp_path / "j")])
    rc_p, out_p, _ = _cli(pmain, argv + [str(tmp_path / "p")])
    assert rc_p == rc_j == 0
    assert out_p.replace(str(tmp_path / "p"), "<out>") == \
        out_j.replace(str(tmp_path / "j"), "<out>")
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


@pytest.mark.parametrize("argv", [
    ["chaos", "Lv_P_CPU_preserve"], ["deploy", "--secrets"],
    ["scenario", "--chaos", "Lv_P_CPU_preserve"],
    ["monitor", "--cycles", "1"]], ids=lambda a: a[0])
def test_subcommands_start_no_probe(argv, monkeypatch):
    """Host only: no ``--device``, and no probe of the card started."""
    from anomod_torch.utils import platform

    def refuse(*a, **k):
        raise AssertionError("a probe of the card was started")
    monkeypatch.setattr(platform, "start_probe", refuse)
    monkeypatch.setattr(platform, "probe_device_platform", refuse)
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)
    assert _cli(pmain, argv)[0] == 0
    assert _cli(pmain, argv + ["--device", "cpu"])[0] == 2


# -- chip_smoke's phase 28 table ----------------------------------------------

def test_fault_plane_digests_are_the_jax_packages():
    """``chip_smoke.FAULT_PLANE_DIGESTS`` (phase 28 holds the card's bytes
    to it) == the sha256 of the JAX package's outputs for phase 28's
    calls; the port's outputs, with ``yaml`` blocked, give it too."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phase28", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    want = {k: hashlib.sha256(v).hexdigest() for k, v in
            cs.fault_plane_outputs(anomod, jmain, REPO).items()}
    assert cs.FAULT_PLANE_DIGESTS == want
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None
    try:
        got = {k: hashlib.sha256(v).hexdigest() for k, v in
               cs.fault_plane_outputs(anomod_torch, pmain, REPO).items()}
    finally:
        sys.modules["yaml"] = saved
        if saved is None:
            sys.modules.pop("yaml")
    assert got == want


# -- one home each --------------------------------------------------------------

def test_helpers_have_one_home():
    """``SN_REQUEST_MIX`` and ``sample_compose_lengths`` live in
    ``workload``, ``endpoint_owner`` and ``SN_ROUTE`` in ``suite``, as in
    the JAX package; ``synth`` keeps no copy, and nothing in the port
    imports PyYAML."""
    defs = {r"^SN_REQUEST_MIX\b": "workload.py",
            r"^def sample_compose_lengths\b": "workload.py",
            r"^def endpoint_owner\b": "suite.py", r"^SN_ROUTE\b": "suite.py"}
    srcs = {f: f.read_text() for f in (REPO / "anomod_torch").rglob("*.py")}
    for pat, home in defs.items():
        where = [f.name for f, text in srcs.items()
                 if re.search(pat, text, re.M)]
        assert where == [home], (pat, where)
    assert not [f for f, text in srcs.items()
                if re.search(r"^\s*(import yaml|from yaml\b)", text, re.M)]
    from anomod_torch import synth
    for name in ("SN_REQUEST_MIX", "sample_compose_lengths",
                 "endpoint_owner", "SN_ROUTE"):
        assert not hasattr(synth, name), name
    assert workload.SN_REQUEST_MIX == jworkload.SN_REQUEST_MIX
    assert json.dumps(suite.SN_ROUTE) == json.dumps(jsuite.SN_ROUTE)
