"""The port's collection toolchain (``io/coverage_report``,
``io/live_exec``, ``campaign``, ``golden``) and its ``collect
kube-logs | docker-logs | jacoco | gcov``, ``campaign`` and ``golden``
subcommands, held to the JAX package with no tolerance at the JAX tests'
inputs (``tests/test_{coverage_report,live_exec,campaign,golden}.py``):
dumps, report XML and summaries byte-equal, the scripted exec answers
giving the same files and ``CollectReport``, the campaign trees equal
file for file (the self-trace by structure) and loading back equal
through both packages' loaders, and the golden report and its markdown
equal on a campaign tree with LFS pointers laid over it.

The CLI surfaces run as ``chip_smoke.py``'s phase 29 runs them
(``collection_plane_outputs``, both packages, in this process): every
output equal between the packages and to
``chip_smoke.COLLECTION_PLANE_DIGESTS``, the JAX package's digests that
the card's machine holds the port to.  An ``.npz`` dump compares by its
members (its zip headers stamp the wall time), the campaign's
self-trace by structure (its ids and times are walls).  No process is
spawned; the subcommands start no probe of the card."""

import argparse
import copy
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import anomod
from anomod import campaign as jcampaign
from anomod import golden as jgolden
from anomod import synth as jsynth
from anomod.cli import main as jmain
from anomod.config import Config as JConfig
from anomod.io import coverage_report as jcr
from anomod.io import dataset as jdataset
from anomod.io import live_exec as jle
from anomod.io import sn_traces as jsn
import anomod_torch
from anomod_torch import campaign, golden, synth
from anomod_torch.cli import main as pmain
from anomod_torch.config import Config as PConfig
from anomod_torch.io import coverage_report as pcr
from anomod_torch.io import dataset as pdataset
from anomod_torch.io import live_exec as ple
from anomod_torch.io import sn_traces as psn
from torch_plain import plain

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke_phase29",
                                               REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

J = SimpleNamespace(cr=jcr, le=jle, synth=jsynth, campaign=jcampaign,
                    golden=jgolden, dataset=jdataset, Config=JConfig,
                    sn=jsn, main=jmain, pkg=anomod)
P = SimpleNamespace(cr=pcr, le=ple, synth=synth, campaign=campaign,
                    golden=golden, dataset=pdataset, Config=PConfig,
                    sn=psn, main=pmain, pkg=anomod_torch)
STAMP = "20260731_120000"


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


# -- io/coverage_report -------------------------------------------------------

def _dump(p, service="ts-order-service", n=20, covered_idx=(0, 1, 2)):
    mask = np.zeros(n, bool)
    mask[list(covered_idx)] = True
    return p.cr.CoverageDump(service, {"a/File.java": mask})


_COVERAGE = {}


def _coverage(p, name="Lv_C_exception_injection"):
    key = (p.pkg.__name__, name)
    if key not in _COVERAGE:
        _COVERAGE[key] = p.synth.generate_experiment(
            name, n_traces=20).coverage
    return _COVERAGE[key]


@pytest.mark.parametrize("call", [
    lambda p: p.cr.merge_dumps([_dump(p), _dump(p, covered_idx=(2, 3))]),
    lambda p: p.cr.merge_dumps([_dump(p), p.cr.CoverageDump(
        "ts-order-service", {"b/Other.java": np.ones(5, bool)})]),
    lambda p: p.cr.merge_dumps([_dump(p), p.cr.CoverageDump(
        "ts-order-service", {"a/File.java": np.ones(25, bool)})]),
    lambda p: p.cr.merge_dumps([_dump(p, "ts-a"), _dump(p, "ts-b")]),
    lambda p: p.cr.merge_dumps([]),
    lambda p: p.cr.write_jacoco_xml(
        _dump(p, n=500, covered_idx=tuple(range(215)))),
    lambda p: p.cr.parse_total_from_xml(p.cr.write_jacoco_xml(
        _dump(p, n=500, covered_idx=tuple(range(215))))),
    lambda p: p.cr.parse_total_from_xml('<report name="x"></report>'),
    lambda p: [p.cr.write_summary_txt("ts-order-service", t, c)
               for t, c in ((500, 215), (0, 0), (7, 7), (3, 1))],
    lambda p: [(d.service, d.lines_total, d.lines_covered,
                d.to_file_coverage(), d.files)
               for d in p.cr.batch_to_dumps(_coverage(p))],
    lambda p: p.cr.batch_to_dumps(_coverage(p, "Normal_case"), seed=7),
    lambda p: p.cr.dumps_to_batch(p.cr.batch_to_dumps(_coverage(p))),
], ids=["merge_union", "merge_disjoint_files", "merge_length_mismatch",
        "merge_cross_service", "merge_empty", "jacoco_xml",
        "parse_total", "parse_total_no_counter", "summary_txt",
        "batch_to_dumps", "batch_to_dumps_seed7", "dumps_to_batch"])
def test_coverage_report_calls_equal(call):
    same(call)


def test_dump_archives_equal_and_cross_load(tmp_path):
    """``save_dump`` writes the same members in both packages; each
    package loads the other's archive to the same dump."""
    dumps = {}
    for tag, p in (("j", J), ("p", P)):
        d = _dump(p, n=77, covered_idx=tuple(range(0, 77, 3)))
        p.cr.save_dump(d, tmp_path / f"{tag}.npz")
        dumps[tag] = d
    assert cs._file_bytes(tmp_path / "j.npz") == \
        cs._file_bytes(tmp_path / "p.npz")
    assert plain(P.cr.load_dump(tmp_path / "j.npz")) == \
        plain(J.cr.load_dump(tmp_path / "p.npz")) == plain(dumps["j"])


def test_collect_coverage_reports_tree_equal(tmp_path):
    """Two pods a service dump the same coverage: per-pod archives, the
    merged report tree and the totals equal between the packages."""
    trees = {}
    for tag, p in (("j", J), ("p", P)):
        dumps = p.cr.batch_to_dumps(_coverage(p, "Normal_case"))
        pods = {f"{d.service}-pod-a": [d] for d in dumps[:5]}
        pods.update({f"{d.service}-pod-b": [d] for d in dumps[:5]})
        root = tmp_path / tag
        totals = p.cr.collect_coverage_reports(
            pods, root / "coverage_data", root / "coverage_report")
        trees[tag] = (totals, cs._tree_bytes(root))
    assert trees["p"] == trees["j"]
    assert len(trees["j"][1]) == 10 + 5 * 3


# -- io/live_exec -------------------------------------------------------------

def _collect_kube(le, run, out, mount):
    return le.KubeLogCollector(runner=le.ExecRunner(run_fn=run)).collect(
        out, stamp=STAMP)


def _collect_kube_tail(le, run, out, mount):
    return le.KubeLogCollector(runner=le.ExecRunner(run_fn=run),
                               namespace="train-ticket").collect(
        out, stamp=STAMP, tail=5, with_events=False)


def _collect_docker(le, run, out, mount):
    return le.DockerLogCollector(runner=le.ExecRunner(run_fn=run)).collect(
        out, stamp=STAMP)


def _collect_docker_since(le, run, out, mount):
    return le.DockerLogCollector(
        runner=le.ExecRunner(run_fn=run),
        services=("compose-post-service", "text-service")).collect(
        out, stamp=STAMP, time_range="10m")


def _collect_jacoco(le, run, out, mount):
    return le.JacocoCoverageCollector(
        runner=le.ExecRunner(run_fn=run)).collect(
        out / "coverage_data", out / "report")


def _collect_gcov(le, run, out, mount):
    return le.GcovCoverageCollector(runner=le.ExecRunner(run_fn=run)).collect(
        mount, out / "coverage_data" / "Exp_coverage_TS", base="Exp",
        stamp="TS")


def _collect_gcov_twice(le, run, out, mount):
    """A second run against the moved tree degrades, loudly."""
    col = le.GcovCoverageCollector(runner=le.ExecRunner(run_fn=run))
    target = out / "coverage_data" / "Exp_coverage_TS"
    return [col.collect(mount, target, base="Exp", stamp="TS"),
            col.collect(mount, target, base="Exp", stamp="TS")]


def _collect_all(le, run, out, mount):
    return [f(le, run, out / f.__name__, mount) for f in (
        _collect_kube, _collect_docker, _collect_jacoco, _collect_gcov)]


COLLECTS = [_collect_kube, _collect_kube_tail, _collect_docker,
            _collect_docker_since, _collect_jacoco, _collect_gcov,
            _collect_gcov_twice]


@pytest.mark.parametrize("scenario", ["scripted", "travel_jar_only",
                                      "nothing_answers"])
@pytest.mark.parametrize("collect", COLLECTS,
                         ids=[f.__name__[9:] for f in COLLECTS])
def test_exec_collectors_equal(tmp_path, collect, scenario):
    """Each exec collector against the scripted cluster (and with the
    JaCoCo CLI in one pod only, and with every command failing): the
    same files, bytes and ``CollectReport`` in both packages."""
    got = {}
    for tag, p in (("j", J), ("p", P)):
        root = tmp_path / tag
        cluster = cs.ScriptedCluster(p.le, p.cr, root / "mount")
        if scenario == "travel_jar_only":
            cluster.jar_pods = ("ts-travel-service-5f7b8-x2k4p",)
        run = cluster if scenario != "nothing_answers" else \
            (lambda cmd, R=p.le.ExecResult: R(1, "", "refused"))
        reps = collect(p.le, run, root / "out", root / "mount")
        reps = reps if isinstance(reps, list) else [reps]
        got[tag] = ([json.dumps(r.to_json()).replace(str(root), "<root>")
                     for r in reps], cs._tree_bytes(root))
    assert got["p"] == got["j"]


def test_exec_collectors_roundtrip_through_loaders(tmp_path):
    """The port's trees load through the port's loaders as the JAX trees
    load through the JAX ones (the JAX tests' loop closed)."""
    from anomod.io import coverage as jcov
    from anomod.io import logs as jlogs
    from anomod_torch.io import coverage as pcov
    from anomod_torch.io import logs as plogs
    got = {}
    for tag, p, logs, cov in (("j", J, jlogs, jcov), ("p", P, plogs, pcov)):
        root = tmp_path / tag
        cluster = cs.ScriptedCluster(p.le, p.cr, root / "mount")
        _collect_all(p.le, cluster, root, root / "mount")
        got[tag] = [
            logs.load_tt_log_dir(root / "_collect_kube"),
            logs.load_sn_log_dir(root / "_collect_docker"),
            cov.load_tt_coverage_report(root / "_collect_jacoco" / "report"),
            cov.load_sn_coverage_dir(
                root / "_collect_gcov" / "coverage_data" / "Exp_coverage_TS")]
    assert plain(got["p"]) == plain(got["j"])
    batch, _ = got["p"][0]
    assert "ts-order-service" in batch.services


@pytest.mark.parametrize("outcome", ["timeout", "oserror", "ran"])
def test_exec_runner_degrades_equally(monkeypatch, outcome):
    """A timeout or a spawn failure is a nonzero ``ExecResult`` (the
    reference scripts' skip-and-continue), a finished command its own
    result; the subprocess call itself is scripted (no process)."""
    def fake_run(cmd, capture_output, text, timeout):
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        if outcome == "oserror":
            raise FileNotFoundError(2, "No such file", cmd[0])
        return subprocess.CompletedProcess(cmd, 3, "out\n", "err\n")
    got = []
    for le in (jle, ple):
        monkeypatch.setattr(le.subprocess, "run", fake_run)
        got.append(plain(le.ExecRunner(timeout=0.5).run(["kubectl", "x"])))
    assert got[0] == got[1]
    assert got[1][2]["returncode"] == {"timeout": 124, "oserror": 127,
                                       "ran": 3}[outcome]


# -- campaign, golden and the CLI: chip_smoke's phase 29 --------------------

@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Phase 29's outputs of both packages (``collection_plane_outputs``,
    through each package's CLI in this process), their temporary trees
    kept; the port's calls with every start of the card probe
    recorded."""
    import anomod.analysis
    import anomod_torch.analysis
    from anomod_torch.utils import platform
    out = {}
    for tag, p, lint in (("j", J, anomod.analysis),
                         ("p", P, anomod_torch.analysis)):
        tmp = tmp_path_factory.mktemp(f"plane_{tag}")
        starts = []
        saved = (platform.start_probe, p.golden.golden_report,
                 lint.status_block)
        platform.start_probe = lambda *a, **k: starts.append(a)
        # the two golden calls read one tree and the two validate calls
        # lint one tree: each package computes each once here
        p.golden.golden_report = _once(saved[1])
        lint.status_block = _once(saved[2])
        try:
            outs, docs = cs.collection_plane_outputs(p.pkg, p.main, tmp)
        finally:
            (platform.start_probe, p.golden.golden_report,
             lint.status_block) = saved
        out[tag] = SimpleNamespace(outs=outs, docs=docs, tmp=tmp,
                                   probes=starts)
    return out


def _once(fn):
    """``fn`` called with no arguments, computed once."""
    memo = []

    def once():
        if not memo:
            memo.append(fn())
        return copy.deepcopy(memo[0])
    return once


KEYS = sorted(cs.COLLECTION_PLANE_DIGESTS)


@pytest.mark.parametrize("key", KEYS)
def test_collection_plane_output_equal(plane, key):
    """One phase-29 output: the port's bytes == the JAX package's, whose
    sha256 is ``chip_smoke.COLLECTION_PLANE_DIGESTS``'s."""
    want = plane["j"].outs[key]
    assert plane["p"].outs[key] == want
    assert hashlib.sha256(want).hexdigest() == \
        cs.COLLECTION_PLANE_DIGESTS[key]


def test_collection_plane_covers_every_output(plane):
    """The table names every output of both packages; no port subcommand
    started a probe of the card; the validate documents' ``native`` and
    ``lint`` blocks have the JAX keys, the port's reading its library
    available and its tree clean."""
    assert set(plane["j"].outs) == set(plane["p"].outs) == set(KEYS)
    assert plane["p"].probes == []
    for argv, doc in plane["p"].docs.items():
        want = plane["j"].docs[argv]
        assert sorted(doc["native"]) == sorted(want["native"])
        assert sorted(doc["lint"]) == sorted(want["lint"])
        assert doc["native"]["available"] is True
        assert doc["lint"]["status"] == "ok" and doc["lint"]["findings"] == 0


def test_campaign_trees_equal_file_for_file(plane):
    """Both packages' campaign trees: the same file set, each file's bytes
    equal (the self-trace by structure, dumps by members)."""
    trees = [cs._tree_bytes(plane[t].tmp / "campaign") for t in ("j", "p")]
    assert list(trees[1]) == list(trees[0])
    assert trees[1] == trees[0]
    assert len(trees[0]) > 400


@pytest.mark.parametrize("testbed,experiment", [
    ("TT", "Lv_P_CPU_preserve"), ("TT", "Lv_S_HTTPABORT_preserve"),
    ("SN", "Svc_Kill_Media"), ("SN", "Code_Stop_TextService")])
def test_campaign_tree_loads_back_equal(plane, testbed, experiment):
    """An archived experiment (LFS pointers where phase 29 laid them) loads
    through both packages' loaders to equal batches, from both trees."""
    got = []
    for tag, p in (("j", J), ("p", P)):
        tree = plane[tag].tmp / "campaign"
        cfg = p.Config(data_root=tree, synth_on_lfs=False, cache_dir=None)
        exp = p.dataset.load_experiment(experiment, testbed, cfg)
        got.append(plain(exp))
    assert got[1] == got[0]
    assert got[0][2]["synthetic"] is False


def test_campaign_self_trace_loads_back_by_structure(plane):
    """The campaign's Jaeger-shaped self-trace loads back through both
    packages' trace loaders: one rooted trace, a span a stage, the same
    services, endpoints and parent links (its times are walls)."""
    got = []
    for tag, p in (("j", J), ("p", P)):
        b = p.sn.load_jaeger_json(plane[tag].tmp / "campaign"
                                  / "campaign_trace_TT.json")
        got.append((b.n_spans, list(b.services), list(b.endpoints),
                    b.parent.tolist(), b.service.tolist(),
                    b.endpoint.tolist()))
    assert got[1] == got[0]
    assert got[0][0] == 1 + 3 * 3 and got[0][3].count(-1) == 1


def test_golden_reads_the_pointers_and_the_baselines(plane):
    """The golden run over the campaign tree (its JSON equal between the
    packages above) sees the LFS pointers phase 29 laid and the normal
    baselines, and scores the faults in the two coverage trees."""
    rep = json.loads(plane["p"].outs["golden"].split(b"\n", 1)[1])
    assert rep["scan"]["TT"]["modality_files"]["trace_data"][
        "n_lfs_stubs"] == 1
    assert rep["scan"]["TT"]["modality_files"]["metric_data"][
        "n_lfs_stubs"] == 2
    assert rep["coverage_detection"]["SN"]["normal_baseline"] \
        == "Normal_Baseline"
    assert rep["coverage_detection"]["TT"]["normal_baseline"] \
        == "Normal_case"
    assert rep["scan"]["TT"]["n_experiments"] == 3


def test_golden_missing_data_root():
    """With no data root the port's census reads both testbeds missing
    (the JAX ``Config`` always has one; a missing tree reads the same)."""
    rep = golden.golden_report(PConfig(data_root=None))
    assert rep["scan"]["SN"]["missing"] and rep["scan"]["TT"]["missing"]
    assert rep["coverage_detection"]["TT"]["n_loaded"] == 0


# -- the CLI's flags ----------------------------------------------------------

class _Caught(Exception):
    pass


def _subparsers(main, monkeypatch):
    """The subcommand parsers ``main`` builds, caught at its one
    ``parse_args`` (a subcommand's own parse goes through
    ``parse_known_args``), with each subcommand's help."""
    def catch(self, args=None, namespace=None):
        raise _Caught(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Caught) as got:
        main(["list"])
    monkeypatch.undo()
    action = next(a for a in got.value.args[0]._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices, {a.dest: a.help for a in action._choices_actions}


_HELP_MAP = (("anomod_torch/analysis/lint_baseline.json",
              "scripts/lint_baseline.json"),
             ("anomod_torch.", "anomod."))


def _flags(parser):
    out = []
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        text = a.help or ""
        for k, v in _HELP_MAP:
            text = text.replace(k, v)
        out.append([a.option_strings, a.dest, a.default, a.choices,
                    a.nargs, a.required, getattr(a.type, "__name__", None),
                    text])
    return out


@pytest.mark.parametrize("cmd", ["collect", "campaign", "golden",
                                 "validate", "lint"])
def test_cli_flags_equal(monkeypatch, cmd):
    """The five surfaces take the JAX CLI's flags, defaults, choices and
    help (the package's name and the baseline's path mapped); none takes
    ``--device``."""
    jsub, jhelp = _subparsers(jmain, monkeypatch)
    psub, phelp = _subparsers(pmain, monkeypatch)
    assert _flags(psub[cmd]) == _flags(jsub[cmd])
    text = phelp[cmd]
    for k, v in _HELP_MAP:
        text = text.replace(k, v)
    assert text == jhelp[cmd]
    assert all("--device" not in a.option_strings
               for a in psub[cmd]._actions)
