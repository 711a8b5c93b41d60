"""The port's contract plane (``analysis/``: the linter, its rules, the
env scanner, the parity audit and the ``contracts`` gate), ``validate.py``
and ``io/native.status()``, with the ``lint`` subcommand, held to the JAX
package with no tolerance on the JAX tests' inputs
(``tests/test_{analysis,validate}.py``): every ``tests/lint_fixtures``
corpus, suppression, baseline and audit case gives the same findings in
both packages, each file linted under its mapped pretend path
(``anomod/x`` for the JAX rules, ``anomod_torch/x`` for the port's; the
messages name each package's own files and tuple, mapped before the
compare); ``lint --rules`` prints the same bytes; the env gate reads the
same documents as ``scripts/check_env_contract.py`` on a mapped tree;
validation reports, dedup and corpus summaries are equal.  The port's
gate reads clean on its own tree, its 17 deliberate exceptions each
carried by a reasoned directive and its baseline empty.  No process is
spawned."""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from anomod import labels as jlabels
from anomod import synth as jsynth
from anomod import validate as jvalidate
from anomod.analysis import envscan as jenvscan
from anomod.analysis import lint as jlint
from anomod.analysis import parity as jparity
from anomod.cli import main as jmain
from anomod.io import native as jnative
from anomod.schemas import Experiment as JExperiment
from anomod.schemas import concat_span_batches as jconcat
from anomod_torch import labels as plabels
from anomod_torch import synth as psynth
from anomod_torch import validate as pvalidate
from anomod_torch.analysis import contracts
from anomod_torch.analysis import envscan as penvscan
from anomod_torch.analysis import lint as plint
from anomod_torch.analysis import parity as pparity
from anomod_torch.analysis import rules as prules
from anomod_torch.cli import main as pmain
from anomod_torch.io import native as pnative
from anomod_torch.schemas import Experiment as PExperiment
from anomod_torch.schemas import concat_span_batches as pconcat
from torch_plain import plain

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"

#: what the port's messages name where the JAX package's name theirs
_MAP = (("anomod_torch/", "anomod/"), ("anomod_torch.", "anomod."),
        ("VARIANT_REPORT_FIELDS", "SHARD_VARIANT_REPORT_FIELDS"),
        ("SHARD_SHARD_", "SHARD_"))


def _unport(text: str) -> str:
    for a, b in _MAP:
        text = text.replace(a, b)
    return text


def _port_path(path: str) -> str:
    return "anomod_torch/" + path[len("anomod/"):] \
        if path.startswith("anomod/") else path


def _findings(fs):
    """Findings as comparable rows, the port's mapped to the JAX names
    (the JAX audit's P401 message wraps its tuple's name, so the words
    compare with whitespace folded)."""
    return sorted([f.rule, _unport(f.path), f.line,
                   " ".join(_unport(f.message).replace(
                       "SHARD_VARIANT_REPORT_ FIELDS",
                       "SHARD_VARIANT_REPORT_FIELDS").split()),
                   f.suppressed, f.reason] for f in fs)


def _both(source: str, jax_path: str, corpus: str = ""):
    """``lint_source`` of one source under the JAX path and its port
    counterpart: the two finding lists, mapped."""
    return (_findings(jlint.lint_source(source, jax_path, corpus)),
            _findings(plint.lint_source(source, _port_path(jax_path),
                                        corpus)))


# -- the fixture corpus and the scoping --------------------------------------

#: every fixture of tests/lint_fixtures with the JAX tests' pretend path
FIXTURE_CASES = [
    ("determinism_trip.py", "anomod/serve/fixture.py", ""),
    ("determinism_pass.py", "anomod/serve/fixture.py", ""),
    ("env_trip.py", "anomod/fixture.py",
     "ANOMOD_KNOWN_KNOB is documented here"),
    ("env_pass.py", "anomod/fixture.py",
     "ANOMOD_KNOWN_KNOB is documented here"),
    ("seam_trip.py", "anomod/serve/fixture.py", ""),
    ("seam_pass.py", "anomod/serve/fixture.py", ""),
    ("seam_gather_trip.py", "anomod/replay.py", ""),
    ("seam_gather_pass.py", "anomod/replay.py", ""),
    ("lock_trip.py", "anomod/obs/registry.py", ""),
    ("lock_pass.py", "anomod/obs/registry.py", ""),
    ("commit_barrier_trip.py", "anomod/serve/fixture.py", ""),
    ("commit_barrier_pass.py", "anomod/serve/fixture.py", ""),
    # the scoping: the same corpora outside (or inside) their scope
    ("determinism_trip.py", "anomod/io/fixture.py", ""),
    ("seam_trip.py", "anomod/serve/batcher.py", ""),
    ("seam_gather_trip.py", "anomod/serve/engine.py", ""),
    ("lock_trip.py", "anomod/utils/tracing.py", ""),
    ("lock_trip.py", "anomod/serve/fixture.py", ""),
    ("commit_barrier_trip.py", "anomod/obs/flight.py", ""),
    ("env_trip.py", "anomod/config.py", ""),
]


@pytest.mark.parametrize("name,path,corpus", FIXTURE_CASES,
                         ids=[f"{n}@{p}" for n, p, _ in FIXTURE_CASES])
def test_fixture_findings_equal(name, path, corpus):
    want, got = _both((FIXTURES / name).read_text(), path, corpus)
    assert got == want
    if name.endswith("_trip.py") and \
            FIXTURE_CASES.index((name, path, corpus)) < 12:
        assert want, "a must-trip fixture tripped nothing"


# -- suppression syntax (the JAX tests' sources) ------------------------------

_VIOLATION = ("import time\n"
              "def f():\n"
              "    return time.time(){directive}\n")
DIRECTIVE = "# anomod-" "lint: "

SUPPRESSION_CASES = {
    "reasoned": _VIOLATION.format(
        directive="  " + DIRECTIVE + "disable=D101 — forensic stamp"),
    "dash_dash": _VIOLATION.format(
        directive="  " + DIRECTIVE + "disable=D101 -- forensic stamp"),
    "colon": _VIOLATION.format(
        directive="  " + DIRECTIVE + "disable=D101: forensic stamp"),
    "bare": _VIOLATION.format(directive="  " + DIRECTIVE + "disable=D101"),
    "unknown_rule": _VIOLATION.format(
        directive="  " + DIRECTIVE + "disable=NOPE — because"),
    "malformed": _VIOLATION.format(directive="  " + DIRECTIVE + "nonsense"),
    "two_rules": _VIOLATION.format(
        directive="  " + DIRECTIVE + "disable=D101,D104 — both"),
    "statement_scope": ("import time\n"
                        "def f(x):\n"
                        "    " + DIRECTIVE + "disable=D101 — blessed block\n"
                        "    if x:\n"
                        "        a = time.time()\n"
                        "        b = time.time()\n"
                        "        return a, b\n"
                        "    return time.time()\n"),
    "file_wide": (DIRECTIVE + "disable-file=D101 — fixture-wide waiver\n"
                  "import time\n"
                  "a = time.time()\n"
                  "b = time.time()\n"),
    "in_docstring": ('"""Doc: ' + DIRECTIVE + 'disable=D101"""\n'
                     "import time\n"
                     "a = time.time()\n"),
    "env_alias_concat": ("from os import environ, getenv\n"
                         "name = 'X'\n"
                         "a = environ['ANOMOD_ALIAS_ROGUE']\n"
                         "b = getenv('ANOMOD_' + name)\n"),
    "env_aliased_module": ("import os as _os\n"
                           "a = _os.environ.get('ANOMOD_ROGUE')\n"
                           "b = _os.getenv(f'ANOMOD_{a}')\n"),
    "perf_counter_forms": ("import time\n"
                           "t0 = time.perf_counter()\n"
                           "dt = time.perf_counter() - t0\n"
                           "x = [time.perf_counter()]\n"),
    "set_iteration": ("s = {3, 1, 2}\n"
                      "for v in set(s):\n"
                      "    pass\n"
                      "xs = sorted(set(s))\n"
                      "ys = list(set(s))\n"
                      "zs = ','.join({'a', 'b'})\n"),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
@pytest.mark.parametrize("path", ["anomod/serve/x.py", "anomod/x.py"])
def test_source_findings_equal(case, path):
    want, got = _both(SUPPRESSION_CASES[case], path)
    assert got == want


# -- baseline semantics -------------------------------------------------------

def _finding_sets(mod, prefix):
    F = mod.Finding
    f1 = F("D101", f"{prefix}/serve/x.py", 3, "wall clock")
    f2 = F("L501", f"{prefix}/obs/registry.py", 9, "unlocked")
    sup = F("D101", "a.py", 1, "x", suppressed=True, reason="why")
    bad = F("LINT000", f"{prefix}/serve/x.py", 3, "bare disable")
    return [([f1, f2], []), ([f1, f2], [f1.key]), ([f1, sup], [f1.key]),
            ([], [f1.key]), ([bad], [bad.key]), ([f1, f2, sup, bad], [])]


def test_baseline_verdicts_and_files_equal(tmp_path):
    """``summarize`` gives the same verdict documents, and ``save_baseline``
    / ``load_baseline`` the same file bytes (LINT000 dropped)."""
    for (jf, jb), (pf, pb) in zip(_finding_sets(jlint, "anomod"),
                                  _finding_sets(plint, "anomod_torch")):
        want = jlint.summarize(jf, jb)
        got = json.loads(_unport(json.dumps(plint.summarize(pf, pb))))
        assert got == want
        jlint.save_baseline(tmp_path / "j.json", [f.key for f in jf] + jb)
        plint.save_baseline(tmp_path / "p.json", [f.key for f in pf] + pb)
        assert _unport((tmp_path / "p.json").read_text()) == \
            (tmp_path / "j.json").read_text()
        assert [_unport(k) for k in plint.load_baseline(
            tmp_path / "p.json")] == jlint.load_baseline(tmp_path / "j.json")
    with pytest.raises(ValueError):
        (tmp_path / "bad.json").write_text('{"findings": [1]}')
        plint.load_baseline(tmp_path / "bad.json")


# -- the parity audit ---------------------------------------------------------

AUDIT_CASES = {
    "synthetic_field": (["served_spans", "sneaky_new_field"],
                        ("serve_wall_s",), "served_spans pinned"),
    "named_by_test": (["sneaky_new_field"], (), "sneaky_new_field pinned"),
    "declared_variant": (["sneaky_new_field"], ("sneaky_new_field",), ""),
    "stale_variant": (["real_field"], ("real_field", "ghost_field"), ""),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_serve_report_audit_equal(case):
    fields, variant, corpus = AUDIT_CASES[case]
    assert _findings(pparity.audit_serve_report(fields, variant, corpus)) \
        == _findings(jparity.audit_serve_report(fields, variant, corpus))


def test_flight_record_audit_equal():
    """The flight-record audit on the port's recorder: clean on the
    engine's record, and an undeclared or a missing key found as the JAX
    audit finds it."""
    planes, variant = pparity.flight_contract(REPO)
    keys = pparity.flight_record_keys(REPO)
    assert (planes, variant) == jparity.flight_contract(REPO)
    for got_keys in (keys, list(keys) + ["stowaway"],
                     [k for k in keys if k != "fold"]):
        assert _findings(pparity.audit_flight_record(got_keys, planes,
                                                     variant)) == \
            _findings(jparity.audit_flight_record(got_keys, planes, variant))
    assert pparity.audit_flight_record(keys, planes, variant) == []
    assert pparity.FLIGHT_SPINE == jparity.FLIGHT_SPINE


def test_port_parity_surface_reads_its_engine():
    """The audit reads the port's ``ServeReport`` fields and its
    ``VARIANT_REPORT_FIELDS`` (the JAX ``SHARD_VARIANT_REPORT_FIELDS``
    role) off the AST, equal to the engine's own, and finds nothing."""
    from anomod_torch.serve import engine
    assert pparity.serve_report_fields(REPO) == tuple(
        f.name for f in dataclasses.fields(engine.ServeReport))
    assert pparity.shard_variant_fields(REPO) == \
        engine.VARIANT_REPORT_FIELDS
    assert pparity.run_parity_audit(REPO) == []
    # a tree without the audited sources: one finding, never a traceback
    got = pparity.run_parity_audit(REPO / "tests")
    assert [f.rule for f in got] == ["P401"]


# -- the port's own tree ------------------------------------------------------

#: the 17 deliberate exceptions in the port, each a reasoned directive:
#: three carry the JAX package's own (engine, feed, chaos), the rest say
#: where the port differs (a runner's rows in one device copy, torch's
#: copies, a wall stamp across processes)
PORT_EXCEPTIONS = sorted([
    ("D101", "anomod_torch/serve/chaos.py"),
    ("D101", "anomod_torch/serve/feed.py"),
    ("D101", "anomod_torch/serve/procshard.py"),
    ("D101", "anomod_torch/serve/procshard.py"),
    ("D104", "anomod_torch/obs/flight.py"),
    ("D104", "anomod_torch/serve/supervise.py"),
    ("S301", "anomod_torch/obs/flight.py"),
    ("S301", "anomod_torch/serve/engine.py"),
    ("S301", "anomod_torch/serve/engine.py"),
    ("S301", "anomod_torch/serve/engine.py"),
    ("S301", "anomod_torch/serve/supervise.py"),
    ("S301", "anomod_torch/serve/supervise.py"),
    ("S302", "anomod_torch/replay.py"),
    ("S302", "anomod_torch/replay.py"),
    ("S302", "anomod_torch/replay.py"),
    ("S302", "anomod_torch/serve/batcher.py"),
    ("S302", "anomod_torch/serve/batcher.py")])


@pytest.fixture(scope="module")
def port_gate():
    """The port's gate over this checkout, run once."""
    return plint.run_gate(REPO)


def test_port_tree_lints_clean(port_gate):
    """Zero unsuppressed findings, an empty baseline, and exactly the 17
    reasoned exceptions."""
    doc, findings = port_gate
    assert doc["status"] == "ok" and doc["findings"] == 0, doc["new"]
    assert plint.load_baseline(plint.baseline_path(REPO)) == []
    assert doc["baseline_size"] == 0 and doc["stale_baseline"] == []
    sup = [f for f in findings if f.suppressed]
    assert sorted((f.rule, f.path) for f in sup) == PORT_EXCEPTIONS
    assert all(len(f.reason) > 20 for f in sup)


def test_scan_set_and_corpus():
    """The port lints its package and its driver, nothing of the JAX
    package, and reads its env contract from its own Config."""
    files = [p.relative_to(REPO).as_posix() for p in plint.scan_files(REPO)]
    assert files[0] == "chip_smoke.py"
    assert all(f.startswith("anomod_torch/") for f in files[1:])
    assert "anomod_torch/analysis/contracts.py" in files
    corpus = plint.env_corpus(REPO)
    assert "ANOMOD_SMOKE_CHILD_PROFILE_DIR" in corpus
    assert (REPO / "anomod_torch" / "config.py").read_text() in corpus


def test_rule_catalog_equal():
    """One catalog: ``lint --rules`` prints the JAX bytes; every rule id
    is in docs/CONTRACTS.md and the directive grammar is the same."""
    outs = []
    for main in (jmain, pmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["lint", "--rules"]) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert plint.RULES == {k: plint.Rule(**dataclasses.asdict(v))
                           for k, v in jlint.RULES.items()}
    doc = (REPO / "docs" / "CONTRACTS.md").read_text()
    assert all(rid in doc for rid in plint.RULES)
    assert plint._DIRECTIVE.pattern == jlint._DIRECTIVE.pattern


def _tree(root: Path, pkg: str, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel.replace("PKG", pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


FIXTURE_TREE = {
    "PKG/config.py": 'X = _env("ANOMOD_KNOWN_KNOB", "1")\n',
    "PKG/serve/clock.py": "import time\nT = time.time()\n",
    "README.md": "docs\n",
}


@pytest.mark.parametrize("flags", [[], ["--no-parity"], ["--json"],
                                   ["--json", "--show-suppressed"]])
def test_lint_cli_on_a_fixture_tree_equal(tmp_path, flags):
    """``lint --root`` on a tree with a wall-clock read in its serve plane
    (and no engine to audit): exit 1, the same documents and stderr in
    both packages, then ``--update-baseline`` rides it (exit 0)."""
    got = []
    for main, pkg in ((jmain, "anomod"), (pmain, "anomod_torch")):
        root = _tree(tmp_path / pkg, pkg, FIXTURE_TREE)
        base = tmp_path / f"{pkg}_baseline.json"
        runs = []
        for extra in ([], ["--update-baseline"], []):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(["lint", "--root", str(root), "--baseline",
                           str(base)] + flags + extra)
            runs.append([rc, _unport(out.getvalue().replace(str(root),
                                                            "<root>")),
                         _unport(err.getvalue().replace(str(root),
                                                        "<root>"))])
        got.append([runs, _unport(base.read_text())])
    assert got[1] == got[0]
    assert [r[0] for r in got[0][0]] == [1, 0, 0]


# -- the env gate and the contracts module -------------------------------------

ENV_TREES = {
    "clean": {},
    "dynamic": {"PKG/dyn.py": 'import os\nname = "SHARDS"\n'
                              'Y = os.environ[f"ANOMOD_{name}"]\n'},
    "uncovered": {"PKG/knob.py": 'import os\nZ = os.environ.get('
                                 '"ANOMOD_ROTTED_KNOB")\n'},
    "documented": {"PKG/knob.py": 'import os\nZ = os.getenv('
                                  '"ANOMOD_DOC_KNOB")\n',
                   "docs/OPS.md": "ANOMOD_DOC_KNOB is documented\n"},
}


def _check_env_contract():
    spec = importlib.util.spec_from_file_location(
        "check_env_contract", REPO / "scripts" / "check_env_contract.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", sorted(ENV_TREES))
def test_env_gate_equal(tmp_path, case):
    """``contracts --env`` on a port tree == ``scripts/check_env_contract.py``
    on the same tree under ``anomod/``: one JSON line, the same exit code."""
    script = _check_env_contract()
    got = []
    for run, pkg in ((script.main, "anomod"),
                     (contracts.main, "anomod_torch")):
        root = _tree(tmp_path / pkg, pkg,
                     {"PKG/config.py": FIXTURE_TREE["PKG/config.py"],
                      "README.md": "docs\n", **ENV_TREES[case]})
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = run(["--env", "--root", str(root)] if pkg != "anomod"
                     else ["--root", str(root)])
        got.append([rc, json.loads(_unport(out.getvalue()))])
    assert got[1] == got[0]
    assert got[0][0] == (0 if case in ("clean", "documented") else 1)


def test_contracts_gates_pass_on_this_tree(port_gate, monkeypatch):
    """The env gate exits 0 on the port's tree, and the gate prints the
    gate's document (:func:`run_gate`'s, run once here) with exit 0;
    ``env_reads`` of both packages agree."""
    monkeypatch.setattr(contracts, "run_gate", lambda root: port_gate)
    for argv in ([], ["--env"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert contracts.main(argv) == 0, out.getvalue()
        doc = json.loads(out.getvalue())
        assert doc["status"] == "ok"
    assert doc["n_vars"] > 60 and doc["n_dynamic"] == 0
    src = "\n".join(SUPPRESSION_CASES[k] for k in
                    ("env_alias_concat", "env_aliased_module"))
    import ast
    tree = ast.parse(src)
    assert plain(penvscan.env_reads(tree)) == plain(jenvscan.env_reads(tree))
    assert prules.CONFIG_MODULE == "anomod_torch/config.py"


# -- validate ----------------------------------------------------------------

def _exp(mod_synth, mod_labels, name, n):
    return mod_synth.generate_experiment(mod_labels.label_for(name),
                                         n_traces=n)


VALIDATE_CASES = {
    "clean": lambda s, lab, E, c: _exp(s, lab, "Lv_P_CPU_preserve", 30),
    "missing_modalities": lambda s, lab, E, c: E(name="Normal_case",
                                                 testbed="TT"),
    "broken_parents": lambda s, lab, E, c: (lambda e: dataclasses.replace(
        e, spans=e.spans._replace(parent=np.full(
            e.spans.n_spans, -1, np.int32))))(
        _exp(s, lab, "Normal_case", 40)),
    "duplicates": lambda s, lab, E, c: (lambda e: dataclasses.replace(
        e, spans=c([e.spans, e.spans])))(_exp(s, lab, "Svc_Kill_Media", 20)),
    "nan_metrics": lambda s, lab, E, c: (lambda e: dataclasses.replace(
        e, metrics=e.metrics._replace(value=np.full_like(
            e.metrics.value, np.nan))))(_exp(s, lab, "Normal_Baseline", 20)),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_reports_equal(case):
    """``validate_experiment`` of the JAX tests' experiments (and a
    duplicated collection, NaN metrics): equal reports and documents."""
    make = VALIDATE_CASES[case]
    want = jvalidate.validate_experiment(
        make(jsynth, jlabels, JExperiment, jconcat))
    got = pvalidate.validate_experiment(
        make(psynth, plabels, PExperiment, pconcat))
    assert plain(got) == plain(want)
    assert got.to_dict() == want.to_dict()
    assert pvalidate.corpus_summary("TT", [got], {"hits": 1}) == \
        jvalidate.corpus_summary("TT", [want], {"hits": 1})


@pytest.mark.parametrize("name", ["Normal_case", "Lv_S_KILLPOD_preserve"])
def test_dedup_traces_equal(name):
    """The columnar dedup of a doubled collection (and of a clean one):
    equal batches, parent links consistent."""
    got = []
    for s, lab, c, v in ((jsynth, jlabels, jconcat, jvalidate),
                         (psynth, plabels, pconcat, pvalidate)):
        b = s.generate_spans(lab.label_for(name), n_traces=20)
        got.append([plain(v.dedup_traces(c([b, b]))),
                    plain(v.dedup_traces(b))])
    assert got[1] == got[0]


def test_validate_from_data_with_a_fresh_cache_equal(tmp_path):
    """The JAX test's regression at both packages: a fresh cache dir and
    no data root, the honest all-miss counters, equal documents."""
    from anomod.config import Config as JConfig
    from anomod.io import cache as jcache
    from anomod.io import dataset as jdataset
    from anomod_torch.config import Config as PConfig
    from anomod_torch.io import cache as pcache
    from anomod_torch.io import dataset as pdataset
    got = []
    for tag, Config, cache, dataset, v in (
            ("j", JConfig, jcache, jdataset, jvalidate),
            ("p", PConfig, pcache, pdataset, pvalidate)):
        cfg = dataclasses.replace(Config(), cache_dir=tmp_path / tag,
                                  data_root=tmp_path / "no-data-root")
        cache.reset_stats()
        exp = dataset.load_experiment("Normal_case", cfg=cfg,
                                      modalities=["traces", "logs"],
                                      n_synth_traces=3)
        got.append(v.corpus_summary("TT", [v.validate_experiment(exp)],
                                    cache_stats=cache.stats().to_dict()))
    assert got[1] == got[0]
    assert got[0]["ingest_cache"]["hits"] == 0
    assert got[0]["ingest_cache"]["misses"] > 0


# -- native.status() ----------------------------------------------------------

def test_native_status_document(monkeypatch):
    """The JAX document's keys; the knob read from the port's Config; a
    failed build reported, never raised (and named under ``on``)."""
    from anomod_torch import config
    want_keys = sorted(jnative.status())
    got = pnative.status()
    assert sorted(got) == want_keys
    assert got["mode"] == "auto" and got["available"] is True
    assert got["staging"] is True and got["build_error"] is None

    def broken():
        raise RuntimeError("g++ -O3 ... failed (exit 1)")
    monkeypatch.setattr(pnative, "library", broken)
    for mode, staging in (("auto", False), ("off", False), ("on", False)):
        monkeypatch.setenv("ANOMOD_NATIVE", mode)
        config.set_config(None)
        try:
            doc = pnative.status()
        finally:
            config.set_config(None)
        assert doc["mode"] == mode and doc["available"] is False
        assert doc["staging"] is staging
        assert "failed" in doc["build_error"]
        assert ("error" in doc) == (mode == "on")
