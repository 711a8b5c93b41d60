"""The port's fault and deployment planes (``topology``, ``chaos``,
``deploy``, ``recovery``) and its own YAML writer (``utils.yamlsafe``),
held to the JAX package with no tolerance, at the JAX tests' inputs
(``tests/test_{topology,chaos,deploy,recovery}.py``): manifests, CRDs,
argv tuples, plans and rendered text equal, ``ChaosController`` UIDs and
``active_effects`` equal, recovery reports equal on every seeded
archetype.  The YAML writer gives PyYAML's bytes on every document the
port renders, with ``yaml`` blocked for the port's calls; PyYAML is the
oracle here only."""

import copy
import sys
from types import SimpleNamespace

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from anomod import chaos as jchaos
from anomod import deploy as jdeploy
from anomod import labels as jlabels
from anomod import recovery as jrecovery
from anomod import synth as jsynth
from anomod import topology as jtopology
from anomod_torch import chaos, deploy, labels, recovery, synth, topology
from anomod_torch.utils import yamlsafe
from torch_plain import plain

J = SimpleNamespace(chaos=jchaos, deploy=jdeploy, labels=jlabels,
                    recovery=jrecovery, synth=jsynth, topology=jtopology)
P = SimpleNamespace(chaos=chaos, deploy=deploy, labels=labels,
                    recovery=recovery, synth=synth, topology=topology)
EXPERIMENTS = [lab.experiment for lab in jlabels.ALL_LABELS]


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


@pytest.fixture
def no_yaml(monkeypatch):
    """PyYAML blocked: ``import yaml`` raises inside the block."""
    monkeypatch.setitem(sys.modules, "yaml", None)


# -- topology -----------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda p: p.topology.sn_compose(),
    lambda p: [p.topology.sn_container_name(s) for s in p.synth.SN_SERVICES
               + ("home-timeline-redis", "user-timeline-redis",
                  "social-graph-redis", "jaeger-agent")],
    lambda p: [(p.topology.tt_service_port(s),
                p.topology.service_package_prefix(s))
               for s in p.synth.TT_SERVICES],
    lambda p: p.topology.tt_deployment("ts-order-service"),
    lambda p: p.topology.tt_deployment("ts-station-service",
                                       with_tracing=False),
    lambda p: p.topology.tt_manifests(),
    lambda p: p.topology.tt_manifests(with_tracing=False),
    lambda p: [p.topology.infer_includes_from_packages(x) for x in
               (["user.controller", "user.service", "com.helper"], [],
                ["a.b", " ", "b.c", "b.d"])],
], ids=["sn_compose", "sn_container_name", "tt_port_prefix",
        "tt_deployment", "tt_deployment_no_tracing", "tt_manifests",
        "tt_manifests_no_tracing", "infer_includes"])
def test_topology_documents_equal(call):
    same(call)


@pytest.mark.parametrize("mode", ["tcpserver", "file"])
@pytest.mark.parametrize("with_tracing", [True, False])
def test_inject_jacoco_equal(mode, with_tracing):
    def run(p):
        docs = p.topology.tt_manifests(with_tracing=with_tracing)
        before = copy.deepcopy(docs)
        once, n1 = p.topology.inject_jacoco(docs, mode=mode)
        twice, n2 = p.topology.inject_jacoco(once, mode=mode)
        assert docs == before                 # inputs not mutated
        svc = {"kind": "Service", "metadata": {"name": "ts-order-service"},
               "spec": {"ports": []}}
        other = p.topology.inject_jacoco(
            [svc, p.topology.tt_deployment("ts-travel-service")],
            tcp_port=6400, svc_includes={"ts-travel-service": "travel.x.*"},
            excludes=None)
        spec = p.topology.tt_deployment("ts-user-service")["spec"][
            "template"]["spec"]
        changed = p.topology.inject_jacoco_pod_spec(spec, mode=mode,
                                                    includes="user.*")
        return once, n1, twice, n2, other, changed, spec
    same(run)


# -- chaos --------------------------------------------------------------------

@pytest.mark.parametrize("exp", EXPERIMENTS)
def test_chaos_plans_equal_per_label(exp):
    """CRD (or its refusal), the CRD's YAML text and its parse back, the
    blade argv and the docker argv of every label."""
    crd = same(lambda p: p.chaos.build_mesh_crd(exp))
    if crd[0] == "ok":
        text = jchaos.mesh_crd_yaml(exp)
        assert chaos.mesh_crd_yaml(exp) == text
        assert plain(chaos.parse_mesh_crd_yaml(text)) == \
            plain(jchaos.parse_mesh_crd_yaml(text)) == \
            plain(jlabels.label_for(exp))
    same(lambda p: p.chaos.blade_create_command(exp))
    same(lambda p: p.chaos.docker_command(exp))
    same(lambda p: p.chaos.parse_mesh_crd({"metadata": {"name": exp}}))


def test_chaos_lookups_and_blade_output_equal():
    same(lambda p: p.chaos.mesh_experiments())
    same(lambda p: [p.chaos.blade_create_command(exp).action
                    for exp in EXPERIMENTS
                    if p.chaos.blade_create_command(exp) is not None])
    same(lambda p: [p.chaos.parse_blade_output(s) for s in (
        '{"code":200,"success":true,"result":"abc123"}',
        '{"Uid":"def456","ok":1}', "created\nuid: 789xyz\n",
        "nothing here", "", "{not json")])
    same(lambda p: p.chaos.build_mesh_crd("NoSuchExperiment"))
    same(lambda p: p.chaos.ChaosController().create("NoSuchExperiment"))


def test_controller_uids_and_effects_equal():
    """One controller through every label's create (UIDs are sha1 of the
    experiment and a counter), each service's ``active_effects`` after
    each, then destroy, the context form and the sweep."""
    def run(p):
        ctl = p.chaos.ChaosController()
        log = []
        services = sorted(set(p.synth.SN_SERVICES + p.synth.TT_SERVICES))
        for exp in EXPERIMENTS:
            h = ctl.create(exp)
            log.append([h, [ctl.active_effects(s) for s in services]])
        log.append(ctl.create_result_json("Lv_P_CPU_preserve"))
        uid = p.chaos.parse_blade_output(log[-1])
        log.append([uid, ctl.destroy(uid), ctl.destroy(uid), ctl.status()])
        log.append(ctl.destroy_all())
        with ctl.inject("Lv_D_TRANSACTION_timeout") as h:
            log.append([h, ctl.status(),
                        ctl.active_effects("ts-order-service")])
        log.append(ctl.status())
        return log
    same(run)


# -- deploy -------------------------------------------------------------------

FLAG_SETS = [dict(), dict(all=True), dict(independent_db=True),
             dict(with_monitoring=True, with_tracing=True),
             dict(with_tracing=True), dict(independent_db=True,
                                           with_tracing=True)]


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=lambda f: "-".join(f) or "none")
def test_tt_deploy_plan_equal(flags):
    def run(p):
        plan = p.deploy.tt_deploy_plan(p.deploy.DeployFlags(**flags))
        cluster = p.recovery.SyntheticCluster([])
        census = p.deploy.execute_plan(plan, cluster)
        return plan, p.deploy.render_plan(plan), census, cluster.now
    same(run)


def test_deploy_helpers_equal():
    same(lambda p: p.deploy.DeployFlags.parse(
        ["--with-tracing", "--with-monitoring"]))
    same(lambda p: p.deploy.DeployFlags.parse(["--bogus"]))
    same(lambda p: p.deploy.TT_DB_SERVICES)
    same(lambda p: p.deploy.mysql_secret_doc(
        "consign-price", "tsdb-mysql-leader", "ts", "Ts_123456", "ts"))
    same(lambda p: [p.deploy.gen_mysql_secrets(),
                    p.deploy.gen_mysql_secrets("tsdb-mysql-leader")])
    same(lambda p: [p.deploy.render_plan(p.deploy.sn_compose_plan(up=u))
                    for u in (True, False)])
    same(lambda p: p.deploy.tt_deploy_plan(p.deploy.DeployFlags(),
                                           namespace="ts"))


# -- recovery -----------------------------------------------------------------

def _cluster(c):
    return [c.now, {n: p for n, p in c.pods.items()}, c.snapshot()]


@pytest.mark.parametrize("testbed", ["TT", "SN"])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_seeded_cluster_reports_equal(testbed, seed):
    """Every seeded archetype (slow, crash-looping, stuck) through the
    readiness controller: the report and the cluster after it."""
    def run(p):
        c = p.recovery.cluster_for_testbed(testbed, seed=seed)
        before = _cluster(c)
        report = p.recovery.ReadinessController().wait_for_pods_ready(c)
        return before, report, _cluster(c)
    same(run)


@pytest.mark.parametrize("case", [
    "healthy", "crashloop", "stuck", "timeout", "late_stuck", "oversub",
    "prometheus", "guarded", "envelope", "phases"])
def test_recovery_cases_equal(case):
    def run(p):
        R = p.recovery
        if case == "healthy":
            c = R.cluster_for_testbed("SN", n_slow=0, n_crashloop=0,
                                      n_stuck=0)
            return R.ReadinessController().wait_for_pods_ready(c)
        if case == "crashloop":
            c = R.SyntheticCluster([R.Pod(name="ok-1", service="ok"),
                                    R.Pod(name="bad-1", service="bad",
                                          crashloop=True,
                                          crashes_before_ok=2)])
            return R.ReadinessController().wait_for_pods_ready(c), _cluster(c)
        if case == "stuck":
            c = R.SyntheticCluster([R.Pod(name="stuck-1", service="s",
                                          stuck_unready=True)])
            return R.ReadinessController(
                stuck_deadline_s=180.0, timeout_s=600.0).wait_for_pods_ready(c)
        if case == "timeout":
            c = R.SyntheticCluster([R.Pod(name="never-1", service="n",
                                          startup_s=10_000.0)])
            return R.ReadinessController(timeout_s=120.0) \
                .wait_for_pods_ready(c)
        if case == "late_stuck":
            c = R.SyntheticCluster([R.Pod(name="late-stuck", service="s",
                                          startup_s=200.0,
                                          stuck_unready=True)])
            return R.ReadinessController(
                stuck_deadline_s=180.0, timeout_s=900.0).wait_for_pods_ready(c)
        if case == "oversub":
            return R.cluster_for_testbed("SN", n_crashloop=40)
        if case == "prometheus":
            c = R.SyntheticCluster([])
            prom = R.PrometheusState(oom_killed=True, ready=False)
            return (R.guard_prometheus(prom, c), prom,
                    R.guard_prometheus(prom, c), prom, c.now)
        if case == "guarded":
            ctl = p.chaos.ChaosController()
            left = ctl.create("Lv_P_CPU_preserve")
            seen = []
            try:
                with R.GuardedRun(ctl) as guard:
                    seen.append([guard.swept_on_entry, ctl.status()])
                    seen.append(ctl.create("Lv_S_KILLPOD_preserve"))
                    raise RuntimeError("body failed")
            except RuntimeError as e:
                seen.append(str(e))
            return seen, ctl.status(), ctl.destroy(left.uid)
        if case == "envelope":
            c = R.cluster_for_testbed("TT", seed=1)
            ctl = p.chaos.ChaosController()
            prom = R.PrometheusState(oom_killed=True, ready=False)
            calls = []

            def body():
                calls.append(ctl.active_effects("ts-preserve-service"))
                return "collected"
            result, report = R.run_with_recovery(
                c, ctl, "Lv_P_CPU_preserve", body, prometheus=prom)
            return result, report, prom, calls, ctl.status(), _cluster(c)
        p0 = R.Pod(name="x", service="s", crashloop=True,
                   crashes_before_ok=1)
        first = [p0.phase_at(2.0), p0.phase_at(10.0)]
        c = R.SyntheticCluster([p0])
        c.advance(10.0)
        c.delete_pod("x")
        c.restart_pod("x")
        return first, p0.phase_at(c.now + 25.0), _cluster(c)
    same(run)


# -- the YAML writer and reader -----------------------------------------------

#: the oracle, held here so it still works where ``yaml`` is blocked
_PYYAML = yaml


def yaml_dump(doc):
    return _PYYAML.safe_dump(doc, sort_keys=False)


def _plan(exp, mod):
    """The ``chaos`` CLI's plan document for a non-mesh label."""
    lab = mod.labels.label_for(exp)
    plan = {"experiment": lab.experiment, "tool": lab.chaos_tool}
    cmd = mod.chaos.blade_create_command(lab)
    if cmd is not None:
        plan["blade"] = list(cmd.args)
        plan["needs_sudo"] = cmd.needs_sudo
    dc = mod.chaos.docker_command(lab)
    if dc is not None:
        plan["docker"] = list(dc)
    return plan


@pytest.mark.parametrize("exp", EXPERIMENTS)
def test_yamlsafe_equals_pyyaml_on_every_plan(exp, no_yaml):
    lab = labels.label_for(exp)
    if lab.chaos_tool == "chaosmesh":
        doc = chaos.build_mesh_crd(exp)
        want = yaml_dump(jchaos.build_mesh_crd(exp))
        assert chaos.mesh_crd_yaml(exp) == want
    else:
        doc = _plan(exp, P)
        want = yaml_dump(_plan(exp, J))
    assert yamlsafe.dump(doc) == want
    assert yamlsafe.load(want) == doc


@pytest.mark.parametrize("host", [None, "tsdb-mysql-leader"])
def test_yamlsafe_equals_pyyaml_on_secrets(host, no_yaml):
    want = _PYYAML.safe_dump_all(jdeploy.gen_mysql_secrets(host),
                                 sort_keys=False)
    assert yamlsafe.dump_all(deploy.gen_mysql_secrets(host)) == want


@pytest.mark.parametrize("doc", [
    {"a": "two\nlines"}, {1: "x"}, {"a": 1.5}, "scalar", {"a": "tab\there"},
    {"a": "caf\u00e9"}, {"": 1}, {"k" * 120: 1}, {"a": ("t",)},
    {"a": " ".join(["word"] * 30)}],
    ids=["multiline", "int_key", "float", "top_scalar", "tab", "unicode",
         "empty_key", "long_key", "tuple", "folded"])
def test_yamlsafe_refuses_outside_its_subset(doc):
    with pytest.raises(ValueError):
        yamlsafe.dump(doc)


@pytest.mark.parametrize("n", range(60, 100, 4))
def test_yamlsafe_near_the_width_raises_or_equals_pyyaml(n):
    """Strings with spaces ending near PyYAML's width of 80 (a mapping
    value, a sequence item, deeper, single-quoted): the port gives
    PyYAML's bytes, and raises only where the one line that would hold
    the string passes 80 columns."""
    for text in (("w " * n)[:n].strip(), "'" + ("ab " * n)[:n - 1]):
        for doc in ({"key": text}, [text], {"k": [{"kk": text}]}):
            try:
                got = yamlsafe.dump(doc)
            except ValueError:
                flat = yaml.safe_dump(doc, sort_keys=False, width=10**6)
                assert max(map(len, flat.splitlines())) > 80, doc
                continue
            assert got == yaml.safe_dump(doc, sort_keys=False)


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n", 'a: "q"\n', "a: 1 # c\n", "a: &x 1\n", "a: |\n  x\n",
    "a: 1.5\n", "- a\n---\n- b\n", "a: 1\n  b: 2\n", "a: 0x1f\n", "a:\n"])
def test_yamlsafe_load_refuses_outside_its_subset(text):
    with pytest.raises(ValueError):
        yamlsafe.load(text)


_ADVERSARIAL = ["100", "1e3", "true", "no", "null", "~", "", "-x", "a: b",
                "#c", "it's", "1.5", "0x1f", "017", "1_000", "12:30",
                "2001-12-14", ".inf", "On", "<<", "=", "? x", ": x", "- x",
                "---", "...", "a #b", "a#b", "@x", " x", "x ", "a  b", "{}",
                "x:", "x:y", '"q"', "!", "*", "&", "%", "'"]
_TEXT = st.one_of(
    st.sampled_from(_ADVERSARIAL),
    st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=126),
            max_size=10),
    st.text(max_size=4))
_SCALAR = st.one_of(_TEXT, st.integers(-10**6, 10**6), st.booleans(),
                    st.none(), st.floats(allow_nan=False, width=32))
_NODE = st.recursive(
    _SCALAR, lambda kids: st.one_of(
        st.lists(kids, max_size=3),
        st.dictionaries(st.one_of(_TEXT, st.integers(0, 2)), kids,
                        max_size=3)), max_leaves=12)
_DOC = st.one_of(st.lists(_NODE, max_size=3),
                 st.dictionaries(_TEXT, _NODE, max_size=3))


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.lists(_DOC, min_size=1, max_size=2))
def test_yamlsafe_raises_or_equals_pyyaml(docs):
    """Nested documents of the subset with adversarial strings: the port
    either raises ``ValueError`` or gives PyYAML's bytes, and reads its own
    text back as PyYAML does."""
    try:
        got = yamlsafe.dump_all(docs)
    except ValueError:
        return
    assert got == yaml.safe_dump_all(docs, sort_keys=False)
    if len(docs) == 1:
        assert yamlsafe.dump(docs[0]) == got
        assert yamlsafe.load(got) == yaml.safe_load(got)
