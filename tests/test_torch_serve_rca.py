"""Online RCA in the port's serve tick (``anomod_torch.serve.rca``)
against the JAX package's (``anomod/serve/rca.py``), on the CPU.

The sampler and the node features are host code and must be equal; the
scorer adds in the JAX package's CPU order, so at ``tests/test_serve_rca
.py``'s deployment the port's verdict stream equals the JAX engine's
(ranked services exact, scores within :data:`ATOL_SCORE`), RCA leaves
every decision byte-identical, a one-run budget settles to the same
rankings, and the first-launch count is one per bucket.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from anomod.serve.engine import run_power_law as jrun_power_law
from anomod.serve.rca import make_culprit_scorer as jmake_scorer
from anomod.serve.rca import online_node_features as jfeatures
from anomod.serve.rca import sample_neighbors as jsample
from anomod_torch.obs.registry import (Registry, get_registry,
                                       set_registry)
from anomod_torch.serve.engine import (RCA_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeEngine,
                                       run_power_law, serve_plane_cfg)
from anomod_torch.serve.rca import (EVIDENCE_WEIGHTS, N_RCA_FEATS, RCA_SEED,
                                    RcaRunner, make_culprit_scorer,
                                    online_node_features, sample_neighbors)

#: ``tests/test_serve_rca.py``'s deployment, one shard
_RUN_KW = dict(n_tenants=8, n_services=6, capacity_spans_per_s=2000,
               overload=2.0, duration_s=60, tick_s=1.0, seed=3,
               window_s=5.0, baseline_windows=4, fault_tenants=2,
               buckets=(64, 256), lane_buckets=(1, 2, 4),
               max_backlog=3000, n_windows=16)

#: verdict scores against the JAX engine's (6-decimal rounded on both)
ATOL_SCORE = 1e-5


def _verdicts(engine):
    return [v.to_dict() for v in engine.rca_verdicts]


def _same_verdicts(got, want, atol=ATOL_SCORE):
    strip = lambda vs: [{k: v for k, v in d.items() if k != "scores"}
                        for d in vs]
    assert strip(got) == strip(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=atol)


@pytest.fixture(scope="module")
def jax_on():
    return jrun_power_law(shards=1, rca=True, flight=False, **_RUN_KW)


@pytest.fixture(scope="module")
def port_on():
    reg = Registry(enabled=True, max_samples=500_000)
    prev = get_registry()
    set_registry(reg)
    try:
        eng, rep = run_power_law(rca=True, device="cpu", **_RUN_KW)
    finally:
        set_registry(prev)
    return eng, rep, reg


# -- host pieces: equal to the JAX package's ------------------------------

def _graph_batches(seed):
    from anomod_torch import labels, synth
    lab = labels.labels_for_testbed("TT")[seed % 13]
    return synth.generate_spans(lab, n_traces=40, seed=seed)


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("k", [2, 8, 16])
def test_sample_neighbors_matches_jax(seed, k):
    """Seeded by ``(RCA_SEED, tenant, window)`` on numpy, the draws are
    the JAX package's: both sample the same graph to the same lists."""
    from anomod.graph import build_service_graph as jgraph
    from anomod_torch.graph import build_service_graph
    batch = _graph_batches(seed)
    g = build_service_graph(batch)
    jg = jgraph(batch)
    got = sample_neighbors(g, k, np.random.default_rng((RCA_SEED, seed, 9)))
    want = jsample(jg, k, np.random.default_rng((RCA_SEED, seed, 9)))
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if k == 2:
        assert got[1].sum(-1).max() == 2          # degree capped


@pytest.mark.parametrize("windows", [2, 8])
def test_online_node_features_match_jax(windows):
    from anomod.replay import ReplayConfig as JReplayConfig
    from anomod_torch.replay import ReplayConfig
    batch = _graph_batches(5)
    kw = dict(n_services=batch.n_services, n_windows=windows,
              window_us=60_000_000, chunk_size=4096)
    got = online_node_features(batch, batch.services, ReplayConfig(**kw))
    want = jfeatures(batch, batch.services, JReplayConfig(**kw))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert not online_node_features(None, batch.services,
                                    ReplayConfig(**kw)).any()


@pytest.mark.parametrize("bucket", [(16, 8), (64, 16)])
def test_culprit_scorer_matches_jax(bucket):
    """Random padded buckets: the port's scorer against the JAX scorer
    (the evidence dot adds in the JAX package's CPU tree, so it is
    bit-equal; the blame rounds within a few f32 ulps), dead rows at
    ``-inf``."""
    import jax
    n, k = bucket
    rng = np.random.default_rng(n)
    jf = jax.jit(jmake_scorer())
    tf = make_culprit_scorer()
    for _ in range(50):
        x = (rng.standard_normal((n, N_RCA_FEATS))
             * rng.uniform(0.01, 200, (n, N_RCA_FEATS))).astype(np.float32)
        neigh = rng.integers(0, n, (n, k)).astype(np.int32)
        nmask = (rng.random((n, k)) < 0.5).astype(np.float32)
        live = (rng.random(n) < 0.8).astype(np.float32)
        want = np.asarray(jf(x, neigh, nmask, live))
        got = tf(torch.from_numpy(x), torch.from_numpy(neigh).long(),
                 torch.from_numpy(nmask), torch.from_numpy(live)).numpy()
        assert np.array_equal(np.isinf(got), live == 0)
        np.testing.assert_allclose(got[live > 0], want[live > 0],
                                   rtol=1e-6, atol=1e-5)
        # the evidence alone (no callee blame) is bit-equal
        e = tf(torch.from_numpy(x), torch.from_numpy(neigh).long(),
               torch.zeros((n, k)), torch.from_numpy(live)).numpy()
        je = np.asarray(jf(x, neigh, np.zeros((n, k), np.float32), live))
        assert np.array_equal(e, je)
    assert EVIDENCE_WEIGHTS.dtype == np.float32


def test_rca_runner_first_launch_count():
    reg = Registry(enabled=True, max_samples=100)
    runner = RcaRunner(((8, 4), (32, 8)), registry=reg, device="cpu")
    assert runner.bucket_for(5) == (8, 4) and runner.bucket_for(9) == (32, 8)
    with pytest.raises(ValueError, match="no RCA bucket"):
        runner.bucket_for(40)
    runner.score(*runner._dead_args(8, 4))
    assert runner.bucket_shapes == {(8, 4)}
    runner.warm()
    runner.warm()                                 # idempotent
    assert runner.bucket_shapes == {(8, 4), (32, 8)}
    assert reg.counter("anomod_serve_rca_compile_total").value == 2
    assert reg.counter("anomod_serve_rca_runs_total").value == 1
    assert runner.runs_by_bucket == {(8, 4): 1}


# -- the serve tick: equal to the JAX engine --------------------------------

def test_verdict_stream_matches_jax_engine(jax_on, port_on):
    """The product pin: every verdict of the JAX engine's run, in order,
    with the ranked services exact and the scores within ATOL_SCORE;
    the hit accounting and the report's RCA fields equal."""
    je, jr = jax_on
    te, tr, _ = port_on
    _same_verdicts(_verdicts(te), _verdicts(je))
    assert tr.n_rca_runs == jr.n_rca_runs == len(te.rca_verdicts) > 0
    assert tr.rca_topk_hits == jr.rca_topk_hits
    assert tr.rca_topk_hits[1] == 2               # the culprit ranks first
    assert tr.rca_eligible == jr.rca_eligible == 2
    assert tr.rca_alert_to_culprit_s == jr.rca_alert_to_culprit_s
    assert tr.rca_enabled is True and tr.rca_wall_s > 0
    assert tr.rca_latency["p99_s"] is not None
    for f in ("offered_spans", "served_spans", "shed_fraction", "latency",
              "n_alerts", "fault_detection"):
        assert getattr(tr, f) == getattr(jr, f), f
    for v in te.rca_verdicts:
        assert len(v.services) == len(v.scores) <= 5
        assert v.scored_s >= v.enqueued_s and v.bucket == (16, 8)
    d = tr.to_dict()
    json.dumps(d)
    assert set(d["rca_topk_hits"]) == {"1", "3", "5"}
    assert "serve.rca" in {s["operationName"] for s in
                           te.tracer.to_jaeger()["data"][0]["spans"]}


def test_rca_on_off_leaves_decisions_byte_identical(port_on):
    te, tr, _ = port_on
    off, rep_off = run_power_law(rca=False, device="cpu", **_RUN_KW)
    assert rep_off.rca_enabled is False and rep_off.n_rca_runs == 0
    assert sorted(off._tenant_det) == sorted(te._tenant_det)
    for tid in off._tenant_det:
        assert [dataclasses.asdict(a) for a in off.alerts_for(tid)] == \
            [dataclasses.asdict(a) for a in te.alerts_for(tid)]
        s0, s1 = off._tenant_replay[tid].state, te._tenant_replay[tid].state
        assert torch.equal(s0.agg.cpu(), s1.agg.cpu())
        assert torch.equal(s0.hist.cpu(), s1.hist.cpu())
    skip = set(VARIANT_REPORT_FIELDS) | set(RCA_REPORT_FIELDS)
    assert {k: v for k, v in rep_off.to_dict().items() if k not in skip} \
        == {k: v for k, v in tr.to_dict().items() if k not in skip}


def test_rca_budget_queues_and_settles_deterministically(port_on):
    """A one-run-per-tick budget defers runs without changing a verdict:
    evidence anchors to the triggering alert window, so only scored_s
    moves (``tests/test_serve_rca.py``'s pin, on the port)."""
    from anomod_torch.serve.traffic import PowerLawTraffic, TenantFault
    te, tr, _ = port_on
    faults = {t: TenantFault("latency", service=1, onset_s=30.0,
                             factor=10.0) for t in range(2)}
    traffic = PowerLawTraffic(n_tenants=8, total_rate_spans_per_s=4000,
                              alpha=1.2, seed=3, n_services=6, faults=faults)
    tight = ServeEngine(traffic.specs, traffic.services,
                        serve_plane_cfg(6, 5.0, 16),
                        capacity_spans_per_s=2000, tick_s=1.0,
                        buckets=(64, 256), lane_buckets=(1, 2, 4),
                        max_backlog=3000, baseline_windows=4, rca=True,
                        rca_budget=1, device="cpu")
    rep_tight = tight.run(traffic, duration_s=60.0)
    strip = lambda vs: [{k: v for k, v in d.items() if k != "scored_s"}
                        for d in vs]
    assert strip(_verdicts(tight)) == strip(_verdicts(te))
    assert rep_tight.rca_topk_hits == tr.rca_topk_hits
    assert rep_tight.rca_eligible == tr.rca_eligible
    assert max(v.scored_s - v.enqueued_s for v in tight.rca_verdicts) > \
        max(v.scored_s - v.enqueued_s for v in te.rca_verdicts)
    assert not tight._rca_queue                   # the drain settled it


def test_rca_compile_count_pin(port_on):
    """One first launch per (nodes, neighbors) bucket over the run, in the
    registry's counters; every run used the bucket of the 6-service
    table."""
    te, tr, reg = port_on
    runner = te._rca_plane.runner
    assert runner.bucket_shapes == set(runner.buckets)
    assert reg.counter("anomod_serve_rca_compile_total").value \
        == len(runner.buckets)
    assert reg.counter("anomod_serve_rca_runs_total").value \
        == tr.n_rca_runs > 0
    assert set(runner.runs_by_bucket) == {runner.bucket_for(6)}
    assert reg.histogram("anomod_serve_rca_seconds").count == tr.n_rca_runs
    assert reg.counter("anomod_serve_rca_queued_total").value \
        == tr.n_rca_runs


def test_rca_alert_across_traffic_gap_keeps_pregap_evidence():
    """An alert that fires across a traffic gap longer than the evidence
    window still scores its pre-gap evidence (``tests/test_serve_rca.py``
    's regression pin, on the port)."""
    from anomod_torch.serve.traffic import PowerLawTraffic, TenantFault

    class GapTraffic:
        def __init__(self, inner):
            self.inner = inner

        def arrivals(self, lo, hi):
            return [(tid, b) for tid, b in self.inner.arrivals(lo, hi)
                    if not (tid == 0 and 27.0 <= lo < 55.0)]

    faults = {0: TenantFault("latency", service=1, onset_s=25.0,
                             factor=10.0)}
    traffic = GapTraffic(PowerLawTraffic(
        n_tenants=2, total_rate_spans_per_s=800, alpha=0.0, seed=3,
        n_services=6, faults=faults))
    eng = ServeEngine(traffic.inner.specs, traffic.inner.services,
                      serve_plane_cfg(6, 5.0, 16),
                      capacity_spans_per_s=2000, tick_s=1.0,
                      buckets=(64, 256), lane_buckets=(1, 2),
                      max_backlog=5000, baseline_windows=4,
                      rca=True, rca_windows=3, device="cpu")
    eng.run(traffic, duration_s=65.0)
    pregap = [v for v in eng.rca_verdicts
              if v.tenant_id == 0 and v.alert_window == 5]
    assert len(pregap) == 1
    assert pregap[0].enqueued_s >= 55.0 and pregap[0].n_spans > 0
    assert pregap[0].services[0] == "svc01"


def test_rca_requires_scoring_and_bucket_capacity():
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.queues import TenantSpec
    specs = [TenantSpec(tenant_id=0, name="t0", priority=0,
                        rate_spans_per_s=10.0)]
    services = tuple(f"s{i}" for i in range(4))
    cfg = ReplayConfig(n_services=4, n_windows=16, window_us=5_000_000,
                       chunk_size=1024)
    with pytest.raises(ValueError, match="score"):
        ServeEngine(specs, services, cfg, score=False, rca=True,
                    device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        ServeEngine(specs, services, cfg, rca=True, rca_buckets=((2, 2),),
                    device="cpu")
    with pytest.raises(ValueError, match="rca_budget"):
        ServeEngine(specs, services, cfg, rca=True, rca_budget=0,
                    device="cpu")


# -- env knobs and the CLI ------------------------------------------------------

def test_rca_env_knobs_read_and_validated_as_jax(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod_torch.config import DEFAULT_SERVE_RCA_BUCKETS, Config
    fields = ("serve_rca", "serve_rca_buckets", "serve_rca_topk",
              "serve_rca_budget", "serve_rca_windows")
    assert Config().serve_rca_buckets == DEFAULT_SERVE_RCA_BUCKETS
    for var, val in (("ANOMOD_SERVE_RCA", "1"),
                     ("ANOMOD_SERVE_RCA_BUCKETS", "8x4, 32x8"),
                     ("ANOMOD_SERVE_RCA_TOPK", "3"),
                     ("ANOMOD_SERVE_RCA_BUDGET", "2"),
                     ("ANOMOD_SERVE_RCA_WINDOWS", "6")):
        monkeypatch.setenv(var, val)
    got, want = Config(), JConfig()
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields] == \
        [True, ((8, 4), (32, 8)), 3, 2, 6]
    for var, bad in (("ANOMOD_SERVE_RCA_BUCKETS", "32x8,8x4"),
                     ("ANOMOD_SERVE_RCA_BUCKETS", "banana"),
                     ("ANOMOD_SERVE_RCA_BUCKETS", "8x0"),
                     ("ANOMOD_SERVE_RCA_TOPK", "0"),
                     ("ANOMOD_SERVE_RCA_BUDGET", "none"),
                     ("ANOMOD_SERVE_RCA_WINDOWS", "1")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var) as e:
            Config()
        with pytest.raises(ValueError) as je:
            JConfig()
        assert str(e.value) == str(je.value)
        monkeypatch.delenv(var)


def test_serve_cli_rca_and_trace_out(tmp_path, capsys):
    from anomod_torch.cli import main
    trace = tmp_path / "serve_trace.json"
    assert main(["serve", "--device", "cpu", "--rca", "--tenants", "6",
                 "--services", "6", "--duration", "40", "--capacity",
                 "2000", "--overload", "2", "--seed", "3",
                 "--fault-tenants", "1", "--trace-out", str(trace)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["rca_enabled"] is True and rep["n_rca_runs"] > 0
    names = {s["operationName"] for s in
             json.loads(trace.read_text())["data"][0]["spans"]}
    assert {"serve.run", "serve.rca"} <= names
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu", "--rca", "--no-score"])
