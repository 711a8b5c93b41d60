"""The port's thread shards (``anomod_torch.serve.shard`` and the engine's
N-shard path) against the JAX package's ``anomod/serve/shard.py`` and
against the port's own 1-shard engine, on the CPU.

Placement equals the JAX functions for the same specs at 1-8 shards; an
N-shard run equals the 1-shard run on every report field outside
``VARIANT_REPORT_FIELDS``, on the detector states and alerts, the RCA
verdicts and the canonical flight journal (two seeds, shards 2 and 3);
the sparse and dense barrier folds give equal scrapes; a failing shard
re-raises at the barrier; the worker knob resolves as the JAX one does
(process workers: ``tests/test_torch_procshard.py``).
"""

import dataclasses
import json

import numpy as np
import pytest

from anomod.serve import shard as jshard
from anomod.serve.queues import TenantSpec as JSpec
from anomod_torch.obs import export
from anomod_torch.obs.registry import Registry, get_registry, set_registry
from anomod_torch.serve import shard
from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
from anomod_torch.serve.queues import TenantSpec
from anomod_torch.serve.traffic import PowerLawTraffic

#: ``tests/test_serve_rca.py``'s deployment, RCA on
_RUN_KW = dict(n_tenants=8, n_services=6, capacity_spans_per_s=2000,
               overload=2.0, duration_s=30, tick_s=1.0, window_s=5.0,
               baseline_windows=2, fault_tenants=2, buckets=(64, 256),
               lane_buckets=(1, 2, 4), max_backlog=3000, n_windows=16,
               rca=True, flight_digest_every=4, device="cpu")


def _specs(n, seed):
    specs = PowerLawTraffic(n_tenants=n, total_rate_spans_per_s=5000.0,
                            alpha=1.2, seed=seed, n_services=4).specs
    return specs, [JSpec(**dataclasses.asdict(s)) for s in specs]


# -- placement --------------------------------------------------------------

@pytest.mark.parametrize("n_shards", range(1, 9))
def test_plan_and_rendezvous_equal_jax(n_shards):
    for n, seed in ((5, 0), (40, 3), (200, 7)):
        specs, jspecs = _specs(n, seed)
        for cap in (0.0, 2500.0, 1e9):
            assert shard.plan_shards(specs, n_shards, cap) \
                == jshard.plan_shards(jspecs, n_shards, cap)
        for tid in range(n):
            assert shard.rendezvous_shard(tid, n_shards) \
                == jshard.rendezvous_shard(tid, n_shards)
    assert shard.served_rate_model(specs, 2500.0) \
        == jshard.served_rate_model(jspecs, 2500.0)
    with pytest.raises(ValueError):
        shard.plan_shards(specs, 0)


def test_fold_helpers_equal_jax():
    parts = [[(3, "c", 0.1), (0, "a", 0.2)], [], [(1, "b", 0.3)]]
    assert shard.fold_verdicts(parts) == jshard.fold_verdicts(parts)
    legs = [{"shard": 2, "x": 1}, {"shard": 0, "x": 2}]
    assert shard.fold_leg_records(legs) == jshard.fold_leg_records(legs)
    for n in range(0, 7):
        items = [[i] for i in range(n)]
        assert shard.fold_tree(items, lambda a, b: a + b) \
            == jshard.fold_tree(items, lambda a, b: a + b)
    assert shard.fold_tree([(1,), (2,), (3,)],
                           lambda a, b: ("(",) + a + b + (")",)) \
        == ("(", "(", 1, 2, ")", 3, ")")


# -- the N-shard engine against the 1-shard engine --------------------------

def _fingerprint(eng):
    out = {}
    for tid in sorted(eng._tenant_replay):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg).tobytes(),
                    np.asarray(st.hist).tobytes())
    return out


def _decisions(rep):
    return {k: v for k, v in rep.to_dict().items()
            if k not in VARIANT_REPORT_FIELDS}


@pytest.fixture(scope="module", params=[3, 11], ids=["seed3", "seed11"])
def one_shard(request):
    return request.param, run_power_law(seed=request.param, **_RUN_KW)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_n_shards_equal_one_shard(one_shard, n_shards):
    seed, (e1, r1) = one_shard
    en, rn = run_power_law(seed=seed, shards=n_shards, **_RUN_KW)
    assert rn.shards == n_shards and r1.shards == 1
    assert sum(rn.shard_tenants.values()) == _RUN_KW["n_tenants"]
    assert sum(rn.shard_spans.values()) == rn.served_spans
    assert len(en._runners) == n_shards and len(en._rca_planes) == n_shards
    assert r1.n_alerts > 0 and r1.n_rca_runs > 0
    assert _decisions(rn) == _decisions(r1)
    assert _fingerprint(en) == _fingerprint(e1)
    assert [repr(v.to_dict()) for v in en.rca_verdicts] \
        == [repr(v.to_dict()) for v in e1.rca_verdicts]
    assert en.flight_recorder.canonical_bytes() \
        == e1.flight_recorder.canonical_bytes()
    # each shard's pool holds exactly the tenants it owns
    for s, r in enumerate(en._runners):
        assert r.pool.capacity == max(rn.shard_tenants[s], 1)
    assert en._workers is None          # the run closed its workers


def test_sparse_and_dense_folds_give_equal_scrapes():
    """The barrier's two merge modes land the same registry (scrape
    journal and Prometheus text, wall-clock series aside); only the
    payload bytes, and their own counter, differ.  The folded counters
    equal the report's books."""
    got = {}
    prev = get_registry()
    try:
        for mode in ("sparse", "dense"):
            reg = Registry(enabled=True)
            set_registry(reg)
            _, rep = run_power_law(seed=3, shards=2, fold=mode,
                                   **dict(_RUN_KW, rca=False))
            got[mode] = (reg, rep)
    finally:
        set_registry(prev)
    (rs, ps), (rd, pd) = got["sparse"], got["dense"]
    payload = "anomod_serve_fold_payload_bytes_total"

    def keep(name):
        return payload not in name and "_seconds" not in name

    def scrape(reg):
        return ([s for s in reg.journal() if keep(s[1])],
                [line for line in export.to_prometheus_text(reg).splitlines()
                 if keep(line)])
    assert scrape(rs) == scrape(rd)
    assert 0 < ps.fold_payload_bytes < pd.fold_payload_bytes
    assert rs.counter("anomod_serve_fused_dispatches_total").value \
        == ps.fused_dispatches
    assert rs.counter("anomod_serve_fold_payload_bytes_total").value \
        == ps.fold_payload_bytes
    assert 'shard="1"' in export.to_prometheus_text(rs)


def test_failing_shard_reraises_at_the_barrier():
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    traffic = PowerLawTraffic(n_tenants=6, total_rate_spans_per_s=2000.0,
                              alpha=1.2, seed=3, n_services=4)
    # unsupervised: with supervision on (the default) the supervisor
    # recovers the failure instead (tests/test_torch_supervise.py)
    eng = ServeEngine(traffic.specs, traffic.services, serve_plane_cfg(4),
                      capacity_spans_per_s=1500.0, shards=2, device="cpu",
                      flight=False, ckpt_every=0)
    done = []
    real = eng._score_shard

    def score(s, served):
        if s == 1:
            raise RuntimeError("shard 1 failed")
        real(s, served)
        done.append(s)
    eng._score_shard = score
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        for k in range(4):
            eng.tick(traffic.arrivals(k * 1.0, (k + 1) * 1.0))
    assert [s for s, _ in eng._last_failures] == [1]
    assert done == [0]          # the sibling finished before the raise
    eng.close()
    # join_all completes every join before the first error propagates
    workers = [shard.ShardWorker(s) for s in range(3)]
    ran = []
    workers[0].submit(lambda: (_ for _ in ()).throw(ValueError("w0")))
    workers[1].submit(lambda: ran.append(1))
    workers[2].submit(lambda: ran.append(2))
    with pytest.raises(ValueError, match="w0"):
        shard.join_all(workers)
    assert sorted(ran) == [1, 2]
    for w in workers:
        w.close()


def test_shard_knobs_and_process_workers_refused(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    from anomod_torch.serve.engine import ServeEngine
    monkeypatch.setenv("ANOMOD_SERVE_SHARDS", "4")
    monkeypatch.setenv("ANOMOD_SERVE_FOLD", "dense")
    cfg = Config()
    assert (cfg.serve_shards, cfg.serve_fold, cfg.serve_worker) \
        == (4, "dense", "thread")
    for var, bad in (("ANOMOD_SERVE_SHARDS", "0"),
                     ("ANOMOD_SERVE_SHARDS", "257"),
                     ("ANOMOD_SERVE_SHARDS", "two"),
                     ("ANOMOD_SERVE_FOLD", "tree"),
                     ("ANOMOD_SERVE_WORKER", "fiber")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)
    # process workers are ported: the knob resolves as the JAX one does
    monkeypatch.setenv("ANOMOD_SERVE_WORKER", "process")
    assert Config().serve_worker == JConfig().serve_worker == "process"
    monkeypatch.delenv("ANOMOD_SERVE_WORKER")
    spec = [TenantSpec(tenant_id=0, name="t0", rate_spans_per_s=10.0)]
    with pytest.raises(ValueError, match="dense|sparse"):
        ServeEngine(spec, ("a",), device="cpu", fold="tree")
    with pytest.raises(ValueError):
        ServeEngine(spec, ("a",), device="cpu", shards=0)


def test_cli_serve_with_shards_on_cpu(capsys):
    from anomod_torch.cli import main
    args = ["serve", "--device", "cpu", "--tenants", "8", "--services",
            "4", "--duration", "12", "--capacity", "1500", "--seed", "3",
            "--buckets", "64,256", "--lane-buckets", "1,2,4"]
    assert main(args) == 0
    one = json.loads(capsys.readouterr().out)
    assert main(args + ["--shards", "2", "--fold", "dense"]) == 0
    two = json.loads(capsys.readouterr().out)
    assert two["shards"] == 2 and one["shards"] == 1
    assert two["flight_enabled"] and two["flight_dropped_ticks"] == 0
    skip = set(VARIANT_REPORT_FIELDS)
    assert {k: v for k, v in one.items() if k not in skip} \
        == {k: v for k, v in two.items() if k not in skip}


def test_launch_counts_survive_concurrent_shard_threads():
    """Shard workers launch the serve kernels concurrently: the launch
    counts are read-modify-writes under a lock, so none is lost even
    with the interpreter switching threads every microsecond."""
    import sys
    import threading

    from anomod_torch.ops import serve_kernels as sk
    before = dict(sk.launches)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [sk._count("lane_delta") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sk.launches["lane_delta"] - before["lane_delta"] == 16 * 2000
    finally:
        sys.setswitchinterval(switch)
        sk.launches.update(before)
