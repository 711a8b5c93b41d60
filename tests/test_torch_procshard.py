"""The port's process shard workers (``anomod_torch.serve.procshard`` and
the engine's process half) against the JAX package's thread engine, on
the CPU.

At ``tests/test_serve_procshard.py``'s compact scenario (6 tenants, 4
services, 20 ticks, seed 5): port runs with each shard's score plane in
a spawned worker process, at 2 shards with the sparse and the dense
barrier fold and at 1 shard, equal the JAX thread engine's run on every
alert stream, decision field and the canonical journal (tolerance 0:
byte equal); a run whose child is killed mid-tick respawns it, restores
it from the checkpoint and still equals it; the sparse fold ships at
most half the dense fold's bytes; ``crc32_combine`` equals ``zlib`` and
the digest fragments fold to the sequential walk; a child that cannot
start (no CUDA where asked, past its start timeout) fails loudly; child
errors are rebuilt as the chaos types; a tenant taken out of one child
and put into another is byte-exact; the knobs match the JAX package's.

The JAX thread engine is the oracle, so no JAX child is spawned.  Each
spawned child imports torch; the module holds torch to one intra-op
thread (the children inherit it) and keeps its spawns to five runs.
"""

import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import (canonical_ticks, crc32_combine,
                                     fold_digest_parts, state_digest,
                                     state_digest_parts)
from anomod_torch.obs.registry import Registry, get_registry, set_registry
from anomod_torch.serve import procshard
from anomod_torch.serve.chaos import ChaosFault, ChaosWorkerCrash
from anomod_torch.serve.engine import (RECOVERY_REPORT_FIELDS,
                                       SUPERVISION_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeReport,
                                       run_power_law)

#: ``tests/test_serve_procshard.py``'s scenario
KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
          overload=2.0, duration_s=20, tick_s=1.0, seed=5,
          window_s=2.0, baseline_windows=4, fault_tenants=1,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, flight_digest_every=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    """One port run under its own enabled registry (the barrier folds
    land there)."""
    prev = get_registry()
    set_registry(Registry(enabled=True))
    try:
        return run_power_law(**{**KW, "device": "cpu", **kw})
    finally:
        set_registry(prev)


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


@pytest.fixture(scope="module")
def jax_thread():
    """The JAX thread engine, 2 shards, pipeline 2: the oracle."""
    eng, rep = jrun_power_law(shards=2, pipeline=2, worker="thread",
                              fold="sparse", **KW)
    return (eng, rep,
            _journal(jcanonical_ticks(eng.flight_recorder.records())))


@pytest.fixture(scope="module")
def proc_runs():
    return {"2-sparse": _run(shards=2, pipeline=2, worker="process",
                             fold="sparse"),
            "1-sparse": _run(shards=1, worker="process", fold="sparse"),
            "2-dense": _run(shards=2, pipeline=2, worker="process",
                            fold="dense")}


def assert_equals_jax_thread(jax_thread, eng, rep, skip=()):
    jeng, jrep, j_journal = jax_thread
    assert sorted(eng._tenant_det) == sorted(jeng._tenant_det)
    for tid in sorted(jeng._tenant_det):
        assert [dataclasses.asdict(a) for a in eng.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in jeng.alerts_for(tid)], tid
    port_fields = {f.name for f in dataclasses.fields(ServeReport)}
    drop = set(VARIANT_REPORT_FIELDS) | set(skip) | {"device"}
    assert {k: v for k, v in rep.to_dict().items() if k not in drop} \
        == {k: v for k, v in jrep.to_dict().items()
            if k in port_fields and k not in drop}
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == j_journal


@pytest.mark.parametrize("leg", ["2-sparse", "1-sparse", "2-dense"])
def test_process_runs_equal_jax_thread_engine(jax_thread, proc_runs, leg):
    eng, rep = proc_runs[leg]
    assert rep.worker == "process" and jax_thread[1].worker == "thread"
    assert rep.fold == leg.split("-")[1]
    assert rep.shards == int(leg[0]) and rep.n_alerts > 0
    assert eng.flight_recorder.header["run"]["worker"] == "process"
    assert eng.flight_recorder.header["engine"]["worker"] == "process"
    # the children's runner books arrived: every staged chunk counted
    assert rep.dispatches_by_width == jax_thread[1].dispatches_by_width
    assert rep.supervised and rep.n_checkpoints > 0
    assert eng._workers is None          # the run reaped its children
    assert eng.worker_start_s > 0
    assert_equals_jax_thread(jax_thread, eng, rep)


def test_sparse_fold_payload_under_half_dense(proc_runs):
    _, sparse = proc_runs["2-sparse"]
    _, dense = proc_runs["2-dense"]
    assert 0 < sparse.fold_payload_bytes <= 0.5 * dense.fold_payload_bytes


def test_child_crash_respawns_with_no_score_gap(jax_thread):
    eng, rep = _run(shards=2, pipeline=2, worker="process", ckpt_every=4,
                    chaos="crash@6:shard=1:phase=fold:repeat=1")
    assert rep.worker == "process"
    assert rep.n_shard_crashes == 1 and rep.n_respawns == 1
    assert rep.n_restored_ticks >= 1
    assert_equals_jax_thread(jax_thread, eng, rep,
                             skip=RECOVERY_REPORT_FIELDS
                             + SUPERVISION_REPORT_FIELDS)
    events = [ev for t in eng.flight_recorder.records()
              for ev in t["recovery"]]
    assert [(ev["kind"], ev["shard"], ev["respawns"]) for ev in events] \
        == [("recovered", 1, 1)]
    assert "ChaosWorkerCrash" in events[0]["error"]


# -- the digest fragments -----------------------------------------------------

def test_crc32_combine_matches_zlib():
    rng = np.random.default_rng(11)
    for n_a, n_b in ((0, 1), (1, 0), (7, 13), (256, 1024), (4096, 3)):
        a = rng.integers(0, 256, n_a, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n_b, dtype=np.uint8).tobytes()
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) \
            == zlib.crc32(a + b)


def test_fold_digest_parts_matches_sequential_walk():
    eng, _ = _run(shards=2, flight=False, duration_s=12)
    replays = eng._tenant_replay
    assert len(replays) >= 4
    assert fold_digest_parts(state_digest_parts(replays)) \
        == state_digest(replays)
    tids = sorted(replays)
    mixed = state_digest_parts({t: replays[t] for t in tids[1::2]}) \
        + state_digest_parts({t: replays[t] for t in tids[::2]})
    assert fold_digest_parts(mixed, prev=0xDEAD) \
        == state_digest(replays, prev=0xDEAD)


# -- no fallback hides the card or the workers --------------------------------

def _init(**over):
    from anomod_torch.serve.engine import power_law_traffic, serve_plane_cfg
    traffic = power_law_traffic(2, 4, 500, 1.0, 4, 3, 1.2, 2.0, 2, 0)
    init = {"shard_id": 0, "specs": traffic.specs,
            "services": traffic.services, "cfg": serve_plane_cfg(4, 2.0, 16),
            "t0_us": 0, "capacity_spans_per_s": 500.0, "tick_s": 1.0,
            "buckets": (64,), "lane_buckets": (1,), "max_backlog": 800,
            "score": True, "fuse": True, "pipeline": 2, "native": False,
            "state": "device", "drain_engine": "heap",
            "det_kw": dict(baseline_windows=2, z_threshold=4.0,
                           consecutive=1, min_count=5.0),
            "device": "cpu", "torch_threads": 1, "registry_enabled": False,
            "chaos_script": "crash@1:shard=1;except@2;stall@3:shard=1",
            "chaos_fired": [1, 0]}
    init.update(over)
    return init


def test_child_keeps_its_shard_faults_and_takes_the_given_device():
    plane = procshard._ShardPlane(_init(shard_id=1))
    assert [(f.kind, f.shard, f.fired) for f in plane.chaos.faults] \
        == [("crash", 0, 1), ("stall", 0, 0)]
    assert plane.static_facts()["device"] == "cpu"
    reply, die = plane.handle({"op": "nope"})
    assert not die and reply["error"]["type"] == "ValueError"
    assert reply["chaos_fired"] == [1, 0] and reply["launches"] == {}


def test_child_takes_and_puts_a_tenant_byte_exact():
    """``take_tenant`` snapshots a tenant out of one child's plane and
    ``put_tenant`` installs it into another's: the digest fragment, the
    alert list and the runner books travel as host data, byte-exact."""
    from anomod_torch.serve.engine import power_law_traffic
    from anomod_torch.serve.queues import QueuedBatch
    init = _init(chaos_script=None, chaos_fired=None)
    src, dst = procshard._ShardPlane(init), procshard._ShardPlane(init)
    traffic = power_law_traffic(2, 4, 500, 1.0, 4, 3, 1.2, 2.0, 2, 0)
    for t in range(4):
        served = [QueuedBatch(tid, 10 * t + tid, spans, spans.n_spans, 0,
                              float(t), 0.0)
                  for tid, spans in traffic.arrivals(float(t), t + 1.0)]
        reply, _ = src.handle({"op": "score", "served": served,
                               "origin_tick": t})
        assert "error" not in reply
    want = {p[0]: p[1:] for p in src.handle({"op": "digest"})[0]["parts"]}
    tid = sorted(want)[0]
    snap = src.handle({"op": "take_tenant", "tid": tid})[0]["snap"]
    assert tid not in src.eng._tenant_replay
    assert src.handle({"op": "take_tenant", "tid": tid})[0]["snap"] is None
    reply, _ = dst.handle({"op": "put_tenant", "tid": tid,
                           "replay": snap[0], "det": snap[1]})
    assert reply["resident_new"] == [tid] and reply["alerts"] == []
    got = {p[0]: p[1:] for p in dst.handle({"op": "digest"})[0]["parts"]}
    assert got == {tid: want[tid]}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this host has a CUDA device")
def test_child_without_cuda_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        procshard._ShardPlane(_init(device="cuda"))


def test_child_past_its_start_timeout_fails_the_start():
    with pytest.raises(TimeoutError, match="did not finish startup"):
        procshard.start_workers([(0, _init()), (1, _init(shard_id=1))],
                                start_timeout_s=0.001)


def test_child_errors_rebuild_as_chaos_types():
    for exc in (ChaosFault("f"), ChaosWorkerCrash("c"), ValueError("v"),
                KeyError("k")):
        try:
            raise exc
        except BaseException as e:    # noqa: BLE001
            got = procshard.rebuild_exc(procshard.ship_exc(e))
        assert type(got) is type(exc)
        assert getattr(got, "kills_worker", False) \
            == isinstance(exc, ChaosWorkerCrash)

    class Odd(Exception):
        kills_worker = True
    try:
        raise Odd("odd")
    except Odd as e:
        got = procshard.rebuild_exc(procshard.ship_exc(e))
    assert type(got) is RuntimeError and got.kills_worker
    assert "Odd" in str(got) and "raise Odd" in got.remote_traceback


def test_worker_knobs_equal_jax(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    for var, bad in (("ANOMOD_SERVE_WORKER", "goroutine"),
                     ("ANOMOD_SERVE_WORKER_START_TIMEOUT_S", "0"),
                     ("ANOMOD_SERVE_WORKER_START_TIMEOUT_S", "3601"),
                     ("ANOMOD_SERVE_WORKER_START_TIMEOUT_S", "soon")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)
    monkeypatch.setenv("ANOMOD_SERVE_WORKER", "process")
    monkeypatch.setenv("ANOMOD_SERVE_WORKER_START_TIMEOUT_S", "30")
    got, want = Config(), JConfig()
    assert (got.serve_worker, got.serve_worker_start_timeout_s) \
        == (want.serve_worker, want.serve_worker_start_timeout_s) \
        == ("process", 30.0)
    cfg = ReplayConfig(n_services=1)
    with pytest.raises(ValueError, match="thread|process"):
        ServeEngine([], ["a"], cfg, device="cpu", worker="greenlet")
    # with no in-process plane asked for, nothing blocks process workers
    # (the blockers: test_process_workers_refused_beside_in_process_planes)
    eng = ServeEngine([], ["a"], cfg, device="cpu", worker="process")
    assert eng.worker_mode == "process" and eng._process_blockers() == []
    assert eng._use_workers and eng._workers is None


def test_policy_scales_across_process_children():
    """The elastic policy across process children (the JAX package's
    ``test_policy_scales_across_process_workers``): under the scripted
    surge a child is spawned at the scale-up, tenants move out of one
    child and into another, the dying child's registry drains before it
    retires, and the run equals the static thread run on every alert,
    decision and the canonical journal, and the JAX engine's elastic
    thread run on the scaling events, decisions and canonical journal."""
    from anomod_torch.serve.engine import POLICY_REPORT_FIELDS
    pkw = dict(overload=0.6, duration_s=24, window_s=5.0, fault_tenants=0,
               chaos="surge@6:factor=6:ticks=6")
    elastic = dict(shards=1, policy="auto", min_shards=1, max_shards=2,
                   cooldown_ticks=3)
    es, rs = _run(shards=1, worker="thread", **pkw)
    ee, re_ = _run(worker="process", **elastic, **pkw)
    jee, jre = jrun_power_law(worker="thread", **elastic, **{**KW, **pkw})
    assert re_.worker == "process" and re_.peak_shards == 2
    assert re_.n_scale_ups >= 1 and re_.n_scale_downs >= 1
    assert re_.n_policy_migrations >= 1
    assert len(ee._runners) == 1 and ee._workers is None
    skip = set(VARIANT_REPORT_FIELDS) | set(POLICY_REPORT_FIELDS) \
        | set(RECOVERY_REPORT_FIELDS) | {"device"}
    assert {k: v for k, v in re_.to_dict().items() if k not in skip} \
        == {k: v for k, v in rs.to_dict().items() if k not in skip}
    for tid in es._tenant_det:
        assert [dataclasses.asdict(a) for a in ee.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in es.alerts_for(tid)]
    assert ee.flight_recorder.canonical_bytes() \
        == es.flight_recorder.canonical_bytes()

    def scaling(eng):
        return [ev for t in eng.flight_recorder.records()
                for ev in t.get("scaling", ())]
    assert scaling(ee) == scaling(jee) and scaling(ee)
    assert_equals_jax_thread(
        (jee, jre, _journal(jcanonical_ticks(jee.flight_recorder.records()))),
        ee, re_, skip=RECOVERY_REPORT_FIELDS)


@pytest.mark.parametrize("plane", ["async_commit", "tier_hot"])
def test_process_workers_refused_beside_in_process_planes(plane,
                                                          monkeypatch):
    """The deferred commit and state tiering keep state the score plane
    shares in-process: an explicit ``worker="process"`` beside either
    raises with the JAX engine's text, an env-sourced one degrades to
    threads."""
    from anomod.serve.engine import ServeEngine as JEngine
    from anomod_torch.config import Config, set_config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    kw = {"async_commit": True} if plane == "async_commit" \
        else {"tier_hot": 4}
    cfg = ReplayConfig(n_services=1)
    with pytest.raises(ValueError) as got:
        ServeEngine([], ["a"], cfg, device="cpu", worker="process", **kw)
    with pytest.raises(ValueError) as want:
        JEngine([], ["a"], cfg, worker="process", **kw)
    assert str(got.value) == str(want.value)
    assert ("deferred-commit seam" if plane == "async_commit"
            else "demotion copier") in str(got.value)
    monkeypatch.setenv("ANOMOD_SERVE_WORKER", "process")
    prev = set_config(Config())
    try:
        eng = ServeEngine([], ["a"], cfg, device="cpu", **kw)
        assert eng.worker_mode == "thread" and len(eng._process_blockers())
        eng.close()
    finally:
        set_config(prev)
