"""The port's serve-plane chaos and shard supervision
(``anomod_torch.serve.chaos``, ``anomod_torch.serve.supervise`` and the
engine's supervised tick) against the JAX package's, on the CPU.

At ``tests/test_serve_supervise.py``'s compact scenario (6 tenants, 4
services, 20 ticks, seed 5, checkpoints every 4 ticks): a chaos-off
supervised run equals the unsupervised port run and the JAX engine's on
states, alerts, SLO, shed and the canonical journal (tolerance 0: byte
equal); a run under crash / except / poolput / stall faults at every
score phase recovers to the fault-free JAX journal at 1 and 2 shards and
pipelines 1 and 2, and the unfused path fires and recovers every kind; a
surge equals the JAX engine's surged run; quarantine and migration give
the JAX engine's counts, decisions and journal; the pooled checkpoint
(one copy a plane) equals the per-tenant gather and is a pure read; the
fault-script grammar, the knobs and the serve CLI's checks give the JAX
package's results and messages.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from anomod.config import Config as JConfig
from anomod.config import validate_chaos_script as jvalidate
from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.config import Config, validate_chaos_script
from anomod_torch.obs.flight import canonical_ticks, diff_journals
from anomod_torch.obs.registry import Registry, get_registry, set_registry
from anomod_torch.serve.chaos import ChaosFault, ServeChaos
from anomod_torch.serve.engine import (RECOVERY_REPORT_FIELDS,
                                       SUPERVISION_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeEngine,
                                       ServeReport, power_law_traffic,
                                       run_power_law, serve_plane_cfg)
from anomod_torch.serve.supervise import (restore_replay, snapshot_replay,
                                          snapshot_replays)

#: ``tests/test_serve_supervise.py``'s scenario: alerts fire (window 2 s,
#: fault onset 12 s) and five checkpoints land (cadence 4 over 20 ticks)
KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
          overload=2.0, duration_s=20, tick_s=1.0, seed=5,
          window_s=2.0, baseline_windows=4, fault_tenants=1,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, flight_digest_every=4, ckpt_every=4)

#: every score phase across both shards of a 2-shard engine, and a stall
#: (the JAX tests' script): five recoveries in one run
ALL_PHASE_SCRIPT = ("crash@6:shard=0:phase=dispatch;"
                    "except@9:shard=1:phase=score;"
                    "poolput@12:shard=0;"
                    "except@15:shard=1:phase=commit;"
                    "crash@17:shard=0:phase=stage;"
                    "stall@10:shard=0:ms=1")

QUARANTINE = dict(shards=2, chaos="except@8:shard=1:phase=dispatch:repeat=-1",
                  retries=2)
MIGRATION = dict(shards=2, retries=3, max_respawns=2,
                 chaos=";".join(f"crash@{t}:shard=0:phase=stage:repeat=-1"
                                for t in range(4, 20)))
SURGE_KW = dict(KW, duration_s=12, chaos="surge@3:factor=3:ticks=4")


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


def _port(**kw):
    return run_power_law(**{**KW, "device": "cpu", **kw})


def _decisions(rep, skip=()):
    drop = set(VARIANT_REPORT_FIELDS) | set(skip) | {"device"}
    return {k: v for k, v in rep.to_dict().items() if k not in drop}


def _fingerprint(eng):
    out = {}
    for tid in sorted(eng._tenant_replay):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg).tobytes(),
                    np.asarray(st.hist).tobytes())
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine's fault-free run (2 shards, pipeline 2, supervised
    at the scenario's cadence): its canonical journal and report."""
    eng, rep = jrun_power_law(shards=2, pipeline=2, **KW)
    return _journal(jcanonical_ticks(eng.flight_recorder.records())), rep


@pytest.fixture(scope="module")
def port_ref():
    return _port(shards=2, pipeline=2)


def _jax_decisions(jrep, skip=()):
    """The JAX report restricted to the port's decision fields."""
    port_fields = {f.name for f in dataclasses.fields(ServeReport)}
    drop = set(VARIANT_REPORT_FIELDS) | set(skip) | {"device"}
    return {k: v for k, v in jrep.to_dict().items()
            if k in port_fields and k not in drop}


# -- the happy path is read-only --------------------------------------------

def test_chaos_off_supervised_equals_unsupervised_and_jax(jax_ref,
                                                          port_ref):
    j_journal, jrep = jax_ref
    eng, rep = port_ref
    off, rep_off = _port(shards=2, pipeline=2, ckpt_every=0)
    assert rep.supervised and rep.ckpt_every == 4
    # the baseline checkpoint, then ticks 3, 7, 11, 15, 19
    assert rep.n_checkpoints == jrep.n_checkpoints == 6
    assert not rep_off.supervised and rep_off.n_checkpoints == 0
    assert rep.n_alerts > 0
    assert _fingerprint(eng) == _fingerprint(off)
    assert _decisions(rep, SUPERVISION_REPORT_FIELDS) \
        == _decisions(rep_off, SUPERVISION_REPORT_FIELDS)
    assert _decisions(rep) == _jax_decisions(jrep)
    for e in (eng, off):
        assert _journal(canonical_ticks(e.flight_recorder.records())) \
            == j_journal


# -- recovery under every fault kind and phase ------------------------------

@pytest.mark.parametrize("shards,pipeline,state", [
    (2, 2, "device"), (2, 1, "device"), (1, 2, "device"), (1, 1, "host")],
    ids=["2sh-p2", "2sh-p1", "1sh-p2", "1sh-p1-host"])
def test_recovery_every_phase_equals_fault_free_jax(jax_ref, port_ref,
                                                    shards, pipeline,
                                                    state):
    j_journal, jrep = jax_ref
    script = ALL_PHASE_SCRIPT if shards == 2 else \
        ALL_PHASE_SCRIPT.replace("shard=1", "shard=0")
    reg = Registry(enabled=True)
    prev = get_registry()
    set_registry(reg)
    try:
        eng, rep = _port(shards=shards, pipeline=pipeline, state=state,
                         chaos=script)
    finally:
        set_registry(prev)
    assert rep.n_shard_crashes == 5           # the stall never fails
    assert rep.n_respawns == (2 if shards == 2 else 0)   # the two kills
    assert rep.n_restored_ticks >= 5
    assert rep.n_quarantined == 0 and rep.n_migrated_tenants == 0
    assert eng._chaos.n_injected == 6 and eng._chaos.n_stalls == 1
    for name, want in (("anomod_serve_chaos_injected_total", 6),
                       ("anomod_serve_chaos_stalls_total", 1),
                       ("anomod_serve_shard_crashes_total", 5),
                       ("anomod_serve_shard_respawns_total", rep.n_respawns),
                       ("anomod_serve_ckpt_total", rep.n_checkpoints),
                       ("anomod_serve_restored_ticks_total",
                        rep.n_restored_ticks)):
        assert reg.counter(name).value == want, name
    assert reg.counter("anomod_serve_recovery_seconds_total").value > 0
    assert reg.counter("anomod_serve_ckpt_seconds_total").value > 0
    # no score gap: the journal is the fault-free JAX run's, the states
    # and decisions the fault-free port run's
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == j_journal
    assert _fingerprint(eng) == _fingerprint(port_ref[0])
    skip = RECOVERY_REPORT_FIELDS + ("serve_state",)
    assert _decisions(rep, skip) == _decisions(port_ref[1], skip)
    events = [ev for t in eng.flight_recorder.records()
              for ev in t["recovery"]]
    assert [ev["kind"] for ev in events] == ["recovered"] * 5
    assert sum(ev["restored_ticks"] for ev in events) \
        == rep.n_restored_ticks


def test_recovered_counts_equal_jax_engine():
    """The JAX engine under the same script at 2 shards, pipeline 2:
    the same crashes, respawns and re-executed slices."""
    _, jrep = jrun_power_law(shards=2, pipeline=2, chaos=ALL_PHASE_SCRIPT,
                             **{**KW, "duration_s": 13})
    _, rep = _port(shards=2, pipeline=2, chaos=ALL_PHASE_SCRIPT,
                   duration_s=13)
    assert rep.n_shard_crashes == jrep.n_shard_crashes == 3
    for f in RECOVERY_REPORT_FIELDS + SUPERVISION_REPORT_FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f


def test_unfused_engine_fires_and_recovers_every_kind():
    kw = dict(duration_s=12, fault_tenants=0, shards=1, fuse=False)
    e0, _ = _port(**kw)
    eng, rep = _port(chaos="crash@4;except@6:phase=fold;poolput@8;"
                           "except@9:phase=commit;stall@5:ms=1", **kw)
    assert eng._chaos.n_injected == 5
    assert rep.n_shard_crashes == 4
    assert _fingerprint(eng) == _fingerprint(e0)
    assert diff_journals(e0.flight_recorder.journal(),
                         eng.flight_recorder.journal()) is None


def test_surge_equals_jax_surge():
    """A surge multiplies every tenant's offered arrivals for its ticks:
    a different run, the same one as the JAX engine's."""
    jeng, jrep = jrun_power_law(**SURGE_KW)
    eng, rep = _port(**{k: v for k, v in SURGE_KW.items()
                        if k not in KW or SURGE_KW[k] != KW[k]})
    assert eng._chaos.n_injected == 1 and rep.n_shard_crashes == 0
    assert rep.offered_spans == jrep.offered_spans
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))


def test_unsupervised_chaos_propagates():
    with pytest.raises(ChaosFault, match="injected exception"):
        _port(shards=1, chaos="except@6:shard=0", ckpt_every=0)


# -- degradation: quarantine and migration -----------------------------------

@pytest.mark.parametrize("case", [QUARANTINE, MIGRATION],
                         ids=["quarantine", "migration"])
def test_degradation_equals_jax_engine(jax_ref, case):
    jeng, jrep = jrun_power_law(**{**KW, **case})
    eng, rep = _port(**case)
    assert rep.ticks == 20
    for f in RECOVERY_REPORT_FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f
    assert _decisions(rep) == _jax_decisions(jrep)
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))
    kinds = [ev["kind"] for t in eng.flight_recorder.records()
             for ev in t["recovery"]]
    assert kinds == [ev["kind"] for t in jeng.flight_recorder.records()
                     for ev in t["recovery"]]
    if case is QUARANTINE:
        assert rep.n_quarantined > 0 and rep.n_migrated_tenants == 0
        assert "quarantine" in kinds
    else:
        # the fault followed the shard: no score gap after migration
        assert rep.n_migrated_tenants > 0 and rep.n_quarantined == 0
        assert rep.n_respawns == 2 and kinds.count("migrate") == 1
        assert _journal(canonical_ticks(eng.flight_recorder.records())) \
            == jax_ref[0]


def test_backoff_sleeps_through_the_injected_clock():
    traffic = power_law_traffic(6, 4, 1000, 2.0, 20, 5, 1.2, 2.0, 4, 1)
    eng = ServeEngine(traffic.specs, traffic.services,
                      serve_plane_cfg(4, 2.0, 16), capacity_spans_per_s=1000,
                      buckets=(64, 256), lane_buckets=(1, 2, 4),
                      max_backlog=1500, device="cpu", ckpt_every=4,
                      retry_backoff_s=0.5, flight=False,
                      chaos="except@6:phase=score:repeat=2")
    slept = []
    eng._supervisor._sleep = slept.append
    eng.run(traffic, duration_s=20)
    # two failed attempts of tick 6's slice: 0.5 s, then doubled
    assert slept == [0.5, 1.0]
    assert eng._supervisor.n_crashes == 1
    assert eng._supervisor.n_restored_ticks > 0


# -- the checkpoint ----------------------------------------------------------

def test_pooled_checkpoint_equals_per_tenant_gather(port_ref):
    eng, _ = port_ref
    reps = eng._tenant_replay
    batched = snapshot_replays(reps)
    assert sorted(batched) == sorted(reps)
    for tid, rep in reps.items():
        one = snapshot_replay(rep)
        got = batched[tid]
        assert {k: got[k] for k in ("t0_us", "window_offset", "n_spans")} \
            == {k: one[k] for k in ("t0_us", "window_offset", "n_spans")}
        for a, b in zip(got["state"], one["state"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert isinstance(a, np.ndarray) and a.dtype == np.float32
                assert a.tobytes() == np.asarray(b).tobytes()
    # a pure read: writing the checkpoint leaves the pool untouched
    tid = sorted(reps)[0]
    before = reps[tid].state.agg.clone()
    batched[tid]["state"].agg[:] = -1.0
    assert torch.equal(reps[tid].state.agg, before)
    # and a restore round trip into a fresh plane is byte-exact
    snap = snapshot_replay(reps[tid])
    runner = reps[tid]._runner
    from anomod_torch.serve.batcher import (BucketedStreamReplay,
                                            PooledStreamReplay)
    for cls in (PooledStreamReplay, BucketedStreamReplay):
        fresh = cls(eng.cfg, eng.t0_us, runner)
        restore_replay(fresh, snap)
        assert np.asarray(fresh.state.agg).tobytes() \
            == snap["state"].agg.tobytes()
        assert fresh.window_offset == reps[tid].window_offset
        if cls is PooledStreamReplay:
            fresh.release()
            with pytest.raises(ValueError, match="released"):
                fresh.state


# -- the grammar, the knobs and the CLI ---------------------------------------

@pytest.mark.parametrize("script", [
    "", "crash@5", "crash@5;except@6:shard=1:phase=score;stall@7:ms=2.5;"
    "poolput@8:repeat=-1", "surge@3:factor=6:ticks=6", " except@0 ; ",
    "boom@5", "crash", "crash@x", "crash@-1", "crash@5:phase=nope",
    "crash@5:repeat=0", "crash@5:shard=-2", "crash@5:frobnicate=1",
    "stall@5:ms=99999", "surge@5:factor=1", "surge@5:ticks=0",
    "surge@5:shard=1", "crash@5:factor=2", "stall@5:ms=abc",
    "crash@5:phase"])
def test_chaos_script_grammar_equals_jax(script):
    try:
        want = jvalidate(script)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_chaos_script(script)
        assert str(got.value) == str(e)
        return
    assert validate_chaos_script(script) == want
    assert [(f.kind, f.tick, f.shard, f.phase, f.repeat)
            for f in ServeChaos(script).faults] \
        == [(f["kind"], f["tick"], f["shard"], f["phase"], f["repeat"])
            for f in want]


def test_supervision_knobs_equal_jax(monkeypatch):
    for var, bad in (("ANOMOD_SERVE_CHAOS", "boom@5"),
                     ("ANOMOD_SERVE_CKPT_EVERY", "-1"),
                     ("ANOMOD_SERVE_CKPT_EVERY", "x"),
                     ("ANOMOD_SERVE_RETRIES", "0"),
                     ("ANOMOD_SERVE_RETRIES", "65"),
                     ("ANOMOD_SERVE_RETRY_BACKOFF_S", "-0.5"),
                     ("ANOMOD_SERVE_RETRY_BACKOFF_S", "soon"),
                     ("ANOMOD_SERVE_MAX_RESPAWNS", "-1"),
                     ("ANOMOD_SERVE_MAX_RESPAWNS", "4097")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)
    monkeypatch.setenv("ANOMOD_SERVE_CHAOS", "crash@4:shard=1")
    monkeypatch.setenv("ANOMOD_SERVE_CKPT_EVERY", "8")
    got, want = Config(), JConfig()
    names = ("serve_chaos", "serve_ckpt_every", "serve_retries",
             "serve_retry_backoff_s", "serve_max_respawns")
    assert [getattr(got, n) for n in names] \
        == [getattr(want, n) for n in names] \
        == ["crash@4:shard=1", 8, 3, 0.0, 8]
    from anomod_torch.replay import ReplayConfig
    for bad in (dict(ckpt_every=-1), dict(retries=0),
                dict(retry_backoff_s=-1.0), dict(max_respawns=-1)):
        with pytest.raises(ValueError):
            ServeEngine([], ["a"], ReplayConfig(n_services=1),
                        device="cpu", **bad)
    with pytest.warns(RuntimeWarning, match="targets shard"):
        ServeEngine([], ["a"], ReplayConfig(n_services=1), device="cpu",
                    chaos="crash@5:shard=1", shards=1)


def _cli_error(main, argv) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        main(argv)
    assert ex.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("flags", [
    ["--ckpt-every", "-1"], ["--chaos", "boom@5"],
    ["--chaos", "crash@5:shard=3", "--shards", "2"],
    ["--chaos", "crash@5:ms=1:phase=zap"], ["--worker", "fiber"]])
def test_cli_serve_checks_equal_jax(flags):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    argv = ["serve", "--tenants", "4", "--duration", "4"] + flags
    assert _cli_error(main, argv) == _cli_error(jmain, argv)


def test_cli_serve_chaos_recovers(capsys):
    from anomod_torch.cli import main
    args = ["serve", "--device", "cpu", "--tenants", "6", "--services",
            "4", "--duration", "12", "--capacity", "1000", "--overload",
            "2", "--seed", "5", "--buckets", "64,256", "--lane-buckets",
            "1,2,4", "--ckpt-every", "4"]
    assert main(args) == 0
    clean = json.loads(capsys.readouterr().out)
    assert main(args + ["--chaos", "crash@5;except@8:phase=score"]) == 0
    hit = json.loads(capsys.readouterr().out)
    assert clean["supervised"] and clean["n_shard_crashes"] == 0
    assert hit["n_shard_crashes"] == 2 and hit["n_restored_ticks"] > 0
    skip = set(VARIANT_REPORT_FIELDS) | set(RECOVERY_REPORT_FIELDS)
    assert {k: v for k, v in clean.items() if k not in skip} \
        == {k: v for k, v in hit.items() if k not in skip}
    assert main(args[:-2] + ["--ckpt-every", "0"]) == 0
    off = json.loads(capsys.readouterr().out)
    assert off["supervised"] is False and off["n_checkpoints"] == 0
