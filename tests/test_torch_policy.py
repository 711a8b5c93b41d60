"""The port's elastic policy (``anomod_torch.serve.policy`` and the
engine's policy half) against the JAX package's, on the CPU.

At ``tests/test_serve_policy.py``'s scenario (6 tenants, 4 services, 24
ticks, seed 5, a 6x surge over ticks 6-11, ``auto`` between 1 and 2
shards, cooldown 3): the port's scaling events and canonical journal
equal the JAX engine's, and its states, alerts and report (outside the
variant and policy fields) equal the port's static run (tolerance 0:
byte equal); a rerun and a replay from the flight header scale on the
same schedule.  A scripted schedule (skipped edges journaled), a
scripted rebalance, the brownout ladder's climb and relax, the policy's
decisions on one synthetic signal stream and ``plan_rebalance`` each
equal the JAX package's; RCA
evidence migrates with its tenant (verdicts equal the static run's); an
elastic run under a crash on the scaled-up shard recovers with no score
gap; the knobs, the script grammar and the serve CLI's checks give the
JAX package's results and messages.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import canonical_ticks
from anomod_torch.serve.engine import (POLICY_REPORT_FIELDS,
                                       RECOVERY_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeReport,
                                       run_power_law)

#: ``tests/test_serve_policy.py``'s scenario
KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
          overload=0.6, duration_s=24, tick_s=1.0, seed=5,
          window_s=5.0, baseline_windows=4, fault_tenants=0,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, flight_digest_every=4)
SURGE = "surge@6:factor=6:ticks=6"
ELASTIC = dict(shards=1, chaos=SURGE, policy="auto", min_shards=1,
               max_shards=2, cooldown_ticks=3)
SCRIPT = dict(shards=1, policy="script",
              policy_script="up@5;up@8;down@14;down@17", min_shards=1,
              max_shards=2)
BROWNOUT = dict(shards=1, policy="script",
                policy_script="brownout@4:level=1;brownout@8:level=2;"
                              "brownout@16:level=0",
                min_shards=1, max_shards=2)


def _port(**kw):
    return run_power_law(**{**KW, "device": "cpu", **kw})


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


def scaling_events(eng):
    return [ev for t in eng.flight_recorder.records()
            for ev in t.get("scaling", ())]


def _fingerprint(eng):
    out = {}
    for tid in sorted(eng._tenant_replay):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg).tobytes(),
                    np.asarray(st.hist).tobytes())
    return out


def _decisions(rep, skip=()):
    drop = set(VARIANT_REPORT_FIELDS) | set(skip) | {"device"}
    return {k: v for k, v in rep.to_dict().items() if k not in drop}


def _jax_decisions(jrep, skip=()):
    port_fields = {f.name for f in dataclasses.fields(ServeReport)}
    drop = set(VARIANT_REPORT_FIELDS) | set(skip) | {"device"}
    return {k: v for k, v in jrep.to_dict().items()
            if k in port_fields and k not in drop}


@pytest.fixture(scope="module")
def static():
    return _port(shards=1, chaos=SURGE)


@pytest.fixture(scope="module")
def elastic():
    return _port(**ELASTIC)


@pytest.fixture(scope="module")
def jax_elastic():
    eng, rep = jrun_power_law(**ELASTIC, **KW)
    return (scaling_events(eng), rep,
            _journal(jcanonical_ticks(eng.flight_recorder.records())))


def assert_no_score_gap(static, eng, rep, skip=()):
    s_eng, s_rep = static
    assert _fingerprint(eng) == _fingerprint(s_eng)
    skip = tuple(POLICY_REPORT_FIELDS) + tuple(skip)
    assert _decisions(rep, skip) == _decisions(s_rep, skip)
    assert eng.flight_recorder.canonical_bytes() \
        == s_eng.flight_recorder.canonical_bytes()


def test_elastic_run_equals_jax_and_the_static_run(static, elastic,
                                                   jax_elastic):
    eng, rep = elastic
    j_events, jrep, j_journal = jax_elastic
    assert rep.policy == "auto" and rep.peak_shards == 2 and rep.shards == 1
    assert rep.n_scale_ups >= 1 and rep.n_scale_downs >= 1
    assert rep.n_policy_migrations >= 2
    events = scaling_events(eng)
    kinds = [ev["kind"] for ev in events]
    assert kinds.index("scale_up") < kinds.index("scale_down")
    assert events == j_events
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == j_journal
    assert _decisions(rep) == _jax_decisions(jrep)
    assert rep.n_checkpoints == jrep.n_checkpoints
    assert_no_score_gap(static, eng, rep)


def test_elastic_schedule_on_rerun_and_header_replay(elastic):
    eng, _ = elastic
    events = scaling_events(eng)
    rerun, _ = _port(**ELASTIC)
    run = dict(eng.flight_recorder.header["run"])
    assert run["policy"] == "auto" and run["max_shards"] == 2
    assert run["cooldown_ticks"] == 3 and run["async_commit"] is False
    run["buckets"] = tuple(run["buckets"])
    run["lane_buckets"] = tuple(run["lane_buckets"])
    replay, _ = run_power_law(device="cpu", **run)
    for other in (rerun, replay):
        assert scaling_events(other) == events
        assert other.flight_recorder.canonical_bytes() \
            == eng.flight_recorder.canonical_bytes()


@pytest.mark.parametrize("leg", ["script", "rebalance", "brownout"])
def test_scripted_policies_equal_jax(leg):
    kw = {"script": SCRIPT, "brownout": BROWNOUT,
          "rebalance": dict(shards=1, chaos=SURGE, policy="script",
                            policy_script="up@4;rebalance@10:k=2;down@16",
                            min_shards=1, max_shards=2)}[leg]
    jeng, jrep = jrun_power_law(**kw, **KW)
    eng, rep = _port(**kw)
    assert scaling_events(eng) == scaling_events(jeng)
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))
    assert _decisions(rep) == _jax_decisions(jrep)
    if leg == "script":
        events = scaling_events(eng)
        assert [(ev["kind"], ev["tick"]) for ev in events] == \
            [("scale_up", 5), ("scale_up", 8), ("scale_down", 14),
             ("scale_down", 17)]
        assert events[1]["skipped"].startswith("at max_shards")
        assert events[3]["skipped"].startswith("at min_shards")
        assert rep.n_scale_ups == 1 and rep.n_scale_downs == 1
    if leg == "brownout":
        assert rep.brownout_ticks == 12
        # level 2 coarsened the digest cadence 4 -> 16 over ticks 8-15:
        # the tick-11 digest is skipped, tick 15's still taken
        digests = {t["tick"]: t["fold"]["state_digest"]
                   for t in eng.flight_recorder.records()}
        assert digests[11] is None and digests[15] is not None
        assert digests[19] is not None


def test_policy_decisions_on_one_signal_stream_equal_jax():
    """Both ElasticPolicy classes fed the same synthetic canonical
    signals (a ramp up, a plateau past the ceiling, a fall) decide the
    same actions tick by tick and end on the same EWMAs and counters."""
    from anomod.serve.policy import ElasticPolicy as JPolicy
    from anomod.serve.policy import TickSignals as JSignals
    from anomod_torch.serve.policy import ElasticPolicy, TickSignals
    rng = np.random.default_rng(4)
    pols = [ElasticPolicy("auto", 1, 3, 1.2, 2),
            JPolicy("auto", 1, 3, 1.2, 2)]
    shards = [1, 1]
    for tick in range(60):
        level = 0.1 if tick < 10 else (0.95 if tick < 35 else 0.01)
        served = {int(t): int(n) for t, n in
                  enumerate(rng.integers(0, 400, 8))}
        chunks = [int(c) for c in rng.integers(0, 20, shards[0])]
        sig = dict(tick=tick, served_by_tenant=served,
                   per_shard_chunks=chunks,
                   backlog_spans=int(level * 1000), max_backlog=1000,
                   shed_delta=int(level * 300), budget_spans=1000.0)
        got = []
        for i, (pol, cls) in enumerate(zip(pols, (TickSignals, JSignals))):
            pol.observe(cls(**sig))
            ds = pol.decide(tick, shards[i])
            for d in ds:
                if d["action"] in ("up", "down"):
                    shards[i] += 1 if d["action"] == "up" else -1
                    pol.note_executed(d["action"], tick, migrated=2,
                                      shards=shards[i])
                elif d["action"] == "brownout":
                    pol.note_executed("brownout", tick, level=d["level"])
                else:
                    pol.note_noop(tick)
            got.append(ds)
        assert got[0] == got[1], tick
    a, b = pols
    assert (a.n_scale_ups, a.n_scale_downs, a.brownout_ticks,
            a.brownout_level, a.pressure_ewma, a.rate_ewma, a.chunk_ewma) \
        == (b.n_scale_ups, b.n_scale_downs, b.brownout_ticks,
            b.brownout_level, b.pressure_ewma, b.rate_ewma, b.chunk_ewma)
    assert a.n_scale_ups > 0 and a.n_scale_downs > 0 and a.brownout_ticks


def test_plan_rebalance_equals_jax():
    from anomod.serve.policy import plan_rebalance as jplan
    from anomod.serve.queues import TenantSpec as JSpec
    from anomod_torch.serve.policy import plan_rebalance
    from anomod_torch.serve.queues import TenantSpec
    specs = [TenantSpec(t, f"t{t}", priority=1, rate_spans_per_s=10.0)
             for t in range(6)]
    jspecs = [JSpec(t, f"t{t}", priority=1, rate_spans_per_s=10.0)
              for t in range(6)]
    shard_of = {0: 0, 1: 0, 2: 0, 3: 0, 4: 1, 5: 1}
    rates = {0: 500.0, 1: 20.0, 2: 20.0, 3: 20.0, 4: 10.0, 5: 10.0}
    assert plan_rebalance(shard_of, 2, specs, rates, 1e4, k=1) == [(0, 1)]
    flat = {t: t % 2 for t in range(6)}
    even = {t: 10.0 for t in range(6)}
    assert plan_rebalance(flat, 2, specs, even, 1e4, k=2) == []
    shard3 = {0: 0, 1: 0, 2: 0, 3: 0, 4: 2, 5: 2}
    moves3 = plan_rebalance(shard3, 3, specs, rates, 1e4, k=1, dead=(1,))
    assert moves3 and all(dst != 1 for _, dst in moves3)
    rng = np.random.default_rng(9)
    for _ in range(20):
        n = int(rng.integers(2, 5))
        placed = {t: int(rng.integers(0, n)) for t in range(6)}
        live = {t: float(rng.lognormal(3, 1.5)) for t in range(6)}
        k = int(rng.integers(1, 4))
        dead = tuple(int(x) for x in rng.choice(n, int(rng.integers(0, 2)),
                                                replace=False))
        assert plan_rebalance(placed, n, specs, live, 300.0, k, dead) \
            == jplan(placed, n, jspecs, live, 300.0, k, dead)


def test_rca_evidence_migrates_with_tenants():
    """An elastic RCA run carries each tenant's evidence to its new
    shard: the verdict stream equals the static RCA run's."""
    from anomod_torch.serve.engine import power_law_traffic
    from anomod_torch.serve.rca import OnlineRCA, RcaRunner
    kw = dict(fault_tenants=1, window_s=2.0, rca=True)
    e_s, _ = _port(shards=1, **kw)
    eng, rep = _port(shards=1, policy="script", policy_script="up@5;down@15",
                     min_shards=1, max_shards=2, **kw)
    assert rep.n_scale_ups == 1 and rep.n_scale_downs == 1
    assert e_s.rca_verdicts
    assert [v.to_dict() for v in eng.rca_verdicts] \
        == [v.to_dict() for v in e_s.rca_verdicts]
    # the seam itself: the buffer and its high-water mark move, by
    # reference; an unbuffered tenant is a no-op
    traffic = power_law_traffic(2, 4, 500.0, 1.0, 10.0, 1, 1.2, 2.0, 4, 0)
    src, dst = (OnlineRCA(traffic.services, 2_000_000, 0,
                          RcaRunner(device="cpu")) for _ in range(2))
    batch = traffic.arrivals(0.0, 1.0)[0][1]
    src.buffer(3, batch)
    held = list(src._buf[3]), src._buf_hi[3]
    src.move_tenant_evidence(dst, 3)
    src.move_tenant_evidence(dst, 4)
    assert 3 not in src._buf and 3 not in src._buf_hi
    assert dst._buf[3] == held[0] and dst._buf_hi[3] == held[1]
    assert 4 not in dst._buf


def test_elastic_with_crash_chaos_recovers_clean(static):
    """A crash on the scaled-up shard one tick after the scale-up
    recovers through supervision with no score gap."""
    eng, rep = _port(**{**ELASTIC,
                        "chaos": SURGE + ";crash@9:shard=1:phase=dispatch"},
                     ckpt_every=4)
    assert rep.n_scale_ups >= 1
    assert rep.n_shard_crashes >= 1 and rep.n_respawns >= 1
    assert_no_score_gap(static, eng, rep,
                        skip=("ckpt_every",) + RECOVERY_REPORT_FIELDS)


def test_policy_knobs_and_grammar_equal_jax(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod.config import validate_policy_script as jvalidate
    from anomod_torch.config import Config, validate_policy_script
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    from anomod_torch.serve.queues import TenantSpec
    for var, bad in (("ANOMOD_SERVE_POLICY", "sometimes"),
                     ("ANOMOD_SERVE_POLICY_SCRIPT", "warp@5"),
                     ("ANOMOD_SERVE_POLICY_MIN_SHARDS", "0"),
                     ("ANOMOD_SERVE_POLICY_MAX_SHARDS", "-2"),
                     ("ANOMOD_SERVE_POLICY_MAX_SHARDS", "lots"),
                     ("ANOMOD_SERVE_POLICY_TARGET_IMBALANCE", "0.5"),
                     ("ANOMOD_SERVE_POLICY_TARGET_IMBALANCE", "wide"),
                     ("ANOMOD_SERVE_POLICY_COOLDOWN_TICKS", "0")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)
    got, want = Config(), JConfig()
    names = ("serve_policy", "serve_policy_script", "serve_policy_min_shards",
             "serve_policy_max_shards", "serve_policy_target_imbalance",
             "serve_policy_cooldown_ticks")
    assert [getattr(got, n) for n in names] \
        == [getattr(want, n) for n in names] == ["off", "", 1, 8, 1.5, 8]
    good = "up@3;rebalance@7:k=2;down@9;brownout@11:level=2"
    assert validate_policy_script(good) == jvalidate(good)
    for bad in ("up", "up@x", "up@-1", "up@5:k=2", "rebalance@5:k=0",
                "brownout@5:level=9", "sideways@5", "rebalance@5:k"):
        with pytest.raises(ValueError) as got:
            validate_policy_script(bad)
        with pytest.raises(ValueError) as want:
            jvalidate(bad)
        assert str(got.value) == str(want.value)
    specs = [TenantSpec(0, "t0", rate_spans_per_s=10.0)]
    cfg = ReplayConfig(n_services=2, n_windows=8, window_us=1_000_000,
                       chunk_size=64)
    with pytest.raises(ValueError, match="envelope"):
        ServeEngine(specs, ["a", "b"], cfg, device="cpu", shards=1,
                    policy="auto", min_shards=2, max_shards=4)
    with pytest.raises(ValueError, match="non-empty"):
        ServeEngine(specs, ["a", "b"], cfg, device="cpu", policy="script")
    with pytest.raises(ValueError, match="off|auto|script"):
        ServeEngine(specs, ["a", "b"], cfg, device="cpu", policy="maybe")
    eng = ServeEngine(specs, ["a", "b"], cfg, device="cpu", policy="auto")
    assert eng._use_workers and eng.shard_of == {0: 0}


@pytest.mark.parametrize("argv,msg", [
    (["--policy-script", "up@3"], "applies to --policy script"),
    (["--policy", "script", "--policy-script", "warp@3"], "--policy-script"),
    (["--min-shards", "2"], "applies to an elastic policy"),
    (["--policy", "auto", "--max-shards", "0"], "--max-shards must be >= 1"),
    (["--async-commit", "--no-async-commit"], "contradicts"),
    (["--policy", "auto", "--max-shards", "2", "--chaos",
      "crash@3:shard=2"], "could never fire"),
])
def test_serve_cli_policy_and_async_checks(argv, msg):
    from anomod_torch.cli import main
    err = io.StringIO()
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(err):
        main(["serve", "--device", "cpu", "--tenants", "2",
              "--duration", "1"] + argv)
    assert e.value.code == 2 and msg in err.getvalue()


def test_serve_cli_elastic_run():
    from anomod_torch.cli import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["serve", "--device", "cpu", "--tenants", "6",
                     "--services", "4", "--capacity", "1000",
                     "--overload", "0.6", "--duration", "24", "--seed", "5",
                     "--policy", "script", "--policy-script",
                     "up@4;down@12", "--max-shards", "2"]) == 0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["policy"] == "script" and rep["peak_shards"] == 2
    assert rep["n_scale_ups"] == 1 and rep["n_scale_downs"] == 1
