"""The port's state tiering (``anomod_torch.serve.tiering``, the census
tracker of ``anomod_torch.obs.census`` and the engine's tiering half)
against the JAX package's, on the CPU.

At ``tests/test_serve_tiering.py``'s scenario (24 tenants, 4 services,
24 ticks at 0.4x load, seed 7; hot capacity 4, demotion after 2 idle
ticks, a 4096-byte warm budget, prefetch 2, a temporary cold directory):
the tiered run's states (``state_digest``), alerts and report (outside
the tiering and variant fields) equal the never-evicted port run's
(tolerance 0: byte equal), its four counters (9 each) and its canonical
journal and tiering events equal the JAX engine's, and a same-config
rerun's equal the first; a kill between a cold entry's tmp write and its
rename leaves the warm entry intact and the run equal; each miss defers
its tenant exactly one tick; tiering composes with the migration seam;
the tier store's round trips, the census tracker's demotion order, the
knobs and the engine's refusals are the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import canonical_ticks, state_digest
from anomod_torch.serve.engine import (TIERING_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeEngine,
                                       run_power_law)

#: ``tests/test_serve_tiering.py``'s scenario and tier geometry
KW = dict(n_tenants=24, n_services=4, capacity_spans_per_s=400,
          overload=0.4, duration_s=24, tick_s=1.0, seed=7,
          window_s=5.0, baseline_windows=2, fault_tenants=0,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, flight_digest_every=4)
TIER_KW = dict(tier_hot=4, tier_demote_after=2, tier_warm_bytes=4096,
               tier_prefetch=2)


def _port(**kw):
    return run_power_law(**{**KW, "device": "cpu", **kw})


def _tiered(cold_dir, **kw):
    return _port(**TIER_KW, tier_cold_dir=str(cold_dir), **kw)


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


def tier_events(eng):
    return [ev for rec in eng.flight_recorder.records()
            for ev in rec["tiering"]]


def _counters(rep):
    return [getattr(rep, k) for k in TIERING_REPORT_FIELDS]


@pytest.fixture(scope="module")
def oracle():
    return _port()


@pytest.fixture(scope="module")
def tiered(tmp_path_factory):
    cold = tmp_path_factory.mktemp("cold")
    return _tiered(cold) + (cold,)


def assert_tier_parity(oracle, eng, rep):
    ref_eng, ref_rep = oracle
    assert sorted(eng._tenant_det) == sorted(ref_eng._tenant_det)
    for tid in sorted(ref_eng._tenant_det):
        assert [dataclasses.asdict(a) for a in eng.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in ref_eng.alerts_for(tid)], tid
    assert state_digest(eng._tenant_replay) \
        == state_digest(ref_eng._tenant_replay)
    skip = set(VARIANT_REPORT_FIELDS) | set(TIERING_REPORT_FIELDS) \
        | {"dispatches_by_width", "device"}
    a = {k: v for k, v in ref_rep.to_dict().items() if k not in skip}
    b = {k: v for k, v in rep.to_dict().items() if k not in skip}
    assert a == b, sorted(k for k in a if a[k] != b[k])


def test_tiered_run_equals_never_evicted_and_jax(oracle, tiered, tmp_path):
    eng, rep, cold = tiered
    jeng, jrep = jrun_power_law(**KW, **TIER_KW,
                                tier_cold_dir=str(tmp_path / "jax"))
    assert _counters(rep) == _counters(jrep) == [4, 9, 9, 9, 9]
    assert len(eng._tier) == 0 and not eng._tier_parked
    assert list(cold.rglob("*.npc"))
    assert_tier_parity(oracle, eng, rep)
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))
    assert tier_events(eng) == [ev for rec in jeng.flight_recorder.records()
                                for ev in rec["tiering"]]
    h = eng.flight_recorder.header
    assert h["engine"]["tier_hot"] == 4 and h["run"]["tier_hot"] == 4
    assert h["run"]["tier_cold_dir"] == str(cold)


def test_tier_events_reconcile_and_rerun_is_equal(tiered, tmp_path):
    eng, rep, _ = tiered
    again, rep2 = _tiered(tmp_path / "again")
    events = tier_events(eng)
    by = {}
    for ev in events:
        by.setdefault((ev["kind"], ev.get("tier")), []).append(ev)
    assert len(by[("demote", "warm")]) == rep.n_tier_demotions_warm
    assert len(by[("demote", "cold")]) == rep.n_tier_demotions_cold
    assert len(by.get(("promote", "warm"), [])) \
        + len(by.get(("promote", "cold"), [])) == rep.n_tier_promotions
    assert len(by[("miss", None)]) == rep.n_tier_misses
    assert canonical_ticks(eng.flight_recorder.records()) \
        == canonical_ticks(again.flight_recorder.records())
    assert tier_events(again) == events
    assert _counters(rep2) == _counters(rep)


def test_each_miss_defers_exactly_one_tick(tiered):
    eng, rep, _ = tiered
    events = tier_events(eng)
    deferred = [ev for ev in events
                if ev["kind"] == "promote" and ev["deferred"]]
    misses = {(ev["tenant"], ev["tick"]) for ev in events
              if ev["kind"] == "miss"}
    assert rep.n_tier_misses == len(deferred) == len(misses) > 0
    assert {(ev["tenant"], ev["tick"] - 1) for ev in deferred} == misses


def test_cold_tier_crash_between_tmp_write_and_rename(oracle, tmp_path,
                                                      monkeypatch):
    import anomod_torch.io.cache as io_cache
    real = io_cache.os.replace
    killed = {"n": 0}

    def killing_replace(src, dst):
        if str(dst).endswith(".npc") and killed["n"] == 0:
            killed["n"] += 1
            raise OSError("simulated kill between tmp write and rename")
        return real(src, dst)
    monkeypatch.setattr(io_cache.os, "replace", killing_replace)
    cold = tmp_path / "cold"
    eng, rep = _tiered(cold)
    assert killed["n"] == 1
    assert list(cold.rglob("*.tmp"))
    published = list(cold.rglob("*.npc"))
    assert published
    for p in published:
        io_cache._read_payload(p.read_bytes())
    assert rep.n_tier_demotions_cold > 0 and len(eng._tier) == 0
    assert_tier_parity(oracle, eng, rep)


def test_tiering_composes_with_the_migration_seam(oracle, tmp_path):
    """A 2-shard supervised tiered run whose shard 0 dies past its
    respawn budget migrates its tenants, demoted ones included, and
    equals the never-evicted 1-shard run."""
    ref_eng, ref_rep = oracle
    eng, rep = _tiered(
        tmp_path / "cold", shards=2, pipeline=2, ckpt_every=4, retries=2,
        max_respawns=1,
        chaos=";".join(f"crash@{t}:shard=0:phase=stage:repeat=-1"
                       for t in range(10, 24)))
    assert rep.n_migrated_tenants > 0
    assert min(_counters(rep)[1:4]) > 0 and len(eng._tier) == 0
    for tid in sorted(ref_eng._tenant_det):
        assert [dataclasses.asdict(a) for a in eng.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in ref_eng.alerts_for(tid)]
    assert state_digest(eng._tenant_replay) \
        == state_digest(ref_eng._tenant_replay)
    assert (rep.latency, rep.shed_fraction, rep.served_spans) \
        == (ref_rep.latency, ref_rep.shed_fraction, ref_rep.served_spans)


def test_tier_store_round_trips_and_checkpoint_hooks(tmp_path):
    """Warm and cold entries give back the demoted snapshot bit for bit
    (a cold one through the prefetch lane or a plain read), the byte
    book follows the entries, and the checkpoint hooks name a warm
    snapshot by reference and a cold one by its content address."""
    from anomod_torch.replay import ReplayState
    from anomod_torch.serve.tiering import TierPlane
    rng = np.random.default_rng(3)

    def snap():
        return {"state": ReplayState(agg=rng.random((8, 6), np.float32),
                                     hist=rng.random((8, 16), np.float32)),
                "t0_us": 5, "window_offset": 2, "n_spans": 40}
    slot = 8 * 22 * 4
    tier = TierPlane(slot, tmp_path, 2, slot_nbytes=slot)
    a, b = snap(), snap()
    tier.demote(3, 1, a, "det1", 2)
    assert tier.status(1) == "warm" and tier.ckpt_snap(1) is a
    tier.demote(4, 2, b, None, 3)           # over budget: tenant 1 spills
    assert (tier.status(1), tier.status(2)) == ("cold", "warm")
    key = tier.ckpt_snap(1)["__tier_cold__"]
    assert tier.ckpt_det(1) == "det1"
    assert tier.warm_state_bytes == slot
    assert np.array_equal(tier.load_cold(key)["state"].agg, a["state"].agg)
    shim = tier.state_shim(1)
    assert shim.window_offset == 2 and shim.n_spans == 40
    assert np.array_equal(shim.get_state().hist, a["state"].hist)
    tier.prefetch(1)
    back, det = tier.take(5, 1, deferred=True)
    assert det == "det1" and back["n_spans"] == 40
    for x, y in zip(back["state"], a["state"]):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert tier.promotions == 1
    back, _ = tier.take(5, 2)
    assert back is b and tier.warm_state_bytes == 0 and len(tier) == 0
    tier.demote(6, 9, snap(), None, 1)
    tier.discard(9)
    assert len(tier) == 0 and tier.warm_state_bytes == 0
    assert [e["kind"] for e in tier.drain_events()] == \
        ["demote", "demote", "demote", "promote", "promote", "demote"]
    tier.close()


def test_census_tracker_order_equals_jax():
    from anomod.obs.census import CensusTracker as JTracker
    from anomod_torch.obs.census import CensusTracker

    class Batch:
        def __init__(self, tid, n):
            self.tenant_id, self.n_spans = tid, n
    rng = np.random.default_rng(5)
    a, b = CensusTracker(), JTracker((4, 16), 3, 1)
    for tick in range(40):
        served = [Batch(int(t), int(n)) for t, n in
                  zip(rng.integers(0, 30, 6), rng.integers(1, 500, 6))]
        a.observe(tick, served)
        b.observe(tick, served)
        resident = sorted(set(int(x) for x in rng.integers(0, 30, 12)))
        assert a.coldest_candidates(tick, resident) \
            == b.coldest_candidates(tick, resident)
        assert [a.ewma_at(t, tick) for t in resident] \
            == [b.ewma_at(t, tick) for t in resident]


def test_tier_knobs_and_refusals_equal_jax(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod.serve.engine import ServeEngine as JEngine
    from anomod_torch.config import Config, set_config
    from anomod_torch.replay import ReplayConfig
    for var, bad in (("ANOMOD_SERVE_TIER_HOT", "-1"),
                     ("ANOMOD_SERVE_TIER_HOT", "lots"),
                     ("ANOMOD_SERVE_TIER_DEMOTE_AFTER", "0"),
                     ("ANOMOD_SERVE_TIER_DEMOTE_AFTER", "soon"),
                     ("ANOMOD_SERVE_TIER_WARM_BYTES", "-4096"),
                     ("ANOMOD_SERVE_TIER_PREFETCH", "0"),
                     ("ANOMOD_SERVE_TIER_PREFETCH", "many")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)
    got, want = Config(), JConfig()
    names = ("serve_tier_hot", "serve_tier_demote_after",
             "serve_tier_warm_bytes", "serve_tier_cold_dir",
             "serve_tier_prefetch")
    assert [getattr(got, n) for n in names] \
        == [getattr(want, n) for n in names]
    cfg = ReplayConfig(n_services=1)
    for kw in (dict(tier_hot=-1), dict(tier_hot=4, tier_demote_after=0),
               dict(tier_hot=4, tier_prefetch=0),
               dict(tier_hot=4, async_commit=True)):
        with pytest.raises(ValueError) as got:
            ServeEngine([], ["a"], cfg, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            JEngine([], ["a"], cfg, **kw)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("ANOMOD_SERVE_TIER_HOT", "4")
    prev = set_config(Config())
    try:
        eng = ServeEngine([], ["a"], cfg, device="cpu", async_commit=True)
        assert eng.tier_hot == 0 and eng._tier is None
        eng = ServeEngine([], ["a"], cfg, device="cpu")
        assert eng.tier_hot == 4 and eng._census_tracker is not None
        eng.close()
    finally:
        set_config(prev)
