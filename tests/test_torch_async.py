"""The port's deferred-commit tick (``async_commit``,
``ANOMOD_SERVE_ASYNC_COMMIT``) against the JAX package's, on the CPU.

At ``tests/test_serve_async.py``'s scenario (6 tenants, 4 services, 20
ticks, seed 5, 2 shards at pipeline 2, checkpoints every 4 ticks, flight
on): the deferred run's canonical journal equals the synchronous port
run's and the JAX deferred run's byte for byte, its states, alerts and
report equal the synchronous run's (outside the variant fields and the
mode and its tick count); a rerun and a replay from the header give the
same bytes; the chaos phases fire in the synchronous order keyed on the
origin tick, and faults at issue, at the barrier and at every phase
recover to the fault-free journal; elastic episodes landing mid-deferral
scale on the synchronous schedule (and the JAX engine's); the unfused
path defers its tail only; the knob's tokens and messages, the report
fields and the engine's refusals are the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import canonical_ticks
from anomod_torch.serve.engine import (ASYNC_REPORT_FIELDS,
                                       RECOVERY_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, ServeReport,
                                       run_power_law)

#: ``tests/test_serve_async.py``'s scenario
KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
          overload=2.0, duration_s=20, tick_s=1.0, seed=5,
          window_s=2.0, baseline_windows=4, fault_tenants=1,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, flight_digest_every=4, ckpt_every=4, flight=True)
#: its elastic scenario: sub-capacity load and a 6x surge
EL_KW = dict(KW, overload=0.6, duration_s=24, window_s=5.0,
             fault_tenants=0, ckpt_every=32)
EL_POLICY = dict(shards=1, chaos="surge@6:factor=6:ticks=6", policy="auto",
                 min_shards=1, max_shards=2, cooldown_ticks=5)
ALL_PHASES = ("crash@6:shard=0:phase=dispatch;"
              "except@9:shard=1:phase=score;"
              "except@15:shard=1:phase=commit;"
              "crash@17:shard=0:phase=stage;"
              "stall@10:shard=0:ms=1")


def _port(**kw):
    return run_power_law(**{**KW, "device": "cpu", **kw})


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


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


def scaling_events(eng):
    return [ev for t in eng.flight_recorder.records()
            for ev in t.get("scaling", ())]


@pytest.fixture(scope="module")
def sync_ref():
    return _port(shards=2, pipeline=2, async_commit=False)


@pytest.fixture(scope="module")
def async_run():
    return _port(shards=2, pipeline=2, async_commit=True)


def assert_async_parity(sync_ref, eng, rep, skip=()):
    s_eng, s_rep = sync_ref
    assert _fingerprint(eng) == _fingerprint(s_eng)
    skip = tuple(ASYNC_REPORT_FIELDS) + tuple(skip)
    assert _decisions(rep, skip) == _decisions(s_rep, skip)
    assert eng.flight_recorder.canonical_bytes() \
        == s_eng.flight_recorder.canonical_bytes()


def test_deferred_run_equals_sync_and_jax(sync_ref, async_run):
    eng, rep = async_run
    jeng, jrep = jrun_power_law(shards=2, pipeline=2, async_commit=True,
                                **KW)
    assert rep.async_commit and not sync_ref[1].async_commit
    assert rep.async_ticks == jrep.async_ticks == rep.ticks
    assert sync_ref[1].async_ticks == 0
    assert rep.commit_defer_wall_s > 0.0
    assert_async_parity(sync_ref, eng, rep)
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))
    port_fields = {f.name for f in dataclasses.fields(ServeReport)}
    assert _decisions(rep) == {k: v for k, v in _decisions(jrep).items()
                               if k in port_fields}
    h = eng.flight_recorder.header
    assert h["engine"]["async_commit"] is True
    assert h["run"]["async_commit"] is True


def test_deferred_rerun_and_header_replay(async_run):
    eng, _ = async_run
    rerun, _ = _port(shards=2, pipeline=2, async_commit=True)
    run = dict(eng.flight_recorder.header["run"])
    run["buckets"] = tuple(run["buckets"])
    run["lane_buckets"] = tuple(run["lane_buckets"])
    replay, _ = run_power_law(device="cpu", **run)
    for other in (rerun, replay):
        assert other.flight_recorder.canonical_bytes() \
            == eng.flight_recorder.canonical_bytes()


@pytest.mark.parametrize("shards,pipeline", [(1, 2), (2, 1)])
def test_deferred_equals_sync_at_other_shapes(sync_ref, shards, pipeline):
    """The inline 1-shard engine and depth 1 defer too, and equal the
    2-shard synchronous run (states and decisions do not depend on the
    shard count, the depth or the deferral)."""
    eng, rep = _port(shards=shards, pipeline=pipeline, async_commit=True)
    assert rep.async_ticks == rep.ticks
    assert_async_parity(sync_ref, eng, rep)


def test_unfused_deferred_equals_unfused_sync():
    """Without fusion there is no issue/commit seam: the tick scores in
    place and only its tail (RCA, journal, policy) waits for the next
    barrier; decisions and journal are the synchronous run's."""
    ref = _port(shards=1, fuse=False)
    eng, rep = _port(shards=1, fuse=False, async_commit=True)
    assert rep.async_ticks == rep.ticks and rep.commit_defer_wall_s == 0.0
    assert_async_parity(ref, eng, rep)


def test_chaos_hooks_fire_on_the_origin_tick_across_the_deferral(
        monkeypatch):
    """Each scored tick's hooks fire in the synchronous order, keyed on
    that tick: ``stage`` and ``dispatch`` at issue, ``fold``, ``score``
    and ``commit`` at the next barrier.  The deferred run's (phase, tick,
    shard) hits equal the synchronous run's."""
    from anomod_torch.serve import chaos as chaos_mod
    hits = {}
    real = chaos_mod.ServeChaos.hit

    def hit(self, phase, tick, shard):
        hits.setdefault(self._mode, []).append((tick, shard, phase))
        return real(self, phase, tick, shard)
    monkeypatch.setattr(chaos_mod.ServeChaos, "hit", hit)
    for mode in (False, True):
        chaos = chaos_mod.ServeChaos("stall@6:shard=0:ms=1")
        chaos._mode = mode
        _port(shards=1, chaos=chaos, async_commit=mode)
    assert hits[True] and sorted(hits[True]) == sorted(hits[False])
    by_tick = {}
    for tick, _, phase in hits[True]:
        by_tick.setdefault(tick, []).append(phase)
    assert all(seq == ["stage", "dispatch", "fold", "score", "commit"]
               for seq in by_tick.values()), by_tick


@pytest.mark.parametrize("script,crashes", [
    ("crash@6:shard=0:phase=dispatch", 1),
    ("except@9:shard=1:phase=commit", 1),
    (ALL_PHASES, 4)], ids=["issue", "barrier", "every-phase"])
def test_chaos_under_deferral_recovers_with_no_score_gap(sync_ref, script,
                                                         crashes):
    eng, rep = _port(shards=2, pipeline=2, chaos=script, async_commit=True)
    assert rep.n_shard_crashes == crashes and rep.n_restored_ticks >= 1
    assert_async_parity(sync_ref, eng, rep, skip=RECOVERY_REPORT_FIELDS)


def test_elastic_episodes_mid_deferral_are_deterministic():
    e_sync, _ = _port(async_commit=False, **{**EL_KW, **EL_POLICY})
    e_async, rep = _port(async_commit=True, **{**EL_KW, **EL_POLICY})
    jeng, _ = jrun_power_law(async_commit=True, **{**EL_KW, **EL_POLICY})
    events = scaling_events(e_async)
    kinds = [ev["kind"] for ev in events]
    assert "scale_up" in kinds and "scale_down" in kinds
    assert events == scaling_events(e_sync) == scaling_events(jeng)
    assert e_async.flight_recorder.canonical_bytes() \
        == e_sync.flight_recorder.canonical_bytes()
    assert _journal(canonical_ticks(e_async.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))
    assert rep.async_ticks == rep.ticks and rep.peak_shards == 2


def test_async_knob_tokens_and_messages_equal_jax(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    monkeypatch.delenv("ANOMOD_SERVE_ASYNC_COMMIT", raising=False)
    assert Config().serve_async_commit is JConfig().serve_async_commit \
        is False
    for tok, want in (("1", True), ("on", True), ("true", True),
                      ("YES", True), ("0", False), ("off", False),
                      ("false", False), ("no", False)):
        monkeypatch.setenv("ANOMOD_SERVE_ASYNC_COMMIT", tok)
        assert Config().serve_async_commit is JConfig().serve_async_commit \
            is want
    for bad in ("treu", "2", "banana", "async"):
        monkeypatch.setenv("ANOMOD_SERVE_ASYNC_COMMIT", bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        assert "ANOMOD_SERVE_ASYNC_COMMIT" in str(got.value)


def test_report_fields_and_env_sourced_deferral(monkeypatch, sync_ref):
    from anomod_torch.config import Config, set_config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    d = sync_ref[1].to_dict()
    assert d["async_commit"] is False and d["async_ticks"] == 0
    assert "commit_defer_wall_s" in VARIANT_REPORT_FIELDS
    assert not set(ASYNC_REPORT_FIELDS) & set(VARIANT_REPORT_FIELDS)
    monkeypatch.setenv("ANOMOD_SERVE_ASYNC_COMMIT", "1")
    prev = set_config(Config())
    try:
        cfg = ReplayConfig(n_services=1)
        assert ServeEngine([], ["a"], cfg, device="cpu").async_commit
        assert not ServeEngine([], ["a"], cfg, device="cpu",
                               async_commit=False).async_commit
    finally:
        set_config(prev)
