"""The port's flight recorder (``anomod_torch.obs.flight``) and ``audit``
against the JAX package's (``anomod/obs/flight.py``), on the CPU.

At ``tests/test_flight.py``'s run with RCA on, the port's canonical
journal equals the JAX engine's byte for byte (as ``json.dumps(...,
sort_keys=True)``) at port shards 1 and 2, pipelines 1 and 3 and host
state; a port rerun is byte-identical; the recorder moves no decision;
the pool digest equals the per-tenant walk; an injected divergence
bisects to its tick and plane; ring drops are counted; the knobs are
validated as the JAX ``Config`` validates them.
"""

import copy
import dataclasses
import json
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.obs.flight import diff_journals as jdiff_journals
from anomod.obs.flight import state_digest as jstate_digest
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import (FLIGHT_FORMAT, FLIGHT_VARIANT_KEYS,
                                     PLANES, FlightRecorder, canonical_ticks,
                                     crc32_combine, diff_journals,
                                     fold_digest_parts, load_journal,
                                     state_digest, state_digest_parts,
                                     versions)
from anomod_torch.serve.engine import (FLIGHT_REPORT_FIELDS,
                                       VARIANT_REPORT_FIELDS, run_power_law)

#: ``tests/test_flight.py``'s run: long enough past the fault onset that
#: the score and rca planes carry live digests
RUN_KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
              overload=2.0, duration_s=24, tick_s=1.0, seed=5,
              window_s=2.0, baseline_windows=4, fault_tenants=1,
              buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
              n_windows=16, flight=True, flight_digest_every=4)


def _run(**overrides):
    return run_power_law(**{**RUN_KW, "device": "cpu", "rca": True,
                            **overrides})


def _canonical(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


@pytest.fixture(scope="module")
def jax_journal():
    """The JAX engine's canonical journal (1 shard, RCA on)."""
    eng, _ = jrun_power_law(rca=True, **RUN_KW)
    return _canonical(jcanonical_ticks(eng.flight_recorder.records()))


@pytest.fixture(scope="module")
def baseline():
    return _run()


# -- the journal against the JAX engine's ----------------------------------

@pytest.mark.parametrize("overrides", [
    {}, dict(shards=2), dict(pipeline=1), dict(pipeline=3),
    dict(state="host")],
    ids=["1-shard", "2-shards", "pipeline-1", "pipeline-3", "host-state"])
def test_canonical_journal_equals_jax_engine(jax_journal, baseline,
                                             overrides):
    eng = _run(**overrides)[0] if overrides else baseline[0]
    got = _canonical(canonical_ticks(eng.flight_recorder.records()))
    assert got == jax_journal


def test_rerun_byte_identical_and_planes_live(baseline):
    eng, rep = baseline
    eng2, _ = _run()
    assert eng.flight_recorder.canonical_bytes() \
        == eng2.flight_recorder.canonical_bytes()
    assert eng.flight_recorder.n_recorded == rep.ticks + 1
    assert rep.flight_enabled and rep.flight_recorded_ticks == rep.ticks + 1
    assert rep.flight_dropped_ticks == 0
    recs = eng.flight_recorder.records()
    assert any(t["score"]["digest"] for t in recs)
    assert any(t["rca"]["digest"] for t in recs)
    assert any(t["fold"]["state_digest"] is not None for t in recs)
    assert recs[-1].get("final") is True
    assert recs[-1]["fold"]["state_digest"] is not None


def test_flight_off_is_read_side_only(baseline):
    eng, rep = baseline
    eng2, rep2 = _run(flight=False)
    assert eng2.flight_recorder is None and rep2.flight_enabled is False
    for tid in eng._tenant_det:
        assert [dataclasses.asdict(a) for a in eng.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in eng2.alerts_for(tid)]
        s1, s2 = eng._tenant_replay[tid].state, eng2._tenant_replay[tid].state
        assert np.array_equal(np.asarray(s1.agg), np.asarray(s2.agg))
        assert np.array_equal(np.asarray(s1.hist), np.asarray(s2.hist))
    skip = set(VARIANT_REPORT_FIELDS) | set(FLIGHT_REPORT_FIELDS)
    assert {k: v for k, v in rep.to_dict().items() if k not in skip} \
        == {k: v for k, v in rep2.to_dict().items() if k not in skip}


def test_variant_keys_excluded_and_shard_legs_in_order(baseline):
    eng, _ = baseline
    recs = eng.flight_recorder.records()
    assert all(set(FLIGHT_VARIANT_KEYS) <= set(r) for r in recs)
    for rec in canonical_ticks(recs):
        assert not set(FLIGHT_VARIANT_KEYS) & set(rec)
        assert set(PLANES) <= set(rec)
    eng2, _ = _run(shards=3, rca=False)
    for rec in eng2.flight_recorder.records():
        legs = rec["topology"]["shard_legs"]
        assert [leg["shard"] for leg in legs] == [0, 1, 2]
        assert sum(leg["chunks"] for leg in legs) == rec["dispatch"]["chunks"]


# -- the state digest -------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_pool_digest_equals_per_tenant_walk(baseline, shards):
    """The pooled read (one copy of the resident rows a plane and runner)
    equals the JAX package's per-tenant ``get_state`` walk over the same
    replays, and the shard fragments fold back into it."""
    eng = baseline[0] if shards == 1 else _run(shards=2)[0]
    reps = eng._tenant_replay
    assert all(r._slot is not None for r in reps.values())
    want = jstate_digest(reps)
    assert state_digest(reps) == want == state_digest(reps, 0)
    assert fold_digest_parts(state_digest_parts(reps)) == want
    # fragments from each shard apart fold to the same digest
    by_shard = {}
    for tid, rep in reps.items():
        by_shard.setdefault(eng.shard_of.get(tid, 0), {})[tid] = rep
    parts = [p for sub in by_shard.values() for p in state_digest_parts(sub)]
    assert fold_digest_parts(parts) == want
    host, _ = _run(state="host")
    assert state_digest(host._tenant_replay) == want


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=64), st.binary(max_size=64))
def test_crc32_combine_is_zlibs(a, b):
    assert crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) \
        == zlib.crc32(a + b)


# -- divergence bisection ---------------------------------------------------

def test_injected_divergence_bisects_to_tick_and_plane(baseline):
    eng, _ = baseline
    a = eng.flight_recorder.journal()
    for plane, key in (("admission", "digest"), ("score", "digest"),
                       ("rca", "digest"), ("dispatch", "chunks")):
        b = copy.deepcopy(a)
        b["ticks"][15][plane][key] = (b["ticks"][15][plane][key] or 0) + 1
        d = diff_journals(a, b)
        assert (d["tick"], d["plane"]) == (15, plane), d
        assert jdiff_journals(a, b) == d
    b = copy.deepcopy(a)
    digest_ticks = [i for i, t in enumerate(b["ticks"])
                    if t["fold"]["state_digest"] is not None]
    b["ticks"][digest_ticks[1]]["fold"]["state_digest"] ^= 0xFF
    d = diff_journals(a, b)
    assert d["plane"] == "fold"
    assert d["tick"] == b["ticks"][digest_ticks[1]]["tick"]
    # two planes in one tick: the causally earliest is named
    b = copy.deepcopy(a)
    b["ticks"][10]["score"]["digest"] += 1
    b["ticks"][10]["admission"]["digest"] += 1
    assert (diff_journals(a, b)["tick"],
            diff_journals(a, b)["plane"]) == (10, "admission")
    b = copy.deepcopy(a)
    b["ticks"] = b["ticks"][:12]
    d = diff_journals(a, b)
    assert d["plane"] == "length" and d["index"] == 12
    # walls differ between runs: never a divergence
    b = copy.deepcopy(a)
    b["ticks"][3]["walls"]["tick_s"] += 1.0
    assert diff_journals(a, b) is None


def test_another_seed_diverges_in_admission_at_tick_0(baseline):
    eng, _ = baseline
    eng2, _ = _run(seed=6)
    d = diff_journals(eng.flight_recorder.journal(),
                      eng2.flight_recorder.journal())
    assert (d["tick"], d["plane"]) == (0, "admission")


# -- the ring, the knobs, the header ----------------------------------------

def test_ring_drops_are_counted():
    eng, rep = _run(flight_max_ticks=4, rca=False)
    fr = eng.flight_recorder
    assert len(fr.records()) == 4
    assert fr.n_recorded == rep.ticks + 1
    assert rep.flight_dropped_ticks == fr.n_dropped == fr.n_recorded - 4 > 0
    assert fr.records()[-1].get("final") is True
    with pytest.raises(ValueError):
        FlightRecorder({}, max_ticks=0)
    with pytest.raises(ValueError):
        FlightRecorder({}, digest_every=0)


def test_flight_knobs_validated_as_jax_does(monkeypatch):
    from anomod.config import Config as JConfig
    from anomod_torch.config import Config
    monkeypatch.setenv("ANOMOD_FLIGHT", "0")
    monkeypatch.setenv("ANOMOD_FLIGHT_DIGEST_EVERY", "32")
    monkeypatch.setenv("ANOMOD_FLIGHT_MAX_TICKS", "128")
    cfg = Config()
    assert (cfg.flight, cfg.flight_digest_every, cfg.flight_max_ticks,
            cfg.flight_dump_dir) == (False, 32, 128, None)
    monkeypatch.setenv("ANOMOD_FLIGHT_DUMP_DIR", "/tmp/fd")
    assert Config().flight_dump_dir == JConfig().flight_dump_dir \
        == Path("/tmp/fd")
    for var in ("ANOMOD_FLIGHT", "ANOMOD_FLIGHT_DIGEST_EVERY",
                "ANOMOD_FLIGHT_MAX_TICKS", "ANOMOD_FLIGHT_DUMP_DIR"):
        monkeypatch.delenv(var)
    cfg, jcfg = Config(), JConfig()
    for f in ("flight", "flight_digest_every", "flight_max_ticks",
              "flight_dump_dir"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for var, bad in (("ANOMOD_FLIGHT_DIGEST_EVERY", "0"),
                     ("ANOMOD_FLIGHT_DIGEST_EVERY", "banana"),
                     ("ANOMOD_FLIGHT_MAX_TICKS", "-1"),
                     ("ANOMOD_FLIGHT_MAX_TICKS", "many")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as got:
            Config()
        with pytest.raises(ValueError) as want:
            JConfig()
        assert str(got.value) == str(want.value)
        monkeypatch.delenv(var)


def test_header_is_self_describing(baseline):
    eng, _ = baseline
    h = eng.flight_recorder.header
    assert h["flight_format"] == FLIGHT_FORMAT
    assert h["digest_every"] == 4
    assert h["engine"]["n_tenants"] == RUN_KW["n_tenants"]
    assert h["engine"]["device"] == "cpu" and h["engine"]["shards"] == 1
    assert h["config"]["flight_digest_every"] >= 1
    run = h["run"]
    assert run["seed"] == RUN_KW["seed"]
    assert run["buckets"] == list(RUN_KW["buckets"])
    assert run["lane_buckets"] == list(RUN_KW["lane_buckets"])
    assert run["max_backlog"] == RUN_KW["max_backlog"]
    assert run["fuse"] is True and run["rca"] is True
    assert run["shards"] == 1 and run["pipeline"] >= 1
    assert run["state"] == "device" and run["fold"] == "sparse"
    json.dumps(h)


def test_versions_name_torch_and_the_device_not_jax():
    v = versions("cpu")
    assert "jax" not in v and "jaxlib" not in v
    assert {"python", "torch", "cuda", "numpy", "device"} <= set(v)
    assert v["device"] == "cpu"


# -- dump, bundle, audit, endpoint --------------------------------------------

def test_dump_atomic_and_loadable(tmp_path, baseline):
    eng, _ = baseline
    path = tmp_path / "flight.json"
    path.write_text('{"stale": true}')
    doc = eng.flight_recorder.dump(path)
    assert list(tmp_path.glob("*.tmp")) == []
    loaded = load_journal(path)
    assert loaded["n_recorded"] == doc["n_recorded"]
    assert diff_journals(loaded, eng.flight_recorder.journal()) is None
    other = tmp_path / "other.json"
    other.write_text('{"ticks": "lol"}')
    with pytest.raises(ValueError):
        load_journal(other)


def test_audit_cli_record_replay_diff(tmp_path, capsys):
    from anomod_torch.cli import main
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    common = ["--tenants", "6", "--services", "4", "--duration", "20",
              "--capacity", "1000", "--seed", "5", "--tick", "1.0",
              "--window-seconds", "2.0", "--baseline-windows", "4",
              "--digest-every", "4", "--device", "cpu"]
    assert main(["audit", "record", "--out", a] + common) == 0
    assert main(["audit", "replay", a, "--out", b, "--shards", "2",
                 "--device", "cpu"]) == 0
    assert main(["audit", "diff", a, b]) == 0
    doc = load_journal(b)
    assert doc["header"]["engine"]["shards"] == 2
    doc["ticks"][7]["admission"]["digest"] ^= 1
    c = tmp_path / "c.json"
    c.write_text(json.dumps(doc))
    capsys.readouterr()
    assert main(["audit", "diff", a, str(c)]) == 1
    out = capsys.readouterr()
    got = json.loads(out.out)["divergence"]
    assert (got["tick"], got["plane"]) == (7, "admission")
    assert "tick 7 in the admission plane" in out.err
    # record flags are refused where the run comes from the header
    with pytest.raises(SystemExit):
        main(["audit", "replay", a, "--out", b, "--seed", "3"])
    with pytest.raises(SystemExit):
        main(["audit", "diff", a, b, "--shards", "2"])


def test_forensic_bundle_on_alert(tmp_path, monkeypatch):
    from anomod_torch.config import Config, set_config
    from anomod_torch.obs.registry import (Registry, get_registry,
                                           set_registry)
    monkeypatch.setenv("ANOMOD_FLIGHT_DUMP_DIR", str(tmp_path / "dumps"))
    reg = Registry(enabled=True)
    prev_reg = get_registry()
    set_registry(reg)
    prev_cfg = set_config(Config())
    try:
        _, rep = _run(rca=False)
    finally:
        set_config(prev_cfg)
        set_registry(prev_reg)
    assert rep.n_alerts > 0
    dumps = sorted((tmp_path / "dumps").glob("flight_forensic_*.json"))
    assert len(dumps) == 1
    assert not list((tmp_path / "dumps").glob("*.tmp"))
    doc = json.loads(dumps[0].read_text())
    assert doc["bundle"] == "anomod-flight-forensic"
    assert "alert" in doc["reason"]
    assert doc["flight"]["ticks"] and doc["registry"]["snapshot"]
    assert doc["trace"]["data"][0]["spans"]
    assert reg.counter("anomod_flight_dumps_total").value == 1
    assert reg.counter("anomod_flight_ticks_total").value \
        == rep.flight_recorded_ticks


def test_http_flight_serves_the_recorder(baseline):
    from anomod_torch.obs.http import ObsHttpServer
    eng, _ = baseline
    with ObsHttpServer(port=0) as srv:
        srv.attach(engine=eng)
        with urllib.request.urlopen(srv.url + "/flight", timeout=10) as r:
            doc = json.loads(r.read())
    fr = eng.flight_recorder
    assert doc["flight_format"] == FLIGHT_FORMAT
    assert (doc["n_recorded"], doc["n_dropped"]) == (fr.n_recorded, 0)
    assert doc["ticks"] == json.loads(json.dumps(fr.records()))
    with ObsHttpServer(port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/flight", timeout=10)
        assert e.value.code == 404
