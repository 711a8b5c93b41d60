"""The port's perf observatory (``anomod_torch.obs.perf``, the batcher's
lifecycle stamps and the engine's perf plane) against the JAX package's,
on the CPU.

The pure functions (the analyzer, the bubble fractions, the barrier fold,
rounding, the bootstrap, capture diffing and history, the Chrome export)
give the JAX functions' outputs on the same seeded inputs (tolerance 0:
equal values).  At ``tests/test_perf.py``'s run (6 tenants, 4 services,
20 ticks, seed 5, pipeline 2): recording on leaves every decision, the
report's decision fields and the canonical journal byte-identical to
recording off; with perf and census on the canonical journal and the
``(tick, shard, width, lanes)`` sequence of the events equal the JAX
engine's; the timeline reconciles with the port's own leg walls to float
rounding.  Two thread shards tag their events and trace lanes by shard,
the deferred commit stamps its ``deferred`` leg, process workers refuse an
explicit perf request with the JAX engine's words, and ``perf record`` /
``diff`` / ``history`` run through the port's CLI.
"""

import json

import numpy as np
import pytest
import torch

import anomod.obs.perf as jperf
import anomod_torch.obs.perf as pperf
from anomod.obs.flight import canonical_ticks as jcanonical_ticks
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.obs.flight import canonical_ticks
from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law

#: ``tests/test_perf.py``'s run
RUN_KW = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
              overload=2.0, duration_s=20, tick_s=1.0, seed=5,
              window_s=5.0, baseline_windows=4, fault_tenants=1,
              buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
              n_windows=16, shards=1, pipeline=2)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the plain lane
    fold's ``index_add_`` piles every padding row onto one segment, and
    under torch's thread pool (and the suite's parallel workers) those
    adds contend, a hundredfold slower on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    return run_power_law(**{**RUN_KW, "device": "cpu", **kw})


def _journal(ticks) -> str:
    return json.dumps(ticks, sort_keys=True)


@pytest.fixture(scope="module")
def perf_pair():
    eng_off, rep_off = _run()
    eng_on, rep_on = _run(perf=True)
    return eng_off, rep_off, eng_on, rep_on


@pytest.fixture(scope="module")
def both_on():
    """The port and the JAX engine with perf and the census on."""
    kw = dict(perf=True, census=True, census_every=4)
    return _run(**kw), jrun_power_law(**RUN_KW, **kw)


def _events(seed: int, n: int = 40):
    """Seeded synthetic lifecycle events over a few ticks, shards and
    scratch slots, some waits zero and some stages longer than waits."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for i in range(n):
        stage, disp, wait = rng.exponential(1e-3, 3)
        if rng.random() < 0.2:
            wait = 0.0
        rec = {"seq": i, "tick": int(i // 10), "shard": int(rng.integers(2)),
               "width": int(rng.choice([64, 256])),
               "lanes": int(rng.choice([1, 2])), "slot": int(rng.integers(2)),
               "staged_t0": t, "staged": t + stage,
               "submitted_t0": t + stage, "submitted": t + stage + disp,
               "retire_t0": t + stage + disp + 1e-4,
               "materialized": t + stage + disp + 1e-4 + wait,
               "folded": t + stage + disp + 2e-4 + wait,
               "refill": None, "deferred_t0": None, "deferred": None}
        if rng.random() < 0.3:
            rec["deferred_t0"], rec["deferred"] = t, t + wait
        out.append(rec)
        t = rec["folded"]
    return out


# ---------------------------------------------------------------------------
# the pure functions == the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_analyze_events_equals_jax(seed, pipeline):
    evs = _events(seed)
    got = pperf.analyze_events(evs, pipeline)
    assert got == jperf.analyze_events(evs, pipeline)
    assert 0.0 <= got["headroom_s"] <= got["wait_s"] + 1e-12


@pytest.mark.parametrize("args", [(0.3, 0.1, 0.5, 2.0), (0.0, 0.0, 0.0, 0.0),
                                  (2.0, 1.5, 1.0, 3.0), (0.2, 0.3, 0.1, -1.0)])
def test_bubble_fractions_equal_jax(args):
    assert pperf.bubble_fractions(*args) == jperf.bubble_fractions(*args)


def test_fold_round_and_recorder_equal_jax():
    evs = _events(3)
    parts = [evs[1::2], evs[::2]]
    assert pperf.fold_perf_records(parts) == jperf.fold_perf_records(parts)
    assert pperf.round_events(evs, 4) == jperf.round_events(evs, 4)
    assert pperf.EVENT_FIELDS == jperf.EVENT_FIELDS
    assert pperf.PERF_FORMAT == jperf.PERF_FORMAT
    recs = (pperf.PerfRecorder(1), jperf.PerfRecorder(1))
    for r in recs:
        r.tick = 4
        for k, key in enumerate(((64, 1, 0), (64, 1, 1), (256, 2, 0))):
            t = float(k)
            r.note_refill(key, t)
            r.note_staged(key, t, t + 0.1)
            r.note_submitted(key, t + 0.1, t + 0.2)
            r.note_deferred(key, t + 0.2, t + 0.3)
            r.note_deferred(key, t + 0.5, t + 0.6)   # kept: first stamp
        r.note_retire((64, 1, 0), 3.0)
        r.note_materialized((64, 1, 0), 3.1)
        r.note_folded((64, 1, 0), 3.2)
        r.note_aborted((64, 1, 1))
        r.note_aborted((9, 9, 9))                    # unknown: not counted
        r.note_staged((64, 1, 0), 4.0, 4.1)
        r.note_refill((64, 1, 0), 4.0)
    assert recs[0].drain() == recs[1].drain()
    assert recs[0].n_aborted == recs[1].n_aborted == 1
    assert recs[0].drain() == [] and recs[0]._open == recs[1]._open


def test_perf_tracer_chrome_equals_jax():
    evs = _events(4)
    got = pperf.perf_tracer(evs).to_chrome()
    assert got == jperf.perf_tracer(evs).to_chrome()
    lanes = {}
    for e in got:
        a = e["args"]
        lanes.setdefault((a["shard"], a["width"], a["lanes"], a["slot"]),
                         set()).add(e["tid"])
    # one Perfetto lane a (shard, scratch slot), grouped by shard
    assert all(len(t) == 1 for t in lanes.values())
    assert len({next(iter(t)) for t in lanes.values()}) == len(lanes)
    assert all(next(iter(t)) // 1000 == int(k[0])
               for k, t in lanes.items())


@pytest.mark.parametrize("seed", [0, 7])
def test_bootstrap_ratio_ci_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a = list(rng.normal(1.0, 0.1, 12))
    b = list(rng.normal(1.3, 0.2, 9))
    assert pperf.bootstrap_ratio_ci(a, b) == jperf.bootstrap_ratio_ci(a, b)
    assert pperf.bootstrap_ratio_ci(a, b, seed=3) \
        == jperf.bootstrap_ratio_ci(a, b, seed=3)


def _capture(walls, **extra):
    """A bench-capture-shaped document (``tests/test_perf.py``'s shape)."""
    return {"metric": "serve_spans_per_sec", "value": 1000.0,
            "timestamp_utc": "2026-01-01T00:00:00Z", "git_sha": "abc",
            "shed_fraction": 0.25, "p99_admission_to_scored_latency_s": 1.5,
            "parity": {"fused_equals_sequential": True},
            "perf": {"raw_wall_s": list(walls),
                     "overlap_headroom_s": 0.01, "overhead_fraction": 0.02},
            **extra}


_WALLS = [0.05, 0.06, 0.055, 0.052, 0.058] * 4


def _doctored(case):
    cap = _capture(_WALLS)
    if case == "slow":
        cap["perf"]["raw_wall_s"] = [2 * w for w in _WALLS]
    elif case == "drift":
        cap["shed_fraction"] = 0.99
    elif case == "gap":
        cap = {"metric": "x", "perf": {"raw_wall_s": [0.05] * 10}}
    return cap


@pytest.mark.parametrize("case,status", [
    ("same", "ok"), ("slow", "wall-regression"), ("drift", "decision-drift"),
    ("gap", "decision-coverage-gap")])
def test_diff_captures_equals_jax(case, status):
    a, b = _capture(_WALLS), _doctored(case)
    got = pperf.diff_captures(a, b, noise_floor=0.35)
    assert got == jperf.diff_captures(a, b, noise_floor=0.35)
    assert got["status"] == status
    if case == "slow":
        assert got["regressions"][0]["path"] == "perf.raw_wall_s"
    if case == "drift":
        # a decision drift is never noise, even with the walls equal
        assert got["decision_mismatches"][0]["path"] == "shed_fraction"
    if case == "gap":
        assert got["decisions"]["identical"] is None


def test_capture_history_equals_jax(tmp_path):
    for i, walls in enumerate((_WALLS, [2 * w for w in _WALLS])):
        cap = _capture(walls)
        cap["timestamp_utc"] = f"2026-01-0{i + 1}T00:00:00Z"
        (tmp_path / f"run{i}.json").write_text(json.dumps(cap))
    (tmp_path / "junk.json").write_text("{not json")
    (tmp_path / "other.json").write_text(json.dumps({"no": "metric"}))
    rows = pperf.capture_history(tmp_path)
    assert rows == jperf.capture_history(tmp_path)
    assert [r["file"] for r in rows] == ["run0.json", "run1.json"]


# ---------------------------------------------------------------------------
# the engine's perf plane
# ---------------------------------------------------------------------------

def test_perf_on_off_decisions_byte_identical(perf_pair):
    eng_off, rep_off, eng_on, rep_on = perf_pair
    assert set(eng_off._tenant_det) == set(eng_on._tenant_det)
    for tid in eng_off._tenant_det:
        assert eng_off.alerts_for(tid) == eng_on.alerts_for(tid)
        s1 = eng_off._tenant_replay[tid].state
        s2 = eng_on._tenant_replay[tid].state
        assert np.array_equal(np.asarray(s1.agg), np.asarray(s2.agg))
        assert np.array_equal(np.asarray(s1.hist), np.asarray(s2.hist))
    skip = set(VARIANT_REPORT_FIELDS) | {"perf_enabled"}
    assert {k: v for k, v in rep_off.to_dict().items() if k not in skip} \
        == {k: v for k, v in rep_on.to_dict().items() if k not in skip}
    assert eng_off.flight_recorder.canonical_bytes() \
        == eng_on.flight_recorder.canonical_bytes()
    assert rep_on.perf_enabled and not rep_off.perf_enabled
    assert rep_on.perf_events_recorded > 0 and eng_on.perf_events_dropped == 0
    assert 0.0 <= rep_on.overlap_headroom_s <= rep_on.fold_wait_s + 1e-9
    assert rep_off.bubble_fractions == {} and rep_off.fold_wait_s == 0.0
    # every record carries the perf key; a perf-off run writes it empty
    recs = eng_on.flight_recorder.records()
    assert sum(len(r["perf"]["events"]) for r in recs) \
        == rep_on.perf_events_recorded
    assert all(r["perf"] == {"events": [], "headroom_s": 0.0, "wait_s": 0.0}
               for r in eng_off.flight_recorder.records())
    assert eng_on.flight_recorder.header["run"]["perf"] is True


def test_canonical_journal_and_event_sequence_equal_jax(both_on):
    (eng, rep), (jeng, jrep) = both_on
    assert _journal(canonical_ticks(eng.flight_recorder.records())) \
        == _journal(jcanonical_ticks(jeng.flight_recorder.records()))

    def seq(events):
        return [(e["tick"], e["shard"], e["width"], e["lanes"])
                for e in events]
    assert seq(eng.perf_events) == seq(jeng.perf_events)
    assert rep.perf_events_recorded == jrep.perf_events_recorded > 0
    # each tick's journal record carries the same events as the JAX one's
    assert [seq(r["perf"]["events"]) for r in eng.flight_recorder.records()] \
        == [seq(r["perf"]["events"]) for r in jeng.flight_recorder.records()]


def _reconciles(eng, rep):
    evs = eng.perf_events
    assert evs and all(set(pperf.EVENT_FIELDS) == set(e) for e in evs)
    disp = sum(e["submitted"] - e["submitted_t0"] for e in evs)
    fold = sum(e["folded"] - e["retire_t0"] for e in evs)
    stage = sum(e["staged"] - e["staged_t0"] for e in evs)
    wait = sum(e["materialized"] - e["retire_t0"] for e in evs)
    # the report's walls round to 4 digits: the slack is rounding only
    assert abs(disp - rep.dispatch_wall_s) <= 1e-3 + 0.01 * disp
    assert abs(fold - rep.fold_wall_s) <= 1e-3 + 0.01 * fold
    assert 0.0 < stage <= rep.stage_wall_s + 1e-3
    assert 0.0 < wait <= fold + 1e-9
    assert abs(wait - rep.fold_wait_s) < 1e-6
    for rec in eng.flight_recorder.records():
        evs_t = rec["perf"]["events"]
        if evs_t:
            fold_t = sum(e["folded"] - e["retire_t0"] for e in evs_t)
            assert abs(fold_t - rec["walls"]["fold_s"]) <= 2e-3
    for e in evs:
        assert e["staged_t0"] <= e["staged"] <= e["submitted_t0"] \
            <= e["submitted"] <= e["retire_t0"] <= e["materialized"] \
            <= e["folded"]


def test_timeline_reconciles_with_report_walls(perf_pair):
    _, _, eng_on, rep_on = perf_pair
    _reconciles(eng_on, rep_on)
    refilled = [e for e in eng_on.perf_events if e["refill"] is not None]
    assert refilled, "a multi-round run reuses scratch slots"
    assert all(e["refill"] >= e["materialized"] for e in refilled)


def test_two_shards_tag_events_and_trace_lanes(perf_pair):
    eng_off, rep_off = perf_pair[:2]
    eng, rep = _run(perf=True, shards=2)
    assert {e["shard"] for e in eng.perf_events} == {0, 1}
    _reconciles(eng, rep)
    assert eng.flight_recorder.canonical_bytes() \
        == eng_off.flight_recorder.canonical_bytes()
    events = pperf.perf_tracer(eng.perf_events).to_chrome()
    by_lane = {}
    for e in events:
        by_lane.setdefault(e["tid"], set()).add(e["args"]["shard"])
    assert all(len(v) == 1 for v in by_lane.values())
    assert {next(iter(v)) for v in by_lane.values()} == {"0", "1"}


def test_deferred_commit_stamps_its_leg(perf_pair):
    eng_off = perf_pair[0]
    eng, rep = _run(perf=True, async_commit=True)
    deferred = [e for e in eng.perf_events if e["deferred"] is not None]
    assert deferred and rep.commit_defer_wall_s > 0.0
    assert all(e["deferred_t0"] <= e["deferred"] for e in deferred)
    stats = pperf.analyze_events(eng.perf_events, eng.pipeline)
    assert stats["commit_defer_s"] > 0.0
    _reconciles(eng, rep)
    assert eng.flight_recorder.canonical_bytes() \
        == eng_off.flight_recorder.canonical_bytes()


def test_process_workers_refuse_an_explicit_perf_request(monkeypatch):
    from anomod.serve.engine import ServeEngine as JServeEngine
    from anomod_torch.config import Config, get_config, set_config
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    from anomod_torch.serve.traffic import PowerLawTraffic
    tr = PowerLawTraffic(n_tenants=4, total_rate_spans_per_s=100,
                         n_services=4)
    cfg = serve_plane_cfg(4, 5.0, 16)
    with pytest.raises(ValueError) as port_err:
        ServeEngine(tr.specs, tr.services, cfg, device="cpu", shards=2,
                    worker="process", perf=True)
    with pytest.raises(ValueError) as jax_err:
        JServeEngine(tr.specs, tr.services, cfg, shards=2,
                     worker="process", perf=True)
    assert str(port_err.value) == str(jax_err.value)
    assert "the perf observatory rides the runners in-process" \
        in str(port_err.value)
    # an env-sourced process request degrades to threads beside it
    monkeypatch.setenv("ANOMOD_SERVE_WORKER", "process")
    monkeypatch.setenv("ANOMOD_PERF", "1")
    old = get_config()
    set_config(Config())
    try:
        eng = ServeEngine(tr.specs, tr.services, cfg, device="cpu", shards=2)
        assert eng.perf and eng.worker_mode == "thread"
        eng.close()
    finally:
        set_config(old)


def test_perf_retention_bound_counts_drops(monkeypatch):
    from anomod_torch.config import Config, get_config, set_config
    monkeypatch.setenv("ANOMOD_PERF_MAX_EVENTS", "8")
    old = get_config()
    set_config(Config())
    try:
        eng, rep = _run(perf=True, duration_s=10, flight=False)
    finally:
        set_config(old)
    assert rep.perf_events_recorded > 8 and rep.fold_wait_s > 0.0
    assert len(eng.perf_events) == 8
    assert eng.perf_events_dropped == rep.perf_events_recorded - 8
    assert eng.perf_events[-1]["tick"] >= eng.perf_events[0]["tick"]


def test_perf_cli_record_diff_history(tmp_path, capsys):
    from anomod_torch.cli import main
    from anomod_torch.utils.tracing import spans_from_chrome
    out, chrome = tmp_path / "timeline.json", tmp_path / "chrome.json"
    assert main(["perf", "record", "--device", "cpu", "--out", str(out),
                 "--chrome", str(chrome), "--tenants", "4", "--duration",
                 "8", "--tick", "1.0", "--capacity", "1000",
                 "--seed", "3"]) == 0
    doc = json.loads(out.read_text())
    assert doc["perf_format"] == 1
    assert doc["report"]["perf_events_recorded"] == len(doc["events"]) > 0
    assert len(doc["raw_wall_s"]) == 8
    assert any(s["name"] == "lane.stage"
               for s in spans_from_chrome(json.loads(chrome.read_text())))
    capsys.readouterr()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    cap = _capture(_WALLS)
    a.write_text(json.dumps(cap))
    for doctored, rc in ((cap, 0), (_doctored("slow"), 1),
                         (_doctored("drift"), 2), (_doctored("gap"), 2)):
        b.write_text(json.dumps(doctored))
        assert main(["perf", "diff", str(a), str(b)]) == rc
        capsys.readouterr()
    assert main(["perf", "history", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["n_captures"] >= 2
    for argv in (["perf", "history", str(tmp_path), "--out", "x.json"],
                 ["perf", "history", str(tmp_path), "--noise-floor", "0.2"],
                 ["perf", "diff", str(a)],
                 ["perf", "record", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            main(argv)
    capsys.readouterr()
