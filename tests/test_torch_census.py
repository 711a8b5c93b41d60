"""The port's fleet census (``anomod_torch.obs.census``, the engine's
census plane, the tier plane's and the spec table's byte prices) against
the JAX package's, on the CPU.

At ``tests/test_census.py``'s run (5 tenants, 4 services, 20 ticks, seed
9, census every 4 ticks): census on leaves every decision and the
canonical journal byte-identical to census off; the ``census`` stream
equals the JAX engine's byte for byte on every plane but ``scratch``, and
its hot-set documents are equal.  The scratch plane holds each package's
own pinned lane scratch: 28 B a lane row in both (the JAX runner's seven
4-byte staged columns, the port's ``sid`` int32 and six f32 planes), over
the (width, lanes, slot) keys each runner has filled, so the difference
is 28 x (sum of width x lanes over the JAX keys - over the port's keys),
derived here from the two runners' key sets.  The stream is byte-equal
across reruns and through ``audit replay``; the hot-set document is
equal across 1 and 2 shards.  The fleet probe at (50, 200, 800)
registered, 20 hot, 4 ticks gives the JAX package's bytes on every plane
but ``scratch`` and its 34.0 B a registered tenant.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import anomod.obs.census as jcensus
import anomod_torch.obs.census as pcensus
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law

#: ``tests/test_census.py``'s run
KW = dict(n_tenants=5, n_services=4, capacity_spans_per_s=1000,
          overload=2.0, duration_s=20, tick_s=1.0, seed=9,
          window_s=2.0, baseline_windows=4, fault_tenants=2,
          buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=1500,
          n_windows=16, shards=1, pipeline=2)

#: bytes a lane row of pinned scratch in either package
SCRATCH_ROW_BYTES = 28


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
    return run_power_law(**{**KW, "device": "cpu", **kw})


def _census_docs(eng):
    return [rec["census"] for rec in eng.flight_recorder.records()
            if rec["census"]["planes"]]


def _census_stream(eng) -> str:
    return json.dumps(_census_docs(eng), sort_keys=True,
                      separators=(",", ":"))


@pytest.fixture(scope="module")
def census_pair():
    eng_off, rep_off = _run()
    eng_on, rep_on = _run(census=True, census_every=4)
    return eng_off, rep_off, eng_on, rep_on


@pytest.fixture(scope="module")
def jax_on():
    return jrun_power_law(census=True, census_every=4, **KW)


def test_census_read_side_byte_parity(census_pair):
    eng_off, rep_off, eng_on, rep_on = census_pair
    assert rep_on.n_alerts > 0
    assert rep_on.census_enabled and not rep_off.census_enabled
    for tid in eng_off._tenant_det:
        assert [dataclasses.asdict(a) for a in eng_off.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in eng_on.alerts_for(tid)]
        s1 = eng_off._tenant_replay[tid].state
        s2 = eng_on._tenant_replay[tid].state
        assert np.array_equal(np.asarray(s1.agg), np.asarray(s2.agg))
        assert np.array_equal(np.asarray(s1.hist), np.asarray(s2.hist))
    skip = set(VARIANT_REPORT_FIELDS) | {"census_enabled", "census_ticks",
                                         "census_hot_set"}
    assert {k: v for k, v in rep_off.to_dict().items() if k not in skip} \
        == {k: v for k, v in rep_on.to_dict().items() if k not in skip}
    assert eng_off.flight_recorder.canonical_bytes() \
        == eng_on.flight_recorder.canonical_bytes()
    assert (rep_off.census_ticks, rep_off.census_hot_set,
            rep_off.census_resident_bytes) == (0, {}, {})
    assert all(r["census"] == {"planes": [], "hot": {}}
               for r in eng_off.flight_recorder.records())


def _scratch_row_sum(keys) -> int:
    return sum(w * lanes for w, lanes, _ in keys)


def test_census_stream_equals_jax_but_scratch(census_pair, jax_on):
    _, _, eng, rep = census_pair
    jeng, jrep = jax_on
    docs, jdocs = _census_docs(eng), _census_docs(jeng)
    assert len(docs) == len(jdocs) == rep.census_ticks == jrep.census_ticks
    assert rep.census_hot_set == jrep.census_hot_set
    for d, j in zip(docs, jdocs):
        assert (d["tick"], d["hot"], d["pool_reconciled"]) \
            == (j["tick"], j["hot"], j["pool_reconciled"])
        assert [p for p in d["planes"] if p["plane"] != "scratch"] \
            == [p for p in j["planes"] if p["plane"] != "scratch"]
        sc = [p for p in d["planes"] if p["plane"] == "scratch"]
        jsc = [p for p in j["planes"] if p["plane"] == "scratch"]
        assert d["total_bytes"] - j["total_bytes"] \
            == sc[0]["bytes"] - jsc[0]["bytes"]
        assert sc[0]["bytes"] % SCRATCH_ROW_BYTES == 0
    # the last census (the run-end settlement) against the final key sets
    port_keys = list(eng.runner._scratch)
    jax_keys = list(jeng.runner._lane_scratch)
    sc = [p for p in docs[-1]["planes"] if p["plane"] == "scratch"][0]
    jsc = [p for p in jdocs[-1]["planes"] if p["plane"] == "scratch"][0]
    assert jsc["bytes"] - sc["bytes"] == SCRATCH_ROW_BYTES * (
        _scratch_row_sum(jax_keys) - _scratch_row_sum(port_keys))
    # two buffers a port slot against the JAX runner's seven columns
    assert (sc["buffers"], jsc["buffers"]) \
        == (2 * len(port_keys), 7 * len(jax_keys))
    assert rep.census_resident_bytes["by_plane"].keys() \
        == jrep.census_resident_bytes["by_plane"].keys()


def test_census_stream_byte_equal_across_reruns(census_pair):
    _, _, eng_on, _ = census_pair
    eng2, _ = _run(census=True, census_every=4)
    assert _census_stream(eng_on) == _census_stream(eng2)


def test_census_hot_set_invariant_across_shards(census_pair):
    _, _, eng_on, rep_on = census_pair
    eng2, rep2 = _run(census=True, census_every=4, shards=2)
    assert rep2.census_hot_set == rep_on.census_hot_set
    assert rep2.census_ticks == rep_on.census_ticks
    doc = _census_docs(eng2)[-1]
    assert {p["shard"] for p in doc["planes"] if p["plane"] == "pool"} \
        == {0, 1}
    a = {k: v for k, v in rep_on.to_dict().items()
         if k not in VARIANT_REPORT_FIELDS}
    b = {k: v for k, v in rep2.to_dict().items()
         if k not in VARIANT_REPORT_FIELDS}
    assert a == b


def test_census_planes_schema_and_reconciliation(census_pair):
    _, _, eng_on, rep_on = census_pair
    docs = _census_docs(eng_on)
    last = docs[-1]
    order = [(p["shard"], p["plane"]) for p in last["planes"]]
    assert order == sorted(order)
    assert {p["plane"] for p in last["planes"]} \
        == set(pcensus.CENSUS_PLANES) - {"rca", "tier"}
    assert pcensus.CENSUS_PLANES == jcensus.CENSUS_PLANES
    assert last["pool_reconciled"] is True
    assert last["total_bytes"] == sum(p["bytes"] for p in last["planes"])
    pool = [p for p in last["planes"] if p["plane"] == "pool"][0]
    assert pool["mode"] == "device"
    assert pool["bytes"] == (pool["capacity"] + 1) * pool["slot_bytes"]
    assert pool["slot_bytes"] == pcensus.pool_slot_nbytes(eng_on.cfg) \
        == jcensus.pool_slot_nbytes(eng_on.cfg)
    assert 0 < pool["slots_used"] <= pool["capacity"]
    rb = rep_on.census_resident_bytes
    assert rb["total"] == last["total_bytes"] and rb["pool_reconciled"]
    assert rb["peak_total"] >= rb["total"]
    ticks = [c["last_served_tick"] for c in rep_on.census_hot_set["coldest"]]
    assert ticks == sorted(ticks)


def test_census_audit_replay_byte_equal():
    eng, _ = _run(census=True, census_every=4, duration_s=12.0)
    run = dict(eng.flight_recorder.header["run"])
    assert run["census"] is True and run["census_every"] == 4
    run["buckets"] = tuple(run["buckets"])
    run["lane_buckets"] = tuple(run["lane_buckets"])
    eng2, _ = run_power_law(device="cpu", **run)
    assert _census_stream(eng) == _census_stream(eng2)


def test_census_gauges_flow_through_the_scrape():
    from anomod_torch import obs
    from anomod_torch.obs.registry import Registry
    old = obs.get_registry()
    reg = Registry()
    obs.set_registry(reg)
    try:
        _run(census=True, census_every=4, duration_s=8)
    finally:
        obs.set_registry(old)
    names = {sample[1] for sample in reg.journal()}
    want = {"anomod_census_resident_bytes", "anomod_census_pool_bytes",
            "anomod_census_scratch_bytes", "anomod_census_admission_bytes",
            "anomod_census_slo_bytes", "anomod_census_rca_bytes",
            "anomod_census_recorder_bytes",
            "anomod_census_registered_tenants",
            "anomod_census_resident_tenants", "anomod_census_hot_tenants",
            "anomod_census_slot_occupancy_fraction"}
    assert want <= names
    assert "anomod_census_ticks_total" in names


def test_process_workers_refuse_an_explicit_census():
    from anomod.serve.engine import ServeEngine as JServeEngine
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    from anomod_torch.serve.traffic import PowerLawTraffic
    tr = PowerLawTraffic(n_tenants=4, total_rate_spans_per_s=100,
                         n_services=4)
    cfg = serve_plane_cfg(4, 5.0, 16)
    with pytest.raises(ValueError) as port_err:
        ServeEngine(tr.specs, tr.services, cfg, device="cpu", shards=2,
                    worker="process", census=True)
    with pytest.raises(ValueError) as jax_err:
        JServeEngine(tr.specs, tr.services, cfg, shards=2,
                     worker="process", census=True)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="census_every"):
        ServeEngine(tr.specs, tr.services, cfg, device="cpu", census=True,
                    census_every=0)


# ---------------------------------------------------------------------------
# byte prices and estimators == the JAX package's
# ---------------------------------------------------------------------------

def test_span_batch_nbytes_equals_jax():
    from anomod import labels as jlabels
    from anomod import synth as jsynth
    from anomod_torch import labels, synth
    pb = synth.generate_spans(labels.ALL_LABELS[0], n_traces=5)
    jb = jsynth.generate_spans(jlabels.ALL_LABELS[0], n_traces=5)
    want = sum(arr.nbytes for arr in (
        pb.trace, pb.parent, pb.service, pb.endpoint, pb.start_us,
        pb.duration_us, pb.is_error, pb.status, pb.kind))
    assert pcensus.span_batch_nbytes(pb) == jcensus.span_batch_nbytes(jb) \
        == want == pb.n_spans * 36


def test_plane_nbytes_reads_shapes_only():
    import torch
    t = torch.empty((3, 5, 7), dtype=torch.float32)
    a = np.empty((3, 5, 7), np.int16)
    assert pcensus.plane_nbytes(t) == t.numel() * t.element_size() == 420
    assert pcensus.plane_nbytes(a) == jcensus.plane_nbytes(a) == a.nbytes
    got = pcensus.process_resident_bytes()
    assert got is None or got > 0


@pytest.mark.parametrize("ids", ["dense", "sparse"])
def test_spec_table_nbytes_equals_jax(ids):
    from anomod.serve.queues import AdmissionController as JAdmission
    from anomod.serve.queues import TenantSpec as JSpec
    from anomod_torch.serve.queues import AdmissionController, TenantSpec
    tids = range(40) if ids == "dense" else range(7, 400, 10)
    specs = [TenantSpec(tenant_id=t, name=f"t{t}", priority=t % 3,
                        rate_spans_per_s=float(t)) for t in tids]
    jspecs = [JSpec(tenant_id=t, name=f"t{t}", priority=t % 3,
                    rate_spans_per_s=float(t)) for t in tids]
    got = AdmissionController(specs, drain_engine="heap").spec_table_nbytes()
    assert got == JAdmission(jspecs, drain_engine="off").spec_table_nbytes()
    if ids == "dense":
        assert got == 34 * len(specs)


def test_tier_plane_members_equal_jax(tmp_path):
    from anomod.serve.tiering import TierPlane as JTierPlane
    from anomod_torch.replay import ReplayState
    from anomod_torch.serve.tiering import TierPlane
    rng = np.random.default_rng(2)
    slot = 8 * 22 * 4
    port = TierPlane(slot, tmp_path / "p", 2, slot_nbytes=slot,
                     hot_capacity=3, demote_after=2)
    jax = JTierPlane(3, 2, slot, tmp_path / "j", 2, slot)
    for tier in (port, jax):
        assert (tier.hot_capacity, tier.demote_after) == (3, 2)
    for tid in (1, 2, 3):
        st = ReplayState(agg=rng.random((8, 6), np.float32),
                         hist=rng.random((8, 16), np.float32))
        snap = {"state": st, "t0_us": 5, "window_offset": 2, "n_spans": 40}
        port.demote(tid, tid, snap, None, 2)
        jax.demote(tid, tid, dict(snap), None, 2)
    port.prefetch(1)
    jax.prefetch(1)
    port.take(5, 1, deferred=True)
    jax.take(5, 1, deferred=True)
    for f in ("n_warm", "n_cold", "warm_state_bytes", "prefetch_joins",
              "demotions_warm", "demotions_cold", "promotions"):
        assert getattr(port, f) == getattr(jax, f), f
    assert port.resident_nbytes() == jax.resident_nbytes() > 0
    port.close()
    jax.close()


@pytest.mark.parametrize("alpha", [0.8, 1.3])
def test_fit_zipf_and_slope_equal_jax(alpha):
    counts = [int(1e6 / r ** alpha) for r in range(1, 200)]
    got = pcensus.fit_zipf(counts)
    assert got == jcensus.fit_zipf(counts) and abs(got - alpha) < 0.05
    assert pcensus.fit_zipf([5, 3]) is jcensus.fit_zipf([5, 3]) is None
    xs = [1000, 10000, 100000]
    ys = [3e-6 * x + 0.25 for x in xs]
    assert pcensus.fit_slope(xs, ys) == jcensus.fit_slope(xs, ys)


def _capture(pool=1000, sweep_bytes=3.5, wall=2e-7, sizes=(1000, 100000),
             hot=50):
    return {"census": {
        "resident_bytes": {"total": pool + 500,
                           "by_plane": {"pool": pool, "slo": 500}},
        "sweep": {"sizes": list(sizes), "hot": hot,
                  "bytes_slope_per_registered": sweep_bytes,
                  "wall_slope_s_per_registered": wall,
                  "wall_intercept_s": 0.04}}}


@pytest.mark.parametrize("b,tol,status", [
    (_capture(), 0.35, "ok"),
    (_capture(pool=1001), 0.35, "bytes-regression"),
    (_capture(sweep_bytes=3.6), 0.35, "slope-regression"),
    (_capture(wall=2.6e-7), 0.35, "ok"),
    (_capture(wall=5e-7), 0.35, "slope-regression"),
    (_capture(wall=5e-7, sizes=(1000, 10000)), 0.35, "ok"),
    ({"metric": "x"}, None, "census-missing")])
def test_diff_census_equals_jax(b, tol, status):
    a = _capture()
    got = pcensus.diff_census(a, b, tolerance=tol)
    assert got == jcensus.diff_census(a, b, tolerance=tol)
    assert got["status"] == status


def test_fleet_probe_equals_jax_but_scratch():
    kw = dict(sizes=(50, 200, 800), hot=20, ticks=4, seed=0)
    got = pcensus.fleet_probe(device="cpu", **kw)
    want = jcensus.fleet_probe(**kw)
    assert got["sizes"] == want["sizes"] == [50, 200, 800]
    assert got["bytes_slope_per_registered"] \
        == want["bytes_slope_per_registered"] == 34.0
    diffs = set()
    for row, jrow in zip(got["rows"], want["rows"]):
        assert row["registered"] == jrow["registered"]
        assert row["hot"] == jrow["hot"] == 20
        assert row["pool_reconciled"] is jrow["pool_reconciled"] is True
        a, b = dict(row["bytes_by_plane"]), dict(jrow["bytes_by_plane"])
        sa, sb = a.pop("scratch"), b.pop("scratch")
        assert a == b
        assert row["resident_bytes"] - jrow["resident_bytes"] == sa - sb
        assert sa % SCRATCH_ROW_BYTES == 0 and sb % SCRATCH_ROW_BYTES == 0
        diffs.add(sa - sb)
    # one hot traffic set at every size: the scratch is size-independent
    assert len(diffs) == 1
    assert np.isfinite(got["wall_slope_s_per_registered"])
    with pytest.raises(ValueError):
        pcensus.fleet_probe(sizes=(50, 200), hot=10, ticks=0, device="cpu")


def test_census_cli_record_probe_diff(tmp_path, capsys):
    from anomod_torch.cli import main
    out = tmp_path / "census.json"
    assert main(["census", "record", "--device", "cpu", "--out", str(out),
                 "--tenants", "4", "--duration", "8", "--tick", "1.0",
                 "--every", "4"]) == 0
    doc = json.loads(out.read_text())
    assert doc["census_format"] == 1 and doc["engine"]["census_every"] == 4
    assert len(doc["stream"]) == doc["report"]["census_ticks"] == 3
    capsys.readouterr()
    probe = tmp_path / "probe.json"
    assert main(["census", "probe", "--device", "cpu", "--sizes", "20,40",
                 "--hot", "10", "--ticks", "2", "--out", str(probe)]) == 0
    sweep = json.loads(probe.read_text())["sweep"]
    assert sweep["sizes"] == [20, 40]
    capsys.readouterr()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_capture()))
    for doctored, rc in ((_capture(), 0), (_capture(pool=2000), 1),
                         (_capture(wall=5e-7), 1), ({"metric": "x"}, 2)):
        b.write_text(json.dumps(doctored))
        assert main(["census", "diff", str(a), str(b)]) == rc
        capsys.readouterr()
    for argv in (["census", "diff", str(a), str(b), "--sizes", "1,2"],
                 ["census", "probe", "--every", "3"],
                 ["census", "record", "--device", "cpu", "--hot", "3",
                  "--out", str(out)],
                 ["census", "record", "--device", "cpu"],
                 ["census", "probe", "--sizes", "5"]):
        with pytest.raises(SystemExit):
            main(argv)
    capsys.readouterr()
