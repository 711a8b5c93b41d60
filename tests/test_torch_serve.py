"""The port's serve plane (``anomod_torch/serve``) against the JAX
package's, on the CPU.

Admission, traffic, bucket planning and the t-digest are host code and
must be byte-identical.  The tenant pool's operations and whole serve runs
must give byte-identical states and equal alert streams and decision
fields: on the CPU the lane kernel's plain version adds each segment's
rows in row order, as the JAX scatter engine does, and every fold is one
f32 add a cell in the same order.  Within the port, fused == sequential
dispatch of the same coalesced batches, pipeline depths 1-3 and device ==
host must agree byte for byte.  Unfused runs push each batch alone where
the fused tick coalesces a tenant's batches of a tick: staging plans and
f32 sums regroup, in the JAX package as here, so an unfused run is held
to the JAX unfused run and to the fused run's admission and SLO fields.
"""

import dataclasses

import numpy as np
import pytest
import torch

from anomod.ops.tdigest import tdigest_build as jbuild
from anomod.ops.tdigest import tdigest_merge_many as jmerge
from anomod.ops.tdigest import tdigest_quantile as jquantile
from anomod.replay import ReplayConfig as JReplayConfig
from anomod.replay import ReplayState as JReplayState
from anomod.replay import TenantStatePool as JPool
from anomod.serve.batcher import split_plan as jsplit_plan
from anomod.serve.engine import run_power_law as jrun_power_law
from anomod.serve.queues import AdmissionController as JAdmission
from anomod.serve.traffic import PowerLawTraffic as JTraffic
from anomod.serve.traffic import ScriptedTraffic as JScripted
from anomod.serve.traffic import TenantFault as JFault
from anomod_torch.ops.tdigest import (tdigest_build, tdigest_merge_many,
                                      tdigest_quantile)
from anomod_torch.replay import ReplayConfig, ReplayState, TenantStatePool
from anomod_torch.schemas import concat_span_batches
from anomod_torch.serve.batcher import BucketRunner, split_plan
from anomod_torch.serve.engine import (VARIANT_REPORT_FIELDS, ServeEngine,
                                       run_power_law)
from anomod_torch.serve.queues import AdmissionController
from anomod_torch.serve.traffic import (PowerLawTraffic, ScriptedTraffic,
                                        TenantFault)
from anomod_torch.state import load_pool, load_tenant_states


def _small_serve_kw(seed=5):
    """6 tenants at 2x overload for 60 virtual seconds over an 8-window
    ring (the ring rolls), one latency fault: sheds, coalesces, lane-
    stacks and alerts."""
    return dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
                overload=2.0, duration_s=60, tick_s=1.0, seed=seed,
                window_s=5.0, baseline_windows=4, fault_tenants=1,
                buckets=(64, 256), lane_buckets=(1, 2, 4),
                max_backlog=1500, n_windows=8)


def _fingerprint(eng):
    """Per tenant: alert stream and the replay state's bytes."""
    out = {}
    for tid in sorted(set(eng._tenant_det) | set(eng._tenant_replay)):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg, np.float32).tobytes(),
                    np.asarray(st.hist, np.float32).tobytes())
    return out


def _decisions(report):
    return {k: v for k, v in dataclasses.asdict(report).items()
            if k not in VARIANT_REPORT_FIELDS and k != "device"}


# -- host planes: byte-identical ------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 63, 64, 300, 4096, 9000])
def test_split_plan_matches_jax(n):
    for buckets in ((64, 256, 1024, 4096, 16384), (128, 512)):
        assert split_plan(n, 4096, buckets) == jsplit_plan(n, 4096, buckets)


def _traffics(seed=3):
    faults = {0: (1, 10.0)}
    kw = dict(n_tenants=9, total_rate_spans_per_s=3000, alpha=1.1,
              seed=seed, n_services=5, batch_cap=128)
    return (PowerLawTraffic(faults={t: TenantFault("latency", s, 6.0, f)
                                    for t, (s, f) in faults.items()}, **kw),
            JTraffic(faults={t: JFault("latency", s, 6.0, f)
                             for t, (s, f) in faults.items()}, **kw))


def test_power_law_arrivals_byte_identical():
    tt, jt = _traffics()
    assert [dataclasses.astuple(s) for s in tt.specs] == \
        [dataclasses.astuple(s) for s in jt.specs]
    for k in range(12):
        got = tt.arrivals(k * 1.0, (k + 1) * 1.0)
        want = jt.arrivals(k * 1.0, (k + 1) * 1.0)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
                else:
                    assert x == y


def test_scripted_traffic_byte_identical():
    tt, jt = _traffics(seed=6)
    streams = {}
    for k in range(3):
        for tid, b in tt.arrivals(k * 1.0, (k + 1) * 1.0):
            streams.setdefault(tid, []).append(b)
    streams = {t: concat_span_batches(bs) for t, bs in streams.items()}
    mine = ScriptedTraffic(streams, tt.specs, t0_us=0)
    ref = JScripted(streams, jt.specs, t0_us=0)
    assert mine.end_s() == ref.end_s()
    for lo in (0.0, 0.5, 1.25, 2.0):
        got, want = mine.arrivals(lo, lo + 0.75), ref.arrivals(lo, lo + 0.75)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.start_us.tobytes() == b.start_us.tobytes()
            assert a.duration_us.tobytes() == b.duration_us.tobytes()


def test_admission_drain_order_byte_identical():
    """The heap drain and priority shedding: same served batches in the
    same order, same SFQ tags, same counters, under 2x overload."""
    tt, jt = _traffics(seed=4)
    mine = AdmissionController(tt.specs, max_backlog=2500)
    ref = JAdmission(jt.specs, max_backlog=2500, drain_engine="off")
    for k in range(25):
        now = float(k + 1)
        for (tid, a), (_, b) in zip(tt.arrivals(k, k + 1.0),
                                    jt.arrivals(k, k + 1.0)):
            assert mine.offer(tid, a, now) == ref.offer(tid, b, now)
        got = [(q.tenant_id, q.seq, q.n_spans, q.enqueued_s, q.finish_tag)
               for q in mine.drain(1500.0)]
        want = [(q.tenant_id, q.seq, q.n_spans, q.enqueued_s, q.finish_tag)
                for q in ref.drain(1500.0)]
        assert got == want
    assert dataclasses.astuple(mine.totals()) == \
        dataclasses.astuple(ref.totals())
    assert mine.totals().shed_spans > 0
    assert {p: dataclasses.astuple(c)
            for p, c in mine.per_priority().items()} == \
        {p: dataclasses.astuple(c) for p, c in ref.per_priority().items()}


@pytest.mark.parametrize("engine", ["heap", "numpy", "native"])
@pytest.mark.parametrize("jax_engine", ["off", "on"])
def test_drain_engines_match_jax_admission(engine, jax_engine):
    """Each of the port's drain engines equals the JAX controller's heap
    engine (``off``) and its native columnar engine (``on``) over the
    overload sequence above: admissions, served order, SFQ floats and
    every counter (evictions: tests/test_torch_native.py)."""
    tt, jt = _traffics(seed=4)
    mine = AdmissionController(tt.specs, max_backlog=2500,
                               drain_engine=engine)
    ref = JAdmission(jt.specs, max_backlog=2500, drain_engine=jax_engine)
    assert mine.drain_engine == engine
    assert ref.drain_engine == ("heap" if jax_engine == "off" else "native")
    for k in range(25):
        now = float(k + 1)
        for (tid, a), (_, b) in zip(tt.arrivals(k, k + 1.0),
                                    jt.arrivals(k, k + 1.0)):
            assert mine.offer(tid, a, now) == ref.offer(tid, b, now)
        got = [(q.tenant_id, q.seq, q.n_spans, q.enqueued_s, q.finish_tag)
               for q in mine.drain(1500.0)]
        want = [(q.tenant_id, q.seq, q.n_spans, q.enqueued_s, q.finish_tag)
                for q in ref.drain(1500.0)]
        assert got == want
        assert mine._vtime == ref._vtime
    assert dataclasses.astuple(mine.totals()) == \
        dataclasses.astuple(ref.totals())
    assert mine.totals().shed_spans > 0
    assert {t: dataclasses.astuple(c) for t, c in mine.counters.items()} == \
        {t: dataclasses.astuple(c) for t, c in ref.counters.items()}


@pytest.mark.parametrize("bad", ["auto", "off", "columnar", None])
def test_bad_drain_engine_raises(bad):
    tt, _ = _traffics()
    with pytest.raises(ValueError, match="drain_engine"):
        AdmissionController(tt.specs, drain_engine=bad)
    with pytest.raises(ValueError, match="drain_engine"):
        run_power_law(device="cpu", drain_engine=bad,
                      **dict(_small_serve_kw(), duration_s=1))


def test_tdigest_quantiles_equal():
    rng = np.random.default_rng(0)
    parts = [rng.lognormal(0, 1, n).astype(np.float32)
             for n in (5, 256, 300)]
    mine = [tdigest_build(p, k=32) for p in parts]
    ref = [jbuild(p, k=32) for p in parts]
    for a, b in zip(mine, ref):
        assert a.mean.tobytes() == b.mean.tobytes()
        assert a.weight.tobytes() == b.weight.tobytes()
    m, r = tdigest_merge_many(mine), jmerge(ref)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert float(tdigest_quantile(m, q)) == float(jquantile(r, q))


# -- the tenant state pool ------------------------------------------------

def _pools(P=6, seed=0):
    """The JAX numpy-engine pool and the port's, started from the same
    random planes through ``state.load_pool``."""
    jcfg = JReplayConfig(n_services=3, n_windows=5)
    cfg = ReplayConfig(n_services=3, n_windows=5)
    ref = JPool(jcfg, capacity=P, engine="numpy")
    rng = np.random.default_rng(seed)
    ref.agg[:] = rng.normal(size=ref.agg.shape).astype(np.float32)
    ref.hist[:] = rng.normal(size=ref.hist.shape).astype(np.float32)
    for _ in range(P):
        ref.acquire()
    mine = load_pool(cfg, ref.agg, ref.hist, device="cpu",
                     next_slot=ref._next, free=ref._free)
    return ref, mine, rng


def _same(mine, ref):
    assert mine.agg.numpy().tobytes() == ref.agg.tobytes()
    assert mine.hist.numpy().tobytes() == ref.hist.tobytes()


def test_pool_put_gather_round_trip_and_load():
    ref, mine, rng = _pools()
    _same(mine, ref)
    st = ReplayState(agg=rng.normal(size=(15, 6)).astype(np.float32),
                     hist=rng.normal(size=(15, 16)).astype(np.float32))
    mine.put(2, st)
    ref.put(2, JReplayState(agg=st.agg, hist=st.hist))
    _same(mine, ref)
    back = mine.gather(2)
    assert back.agg.numpy().tobytes() == st.agg.tobytes()
    mine.put(3, back)
    assert mine.gather(3).hist.numpy().tobytes() == st.hist.tobytes()
    mine.release(3)
    assert mine.acquire() == 3
    assert not mine.gather(3).agg.any() and not mine.gather(3).hist.any()
    fresh = TenantStatePool(ReplayConfig(n_services=3, n_windows=5),
                            capacity=1, device="cpu")
    slots = load_tenant_states(fresh, [st, back])
    assert slots == [1, 2] and fresh.capacity == 2
    assert fresh.gather(2).agg.numpy().tobytes() == st.agg.tobytes()


def test_pool_duplicate_slot_fold_in_lane_order():
    ref, mine, rng = _pools()
    for slots in ([3, 1, 3, 2, 3], [1, 2, 3], [4, 4], [5]):
        L = len(slots) + 1                       # one dead pad lane
        da = rng.normal(size=(L, 15, 6)).astype(np.float32) * 1e3
        dh = rng.normal(size=(L, 15, 16)).astype(np.float32)
        want = ref.agg.copy()
        for i, s in enumerate(slots):            # (state + d_i) + d_j
            want[s] = want[s] + da[i]
        ref.scatter_fold(slots, da, dh)
        mine.scatter_fold(slots, torch.from_numpy(da), torch.from_numpy(dh))
        _same(mine, ref)
        assert mine.agg.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("k", [0, 2, 5, 9])
def test_pool_roll_matches_jax_and_stream_roll(k):
    from anomod_torch.stream import roll_ring_state
    ref, mine, _ = _pools(seed=k)
    cfg = ReplayConfig(n_services=3, n_windows=5)
    before = mine.gather(4)
    ref.roll(4, k)
    mine.roll(4, k)
    _same(mine, ref)
    rolled = roll_ring_state(before, cfg, k)
    assert mine.gather(4).agg.numpy().tobytes() == \
        rolled.agg.numpy().tobytes()


def test_pool_gather_window_and_rows_match_jax():
    ref, mine, rng = _pools(P=9)
    slots = rng.integers(0, 10, 7)
    cols = rng.integers(0, 5, 7)
    assert mine.gather_window(slots, cols).tobytes() == \
        ref.gather_window(slots, cols).tobytes()
    assert mine.gather_rows(slots).tobytes() == \
        ref.gather_rows(slots).tobytes()
    with pytest.raises(IndexError):
        mine.gather_window([1], [5])


def test_runner_fill_pads_dead_rows_and_lanes():
    tt, _ = _traffics()
    batch = concat_span_batches([b for _, b in tt.arrivals(0.0, 1.0)])
    cfg = ReplayConfig(n_services=5, n_windows=8, window_us=1_000_000,
                       chunk_size=1024)
    runner = BucketRunner(cfg, buckets=(64, 256), lane_buckets=(1, 4),
                          device="cpu")
    plan = runner.stage_plan(batch, 0)
    width, cols = plan[-1]
    (sid, planes), _ = runner._fill_slot(width, 4, [cols, cols])
    m = cols["sid"].shape[0]
    assert (sid[:2, :m].numpy() == cols["sid"]).all()
    assert (sid[:2, m:] == cfg.sw).all() and (sid[2:] == cfg.sw).all()
    assert (planes[:2, 4, :m].numpy() == cols["dur"]).all()
    assert (planes[:2, 5, :m].numpy() == cols["dur"] * cols["dur"]).all()
    assert (planes[:, :, m:] == 0).all() and (planes[2:] == 0).all()


def test_abort_lanes_keeps_last_committed_states():
    """A failed tick discards its in-flight dispatches unfolded; the
    folds that had retired stay."""
    from anomod_torch.serve.batcher import PooledStreamReplay
    tt, _ = _traffics()
    cfg = ReplayConfig(n_services=5, n_windows=8, window_us=1_000_000,
                       chunk_size=256)
    runner = BucketRunner(cfg, buckets=(64, 256), lane_buckets=(1, 2),
                          pipeline=3, device="cpu")
    reps = [PooledStreamReplay(cfg, 0, runner) for _ in range(2)]
    batch = concat_span_batches([b for _, b in tt.arrivals(0.0, 1.0)])
    plans = [r.plan_push(batch)[1] for r in reps]
    runner.submit_lanes(256, [(r, p[0][1]) for r, p in zip(reps, plans)])
    runner.drain_lanes()
    committed = [r.state.agg.clone() for r in reps]
    assert all(bool(c.abs().sum() > 0) for c in committed)
    runner.submit_lanes(256, [(r, p[1][1]) for r, p in zip(reps, plans)])
    assert runner.inflight_dispatches == 1
    runner.abort_lanes()
    assert runner.inflight_dispatches == 0
    for r, c in zip(reps, committed):
        assert torch.equal(r.state.agg, c)


# -- whole serve runs -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    return {fuse: jrun_power_law(flight=False, fuse=fuse, **_small_serve_kw())
            for fuse in (True, False)}


@pytest.fixture(scope="module")
def port_run():
    return run_power_law(device="cpu", **_small_serve_kw())


#: report fields set by admission and the tick clock alone
ADMISSION_FIELDS = ("offered_spans", "admitted_spans", "served_spans",
                    "shed_spans", "shed_fraction", "served_batches",
                    "peak_backlog_spans", "latency", "per_priority")


@pytest.mark.parametrize("fuse", [True, False])
def test_serve_run_matches_jax_engine(jax_runs, port_run, fuse):
    """Fused and unfused, the port's run equals the JAX engine's: every
    decision field, and per tenant its alert stream and state bytes."""
    je, jr = jax_runs[fuse]
    te, tr = port_run if fuse else run_power_law(
        device="cpu", fuse=False, **_small_serve_kw())
    for f in ADMISSION_FIELDS + (
            "dispatches_by_width", "fused_dispatches", "lanes_by_bucket",
            "lane_pad_waste", "n_alerts", "n_tenants_alerted",
            "fault_detection"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.shed_spans > 0 and tr.n_alerts > 0
    assert (tr.fused_dispatches > 0 and max(tr.lanes_by_bucket) > 1) \
        if fuse else tr.fused_dispatches == 0
    # the port's defaults: native staging of every fused dispatch and the
    # native drain
    assert tr.native_staging and te.admission.drain_engine == "native"
    assert tr.native_staged_dispatches == tr.fused_dispatches
    if jr.native_staging:
        assert tr.native_staged_dispatches == jr.native_staged_dispatches
    assert _fingerprint(te) == _fingerprint(je)


def test_fused_equals_sequential_over_coalesced_batches():
    """THE fused parity pin: a fused run's per-tenant states and alert
    streams equal pushing every tick's coalesced batches tenant by tenant
    through one-lane dispatches (coalescing is exercised: some tick
    serves one tenant two batches)."""
    from anomod_torch.serve.engine import (power_law_traffic,
                                           replay_served_sequentially,
                                           serve_plane_cfg)
    kw = dict(_small_serve_kw(seed=2), capacity_spans_per_s=3000,
              max_backlog=4500)
    traffic = power_law_traffic(kw["n_tenants"], kw["n_services"],
                                kw["capacity_spans_per_s"], kw["overload"],
                                kw["duration_s"], kw["seed"], 1.2,
                                kw["window_s"], kw["baseline_windows"],
                                kw["fault_tenants"])
    eng = ServeEngine(traffic.specs, traffic.services,
                      serve_plane_cfg(kw["n_services"], kw["window_s"],
                                      kw["n_windows"]),
                      capacity_spans_per_s=kw["capacity_spans_per_s"],
                      buckets=kw["buckets"], lane_buckets=kw["lane_buckets"],
                      max_backlog=kw["max_backlog"], device="cpu")
    eng.runner.warm()
    eng.runner.warm_lanes()
    log = []
    for _ in range(int(kw["duration_s"])):
        lo = eng.clock.now_s
        log.append(eng.tick(traffic.arrivals(lo, lo + eng.clock.tick_s)))
    for det in eng._tenant_det.values():
        det.finish()
    assert any(len({qb.tenant_id for qb in served}) < len(served)
               for served in log)
    seq = replay_served_sequentially(eng, log)
    want = _fingerprint(eng)
    assert sorted(seq) == sorted(want)
    for tid, det in seq.items():
        st = det.replay.state
        assert ([dataclasses.asdict(a) for a in det.alerts],
                st.agg.numpy().tobytes(), st.hist.numpy().tobytes()) \
            == want[tid]
    assert sum(len(d.alerts) for d in seq.values()) > 0


@pytest.mark.parametrize("variant", [
    dict(pipeline=1), dict(pipeline=3), dict(state="host"),
    dict(native_stage=False), dict(drain_engine="heap"),
    dict(drain_engine="numpy"),
    dict(native_stage=False, drain_engine="heap")])
def test_serve_variants_byte_identical_within_port(port_run, variant):
    te, tr = port_run
    ve, vr = run_power_law(device="cpu", **variant, **_small_serve_kw())
    assert _fingerprint(ve) == _fingerprint(te)
    assert _decisions(vr) == _decisions(tr)
    assert vr.serve_state == variant.get("state", "device")
    assert vr.native_staging == variant.get("native_stage", True)
    assert ve.admission.drain_engine == variant.get("drain_engine", "native")


def test_unfused_host_equals_unfused_device():
    ue, ur = run_power_law(device="cpu", fuse=False, **_small_serve_kw(3))
    he, hr = run_power_law(device="cpu", fuse=False, state="host",
                           **_small_serve_kw(3))
    assert _fingerprint(he) == _fingerprint(ue)
    assert _decisions(hr) == _decisions(ur)
    fe, fr = run_power_law(device="cpu", **_small_serve_kw(3))
    assert [getattr(fr, f) for f in ADMISSION_FIELDS] == \
        [getattr(ur, f) for f in ADMISSION_FIELDS]


def test_report_is_json_and_names_device(port_run):
    import json
    _, tr = port_run
    d = json.loads(json.dumps(tr.to_dict()))
    assert d["device"] == "cpu" and d["serve_state"] == "device"
    assert d["stage_wall_s"] >= 0 and d["sustained_spans_per_sec"] > 0


def test_cli_serve_on_cpu(capsys):
    import json

    from anomod_torch.cli import main
    assert main(["serve", "--device", "cpu", "--tenants", "4",
                 "--services", "3", "--duration", "12", "--capacity", "800",
                 "--overload", "2", "--buckets", "64,256",
                 "--lane-buckets", "1,2,4", "--max-backlog", "1200"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_tenants"] == 4 and out["buckets"] == [64, 256]
    assert out["device"] == "cpu" and 0.0 <= out["shed_fraction"] <= 1.0


def test_engine_without_card_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    specs = PowerLawTraffic(n_tenants=2, total_rate_spans_per_s=10).specs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(specs, ("a", "b"), ReplayConfig(n_services=2))
    from anomod_torch.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--tenants", "2", "--duration", "2"])
    eng = ServeEngine(specs, ("a", "b"), ReplayConfig(n_services=2),
                      device="cpu")
    assert eng.runner.pool.device.type == "cpu"
    with pytest.raises(ValueError):
        ServeEngine(specs, ("a", "b"), ReplayConfig(n_services=2),
                    device="cpu", state="auto")
