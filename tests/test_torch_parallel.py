"""The port's parallel planes (``anomod_torch.parallel``) against the JAX
package's on ``make_mesh(2)``.

The port runs one process per device: a module fixture launches two
``gloo`` ranks on the CPU once (``tests/torch_dist_worker.py``, which
imports no JAX) and every library check runs in that one group; the
parent runs the JAX side on two of its virtual CPU devices, where
``shard_chunks`` cuts the corpus into the same two shards.  The CLI's
``replay`` and ``stream --devices 2`` each spawn their own two ranks.
Every launch has its own 120 s limit.

Tolerances: count / err / 5xx / histogram planes are exact; the moment
planes within ``rtol=1e-5, atol=1e-3`` (f32 sums taken in another order,
as in the single-device replay tests); the ring and the psum within f32
reassociation (``rtol=1e-6``); the HLL pmax, the reduce-scatter of
integer-valued f32 and the t-digest weights exact; the t-digest means
within the port's t-digest tests' ``rtol=1e-5, atol=1e-5``.  HLL
registers equal the JAX XLA plane's outside the buckets its float32
``_clz32`` explains, and the port's single-device plane's exactly.
"""

import json
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from anomod import labels as jlabels
from anomod import replay as jreplay
from anomod import stream as jstream
from anomod import synth as jsynth
from anomod.parallel import make_mesh as jmake_mesh
from anomod.parallel.mesh import shard_chunks as jshard_chunks
from anomod.schemas import concat_span_batches as jconcat
from anomod.schemas import take_spans as jtake
from anomod_torch import replay as treplay
from anomod_torch import stream as tstream
from anomod_torch.parallel import launch, make_mesh, make_sharded_replay_fn
from anomod_torch.parallel.mesh import Mesh, shard_chunks
from anomod_torch.schemas import take_spans
from test_torch_sketches import assert_registers_explained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
#: the JAX shard body a port per-rank kernel stands for
JAX_KERNEL = {"cuda": "pallas", "matmul": "xla"}


@pytest.fixture(scope="module")
def ranks():
    """The one 2-rank gloo launch of the library checks."""
    return launch(W.library_checks, 2, device="cpu",
                  timeout=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(2)


@pytest.fixture
def one_thread():
    """The port's serve tick on the CPU, on one torch thread (the plain
    fold contends under torch's thread pool)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_planes(agg, hist, ref_agg, ref_hist):
    agg, ref_agg = np.asarray(agg), np.asarray(ref_agg)
    np.testing.assert_array_equal(agg[:, :3], ref_agg[:, :3])
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref_hist))
    np.testing.assert_allclose(agg[:, 3:], ref_agg[:, 3:], rtol=1e-5,
                               atol=1e-3)


def _cpu_mesh(world=2, rank=0):
    """A rank's mesh object with no group behind it: enough for the
    refusals, which raise before any collective."""
    return Mesh(axis="data", world_size=world, rank=rank,
                device=torch.device("cpu"), backend="gloo")


# -- the launch -------------------------------------------------------------


def test_library_launch_runs_two_gloo_ranks_in_rank_order(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert (r["world"], r["backend"], r["devices"]) == (2, "gloo", 2)
    # a replicated merge leaves every rank with the same state
    a, b = ranks
    for key in ("psum", "ring", "hll", "td_mean", "td_weight"):
        np.testing.assert_array_equal(a["collectives"][key],
                                      b["collectives"][key])
    for run in ("cuda-replicated", "matmul-replicated"):
        for plane in ("agg", "hist", "hll"):
            np.testing.assert_array_equal(a["replay"][run][plane],
                                          b["replay"][run][plane])
    for k, v in a["stream"].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, b["stream"][k])
        else:
            assert v == b["stream"][k], k
    assert a["serve"] == b["serve"]


def _world_1(fail):
    mesh = make_mesh(device="cpu")
    if fail:
        raise KeyError("planted")
    return mesh.world_size, mesh.rank, mesh.backend


def test_launch_at_world_1_runs_in_process_and_leaves_no_group():
    """World size 1 runs in the calling process (no spawn): its result
    comes back, its exception propagates as raised, and the group is
    gone either way."""
    assert launch(_world_1, 1, device="cpu", args=(False,)) == \
        [(1, 0, "gloo")]
    assert not torch.distributed.is_initialized()
    with pytest.raises(KeyError, match="planted"):
        launch(_world_1, 1, device="cpu", args=(True,))
    assert not torch.distributed.is_initialized()


# -- checks that need no group ------------------------------------------------


def _corpus_chunks():
    jbatch = jconcat([jsynth.generate_spans(l, n_traces=30)
                      for l in jlabels.labels_for_testbed("TT")])
    cfg = jreplay.ReplayConfig(n_services=jbatch.n_services, chunk_size=512)
    return jreplay.stage_columns(jbatch, cfg)[0], cfg.sw


def _exact_multiple_chunks():
    """``tests/test_parallel.py``'s regression input: 3 full chunks, no
    staging padding."""
    rng = np.random.default_rng(3)
    n, C = 128 * 3, 128
    chunks = {"sid": rng.integers(0, 8, n).astype(np.int32),
              "tid": rng.integers(1, 50, n).astype(np.int32),
              "dur": rng.uniform(1, 5, n).astype(np.float32),
              "dur_raw": rng.uniform(10, 50, n).astype(np.float32),
              "err": np.zeros(n, np.float32), "s5": np.zeros(n, np.float32),
              "valid": np.ones(n, np.float32)}
    return {k: v.reshape(3, C) for k, v in chunks.items()}, 8


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("source", ["corpus", "exact_multiple"])
def test_shard_chunks_byte_equal_to_jax(n_shards, source):
    chunks, dead = (_corpus_chunks() if source == "corpus"
                    else _exact_multiple_chunks())
    got = shard_chunks(chunks, n_shards, dead_sid=dead)
    want = jshard_chunks(chunks, n_shards, dead_sid=dead)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()
    pad = got["sid"].reshape(-1, got["sid"].shape[-1])[
        chunks["sid"].shape[0]:]
    assert pad.size == 0 or (pad == dead).all()


def test_mesh_refuses_what_is_not_attached():
    # the card is the default: with no card (or too few) it raises
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(2, device="cuda")
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(2)
    # on the CPU "attached" is the launched world size
    with pytest.raises(ValueError, match="requested a 2-device mesh but "
                       "1 device"):
        make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")


def test_launch_on_the_card_refuses_before_spawning():
    before = set(multiprocessing.active_children())
    if torch.cuda.is_available():
        n = torch.cuda.device_count() + 1
        with pytest.raises(ValueError, match=f"requested a {n}-device mesh"):
            launch(_world_1, n, args=(False,))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch(_world_1, 2, args=(False,))
    assert set(multiprocessing.active_children()) == before


def test_collectives_refuse_tensors_off_the_mesh_device():
    from anomod_torch.parallel import collectives as coll
    nccl = Mesh(axis="data", world_size=1, rank=0,
                device=torch.device("cuda", 0), backend="nccl")
    for fn in (coll.psum, coll.ring_allreduce, coll.pmax_merge_hll,
               coll.reduce_scatter_state):
        with pytest.raises(ValueError, match="cpu tensor on a nccl mesh"):
            fn(torch.zeros(2, 2), nccl)
    with pytest.raises(ValueError, match="divisible"):
        coll.reduce_scatter_state(torch.zeros(3, 2), _cpu_mesh())


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["numpy", "cuda-sorted", "scattered-sw",
                                  "merge-mode"])
def test_sharded_replay_refusals_match_jax(case, jmesh):
    from anomod.parallel.replay import make_sharded_replay_fn as jfn
    tcfg = treplay.ReplayConfig(n_services=4)
    jcfg = jreplay.ReplayConfig(n_services=4)
    mesh = _cpu_mesh()
    if case in ("numpy", "cuda-sorted"):
        with pytest.raises(ValueError, match=f"unknown replay kernel "
                           f"'{case}'"):
            make_sharded_replay_fn(tcfg, mesh, kernel=case)
        # the JAX names of the same two engines are refused alike
        jname = "numpy" if case == "numpy" else "pallas-sorted"
        assert f"unknown replay kernel '{jname}'" in _jax_error(
            lambda: jfn(jcfg, jmesh, kernel=jname))
        return
    kw = ({"merge": "gather"} if case == "merge-mode" else
          {"merge": "scattered"})
    if case == "scattered-sw":
        tcfg = treplay.ReplayConfig(n_services=3, n_windows=3)
        jcfg = jreplay.ReplayConfig(n_services=3, n_windows=3)
    port = _jax_error(lambda: make_sharded_replay_fn(tcfg, mesh, **kw))
    assert port == _jax_error(lambda: jfn(jcfg, jmesh, **kw))


@pytest.mark.parametrize("case", ["mesh-and-replay", "mesh-and-hll"])
def test_detector_mesh_refusals_match_jax(case):
    tcfg = treplay.ReplayConfig(n_services=2)
    jcfg = jreplay.ReplayConfig(n_services=2)
    svcs = ("a", "b")
    if case == "mesh-and-replay":
        port = _jax_error(lambda: tstream.OnlineDetector(
            svcs, tcfg, 0, mesh=_cpu_mesh(),
            replay=tstream.StreamReplay(tcfg, 0, device="cpu")))
        want = _jax_error(lambda: jstream.OnlineDetector(
            svcs, jcfg, 0, mesh=object(),
            replay=jstream.StreamReplay(jcfg, 0)))
    else:
        port = _jax_error(lambda: tstream.OnlineDetector(
            svcs, tcfg, 0, mesh=_cpu_mesh(), with_hll=True))
        want = _jax_error(lambda: jstream.OnlineDetector(
            svcs, jcfg, 0, mesh=object(), with_hll=True))
    assert port == want


SERVE_REFUSALS = {"shards": dict(shards=2),
                  "async_commit": dict(async_commit=True),
                  "policy": dict(policy="auto"),
                  "state_device": dict(state="device"),
                  "tier_hot": dict(tier_hot=4),
                  "worker_process": dict(worker="process"),
                  "ckpt_every": dict(ckpt_every=8)}


def _engines(mesh_kw_port, mesh_kw_jax, **kw):
    from anomod.serve.engine import ServeEngine as JEngine
    from anomod.serve.queues import TenantSpec as JSpec
    from anomod_torch.serve.engine import ServeEngine as TEngine
    from anomod_torch.serve.queues import TenantSpec as TSpec
    tcfg = treplay.ReplayConfig(n_services=2, chunk_size=512)
    jcfg = jreplay.ReplayConfig(n_services=2, chunk_size=512)
    port = lambda: TEngine([TSpec(0, "t0")], ("a", "b"), tcfg,  # noqa: E731
                           **mesh_kw_port, **kw)
    jax = lambda: JEngine([JSpec(0, "t0")], ("a", "b"), jcfg,  # noqa: E731
                          **mesh_kw_jax, **kw)
    return port, jax


@pytest.mark.parametrize("case", sorted(SERVE_REFUSALS))
def test_serve_mesh_refusals_match_jax(case):
    port, jax = _engines(dict(mesh=_cpu_mesh()), dict(mesh=object()),
                         **SERVE_REFUSALS[case])
    msg = _jax_error(port)
    assert "mesh" in msg
    assert msg == _jax_error(jax)


def test_serve_mesh_turns_env_sourced_knobs_off_as_jax(monkeypatch):
    """An env-sourced knob that the mesh plane refuses is off beside it,
    in both packages; the fusion flag stays, unused."""
    from anomod import config as jconfig
    from anomod_torch import config as tconfig
    for k, v in (("ANOMOD_SERVE_ASYNC_COMMIT", "1"),
                 ("ANOMOD_SERVE_POLICY", "auto"),
                 ("ANOMOD_SERVE_TIER_HOT", "4"),
                 ("ANOMOD_SERVE_WORKER", "process"),
                 ("ANOMOD_SERVE_CKPT_EVERY", "8"),
                 ("ANOMOD_SERVE_STATE", "auto")):
        monkeypatch.setenv(k, v)
    prev_t = tconfig.set_config(tconfig.Config())
    prev_j = jconfig.get_config()
    jconfig.set_config(jconfig.Config())
    try:
        port, jax = _engines(dict(mesh=_cpu_mesh()), dict(mesh=object()))
        for eng in (port(), jax()):
            assert eng.async_commit is False
            assert eng.policy is None
            assert eng.tier_hot == 0
            assert eng.worker_mode == "thread"
            assert eng.ckpt_every == 0
            assert eng.serve_state == "host"
            assert eng._fused is False
    finally:
        tconfig.set_config(prev_t)
        jconfig.set_config(prev_j)


# -- the collectives ----------------------------------------------------------


def test_collectives_match_jax_shard_map(ranks, jmesh):
    import jax
    from jax.sharding import PartitionSpec as P

    from anomod.parallel import collectives as jcoll
    from anomod.parallel.mesh import shard_map_compat
    inp = [W.collective_inputs(r) for r in (0, 1)]
    stacked = {k: np.stack([inp[0][k], inp[1][k]]) for k in inp[0]}

    def body(x, sc, hll, tm, tw):
        m, w = jcoll.allgather_merge_tdigests(tm[0], tw[0], "data")
        return (jax.lax.psum(x[0], "data")[None],
                jcoll.ring_allreduce(x[0], "data")[None],
                jcoll.reduce_scatter_state(sc[0], "data")[None],
                jcoll.pmax_merge_hll(hll[0], "data")[None], m[None], w[None])

    fn = shard_map_compat(body, mesh=jmesh, in_specs=(P("data"),) * 5,
                          out_specs=(P("data"),) * 6)
    outs = [np.asarray(o) for o in jax.jit(fn)(
        *(stacked[k] for k in ("x", "scatter", "hll", "td_mean",
                               "td_weight")))]
    psum, ring, scatter, hll, td_mean, td_weight = outs
    want_sum = stacked["x"].sum(axis=0)
    for r, got in enumerate(ranks):
        c = got["collectives"]
        np.testing.assert_allclose(c["psum"], psum[r], rtol=1e-6)
        np.testing.assert_allclose(c["ring"], ring[r], rtol=1e-6)
        np.testing.assert_allclose(c["ring"], c["psum"], rtol=1e-6)
        np.testing.assert_allclose(c["psum"], want_sum, rtol=1e-6)
        np.testing.assert_array_equal(c["scatter"], scatter[r])
        np.testing.assert_array_equal(c["hll"], hll[r])
        np.testing.assert_array_equal(c["td_weight"], td_weight[r])
        np.testing.assert_allclose(c["td_mean"], td_mean[r], rtol=1e-5,
                                   atol=1e-5)
    # the scattered slices reassemble the full sum of integer-valued f32
    np.testing.assert_array_equal(
        np.concatenate([g["collectives"]["scatter"] for g in ranks]),
        stacked["scatter"].sum(axis=0))


# -- the sharded replay -------------------------------------------------------


@pytest.fixture(scope="module")
def replay_inputs():
    jbatch = jconcat([jsynth.generate_spans(l, n_traces=30)
                      for l in jlabels.labels_for_testbed("TT")])
    jcfg = jreplay.ReplayConfig(n_services=jbatch.n_services, chunk_size=512)
    tcfg = treplay.ReplayConfig(n_services=jbatch.n_services, chunk_size=512)
    chunks, n = jreplay.stage_columns(jbatch, jcfg)
    single = treplay.make_replay_fn(tcfg, device="cpu", with_hll=True)(chunks)
    return jbatch, jcfg, tcfg, chunks, n, single


@pytest.mark.parametrize("kernel,merge", W.REPLAY_RUNS)
def test_sharded_replay_matches_jax_and_single_device(ranks, jmesh,
                                                       replay_inputs, kernel,
                                                       merge):
    from anomod.parallel.replay import make_sharded_replay_fn as jfn
    from anomod.parallel.replay import stage_sharded as jstage
    jbatch, jcfg, tcfg, chunks, n, single = replay_inputs
    dev, jn = jstage(jbatch, jmesh, jcfg)
    want = jfn(jcfg, jmesh, kernel=JAX_KERNEL[kernel], with_hll=True,
               merge=merge)(dev)
    runs = [r["replay"][f"{kernel}-{merge}"] for r in ranks]
    assert ranks[0]["replay"]["n"] == jn == n == jbatch.n_spans
    if merge == "scattered":
        rows = tcfg.sw // 2
        for r, run in enumerate(runs):
            assert run["agg"].shape[0] == rows
        agg = np.concatenate([run["agg"] for run in runs])
        hist = np.concatenate([run["hist"] for run in runs])
    else:
        agg, hist = runs[0]["agg"], runs[0]["hist"]
    _assert_planes(agg, hist, want.agg, want.hist)
    _assert_planes(agg, hist, single.agg.numpy(), single.hist.numpy())
    assert float(agg[:, 0].astype(np.float64).sum()) == n
    tid = chunks["tid"].reshape(-1)
    sid = chunks["sid"].reshape(-1)
    live = sid < tcfg.sw
    for run in runs:
        np.testing.assert_array_equal(run["hll"], single.hll.numpy())
        assert_registers_explained(run["hll"], want.hll, tid[live],
                                   sid[live] // tcfg.n_windows, tcfg.hll_p)


# -- the sharded streaming plane ----------------------------------------------


def test_sharded_stream_replay_matches_jax_and_single_device(ranks, jmesh):
    from anomod.parallel.stream import ShardedStreamReplay as JSharded
    label = jlabels.label_for("Svc_Kill_UserTimeline")
    batch = jsynth.generate_experiment(label, n_traces=200, seed=0).spans
    batch = jtake(batch, np.argsort(batch.start_us, kind="stable"))
    t0 = int(batch.start_us.min())
    jcfg = jreplay.ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    tcfg = treplay.ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    cuts = W._cuts(batch.n_spans, W.SPAN_CUTS_AT)
    jplane = JSharded(jcfg, t0, jmesh)
    single = tstream.StreamReplay(tcfg, t0, device="cpu")
    windows = []
    for lo, hi in zip(cuts, cuts[1:]):
        w = jplane.push(jtake(batch, slice(lo, hi)))
        assert single.push(take_spans(batch, slice(lo, hi))) == w
        windows.append(w)
    jdet = jstream.OnlineDetector(batch.services, jcfg, t0,
                                  replay=JSharded(jcfg, t0, jmesh))
    tdet = tstream.OnlineDetector(batch.services, tcfg, t0, device="cpu",
                                  replay=tstream.StreamReplay(tcfg, t0,
                                                              device="cpu"))
    for lo, hi in zip(cuts, cuts[1:]):
        jdet.push(jtake(batch, slice(lo, hi)))
        tdet.push(take_spans(batch, slice(lo, hi)))
    jdet.finish()
    tdet.finish()
    assert jdet.alerts and W.alert_keys(jdet.alerts) == \
        W.alert_keys(tdet.alerts)
    for r in ranks:
        s = r["stream"]
        assert s["windows"] == windows
        assert s["n_spans"] == jplane.n_spans == single.n_spans
        _assert_planes(s["agg"], s["hist"], jplane.state.agg,
                       jplane.state.hist)
        _assert_planes(s["agg"], s["hist"], single.state.agg.numpy(),
                       single.state.hist.numpy())
        assert s["alerts"] == W.alert_keys(jdet.alerts)


def test_sharded_edge_attribution_matches_jax_and_single_device(ranks,
                                                                jmesh):
    label = jlabels.label_for("Lv_C_travel_detail_failure")
    hard = jsynth.HardMode(severity=1.0, noise=0.0, fault_locus="edge")
    exp = jsynth.generate_spans(label, n_traces=300, seed=0, hard=hard)
    psvc = jstream.resolve_parent_services(exp)
    order = np.argsort(exp.start_us, kind="stable")
    batch, psvc = jtake(exp, order), psvc[order]
    t0 = int(batch.start_us.min())
    has = batch.parent >= 0
    edges = set(zip(batch.service[batch.parent[has]].tolist(),
                    batch.service[has].tolist()))
    jcfg = jreplay.ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    tcfg = treplay.ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    jdet = jstream.OnlineDetector(batch.services, jcfg, t0, call_edges=edges,
                                  mesh=jmesh)
    tdet = tstream.OnlineDetector(batch.services, tcfg, t0, call_edges=edges,
                                  device="cpu")
    cuts = W._cuts(batch.n_spans, W.EDGE_CUTS_AT)
    for lo, hi in zip(cuts, cuts[1:]):
        sl = slice(lo, hi)
        jdet.push(jtake(batch, sl), parent_service=psvc[sl])
        tdet.push(take_spans(batch, sl), parent_service=psvc[sl])
    jdet.finish()
    tdet.finish()
    key = W.alert_keys(jdet.alerts, evidence=True)
    assert W.alert_keys(tdet.alerts, evidence=True) == key
    assert any(e == "edge" for _, _, e in key)
    for r in ranks:
        s = r["stream"]
        assert s["edge_replay"] == "ShardedStreamReplay"
        assert s["edge_cfg_services"] == 3 * batch.n_services
        assert s["edge_alerts"] == key
        assert s["edge_ranked"][0] == label.target_service


# -- the serve mesh plane -----------------------------------------------------


def test_serve_mesh_plane_matches_jax_mesh_and_port_bucketed(ranks, jmesh,
                                                             one_thread):
    from anomod.serve import traffic as jtraffic
    from anomod.serve.engine import ServeEngine as JEngine
    from anomod_torch.serve import traffic as ttraffic
    from anomod_torch.serve.engine import ServeEngine as TEngine
    traffic, kw, cfg_kw, duration = W.serve_traffic(jtraffic)
    jeng = JEngine(traffic.specs, traffic.services,
                   jreplay.ReplayConfig(**cfg_kw), mesh=jmesh,
                   max_tenant_backlog=100_000, **kw)
    jeng.run(traffic, duration_s=duration)
    traffic, kw, cfg_kw, duration = W.serve_traffic(ttraffic)
    teng = TEngine(traffic.specs, traffic.services,
                   treplay.ReplayConfig(**cfg_kw), device="cpu", **kw)
    teng.run(traffic, duration_s=duration)
    for t in (0, 1):
        want = W.alert_keys(jeng.alerts_for(t))
        assert W.alert_keys(teng.alerts_for(t)) == want
        for r in ranks:
            assert r["serve"]["alerts"][t] == want
    assert ranks[0]["serve"]["alerts"][0]          # the fault alerted
    for r in ranks:
        s = r["serve"]
        assert (s["fused"], s["replay"], s["ckpt_every"], s["state"]) == \
            (False, "ShardedStreamReplay", 0, "host")


# -- the CLI ------------------------------------------------------------------


def _cli(*argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "anomod_torch", *argv],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_cli_replay_devices_2_reports_the_jax_span_count(jmesh):
    from anomod.parallel import sharded_throughput as jthroughput
    doc, = _cli("replay", "--device", "cpu", "--devices", "2",
                "--traces", "60", "--repeats", "1")
    assert doc["devices"] == 2 and doc["device"] == "cpu"
    jbatch = jconcat([jsynth.generate_spans(l, n_traces=60)
                      for l in jlabels.labels_for_testbed("TT")])
    r = jthroughput(jbatch, jmesh,
                    jreplay.ReplayConfig(n_services=jbatch.n_services),
                    repeats=1)
    assert doc["n_spans"] == r.n_spans == jbatch.n_spans


def test_cli_stream_devices_2_prints_the_single_device_alerts(capsys):
    from anomod_torch.cli import main
    argv = ["stream", "Lv_P_CPU_preserve", "--device", "cpu",
            "--traces", "120"]
    row, summary = _cli(*argv, "--devices", "2")
    assert main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert row["alerts"] and row["alerts"] == lines[0]["alerts"]
    assert row["ranked"] == lines[0]["ranked"]
    assert summary == lines[1]


CLI_REFUSALS = {
    "replay-numpy": (["replay", "--devices", "2", "--kernel", "numpy"],
                     "--kernel numpy is the single-chip host engine"),
    "replay-sorted": (["replay", "--devices", "2", "--kernel",
                       "cuda-sorted"], "--kernel cuda-sorted stages on the "
                      "host for one chip; the sharded path uses 'cuda' or "
                      "'matmul'"),
    "replay-replicate": (["replay", "--devices", "2", "--replicate", "2"],
                         "--replicate is not supported with --devices"),
    "replay-negative": (["replay", "--devices", "-1"],
                        "--devices must be >= 0"),
    "serve-shards": (["serve", "--devices", "2", "--shards", "2"],
                     "the mesh plane manages its own sharded dispatch"),
    "serve-state": (["serve", "--devices", "2", "--state", "device"],
                    "the mesh plane manages its own sharded state"),
    "serve-live": (["serve", "--devices", "2", "--from-live", "self"],
                   "--devices is not supported on the live-feed path"),
}
#: serve refusals the JAX CLI makes too: the same message
CLI_REFUSALS_JAX = {
    "serve-ckpt": ["serve", "--devices", "2", "--ckpt-every", "8"],
    "serve-policy": ["serve", "--devices", "2", "--policy", "auto"],
    "serve-async": ["serve", "--devices", "2", "--async-commit"],
    "serve-worker": ["serve", "--devices", "2", "--worker", "process"],
}


def _cli_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("case", sorted(CLI_REFUSALS))
def test_cli_devices_refusals(case, capsys):
    from anomod_torch.cli import main
    argv, msg = CLI_REFUSALS[case]
    assert msg in _cli_error(main, [*argv, "--device", "cpu"], capsys)


@pytest.mark.parametrize("case", sorted(CLI_REFUSALS_JAX))
def test_cli_devices_refusals_match_jax(case, capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    argv = CLI_REFUSALS_JAX[case]
    port = _cli_error(main, [*argv, "--device", "cpu"], capsys)
    assert port == _cli_error(jmain, argv, capsys)


def test_cli_devices_past_the_attached_cards_fail(capsys):
    from anomod_torch.cli import main
    with pytest.raises((RuntimeError, SystemExit)) as e:
        main(["replay", "--devices", str(torch.cuda.device_count() + 1)])
    if isinstance(e.value, SystemExit):
        assert e.value.code != 0
        assert "device(s) are attached" in capsys.readouterr().err
