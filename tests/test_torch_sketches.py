"""The port's sketch featurization path against the JAX package.

Same corpora (the generators are byte-identical), same staging:
- HLL registers equal the numpy oracle register for register.  Against
  the JAX package's XLA ``with_hll`` plane they are equal except in the
  buckets holding an item whose float32 ``_clz32`` (``xp=jnp``) differs
  from the exact count; the tests compute that set.
- t-digests built through the port equal the JAX Pallas build's weights
  exactly (integer sums) and its means within ``rtol=1e-5, atol=1e-5``;
  ``segment_pad`` is byte-identical.
- ``replay_percentiles`` and the per-edge percentiles hold the JAX
  package's own bar against its host and Pallas engines (``rtol=2e-3,
  atol=1e-2``, ``tests/test_replay.py``) and a tighter one, ``rtol=1e-6,
  atol=1e-4``: on the CPU the digests come out equal.
"""

import json

import numpy as np
import pytest
import torch

from anomod import labels as jlabels
from anomod import replay as jreplay
from anomod import stream as jstream
from anomod import synth as jsynth
from anomod.ops import hll as jhll
from anomod.ops import tdigest as jtd
from anomod.schemas import concat_span_batches
from anomod.schemas import take_spans as jtake
from anomod_torch import replay as treplay
from anomod_torch import stream as tstream
from anomod_torch.ops import hll as thll
from anomod_torch.ops import tdigest as ttd
from anomod_torch.schemas import take_spans

TIGHT = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def tt_batch():
    """The JAX replay tests' corpus: 13 TT labels x 40 traces."""
    return concat_span_batches([jsynth.generate_spans(l, n_traces=40)
                                for l in jlabels.labels_for_testbed("TT")])


def _cfgs(batch, **kw):
    return (jreplay.ReplayConfig(n_services=batch.n_services, **kw),
            treplay.ReplayConfig(n_services=batch.n_services, **kw))


def f32_clz_buckets(tid, lane, p):
    """``(lane, bucket)`` pairs holding an item whose float32 clz (the
    JAX ``_clz32`` under ``xp=jnp``) differs from the exact one."""
    import jax.numpy as jnp
    h = jhll._avalanche32(np.asarray(tid).astype(np.uint32), np)
    h2 = jhll._avalanche32(h ^ np.uint32(0x9E3779B9), np)
    off = jhll._clz32(h2, np) != np.asarray(jhll._clz32(jnp.asarray(h2),
                                                          jnp))
    bucket = (h >> np.uint32(32 - p)).astype(np.int64)
    return set(zip(np.asarray(lane)[off].tolist(), bucket[off].tolist()))


def assert_registers_explained(got, jax_regs, tid, lane, p):
    """Port registers equal to the JAX XLA plane's outside the buckets
    the float32 clz explains."""
    got, jax_regs = np.asarray(got), np.asarray(jax_regs)
    assert got.shape == jax_regs.shape
    diff = set(zip(*np.nonzero(got != jax_regs)))
    diff = {(int(a), int(b)) for a, b in diff}
    assert diff <= f32_clz_buckets(tid, lane, p)
    return diff


def _replay_lanes(chunks, cfg):
    """The staged rows' trace ids and HLL lanes (dead rows excluded)."""
    sid = chunks["sid"].reshape(-1)
    live = sid < cfg.sw
    return chunks["tid"].reshape(-1)[live], sid[live] // cfg.n_windows


# -- HLL ------------------------------------------------------------------


def test_hll_module_matches_numpy_oracle():
    p = 10
    items = (np.arange(20_000, dtype=np.int64) * 2654435761 % (2**31)
             ).astype(np.int32)
    regs = thll.hll_init(p, device="cpu")
    got = thll.hll_add(regs, torch.from_numpy(items), p=p)
    assert bool((regs == 0).all())               # the input is not changed
    want = jhll.hll_add(jhll.hll_init(p), items, p=p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert thll.hll_estimate(got) == jhll.hll_estimate(want)
    lane = torch.from_numpy((items % 3).astype(np.int32))
    got3 = thll.hll_add(thll.hll_init(p, lanes=3, device="cpu"),
                        torch.from_numpy(items), p=p, lane=lane)
    want3 = jhll.hll_add(jhll.hll_init(p, lanes=3), items, p=p,
                         lane=items % 3)
    np.testing.assert_array_equal(got3.numpy(), want3)
    np.testing.assert_array_equal(
        thll.hll_estimate(got3), [jhll.hll_estimate(r) for r in want3])
    a = thll.hll_add(thll.hll_init(p, device="cpu"),
                     torch.from_numpy(items[:12_000]), p=p)
    b = thll.hll_add(thll.hll_init(p, device="cpu"),
                     torch.from_numpy(items[8_000:]), p=p)
    np.testing.assert_array_equal(thll.hll_merge(a, b).numpy(), want)


def test_with_hll_plane_matches_jax_xla_plane(tt_batch):
    jcfg, tcfg = _cfgs(tt_batch, chunk_size=2048)
    chunks, _ = treplay.stage_columns(tt_batch, tcfg)
    want = jreplay.make_replay_fn(jcfg, with_hll=True)(chunks)
    got = treplay.make_replay_fn(tcfg, device="cpu", with_hll=True)(chunks)
    assert got.hll.shape == (tcfg.n_services, tcfg.hll_m)
    tid, lane = _replay_lanes(chunks, tcfg)
    assert_registers_explained(got.hll, want.hll, tid, lane, tcfg.hll_p)
    np.testing.assert_array_equal(
        got.hll.numpy(), jhll.hll_add(jhll.hll_init(8, lanes=tcfg.n_services),
                                      tid, p=8, lane=lane))


def test_with_hll_plane_differs_only_where_f32_clz_does():
    """Trace ids crafted so the rank hash sits just below a power of two:
    the JAX XLA plane misses some registers, the port matches the numpy
    oracle, and every difference lies in the computed set."""
    from test_torch_sketch_kernels import items_with_h2_below_powers_of_two
    jcfg, tcfg = (c(n_services=3, n_windows=4, chunk_size=1024)
                  for c in (jreplay.ReplayConfig, treplay.ReplayConfig))
    tid = items_with_h2_below_powers_of_two()
    n = tid.size + (-tid.size) % 1024
    sid = np.full(n, tcfg.sw, np.int32)
    sid[:tid.size] = np.arange(tid.size) % tcfg.sw
    chunks = {k: np.zeros(n, np.float32) for k in
              ("dur", "dur_raw", "err", "s5", "valid")}
    chunks["valid"][:tid.size] = 1.0
    chunks["sid"] = sid
    chunks["tid"] = np.zeros(n, np.int32)
    chunks["tid"][:tid.size] = tid
    chunks = {k: v.reshape(-1, 1024) for k, v in chunks.items()}
    want = jreplay.make_replay_fn(jcfg, with_hll=True)(chunks)
    got = treplay.make_replay_fn(tcfg, device="cpu", with_hll=True)(chunks)
    lane = sid[:tid.size] // tcfg.n_windows
    diff = assert_registers_explained(got.hll, want.hll, tid, lane, 8)
    assert diff                                  # the check has teeth
    np.testing.assert_array_equal(
        got.hll.numpy(), jhll.hll_add(jhll.hll_init(8, lanes=3), tid, p=8,
                                      lane=lane))


# -- t-digest -------------------------------------------------------------


def _assert_digest(got, want):
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5, atol=1e-5)


def test_tdigest_build_matches_pallas():
    from anomod.ops.pallas_tdigest import tdigest_build_pallas
    vals = np.random.default_rng(0).lognormal(3.0, 1.0, (5, 256)).astype(
        np.float32)
    got = ttd.tdigest_build_tensor(torch.from_numpy(vals), k=32)
    _assert_digest(got, tdigest_build_pallas(vals, k=32, interpret=True))
    host = ttd.TDigest(got.mean.numpy(), got.weight.numpy())
    ref = jtd.tdigest_build(vals, k=32)
    for q in (0.5, 0.9, 0.99):
        np.testing.assert_allclose(ttd.tdigest_quantile(host, q),
                                   jtd.tdigest_quantile(ref, q), rtol=1e-4)


def test_tdigest_by_segment_matches_pallas():
    from anomod.ops.pallas_tdigest import tdigest_by_segment_pallas
    rng = np.random.default_rng(21)
    S = 6
    seg = rng.integers(0, S, 3000).astype(np.int32)
    vals = rng.lognormal(3.0 + seg * 0.2, 0.7).astype(np.float32)
    got = ttd.tdigest_by_segment(vals, seg, S, k=32, device="cpu")
    _assert_digest(got, tdigest_by_segment_pallas(vals, seg, S, k=32,
                                                  interpret=True))


def test_tdigest_merge_matches_pallas():
    from anomod.ops.pallas_tdigest import (tdigest_build_pallas,
                                           tdigest_merge_pallas)
    rng = np.random.default_rng(1)
    a = rng.normal(10, 2, size=(3, 128)).astype(np.float32)
    b = rng.normal(14, 3, size=(3, 128)).astype(np.float32)
    got = ttd.tdigest_merge_tensor(
        ttd.tdigest_build_tensor(torch.from_numpy(a), k=32),
        ttd.tdigest_build_tensor(torch.from_numpy(b), k=32))
    want = tdigest_merge_pallas(tdigest_build_pallas(a, k=32, interpret=True),
                                tdigest_build_pallas(b, k=32, interpret=True),
                                interpret=True)
    _assert_digest(got, want)


def test_tdigest_weighted_and_padded_matches_pallas():
    from anomod.ops.pallas_tdigest import tdigest_build_pallas
    vals = np.random.default_rng(2).uniform(0, 100, size=(2, 64)).astype(
        np.float32)
    w = np.ones_like(vals)
    w[:, 48:] = 0.0
    got = ttd.tdigest_build_tensor(torch.from_numpy(vals), k=16,
                            weights=torch.from_numpy(w))
    _assert_digest(got, tdigest_build_pallas(vals, k=16, weights=w,
                                             interpret=True))


def test_numpy_tdigest_is_unchanged():
    """The host build (serve SLO digests, the CLI's corpus merge) still
    equals the JAX numpy build bit for bit."""
    vals = np.random.default_rng(4).lognormal(3.0, 1.0, (3, 500)).astype(
        np.float32)
    got = ttd.tdigest_merge_many([ttd.tdigest_build(v, k=64) for v in vals])
    want = jtd.tdigest_merge_many([jtd.tdigest_build(v, k=64) for v in vals])
    assert got.mean.tobytes() == want.mean.tobytes()
    assert got.weight.tobytes() == want.weight.tobytes()


@pytest.mark.parametrize("n,n_seg,pad_to", [(0, 5, 128), (1, 1, 1),
                                            (3000, 7, 1), (3000, 7, 128),
                                            (2000, 40, 128)])
def test_segment_pad_byte_identical(n, n_seg, pad_to):
    rng = np.random.default_rng(n + n_seg)
    seg = rng.integers(0, n_seg, n).astype(np.int32)
    vals = rng.lognormal(2.0, 1.0, n).astype(np.float32)
    got = ttd.segment_pad(vals, seg, n_seg, pad_to=pad_to)
    want = jtd.segment_pad(vals, seg, n_seg, pad_to=pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# -- the replay planes ----------------------------------------------------


def test_replay_percentiles_match_jax_engines(tt_batch):
    jcfg, tcfg = _cfgs(tt_batch, chunk_size=2048)
    got = treplay.replay_percentiles(tt_batch, tcfg, qs=(0.5, 0.99),
                                     device="cpu")
    assert got.shape == (tcfg.sw, 2) and got.dtype == np.float32
    assert (got[:, 1] > 0).sum() > 100
    for engine in ("host", "pallas"):
        want = jreplay.replay_percentiles(tt_batch, jcfg, qs=(0.5, 0.99),
                                          engine=engine)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2)
        np.testing.assert_allclose(got, want, **TIGHT)
    d = treplay.replay_digests(tt_batch, tcfg, device="cpu")
    want = jreplay.replay_digests(tt_batch, jcfg, engine="pallas")
    np.testing.assert_array_equal(d.weight, want.weight)


def test_replay_edge_features_match_jax():
    """The setting of the JAX per-edge test: a 20x link fault, 200
    traces, 8 windows of 300 s."""
    lab = jlabels.label_for("Lv_D_TRANSACTION_timeout")
    hard = jsynth.HardMode(severity=1.0, fault_locus="edge")
    batch = jsynth.generate_spans(lab, n_traces=200, seed=5, hard=hard)
    jcfg, tcfg = _cfgs(batch, n_windows=8, window_us=300_000_000)
    pct, counts, table = treplay.replay_edge_features(batch, tcfg,
                                                      device="cpu")
    jpct, jcounts, jtable = jreplay.replay_edge_features(batch, jcfg)
    assert table == jtable
    assert pct.shape == (len(table) * 8, 3) and counts.dtype == np.float64
    np.testing.assert_allclose(pct, jpct, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(pct, jpct, **TIGHT)
    # distinct counts are equal wherever the registers are
    chunks, cfg_e, _ = treplay._edge_staged(batch, tcfg)
    got = treplay.make_replay_fn(cfg_e, device="cpu", with_hll=True)(chunks)
    jcfg_e = jreplay.ReplayConfig(n_services=cfg_e.n_services, n_windows=8,
                                  window_us=300_000_000)
    want = jreplay.make_replay_fn(jcfg_e, with_hll=True)(chunks)
    tid, lane = _replay_lanes(chunks, cfg_e)
    diff = assert_registers_explained(got.hll, want.hll, tid, lane, 8)
    same = sorted(set(range(len(table))) - {a for a, _ in diff})
    np.testing.assert_array_equal(counts[same], jcounts[same])
    # the single-plane entries give the same planes
    pct1, table1 = treplay.replay_edge_percentiles(batch, tcfg, device="cpu")
    counts1, table2 = treplay.replay_edge_distinct(batch, tcfg, device="cpu")
    assert table1 == table2 == table
    np.testing.assert_array_equal(pct1, pct)
    np.testing.assert_array_equal(counts1, counts)


# -- stream, state, CLI ---------------------------------------------------


def test_with_hll_stream_equals_one_replay_pass(tt_batch):
    order = np.argsort(tt_batch.start_us, kind="stable")
    b = take_spans(tt_batch, order)
    _, tcfg = _cfgs(b, chunk_size=2048)
    sr = tstream.StreamReplay(tcfg, int(b.start_us.min()), device="cpu",
                              with_hll=True)
    cuts = [0, 700, 701, 4000, b.n_spans]
    for lo, hi in zip(cuts, cuts[1:]):
        sr.push(take_spans(b, slice(lo, hi)))
    chunks, _ = treplay.stage_columns(b, tcfg)
    once = treplay.make_replay_fn(tcfg, device="cpu", with_hll=True)(chunks)
    assert torch.equal(sr.state.hll, once.hll)
    assert bool((sr.state.hll > 0).any())
    rolled = tstream.roll_ring_state(sr.state, tcfg, 3)
    assert rolled.hll is sr.state.hll           # per service: not rolled


def test_with_hll_state_carried_from_jax_stream(tt_batch):
    """Half a corpus through the JAX with_hll plane, its state moved into
    the port, the rest through the port: the registers equal the whole
    corpus through the JAX plane, up to the float32-clz buckets."""
    from anomod_torch.state import from_numpy_state, to_numpy_state
    order = np.argsort(tt_batch.start_us, kind="stable")
    b = take_spans(tt_batch, order)
    jcfg, tcfg = _cfgs(b, chunk_size=2048)
    t0, half = int(b.start_us.min()), b.n_spans // 2
    jr = jstream.StreamReplay(jcfg, t0, with_hll=True)
    jr.push(jtake(b, slice(0, half)))
    carried = tstream.StreamReplay(tcfg, t0, device="cpu", with_hll=True)
    carried.set_state(from_numpy_state(*(np.asarray(a) for a in jr.state),
                                       device="cpu"))
    carried.push(take_spans(b, slice(half, b.n_spans)))
    jr.push(jtake(b, slice(half, b.n_spans)))
    _, _, hll = to_numpy_state(carried.state)
    chunks, _ = treplay.stage_columns(b, tcfg)
    tid, lane = _replay_lanes(chunks, tcfg)
    assert_registers_explained(hll, jr.state.hll, tid, lane, tcfg.hll_p)


def test_detector_with_hll_and_injected_replay_refused():
    _, tcfg = _cfgs(jsynth.generate_spans(jlabels.label_for("Normal_case"),
                                          n_traces=5))
    services = tuple(f"s{i}" for i in range(tcfg.n_services))
    replay = tstream.StreamReplay(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="with_hll"):
        tstream.OnlineDetector(services, tcfg, 0, replay=replay,
                               with_hll=True, device="cpu")
    det = tstream.OnlineDetector(services, tcfg, 0, with_hll=True,
                                 device="cpu")
    assert det.replay.state.hll.shape == (3 * tcfg.n_services, tcfg.hll_m)


def test_digest_state_round_trip():
    from anomod_torch.state import from_numpy_digest, to_numpy_digest
    vals = np.random.default_rng(3).lognormal(2.0, 1.0, (4, 300)).astype(
        np.float32)
    jd = jtd.tdigest_build(vals, k=32)
    td = from_numpy_digest(jd.mean, jd.weight, device="cpu")
    assert torch.is_tensor(td.mean) and td.mean.shape == (4, 32)
    back = to_numpy_digest(td)
    assert back.mean.tobytes() == jd.mean.tobytes()
    assert back.weight.tobytes() == jd.weight.tobytes()
    # a digest carried in merges on as the JAX one does
    more = ttd.tdigest_build_tensor(torch.from_numpy(vals[:, ::-1].copy()),
                                    k=32)
    merged = to_numpy_digest(ttd.tdigest_merge_tensor(td, more))
    want = jtd.tdigest_merge(jd, jtd.tdigest_build(vals[:, ::-1], k=32))
    np.testing.assert_array_equal(merged.weight, want.weight)
    np.testing.assert_allclose(merged.mean, want.mean, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        from_numpy_digest(jd.mean, jd.weight[:, :4], device="cpu")


def test_cli_sketch_flags_match_jax(capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main as tmain
    flags = ["replay", "--traces", "30", "--kernel", "numpy", "--percentiles",
             "--edge-percentiles"]
    assert jmain(flags) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tmain(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(got) and got["n_spans"] == want["n_spans"]
    assert got["latency_us"].keys() == want["latency_us"].keys() != set()
    for k, v in want["latency_us"].items():
        assert abs(got["latency_us"][k] - v) <= 0.1
    assert len(got["edge_p99_us_top"]) == len(want["edge_p99_us_top"]) == 5
    for g, w in zip(got["edge_p99_us_top"], want["edge_p99_us_top"]):
        assert g["edge"] == w["edge"]
        assert abs(g["p99_us"] - w["p99_us"]) <= 0.1
        assert abs(g["distinct_traces"] - w["distinct_traces"]) <= 0.1
