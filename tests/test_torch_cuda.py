"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports no JAX, so on the card it runs without the
suite's JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Tolerance: count / err / 5xx / histogram planes (and the roofline
ablations' count and exact rows) are small-integer f32 sums and must be
EQUAL; the moment planes are f32 sums taken in another order
(shared-memory atomics in the replay kernels, ``index_add_`` in the plain
version on the card) and agree to ``rtol=1e-4, atol=1e-3`` at these
sizes.  The lane-delta kernel sums in row order and must equal the plain
version run on the host bit for bit; the window gather is a copy and
must equal its plain version bit for bit.  The t-digest reduction's
weights (integer sums) must equal its plain version's and its means agree
to ``rtol=1e-5``; HLL registers (integer maxima) must be equal.
"""

import numpy as np
import pytest
import torch

from anomod_torch.ops import replay_kernels as rk

H = 16


@pytest.fixture
def cuda_device():
    """The card; decided at run time, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(n, sw, seed):
    """Span ids (with dead-lane padding) and [6, n] planes, from numpy."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, sw + 1, n).astype(np.int32)
    valid = (rng.random(n) < 0.9).astype(np.float32)
    dur_us = (rng.lognormal(8.0, 1.0, n).astype(np.float32) * valid)
    dur = np.log1p(dur_us)
    planes = np.stack([
        valid,
        ((rng.random(n) < 0.2) * valid).astype(np.float32),
        ((rng.random(n) < 0.1) * valid).astype(np.float32),
        dur_us, dur, dur * dur]).astype(np.float32)
    sid[valid == 0] = sw                      # padding rows: dead lane
    return sid, planes


def _assert_planes(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])     # exact
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])     # histogram
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6],      # moments
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sw", [1440, 4320])
def test_dense_kernel_matches_plain(cuda_device, sw):
    sid, planes = _inputs(200_000, sw, seed=8)
    s = torch.from_numpy(sid).to(cuda_device)
    p = torch.from_numpy(planes).to(cuda_device)
    for reps in (1, 2):
        before = rk.launches["replay_dense"]
        got = rk.replay_dense(s, p, sw, H, inner_repeats=reps)
        torch.cuda.synchronize()
        assert rk.launches["replay_dense"] == before + 1
        _assert_planes(got, rk.replay_dense_plain(s, p, sw, H,
                                                  inner_repeats=reps))


@pytest.mark.cuda
@pytest.mark.parametrize("sw", [1440, 4320])
def test_sorted_kernel_matches_plain(cuda_device, sw):
    sid, planes = _inputs(200_000, sw, seed=9)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rk.stage_sorted_planes(sid, planes, sw)]
    before = rk.launches["replay_sorted"]
    got = rk.replay_sorted(*args, sw, H, inner_repeats=2)
    torch.cuda.synchronize()
    assert rk.launches["replay_sorted"] == before + 1
    _assert_planes(got, rk.replay_sorted_plain(*args, sw, H,
                                               inner_repeats=2))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["counts", "no_hist"])
def test_sorted_ablation_kernel_matches_plain(cuda_device, mode):
    """The roofline probe's ablations: count and exact rows equal to the
    plain version's, hi and lo rows within tolerance, every one of the NWK
    columns kept; the count row sums to the live spans times the repeats
    and its first SW columns equal the sorted kernel's count column."""
    sw = 1440
    sid, planes = _inputs(200_000, sw, seed=12)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rk.stage_sorted_planes(sid, planes, sw)]
    full = rk.replay_sorted(*args, sw, H)
    for reps in (1, 2):
        before = rk.launches[f"replay_sorted_{mode}"]
        got = rk.replay_sorted_ablation(*args, sw, mode, inner_repeats=reps)
        torch.cuda.synchronize()
        assert rk.launches[f"replay_sorted_{mode}"] == before + 1
        want = rk.replay_sorted_ablation_plain(*args, sw, mode,
                                               inner_repeats=reps)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert got.shape == (rk.ABLATION_ROWS[mode], 1536)
        np.testing.assert_array_equal(got[:3], want[:3])
        np.testing.assert_allclose(got[3:], want[3:], rtol=1e-4, atol=1e-3)
        assert float(got[0].astype(np.float64).sum()) == \
            float(planes[0].sum()) * reps
        if reps == 1:
            np.testing.assert_array_equal(got[0, :sw],
                                          full[:, 0].cpu().numpy())
    z32 = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    zp = torch.zeros((6, 0), dtype=torch.float32, device=cuda_device)
    out = rk.replay_sorted_ablation(z32, zp, z32, sw, mode)
    assert out.shape == (rk.ABLATION_ROWS[mode], 1536)
    assert bool((out == 0).all())


def _lane_inputs(L, W, sw, seed):
    """[L, W] span ids (dead-lane padded, one all-dead lane) and the
    lane-major [L, 6, W] planes, from numpy."""
    sid, planes = _inputs(L * W, sw, seed)
    sid = sid.reshape(L, W)
    sid[L // 2] = sw
    planes = planes.reshape(6, L, W).transpose(1, 0, 2).copy()
    planes[L // 2] = 0.0
    return sid, planes


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 4096])
def test_lane_delta_kernel_matches_plain(cuda_device, width):
    """The lane kernel sums in row order: bit-identical to the CPU plain
    version (row-ordered index_add_), to itself across runs and lane
    counts; within tolerance of the card's unordered index_add_."""
    from anomod_torch.ops import serve_kernels as sk
    sw = 384
    sid, planes = _lane_inputs(32, width, sw, seed=11)
    s = torch.from_numpy(sid).to(cuda_device)
    p = torch.from_numpy(planes).to(cuda_device)
    before = sk.launches["lane_delta"]
    got = sk.lane_delta(s, p, sw, H)
    again = sk.lane_delta(s, p, sw, H)
    torch.cuda.synchronize()
    assert sk.launches["lane_delta"] == before + 2
    assert torch.equal(got, again)
    cpu = sk.lane_delta_plain(torch.from_numpy(sid), torch.from_numpy(planes),
                              sw, H)
    assert torch.equal(got.cpu(), cpu)
    assert bool((got[16] == 0).all())                # the all-dead lane
    for lane in (0, 7, 31):
        one = sk.lane_delta(s[lane:lane + 1].contiguous(),
                            p[lane:lane + 1].contiguous(), sw, H)
        assert torch.equal(one[0], got[lane])
    plain = sk.lane_delta_plain(s, p, sw, H)
    _assert_planes(got.reshape(-1, 6 + H), plain.reshape(-1, 6 + H))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64, 256])
def test_window_gather_kernel_matches_plain(cuda_device, T):
    from anomod_torch.ops import serve_kernels as sk
    rng = np.random.default_rng(T)
    pool = torch.from_numpy(
        rng.random((201, 384, 6)).astype(np.float32)).to(cuda_device)
    slots = torch.from_numpy(
        rng.integers(0, 201, T).astype(np.int32)).to(cuda_device)
    cols = torch.from_numpy(
        rng.integers(0, 32, T).astype(np.int32)).to(cuda_device)
    got = sk.window_gather(pool, slots, cols, 12, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.window_gather_plain(pool, slots, cols, 12, 32))


@pytest.mark.cuda
def test_pool_ops_on_card_equal_host(cuda_device):
    """The device pool's fold (contiguous slice add and the wave split of
    duplicated slots), roll and window gather give the same bytes on the
    card as on the host."""
    from anomod_torch.replay import ReplayConfig, TenantStatePool
    cfg = ReplayConfig(n_services=12, n_windows=32)
    rng = np.random.default_rng(3)
    pools = [TenantStatePool(cfg, capacity=8, device=d)
             for d in (cuda_device, "cpu")]
    for slots in ([1, 2, 3], [3, 1, 3, 2, 3], [5, 5]):
        da = rng.normal(size=(6, cfg.sw, 6)).astype(np.float32) * 1e3
        dh = rng.normal(size=(6, cfg.sw, H)).astype(np.float32)
        for pool in pools:
            pool.scatter_fold(slots, torch.from_numpy(da).to(pool.device),
                              torch.from_numpy(dh).to(pool.device))
    for pool in pools:
        pool.roll(3, 7)
    assert torch.equal(pools[0].agg.cpu(), pools[1].agg)
    assert torch.equal(pools[0].hist.cpu(), pools[1].hist)
    slots, cols = rng.integers(0, 9, 40), rng.integers(0, 32, 40)
    assert (pools[0].gather_window(slots, cols).tobytes()
            == pools[1].gather_window(slots, cols).tobytes())


def _serve_fingerprint(eng):
    import dataclasses
    out = {}
    for tid in sorted(eng._tenant_replay):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg).tobytes(),
                    np.asarray(st.hist).tobytes())
    return out


@pytest.mark.cuda
def test_fused_serve_on_card_equals_host_and_cpu_twins(cuda_device):
    """A small overloaded serve run on the card (fused, device pool,
    depth 2) is byte-identical to its host-seam and depth-1 twins on the
    card and to the same run on the CPU through the plain versions; the
    unfused run on the card equals the unfused run on the CPU."""
    import dataclasses

    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
    kw = dict(n_tenants=6, n_services=4, capacity_spans_per_s=1000,
              overload=2.0, duration_s=60, tick_s=1.0, seed=5, window_s=5.0,
              baseline_windows=4, fault_tenants=1, buckets=(64, 256),
              lane_buckets=(1, 2, 4), max_backlog=1500, n_windows=8)

    def decisions(rep):
        return {k: v for k, v in dataclasses.asdict(rep).items()
                if k not in VARIANT_REPORT_FIELDS and k != "device"}
    sk.reset_launches()
    eng, rep = run_power_law(device=cuda_device, **kw)
    assert sk.launches["lane_delta"] > 0 and sk.launches["window_gather"] > 0
    assert rep.n_alerts > 0 and rep.fused_dispatches > 0
    want = _serve_fingerprint(eng)
    for variant in (dict(state="host"), dict(pipeline=1),
                    dict(device="cpu")):
        run_kw = dict(dict(kw, device=cuda_device), **variant)
        e2, r2 = run_power_law(**run_kw)
        assert _serve_fingerprint(e2) == want, variant
        assert decisions(r2) == decisions(rep), variant
    unfused = [run_power_law(**dict(kw, device=d, fuse=False))
               for d in (cuda_device, "cpu")]
    assert _serve_fingerprint(unfused[0][0]) == \
        _serve_fingerprint(unfused[1][0])
    assert decisions(unfused[0][1]) == decisions(unfused[1][1])


@pytest.mark.cuda
def test_empty_corpus_gives_zeros_on_card(cuda_device):
    z32 = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    zp = torch.zeros((6, 0), dtype=torch.float32, device=cuda_device)
    for out in (rk.replay_dense(z32, zp, 1440, H),
                rk.replay_sorted(z32, zp, z32, 1440, H)):
        assert out.shape == (1440, 6 + H)
        assert bool((out == 0).all())


def _digest_inputs(R, L, K, seed):
    """Scale-pass-shaped t-digest lanes from numpy: non-decreasing bucket
    rows (a few outside [0, K)), 0/1 weights with a zero padding tail."""
    rng = np.random.default_rng(seed)
    bucket = np.sort(rng.integers(-1, K + 1, (R, L)), axis=1).astype(np.int32)
    w = (rng.random((R, L)) < 0.9).astype(np.float32)
    w[:, L - L // 4:] = 0.0
    v = np.log1p(rng.lognormal(8.0, 1.0, (R, L))).astype(np.float32)
    return bucket, w, w * v


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", [(1, 1), (1, 2944), (7, 33), (1440, 2944),
                                 (2880, 300)])
def test_tdigest_reduce_kernel_matches_plain(cuda_device, R, L):
    """Weights (integer sums) equal; means within rtol=1e-5 (each centroid
    sums tens of f32 terms in another order); two launches bit-identical."""
    from anomod_torch.ops import sketch_kernels as sk
    K = 64
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _digest_inputs(R, L, K, seed=R + L)]
    before = sk.launches["tdigest_reduce"]
    mean, weight = sk.tdigest_reduce(*args, K)
    mean2, weight2 = sk.tdigest_reduce(*args, K)
    torch.cuda.synchronize()
    assert sk.launches["tdigest_reduce"] == before + 2
    assert torch.equal(mean, mean2) and torch.equal(weight, weight2)
    pm, pw = sk.tdigest_reduce_plain(*args, K)
    assert torch.equal(weight, pw)
    np.testing.assert_allclose(mean.cpu().numpy(), pm.cpu().numpy(),
                               rtol=1e-5, atol=0.0)
    cm, cw = sk.tdigest_reduce_plain(*[a.cpu() for a in args], K)
    assert torch.equal(weight.cpu(), cw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 475_358])
def test_hll_update_kernel_matches_plain(cuda_device, n):
    """Registers equal the plain version's on the card and on the host:
    the single sketch (p = 10), a 91-lane plane with items on the dead
    lane (p = 8, shared-memory registers) and a 300-lane plane (p = 8,
    307 KB: registers updated in device memory)."""
    from anomod_torch.ops import sketch_kernels as sk
    rng = np.random.default_rng(n)
    items = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    it = torch.from_numpy(items).to(cuda_device)
    cases = [(None, (1 << 10,), 10)]
    for L in (90, 300):
        lane = rng.integers(0, L + 1, n).astype(np.int32)   # L: dead lane
        cases.append((torch.from_numpy(lane).to(cuda_device), (L, 256), 8))
    for lane, shape, p in cases:
        before = sk.launches["hll_update"]
        regs = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
        got = sk.hll_update(regs, it, lane, p)
        torch.cuda.synchronize()
        assert got is regs and sk.launches["hll_update"] == before + 1
        want = sk.hll_update_plain(torch.zeros_like(regs), it, lane, p)
        assert torch.equal(got, want)
        host = sk.hll_update_plain(
            torch.zeros(shape, dtype=torch.int32), it.cpu(),
            None if lane is None else lane.cpu(), p)
        assert torch.equal(got.cpu(), host)
        again = sk.hll_update(got.clone(), it, lane, p)      # max: idempotent
        assert torch.equal(again, got)


@pytest.mark.cuda
def test_sketch_kernels_empty_inputs(cuda_device):
    from anomod_torch.ops import sketch_kernels as sk
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    regs = torch.full((4, 256), 2, dtype=torch.int32, device=cuda_device)
    assert torch.equal(sk.hll_update(regs.clone(), z, z, 8), regs)
    b = torch.zeros((3, 0), dtype=torch.int32, device=cuda_device)
    f = torch.zeros((3, 0), dtype=torch.float32, device=cuda_device)
    mean, weight = sk.tdigest_reduce(b, f, f, 64)
    torch.cuda.synchronize()
    assert mean.shape == (3, 64) and bool((mean == 0).all())
    assert bool((weight == 0).all())
    mean, weight = sk.tdigest_reduce(b[:0], f[:0], f[:0], 64)
    assert mean.shape == (0, 64)


@pytest.mark.cuda
def test_sketch_path_on_card_matches_cpu(cuda_device):
    """replay_edge_features on a small corpus: the card's run and the
    host's (plain versions) give the same edge table and distinct counts,
    and percentiles within rtol=1e-4."""
    from anomod_torch import labels, synth
    from anomod_torch.ops import sketch_kernels as sk
    from anomod_torch.replay import ReplayConfig, replay_edge_features
    batch = synth.generate_spans(labels.label_for("Lv_D_TRANSACTION_timeout"),
                                 n_traces=200, seed=5)
    cfg = ReplayConfig(n_services=batch.n_services, n_windows=8,
                       window_us=300_000_000)
    sk.reset_launches()
    pct, counts, table = replay_edge_features(batch, cfg, device=cuda_device)
    assert sk.launches["tdigest_reduce"] > 0 and sk.launches["hll_update"] > 0
    cpct, ccounts, ctable = replay_edge_features(batch, cfg, device="cpu")
    assert table == ctable
    np.testing.assert_array_equal(counts, ccounts)
    np.testing.assert_allclose(pct, cpct, rtol=1e-4, atol=1e-2)
