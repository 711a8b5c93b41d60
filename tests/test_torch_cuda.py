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
sizes.  The lane-delta kernel sorts each lane's rows by segment (stably)
and sums in row order, so it must equal the plain version run on the host
bit for bit; the window gather is a copy and
must equal its plain version bit for bit.  The t-digest reduction's
weights (integer sums) must equal its plain version's and its means agree
to ``rtol=1e-5``, and they must equal the numpy restatement of the
kernel's add order (``tests/torch_tdigest_order.py``) bit for bit; HLL
registers (integer maxima) must be equal.
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
@pytest.mark.parametrize("kind", ["spread", "one segment", "all dead"])
@pytest.mark.parametrize("n,sw", [(4096, 4320), (491_520, 1440),
                                  (491_520, 4320)])
def test_dense_kernel_path_shapes_and_ends(cuda_device, n, sw, kind):
    """The stream chunk (owned slices), the corpus pass (clusters) and a
    corpus over two shared-memory tiles; spans spread, all in one segment
    (every atomic on one row) or all on the dead lane with nonzero planes
    (dropped).  The count column sums to the live spans x repeats."""
    sid, planes = _inputs(n, sw, seed=n + sw)
    if kind == "one segment":
        sid[:] = sw // 3
        planes[0] = 1.0
    elif kind == "all dead":
        sid[:] = sw
        planes[0] = 1.0
    live = float(planes[0][sid < sw].sum())
    s = torch.from_numpy(sid).to(cuda_device)
    p = torch.from_numpy(planes).to(cuda_device)
    for reps in (1, 2):
        got = rk.replay_dense(s, p, sw, H, inner_repeats=reps)
        torch.cuda.synchronize()
        _assert_planes(got, rk.replay_dense_plain(s, p, sw, H,
                                                  inner_repeats=reps))
        assert float(got[:, 0].double().sum()) == live * reps
        if kind == "all dead":
            assert not bool(got.any())


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
@pytest.mark.parametrize("width", [64, 4096, 16384])
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


def _adversarial_lanes(kind, L, W, sw, seed):
    """[L, W] lanes whose live rows all fall in one segment (``hot``),
    alternate between two (``alternating``) or are none (``dead``), with
    ragged dead tails on every other lane."""
    sid, planes = _inputs(L * W, sw, seed)
    sid = sid.reshape(L, W)
    planes = planes.reshape(6, L, W).transpose(1, 0, 2).copy()
    live = planes[:, 0] > 0
    if kind == "hot":
        sid[live] = sw // 3
    elif kind == "alternating":
        sid[:] = np.where(live, np.where(np.arange(W) % 2 == 0, 5, sw - 2),
                          sw)
    else:
        sid[:] = sw
    for lane in range(0, L, 2):
        sid[lane, W - W // (lane + 2):] = sw
    planes *= (sid < sw)[:, None, :]
    return sid, planes


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 7, 32])
@pytest.mark.parametrize("kind", ["hot", "alternating", "dead"])
def test_lane_delta_kernel_adversarial_lanes(cuda_device, kind, L):
    """Skewed lanes through the per-lane counting sort: bit-identical to
    the host's plain version, across runs, and per lane against its
    one-lane dispatch, at W = 4096 and the widest bucket, 16384."""
    from anomod_torch.ops import serve_kernels as sk
    sw = 384
    for W in (4096, 16384):
        sid, planes = _adversarial_lanes(kind, L, W, sw, seed=L + W)
        s = torch.from_numpy(sid).to(cuda_device)
        p = torch.from_numpy(planes).to(cuda_device)
        got = sk.lane_delta(s, p, sw, H)
        again = sk.lane_delta(s, p, sw, H)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        cpu = sk.lane_delta_plain(torch.from_numpy(sid),
                                  torch.from_numpy(planes), sw, H)
        assert torch.equal(got.cpu(), cpu)
        for lane in range(L):
            one = sk.lane_delta(s[lane:lane + 1].contiguous(),
                                p[lane:lane + 1].contiguous(), sw, H)
            assert torch.equal(one[0], got[lane])
        if kind == "dead":
            assert not bool(got.any())


def _sorted_end(kind, sw, block=4096, k=128, seed=4):
    """Sorted-staged inputs at one end of the run-length distribution:
    every block one segment (``one segment``) or consecutive spans on
    consecutive segments of the window (``run length 1``); about 5 % of
    the rows are all-zero padding."""
    rng = np.random.default_rng(seed)
    wids = np.repeat(np.array([0, 2, 5, 10], np.int32), 3)
    t = wids.size * block
    if kind == "one segment":
        sid_l = np.repeat(rng.integers(0, k, wids.size), block)
    else:
        sid_l = np.arange(t) % k
    live = rng.random(t) < 0.95
    dur_us = rng.lognormal(8.0, 1.0, t).astype(np.float32)
    planes = np.stack([np.ones(t), rng.random(t) < 0.2, rng.random(t) < 0.1,
                       dur_us, np.log1p(dur_us),
                       np.log1p(dur_us) ** 2]).astype(np.float32) * live
    assert int(wids.max()) * k + k <= sw
    return sid_l.astype(np.int32), planes, wids, int(live.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "counts", "no_hist"])
@pytest.mark.parametrize("kind", ["one segment", "run length 1"])
def test_sorted_fold_run_length_ends(cuda_device, kind, mode):
    """The run-aggregated sorted fold at both ends of run length: exact
    rows equal to the plain version's, moments (hi and lo rows) within
    rtol=1e-4, the count row summing to the live spans times the
    repeats."""
    sw = 1440
    sid_l, planes, wids, n_live = _sorted_end(kind, sw)
    args = [torch.from_numpy(a).to(cuda_device) for a in (sid_l, planes,
                                                          wids)]
    for reps in (1, 2):
        if mode == "full":
            got = rk.replay_sorted(*args, sw, H, inner_repeats=reps)
            torch.cuda.synchronize()
            _assert_planes(got, rk.replay_sorted_plain(*args, sw, H,
                                                       inner_repeats=reps))
            count = got[:, 0].cpu().numpy()
        else:
            got = rk.replay_sorted_ablation(*args, sw, mode,
                                            inner_repeats=reps)
            want = rk.replay_sorted_ablation_plain(*args, sw, mode,
                                                   inner_repeats=reps)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(got[:3], want[:3])
            np.testing.assert_allclose(got[3:], want[3:], rtol=1e-4,
                                       atol=1e-3)
            count = got[0]
        assert float(count.astype(np.float64).sum()) == n_live * reps


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "counts"])
def test_sorted_reductions_assert_wids_order(cuda_device, mode):
    """On the card the sorted reductions check that ``wids`` is
    non-decreasing themselves (a device-side assert, which ends the
    process's CUDA context, hence a child process): ordered ``wids`` run,
    reversed ones fail at the next sync."""
    import subprocess
    import sys
    from pathlib import Path
    call = ("rk.replay_sorted(s, p, w, 300, 16, block=256)" if mode == "full"
            else "rk.replay_sorted_ablation(s, p, w, 300, 'counts', "
                 "block=256)")
    code = "\n".join([
        "import torch",
        "from anomod_torch.ops import replay_kernels as rk",
        "s = torch.zeros(512, dtype=torch.int32, device='cuda')",
        "p = torch.zeros((6, 512), device='cuda')",
        "w = torch.tensor([0, 1], dtype=torch.int32, device='cuda')",
        call, "torch.cuda.synchronize()", "print('ordered ok', flush=True)",
        "w = w.flip(0).contiguous()", call, "torch.cuda.synchronize()",
        "print('reversed ok', flush=True)"])
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert "ordered ok" in run.stdout, run.stderr[-2000:]
    assert run.returncode != 0 and "reversed ok" not in run.stdout
    assert "assert" in run.stderr.lower(), run.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64, 256])
def test_window_gather_kernel_matches_plain(cuda_device, T):
    from anomod_torch.ops import serve_kernels as sk
    rng = np.random.default_rng(T)
    pool = torch.from_numpy(
        rng.random((201, 384, 6)).astype(np.float32)).to(cuda_device)
    slots = rng.integers(0, 201, T).astype(np.int32)
    cols = rng.integers(0, 32, T).astype(np.int32)
    got = sk.window_gather(pool, slots, cols, 12, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.window_gather_plain(
        pool, torch.from_numpy(slots).to(cuda_device),
        torch.from_numpy(cols).to(cuda_device), 12, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [6, 5])
def test_window_gather_kernel_above_one_launch(cuda_device, F):
    """More tenants than one launch's parameter block holds: one launch a
    planned range, bit-equal to indexing, with slot 0, duplicated slots
    and the last column; odd F takes the scalar path."""
    from anomod_torch.ops import serve_kernels as sk
    T = 2 * sk.GATHER_PAIRS + 37
    rng = np.random.default_rng(F)
    pool = torch.from_numpy(
        rng.normal(size=(201, 384, F)).astype(np.float32)).to(cuda_device)
    slots = rng.integers(0, 201, T).astype(np.int32)
    cols = rng.integers(0, 32, T).astype(np.int32)
    slots[0], slots[T // 2], cols[-1] = 0, slots[1], 31
    before = sk.launches["window_gather"]
    got = sk.window_gather(pool, torch.from_numpy(slots), cols, 12, 32)
    torch.cuda.synchronize()
    assert sk.launches["window_gather"] - before == len(sk.gather_plan(T)) == 3
    assert torch.equal(got, sk.window_gather_plain(
        pool, torch.from_numpy(slots).to(cuda_device),
        torch.from_numpy(cols).to(cuda_device), 12, 32))


@pytest.mark.cuda
def test_window_gather_rejects_indices_on_the_card(cuda_device):
    from anomod_torch.ops import serve_kernels as sk
    pool = torch.zeros((3, 12, 6), device=cuda_device)
    on_card = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    host = np.zeros(2, np.int32)
    with pytest.raises(ValueError):
        sk.window_gather(pool, on_card, host, 3, 4)
    with pytest.raises(ValueError):
        sk.window_gather(pool.cpu(), host, on_card, 3, 4)


@pytest.mark.cuda
def test_pool_gather_window_numpy_indices_equal_host(cuda_device):
    """gather_window with numpy indices, more tenants than one launch
    holds: the card's pool gives the host pool's bytes."""
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.replay import ReplayConfig, TenantStatePool
    cfg = ReplayConfig(n_services=12, n_windows=32)
    rng = np.random.default_rng(11)
    pools = [TenantStatePool(cfg, capacity=40, device=d)
             for d in (cuda_device, "cpu")]
    agg = rng.normal(size=pools[1].agg.shape).astype(np.float32)
    for pool in pools:
        pool.agg.copy_(torch.from_numpy(agg))
    T = sk.GATHER_PAIRS + 100
    slots = rng.integers(0, 41, T)
    cols = rng.integers(0, 32, T)
    slots[0], cols[-1] = 0, 31
    assert (pools[0].gather_window(slots, cols).tobytes()
            == pools[1].gather_window(slots, cols).tobytes())


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
@pytest.mark.parametrize("R,L,sorted_rows,aligned", [
    (1, 1, True, True), (7, 33, True, True), (11, 384, False, True),
    (64, 1000, False, True), (300, 2944, True, True),
    (300, 2944, False, False), (2880, 2944, True, True)])
def test_tdigest_reduce_kernel_bit_equal_to_its_order(cuda_device, R, L,
                                                      sorted_rows, aligned):
    """The kernel's means and weights equal the numpy restatement of its
    add order bit for bit: rows sorted by bucket (as the scale pass
    writes them) or shuffled, buckets outside [0, K), lengths past the
    128-slot steps, and planes whose rows are not 16-byte aligned (the
    scalar loads)."""
    from anomod_torch.ops import sketch_kernels as sk
    from torch_tdigest_order import tdigest_reduce_in_kernel_order
    K = 64
    rng = np.random.default_rng(R * L)
    arrs = list(_digest_inputs(R, L, K, seed=R + L))
    if not sorted_rows:
        perm = np.argsort(rng.random((R, L)), axis=1)
        arrs = [np.take_along_axis(a, perm, axis=1) for a in arrs]
    args = []
    for a in arrs:
        t = torch.from_numpy(a).to(cuda_device)
        if not aligned:                  # the same values, 4 bytes on
            flat = torch.empty(R * L + 1, dtype=t.dtype, device=cuda_device)
            t = flat[1:].view(R, L).copy_(t)
        args.append(t)
    mean, weight = sk.tdigest_reduce(*args, K)
    torch.cuda.synchronize()
    want_m, want_w = tdigest_reduce_in_kernel_order(*arrs, K)
    np.testing.assert_array_equal(weight.cpu().numpy(), want_w)
    np.testing.assert_array_equal(mean.cpu().numpy(), want_m)
    pm, pw = sk.tdigest_reduce_plain(*args, K)
    assert torch.equal(weight, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 475_358])
def test_hll_update_kernel_matches_plain(cuda_device, n):
    """Registers equal the plain version's on the card and on the host:
    the single sketch (p = 10), a 91-lane plane with items on the dead
    lane (p = 8) and a 300-lane plane (p = 8, 307 KB)."""
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
@pytest.mark.parametrize("p", [4, 8, 10, 16])
@pytest.mark.parametrize("kind", ["spread", "all dead", "one register",
                                  "fewer rows than a block", "six lanes"])
def test_hll_update_kernel_ends(cuda_device, p, kind):
    """The register update at its ends, on a 91-lane plane (p = 16: the
    direct path) and a 6-lane one (p = 16: a 196 KB slice a block): equal
    to the plain version (on the card and the host), and two launches
    identical."""
    from anomod_torch.ops import sketch_kernels as sk
    L, n = (6 if kind == "six lanes" else 91), 200_003
    rng = np.random.default_rng(p)
    items = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    lane = rng.integers(0, L + 1, n).astype(np.int32)     # L: dead lane
    if kind == "all dead":
        lane[:] = L
    elif kind == "one register":
        items[:], lane[:] = items[0], 3
    elif kind == "fewer rows than a block":
        items, lane = items[:100], lane[:100]
    it = torch.from_numpy(items).to(cuda_device)
    ln = torch.from_numpy(lane).to(cuda_device)
    zero = torch.zeros((L, 1 << p), dtype=torch.int32, device=cuda_device)
    got = sk.hll_update(zero.clone(), it, ln, p)
    again = sk.hll_update(zero.clone(), it, ln, p)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, sk.hll_update_plain(zero.clone(), it, ln, p))
    assert torch.equal(got.cpu(), sk.hll_update_plain(
        zero.cpu(), it.cpu(), ln.cpu(), p))
    if kind == "all dead":
        assert not bool(got.any())
    if kind == "one register":
        assert int((got != 0).sum()) == 1


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


@pytest.mark.cuda
def test_detect_on_card_equals_numpy_oracle(cuda_device):
    """The torch score on the card against the numpy oracle: scores to
    rtol 1e-5, and every summary row equal."""
    from anomod_torch import detect, labels, synth
    corpus = [synth.generate_experiment(l, n_traces=40)
              for l in labels.labels_for_testbed("TT")]
    card = detect.evaluate_corpus(corpus, device=cuda_device)
    oracle = detect.evaluate_corpus(corpus, device="cpu")
    assert (card.top1, card.top3, card.top5, card.detection_accuracy,
            card.n_rca_cases) == (oracle.top1, oracle.top3, oracle.top5,
                                  oracle.detection_accuracy,
                                  oracle.n_rca_cases)
    assert detect.per_level_breakdown(card) == \
        detect.per_level_breakdown(oracle)
    np.testing.assert_allclose([r.score for r in card.results],
                               [r.score for r in oracle.results], rtol=1e-5)
    services = tuple(synth.TT_SERVICES)
    base = detect.extract_features(corpus[0], services).x
    for exp in corpus:
        feat = detect.extract_features(exp, services).x
        got = detect.service_scores(feat, base, cuda_device)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(),
                                   detect.service_scores_numpy(feat, base),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_gat_first_epoch_on_card_agrees_with_cpu(cuda_device):
    """One generator draw on both devices; the first epoch's loss agrees
    to rtol 1e-5 and the forward to rtol 1e-5 (f32, TF32 off)."""
    from anomod_torch import rca
    assert not torch.backends.cuda.matmul.allow_tf32
    train, evalb = rca.prepare_data("SN", range(2), [100], 20)
    F = train["x"].shape[-1]
    on_card = rca.init_model("gat", F, seed=0, device=cuda_device)
    on_cpu = rca.init_model("gat", F, seed=0, device="cpu")
    for k, v in on_cpu.state_dict().items():
        assert torch.equal(on_card.state_dict()[k].cpu(), v)
    b_card = rca.to_device(train, cuda_device)
    b_cpu = rca.to_device(train, torch.device("cpu"))
    with torch.no_grad():
        np.testing.assert_allclose(
            rca.apply_model("gat", on_card, b_card).cpu().numpy(),
            rca.apply_model("gat", on_cpu, b_cpu).numpy(),
            rtol=1e-5, atol=1e-6)
    got = rca.train_loop("gat", on_card, rca.make_optimizer(on_card),
                         b_card, 0, 3)
    want = rca.train_loop("gat", on_cpu, rca.make_optimizer(on_cpu),
                          b_cpu, 0, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["temporal", "lru", "transformer",
                                    "moe", "linegraph"])
def test_family_forward_backward_on_card_agrees_with_cpu(cuda_device,
                                                         family):
    """One generator draw on both devices for each family the quality
    sweep adds: the forward within rtol 1e-5, the loss within rtol 1e-5
    and every gradient within rtol 1e-4 (f32 with TF32 off; sums taken in
    the card's reduction order)."""
    from anomod_torch import rca
    assert not torch.backends.cuda.matmul.allow_tf32
    train, _ = rca.prepare_data("SN", range(2), [100], 20,
                                edge_features=family == "linegraph")
    models = {d: rca.init_model(family, train, seed=0, device=d)
              for d in (cuda_device, torch.device("cpu"))}
    out = {}
    for dev, model in models.items():
        batch = rca.to_device(train, dev)
        scores = rca.apply_model(family, model, batch)
        loss = rca.rca_loss(scores, batch)
        loss.backward()
        out[dev.type] = (scores.detach().cpu().numpy(), loss.item(),
                         {k: p.grad.cpu().numpy()
                          for k, p in model.named_parameters()})
    (s_card, l_card, g_card), (s_cpu, l_cpu, g_cpu) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    for k, g in g_cpu.items():
        np.testing.assert_allclose(g_card[k], g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,sw", [(1024, 64), (4096, 4320)],
                         ids=["selfscrape", "stream_chunk"])
def test_dense_kernel_hi_lo_fold_on_crowded_chunks(cuda_device, n, sw):
    """The widened dense fold (each moment's hi and lo sums apart, added
    as the output is written) at the self-scrape's and the stream's chunk
    shapes, the spans crowded onto 40 segments as a stream chunk's are:
    against the plain version on the card and on the host (the JAX chunk
    step's bits on the CPU), exact planes equal, moments within
    tolerance."""
    sid, planes = _inputs(n, sw, seed=n + 1)
    hot = np.random.default_rng(n).integers(0, sw, 40)
    sid = np.where(sid < sw, hot[sid % 40], sw).astype(np.int32)
    s = torch.from_numpy(sid).to(cuda_device)
    p = torch.from_numpy(planes).to(cuda_device)
    got = rk.replay_dense(s, p, sw, H)
    torch.cuda.synchronize()
    assert not rk.dense_plan(n, sw, H, 132, lambda smem: 16).clustered
    _assert_planes(got, rk.replay_dense_plain(s, p, sw, H))
    _assert_planes(got, rk.replay_dense_plain(torch.from_numpy(sid),
                                              torch.from_numpy(planes),
                                              sw, H))


@pytest.mark.cuda
def test_multimodal_stream_on_card_equals_plain_fold(cuda_device):
    """The multimodal stream through the dense kernel against the same
    stream through its plain version on the card: alert lists, ranked
    services and first-alert windows equal."""
    from anomod_torch.replay import stage_planes
    from anomod_torch.stream import StreamReplay, stream_quality

    class PlainFold(StreamReplay):
        def __init__(self, cfg, t0_us, device=None, with_hll=False):
            super().__init__(cfg, t0_us, device=device, with_hll=with_hll)
            SW, nh = cfg.sw, cfg.n_hist_buckets

            def step(state, chunk):
                sid, planes = stage_planes(chunk, xp=torch)
                out = rk.replay_dense_plain(sid, planes, SW, nh)
                return state._replace(agg=state.agg + out[:, :6],
                                      hist=state.hist + out[:, 6:])
            self._step = step

    names = ["Lv_D_cachelimit", "Lv_S_KILLPOD_preserve"]
    rk.reset_launches()
    rows = stream_quality("TT", 160, multimodal=True, experiments=names,
                          device=cuda_device)
    assert rk.launches["replay_dense"] > 0
    plain = stream_quality("TT", 160, multimodal=True, experiments=names,
                           device=cuda_device, replay_factory=PlainFold)
    for r, p in zip(rows, plain):
        assert r["ranked"] == p["ranked"]
        assert r["first_alert_window"] == p["first_alert_window"]
        assert [(a.window, a.service, a.evidence) for a in r["alerts"]] == \
            [(a.window, a.service, a.evidence) for a in p["alerts"]]


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(16, 8), (64, 16)])
def test_rca_scorer_on_card_equals_cpu(cuda_device, bucket):
    """The culprit scorer on the card adds in the order it adds on the
    CPU (every sum written out as elementwise adds): the same f32 bits,
    dead rows at ``-inf``."""
    from anomod_torch.serve.rca import N_RCA_FEATS, make_culprit_scorer
    n, k = bucket
    rng = np.random.default_rng(n)
    score = make_culprit_scorer()
    for _ in range(20):
        x = (rng.standard_normal((n, N_RCA_FEATS))
             * rng.uniform(0.01, 200, (n, N_RCA_FEATS))).astype(np.float32)
        args = [torch.from_numpy(x),
                torch.from_numpy(rng.integers(0, n, (n, k))),
                torch.from_numpy((rng.random((n, k)) < 0.5)
                                 .astype(np.float32)),
                torch.from_numpy((rng.random(n) < 0.8).astype(np.float32))]
        want = score(*args).numpy()
        got = score(*(a.to(cuda_device) for a in args)).cpu().numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(np.isinf(got), args[3].numpy() == 0)


@pytest.mark.cuda
def test_serve_with_rca_on_card_equals_cpu(cuda_device):
    """A small serve run with online RCA on the card: the verdict stream
    and every decision equal the same run on the CPU, and RCA leaves the
    card run's states and alerts as they are with RCA off."""
    import dataclasses

    from anomod_torch.serve.engine import (RCA_REPORT_FIELDS,
                                           VARIANT_REPORT_FIELDS,
                                           run_power_law)
    kw = dict(n_tenants=8, n_services=6, capacity_spans_per_s=2000,
              overload=2.0, duration_s=60, tick_s=1.0, seed=3, window_s=5.0,
              baseline_windows=4, fault_tenants=2, buckets=(64, 256),
              lane_buckets=(1, 2, 4), max_backlog=3000, n_windows=16)

    def decisions(rep, skip=()):
        return {k: v for k, v in dataclasses.asdict(rep).items()
                if k not in VARIANT_REPORT_FIELDS + tuple(skip)
                and k != "device"}
    eng, rep = run_power_law(device=cuda_device, rca=True, **kw)
    cpu, rep_cpu = run_power_law(device="cpu", rca=True, **kw)
    off, rep_off = run_power_law(device=cuda_device, rca=False, **kw)
    assert rep.n_rca_runs > 0 and rep.rca_topk_hits[1] == 2
    assert [v.to_dict() for v in eng.rca_verdicts] == \
        [v.to_dict() for v in cpu.rca_verdicts]
    assert decisions(rep) == decisions(rep_cpu)
    assert _serve_fingerprint(eng) == _serve_fingerprint(off)
    assert decisions(rep, RCA_REPORT_FIELDS) == \
        decisions(rep_off, RCA_REPORT_FIELDS)


@pytest.mark.cuda
def test_sharded_serve_on_card_equals_cpu_on_shard_streams(cuda_device,
                                                           monkeypatch):
    """A 2-shard serve run with RCA on the card equals its CPU twin and
    the 1-shard card run (states, alerts, verdicts, decisions, canonical
    flight journal), and every lane_delta / window_gather launch of the
    run comes from a shard runner's own stream, never the default one."""
    import dataclasses

    from anomod_torch import replay
    from anomod_torch.serve import batcher
    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
    kw = dict(n_tenants=8, n_services=6, capacity_spans_per_s=2000,
              overload=2.0, duration_s=60, tick_s=1.0, seed=3, window_s=5.0,
              baseline_windows=4, fault_tenants=2, buckets=(64, 256),
              lane_buckets=(1, 2, 4), max_backlog=3000, n_windows=16,
              rca=True, flight=True, flight_digest_every=4)
    streams = {"lane_delta": [], "window_gather": []}

    def spy(name, fn):
        def wrapped(*a, **k):
            streams[name].append(
                torch.cuda.current_stream(cuda_device).cuda_stream)
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(batcher, "lane_delta",
                        spy("lane_delta", batcher.lane_delta))
    monkeypatch.setattr(replay, "window_gather",
                        spy("window_gather", replay.window_gather))
    eng, rep = run_power_law(device=cuda_device, shards=2, **kw)
    own = {r.stream.cuda_stream for r in eng._runners}
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert len(own) == 2 and default not in own
    for name, seen in streams.items():
        assert seen and set(seen) == own, name
    monkeypatch.undo()

    def decisions(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS and k != "device"}
    for e2, r2 in (run_power_law(device="cpu", shards=2, **kw),
                   run_power_law(device=cuda_device, **kw)):
        assert _serve_fingerprint(e2) == _serve_fingerprint(eng)
        assert decisions(r2) == decisions(rep)
        assert [repr(v.to_dict()) for v in e2.rca_verdicts] \
            == [repr(v.to_dict()) for v in eng.rca_verdicts]
        assert e2.flight_recorder.canonical_bytes() \
            == eng.flight_recorder.canonical_bytes()
    assert rep.n_alerts > 0 and rep.n_rca_runs > 0


_SMALL_SERVE = dict(n_tenants=8, n_services=6, capacity_spans_per_s=2000,
                    overload=2.0, duration_s=60, tick_s=1.0, seed=3,
                    window_s=5.0, baseline_windows=4, fault_tenants=2,
                    buckets=(64, 256), lane_buckets=(1, 2, 4),
                    max_backlog=3000, n_windows=16, flight=True,
                    flight_digest_every=4, ckpt_every=4)


def _decisions(rep, skip=()):
    import dataclasses

    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS
    return {k: v for k, v in dataclasses.asdict(rep).items()
            if k not in VARIANT_REPORT_FIELDS + tuple(skip)
            and k != "device"}


@pytest.mark.cuda
def test_process_serve_on_card_equals_thread_run(cuda_device):
    """2 shard processes on the card (each child its own CUDA context,
    pool and runner) equal 2 shard threads on the card: alert streams,
    decisions and the canonical flight journal; the children launch the
    lane kernel, and their replies carry the counts home."""
    import dataclasses

    from anomod_torch.serve.engine import run_power_law
    te, tr = run_power_law(device=cuda_device, shards=2, **_SMALL_SERVE)
    pe, pr = run_power_law(device=cuda_device, shards=2, worker="process",
                           **_SMALL_SERVE)
    assert pr.worker == "process" and tr.worker == "thread"
    assert pr.n_alerts > 0 and _decisions(pr) == _decisions(tr)
    for tid in te._tenant_det:
        assert [dataclasses.asdict(a) for a in pe.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in te.alerts_for(tid)]
    assert pe.flight_recorder.canonical_bytes() \
        == te.flight_recorder.canonical_bytes()
    assert pe.worker_launches.get("lane_delta", 0) > 0
    assert pe.worker_launches.get("window_gather", 0) > 0
    assert pe._workers is None


@pytest.mark.cuda
def test_chaos_recovery_on_card_equals_fault_free(cuda_device):
    """A small run under a worker kill, a score-phase exception and a
    pool-put failure, on the card at 1 and 2 shards: restored from the
    checkpoint (a put on the shard runner's stream, synced) and
    re-executed, it equals the fault-free card run on states, alerts,
    decisions and the canonical journal."""
    from anomod_torch.serve.engine import (RECOVERY_REPORT_FIELDS,
                                           run_power_law)
    for shards, script in ((1, "crash@6;except@13:phase=score;poolput@21"),
                           (2, "crash@6:shard=1;except@13:phase=score;"
                               "poolput@21:shard=1")):
        e0, r0 = run_power_law(device=cuda_device, shards=shards,
                               **_SMALL_SERVE)
        e1, r1 = run_power_law(device=cuda_device, shards=shards,
                               chaos=script, **_SMALL_SERVE)
        assert r1.n_shard_crashes == 3 and r1.n_restored_ticks > 0
        assert r1.n_respawns == (1 if shards == 2 else 0)
        assert _serve_fingerprint(e1) == _serve_fingerprint(e0)
        assert _decisions(r1, RECOVERY_REPORT_FIELDS) \
            == _decisions(r0, RECOVERY_REPORT_FIELDS)
        assert e1.flight_recorder.canonical_bytes() \
            == e0.flight_recorder.canonical_bytes()


@pytest.mark.cuda
def test_lane_delta_from_threads_at_mixed_lane_counts(cuda_device):
    """Serve shard threads launch the lane kernel at once, each on its
    own stream and at its own lane count, so at its own shared-memory
    size (the cap is one per kernel for the process): every launch
    succeeds and equals the plain version bit for bit.  (Before the C
    entry held one lock over the cap's set and the launch, 8 x 200
    launches failed here in one of two runs.)"""
    import threading

    from anomod_torch.ops import serve_kernels as sk
    sw, w = 384, 4096
    cases = []
    for i, lanes in enumerate((1, 32, 2, 16, 1, 32, 4, 8)):
        sid, planes = zip(*(_inputs(w, sw, 100 * i + j)
                            for j in range(lanes)))
        sid, planes = np.stack(sid), np.stack(planes)
        want = sk.lane_delta_plain(torch.from_numpy(sid),
                                   torch.from_numpy(planes), sw, H)
        cases.append((torch.from_numpy(sid).to(cuda_device),
                       torch.from_numpy(planes).to(cuda_device), want))
    torch.cuda.synchronize()
    errors, outs = [], [None] * len(cases)

    def work(k):
        sid, planes, _ = cases[k]
        stream = torch.cuda.Stream(cuda_device)
        try:
            with torch.cuda.stream(stream):
                for _ in range(1000):
                    out = sk.lane_delta(sid, planes, sw, H)
                stream.synchronize()
            outs[k] = out.cpu()
        except Exception as e:      # noqa: BLE001 - asserted below
            errors.append(repr(e))
    threads = [threading.Thread(target=work, args=(k,))
               for k in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for out, (_, _, want) in zip(outs, cases):
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_deferred_tick_on_card_leaves_dispatches_in_flight(cuda_device,
                                                           monkeypatch):
    """The deferred-commit tick on the card, 2 shard threads at pipeline
    2: at each barrier the issued tick's last dispatches are still in
    their runners' in-flight queues (the issue half submitted on the
    shard streams without waiting), the deferral wall is above 0, and
    states, alerts, decisions and the canonical journal equal the
    synchronous card run's."""
    from anomod_torch.serve import engine as eng_mod
    from anomod_torch.serve.engine import (ASYNC_REPORT_FIELDS,
                                           run_power_law)
    seen = []
    real = eng_mod.ServeEngine._commit_deferred

    def commit(self):
        if self._deferred is not None and self._deferred["pending"]:
            seen.append(sum(r.inflight_dispatches for r in self._runners))
        return real(self)
    monkeypatch.setattr(eng_mod.ServeEngine, "_commit_deferred", commit)
    ea, ra = run_power_law(device=cuda_device, shards=2, pipeline=2,
                           async_commit=True, **_SMALL_SERVE)
    monkeypatch.undo()
    es, rs = run_power_law(device=cuda_device, shards=2, pipeline=2,
                           async_commit=False, **_SMALL_SERVE)
    assert ra.async_commit and ra.async_ticks == ra.ticks
    assert ra.commit_defer_wall_s > 0 and rs.commit_defer_wall_s == 0
    assert seen and max(seen) > 0
    assert all(r.inflight_dispatches == 0 for r in ea._runners)
    assert _serve_fingerprint(ea) == _serve_fingerprint(es)
    assert _decisions(ra, ASYNC_REPORT_FIELDS) \
        == _decisions(rs, ASYNC_REPORT_FIELDS)
    assert ea.flight_recorder.canonical_bytes() \
        == es.flight_recorder.canonical_bytes()


@pytest.mark.cuda
def test_scale_up_on_card_builds_runner_on_own_stream(cuda_device,
                                                      monkeypatch):
    """A scripted scale-up mid-run on the card builds shard 1's runner on
    a stream of its own (not shard 0's, not the default one), the lane
    kernel launches from both shard streams only, and the elastic run
    (up at tick 5, down at tick 15) equals the static card run on states,
    alerts, decisions and the canonical journal."""
    from anomod_torch.serve import batcher
    from anomod_torch.serve import engine as eng_mod
    from anomod_torch.serve.engine import (POLICY_REPORT_FIELDS,
                                           run_power_law)
    built, launched = [], []
    real = eng_mod.ServeEngine._scale_up

    def scale_up(self):
        moved = real(self)
        built.append(self._runners[-1].stream.cuda_stream)
        return moved

    def spy(*a, **k):
        launched.append(torch.cuda.current_stream(cuda_device).cuda_stream)
        return lane_delta(*a, **k)
    lane_delta = batcher.lane_delta
    monkeypatch.setattr(eng_mod.ServeEngine, "_scale_up", scale_up)
    monkeypatch.setattr(batcher, "lane_delta", spy)
    ee, re_ = run_power_law(device=cuda_device, shards=1, policy="script",
                            policy_script="up@5;down@15", min_shards=1,
                            max_shards=2, **_SMALL_SERVE)
    stream0 = ee._runners[0].stream.cuda_stream
    monkeypatch.undo()
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert re_.n_scale_ups == 1 and re_.n_scale_downs == 1
    assert re_.peak_shards == 2 and re_.n_policy_migrations > 0
    assert len(built) == 1 and built[0] not in (stream0, default)
    assert set(launched) == {stream0, built[0]}
    es, rs = run_power_law(device=cuda_device, shards=1, **_SMALL_SERVE)
    assert _serve_fingerprint(ee) == _serve_fingerprint(es)
    assert _decisions(re_, POLICY_REPORT_FIELDS) \
        == _decisions(rs, POLICY_REPORT_FIELDS)
    assert ee.flight_recorder.canonical_bytes() \
        == es.flight_recorder.canonical_bytes()


@pytest.mark.cuda
def test_tier_round_trip_through_card_pool_is_bit_equal(cuda_device,
                                                        tmp_path):
    """A tenant state demoted out of the card's pool and promoted back
    into another slot (through the host warm tier, then through a cold
    entry on disk) is bit-equal; and a tiered run on the card (warm and
    cold demotions, promotions and misses all firing) equals the
    never-evicted card run on every state, alert and the SLO."""
    import dataclasses

    from anomod_torch.obs.flight import state_digest
    from anomod_torch.serve.batcher import BucketRunner, PooledStreamReplay
    from anomod_torch.serve.engine import run_power_law, serve_plane_cfg
    from anomod_torch.serve.supervise import restore_replay, snapshot_replay
    from anomod_torch.serve.tiering import TierPlane
    cfg = serve_plane_cfg(4, 5.0, 16)
    runner = BucketRunner(cfg, (64, 256), pool_slots=2, device=cuda_device,
                          own_stream=True)
    rng = np.random.default_rng(11)
    rep = PooledStreamReplay(cfg, 0, runner)
    with runner.on_stream():
        rep.set_state(type(rep.get_state())(
            agg=rng.random((cfg.sw, 6), dtype=np.float32),
            hist=rng.random((cfg.sw, H), dtype=np.float32)))
        want = snapshot_replay(rep)
    for cold in (False, True):
        tier = TierPlane(0 if cold else 1 << 20,
                         tmp_path / "cold" if cold else None, 1,
                         slot_nbytes=cfg.sw * (6 + H) * 4)
        with runner.on_stream():
            snap = snapshot_replay(rep)
            rep.release()
        tier.demote(0, 7, snap, None, 1)
        assert tier.status(7) == ("cold" if cold else "warm")
        tier.prefetch(7)
        back, _ = tier.take(1, 7)
        rep = PooledStreamReplay(cfg, 0, runner)
        with runner.on_stream():
            restore_replay(rep, back)
            got = snapshot_replay(rep)
        runner.sync()
        tier.close()
        for a, b in zip(got["state"], want["state"]):
            assert (a is None and b is None) or np.array_equal(a, b)
    kw = dict(n_tenants=24, n_services=4, capacity_spans_per_s=400,
              overload=0.4, duration_s=24, tick_s=1.0, seed=7, window_s=5.0,
              baseline_windows=2, fault_tenants=0, buckets=(64, 256),
              lane_buckets=(1, 2, 4), max_backlog=1500, n_windows=16,
              flight_digest_every=4)
    e0, r0 = run_power_law(device=cuda_device, **kw)
    e1, r1 = run_power_law(device=cuda_device, tier_hot=4,
                           tier_demote_after=2, tier_warm_bytes=4096,
                           tier_prefetch=2,
                           tier_cold_dir=str(tmp_path / "run"), **kw)
    assert min(r1.n_tier_demotions_warm, r1.n_tier_demotions_cold,
               r1.n_tier_promotions, r1.n_tier_misses) > 0
    assert len(e1._tier) == 0
    assert state_digest(e1._tenant_replay) == state_digest(e0._tenant_replay)
    for tid in e0._tenant_det:
        assert [dataclasses.asdict(a) for a in e1.alerts_for(tid)] \
            == [dataclasses.asdict(a) for a in e0.alerts_for(tid)]
    assert r1.latency == r0.latency and r1.shed_spans == r0.shed_spans


@pytest.mark.cuda
def test_dogfood_feed_on_card_live_equals_replay(cuda_device, tmp_path):
    """The live feed's dogfood loop on the card (the port's own
    ``/metrics`` scraped each tick, ``tests/test_feed.py``'s sizes):
    recorded live, then replayed from its wire journal on the card, with
    the lane kernel launched; both give the same canonical journal,
    states, alerts, latency and shed."""
    from anomod_torch.obs.http import ObsHttpServer
    from anomod_torch.obs.registry import Registry, get_registry, set_registry
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve.feed import run_live_feed
    kw = dict(capacity_spans_per_s=2000.0, duration_s=6.0, tick_s=1.0,
              window_s=2.0, baseline_windows=2, buckets=(64,), n_windows=16,
              flight=True, flight_digest_every=2, device=cuda_device)
    wire = tmp_path / "wire.json"
    prev = get_registry()
    set_registry(Registry(enabled=True))
    try:
        sk.reset_launches()
        with ObsHttpServer(port=0) as srv:
            ea, ra, fa = run_live_feed(scrape_url=f"{srv.url}/metrics",
                                       n_tenants=4, n_services=4,
                                       journal=wire, **kw)
        eb, rb, fb = run_live_feed(replay=wire, **kw)
    finally:
        set_registry(prev)
    assert sk.launches["lane_delta"] > 0 and ra.served_spans > 0
    assert fb.transport.n_served == fa.n_polls == 6
    assert ea.flight_recorder.canonical_bytes() \
        == eb.flight_recorder.canonical_bytes()
    assert (ra.served_spans, ra.shed_fraction, ra.latency) \
        == (rb.served_spans, rb.shed_fraction, rb.latency)
    assert _serve_fingerprint(ea) == _serve_fingerprint(eb)


@pytest.mark.cuda
def test_multimodal_sidecar_on_card_equals_cpu(cuda_device):
    """The multimodal sidecar on the card (``tests/test_serve.py``'s run:
    ``Svc_Kill_UserTimeline``, 100 traces, 60 s ticks) equals its CPU
    twin on the alert list, ``modality_events`` and the canonical
    journal, with the lane kernel launched."""
    import dataclasses

    from anomod_torch import labels, synth
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    from anomod_torch.serve.queues import TenantSpec
    from anomod_torch.serve.traffic import ScriptedTraffic
    label = labels.label_for("Svc_Kill_UserTimeline")
    exp = synth.generate_experiment(label, n_traces=100, seed=0)
    t0 = int(exp.spans.start_us.min())
    specs = [TenantSpec(tenant_id=0, name="t0")]
    runs = []
    for dev in (cuda_device, "cpu"):
        traffic = ScriptedTraffic({0: exp.spans}, specs, t0,
                                  experiments={0: exp})
        eng = ServeEngine(
            specs, exp.spans.services,
            ReplayConfig(n_services=len(exp.spans.services),
                         chunk_size=4096),
            t0_us=t0, capacity_spans_per_s=10_000_000, tick_s=60.0,
            buckets=(256, 1024), max_backlog=10_000_000, baseline_windows=8,
            multimodal=True, testbed=label.testbed, device=dev)
        sk.reset_launches()
        rep = eng.run(traffic, duration_s=traffic.end_s() + 60.0)
        runs.append((eng, rep, dict(sk.launches)))
    (ec, rc, lc), (eh, rh, _) = runs
    assert lc["lane_delta"] > 0
    assert rc.modality_events == rh.modality_events
    assert min(rc.modality_events.values()) > 0
    assert ec.alerts_for(0) and [dataclasses.asdict(a)
                                 for a in ec.alerts_for(0)] \
        == [dataclasses.asdict(a) for a in eh.alerts_for(0)]
    assert ec.flight_recorder.canonical_bytes() \
        == eh.flight_recorder.canonical_bytes()


@pytest.mark.cuda
def test_sharded_replay_world_1_nccl_equals_single_card(cuda_device):
    """A world-1 NCCL group on the card: the sharded replay (the dense
    kernel and the one-hot product a rank, the HLL plane) equals the
    single-card fold, the dense kernel and the HLL kernel launched from
    the sharded path."""
    from anomod_torch import labels, synth
    from anomod_torch.ops import sketch_kernels as skk
    from anomod_torch.parallel import (launch, make_mesh,
                                       make_sharded_replay_fn, stage_sharded)
    from anomod_torch.replay import ReplayConfig, make_replay_fn, stage_columns
    from anomod_torch.schemas import concat_span_batches
    batch = concat_span_batches([synth.generate_spans(l, n_traces=30)
                                 for l in labels.labels_for_testbed("TT")])
    cfg = ReplayConfig(n_services=batch.n_services, chunk_size=512)
    chunks, n = stage_columns(batch, cfg)
    single = make_replay_fn(cfg, device=cuda_device, with_hll=True)(chunks)

    def body():
        mesh = make_mesh(1)
        assert (mesh.backend, mesh.device.type) == ("nccl", "cuda")
        shard, n_shard = stage_sharded(batch, mesh, cfg)
        assert n_shard == n
        out = {}
        for kernel in ("cuda", "matmul"):
            before = (rk.launches["replay_dense"], skk.launches["hll_update"])
            st = make_sharded_replay_fn(cfg, mesh, kernel=kernel,
                                        with_hll=True)(shard)
            out[kernel] = (torch.cat([st.agg, st.hist], 1).cpu(),
                           st.hll.cpu(),
                           (rk.launches["replay_dense"] - before[0],
                            skk.launches["hll_update"] - before[1]))
        return out

    res = launch(body, 1, device=cuda_device)[0]
    want = torch.cat([single.agg, single.hist], 1)
    for kernel, (acc, hll, launched) in res.items():
        _assert_planes(acc, want)
        assert torch.equal(hll, single.hll.cpu()), kernel
        assert float(acc[:, 0].double().sum()) == n
        assert launched == ((1, 1) if kernel == "cuda" else (0, 1)), kernel
    assert not torch.distributed.is_initialized()


#: the sends and collectives a group of one must never issue
_COMM_OPS = ("batch_isend_irecv", "isend", "irecv", "send", "recv",
             "all_reduce", "all_gather", "all_gather_into_tensor",
             "all_to_all_single", "reduce_scatter_tensor")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ppermute", "all_to_all", "copy_to",
                                  "reduce_from", "gather_from"])
def test_differentiable_collective_at_group_size_1_sends_nothing(
        cuda_device, monkeypatch, name):
    """In a world-1 NCCL group on the card each differentiable collective
    is the identity forward and backward, and issues no send, receive or
    collective (NCCL is never asked to send to itself)."""
    import torch.distributed as dist
    from anomod_torch.parallel import collectives as coll
    from anomod_torch.parallel import launch
    from anomod_torch.parallel.train import make_mesh2d
    calls = []

    def body():
        mesh = make_mesh2d(1)
        group = mesh.axis_group("model")
        fn = {"ppermute": lambda x: coll.ppermute(x, mesh, "data"),
              "all_to_all": lambda x: coll.all_to_all(x, mesh, "model", 1, 0),
              "copy_to": lambda x: coll.copy_to(x, group),
              "reduce_from": lambda x: coll.reduce_from(x, group),
              "gather_from": lambda x: coll.gather_from(x, group, 1)}[name]
        g = torch.Generator(device=cuda_device).manual_seed(7)
        x = torch.randn((8, 6, 4), device=cuda_device, generator=g,
                        requires_grad=True)
        up = torch.randn((8, 6, 4), device=cuda_device, generator=g)
        for op in _COMM_OPS:
            monkeypatch.setattr(dist, op,
                                lambda *a, _op=op, **k: calls.append(_op))
        try:
            y = fn(x)
            (grad,) = torch.autograd.grad(y, x, up)
        finally:
            monkeypatch.undo()
        return torch.equal(y, x), torch.equal(grad, up)

    assert launch(body, 1, device=cuda_device)[0] == (True, True)
    assert calls == []


@pytest.mark.cuda
def test_dryrun_multichip_world_1_on_card_launches_the_kernels(cuda_device):
    """``graft_entry.dryrun_multichip(1)`` on the card: every plane's
    step passes its check, the dense fold and the HLL kernel launched
    from its sharded replay and stream."""
    from anomod_torch.graft_entry import dryrun_multichip
    from anomod_torch.ops import sketch_kernels as skk
    before = (rk.launches["replay_dense"], skk.launches["hll_update"])
    run = dryrun_multichip(1, device=cuda_device)
    assert (run["n_devices"], run["device"]) == (1, "cuda")
    assert run["mesh2d"] == {"data": 1, "model": 1}
    assert rk.launches["replay_dense"] > before[0]
    assert skk.launches["hll_update"] > before[1]
    assert not torch.distributed.is_initialized()


# -- the device decisions -------------------------------------------------------

@pytest.mark.cuda
def test_probe_answers_cuda_on_the_card(cuda_device, monkeypatch):
    from anomod_torch.utils import platform
    monkeypatch.delenv("ANOMOD_SKIP_PROBE", raising=False)
    assert platform.probe_device_platform()[0] == "cuda"
    assert platform.ensure_live_backend() == "probe ok: cuda"


@pytest.mark.cuda
def test_failover_leaves_a_real_out_of_memory_on_the_card(cuda_device):
    from anomod_torch.utils import platform
    calls = []

    def oom(d):
        calls.append(d.type)
        total = torch.cuda.get_device_properties(d).total_memory
        return torch.empty(2 * total, dtype=torch.uint8, device=d)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        platform.with_cpu_failover(oom, cuda_device, allow=True)
    assert calls == ["cuda"]


@pytest.mark.cuda
def test_knobs_refuse_jax_formulations_before_a_launch(cuda_device,
                                                       monkeypatch):
    from anomod_torch import replay
    from anomod_torch.config import set_config
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.ops import sketch_kernels as skk
    from anomod_torch.serve.batcher import BucketRunner
    cfg = replay.ReplayConfig(n_services=4)
    batch = replay_corpus_for_knobs()
    prev = set_config(None)
    try:
        sk.reset_launches()
        skk.reset_launches()
        for v in ("matmul", "scatter"):
            monkeypatch.setenv("ANOMOD_SERVE_LANE_ENGINE", v)
            set_config(None)
            with pytest.raises(ValueError, match="names a JAX formulation"):
                BucketRunner(cfg, device=cuda_device)
        for v in ("auto", "pallas", "PALLAS"):
            monkeypatch.setenv("ANOMOD_SERVE_LANE_ENGINE", v)
            set_config(None)
            BucketRunner(cfg, device=cuda_device)
        for v in ("host", "xla"):
            monkeypatch.setenv("ANOMOD_TDIGEST_ENGINE", v)
            set_config(None)
            with pytest.raises(ValueError, match="ANOMOD_TDIGEST_ENGINE"):
                replay.replay_percentiles(batch, device=cuda_device)
        assert not any(sk.launches.values()) \
            and not any(skk.launches.values())
        monkeypatch.setenv("ANOMOD_TDIGEST_ENGINE", "PALLAS")
        set_config(None)
        got = replay.replay_percentiles(batch, device=cuda_device)
        assert skk.launches["tdigest_reduce"] > 0
        monkeypatch.delenv("ANOMOD_TDIGEST_ENGINE")
        set_config(None)
        np.testing.assert_array_equal(
            got, replay.replay_percentiles(batch, device=cuda_device))
    finally:
        set_config(prev)


def replay_corpus_for_knobs():
    from anomod_torch import labels, synth
    from anomod_torch.schemas import concat_span_batches
    return concat_span_batches([synth.generate_spans(l, n_traces=10)
                                for l in labels.labels_for_testbed("TT")])
