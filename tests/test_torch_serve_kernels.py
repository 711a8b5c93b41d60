"""The serve-tick kernels' plain PyTorch versions against the JAX package.

On the CPU the wrappers take their plain versions: ``lane_delta_plain``
(an ``index_add_`` over the scatter engine's 25-column payload, which on
the CPU adds each segment's rows in row order, as XLA:CPU's segment sum
does) and ``window_gather_plain`` (advanced indexing).  The CUDA kernels
are held against these on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).

Tolerances: against the JAX scatter engine and the Pallas window gather,
bit equality.  Against the Pallas lane kernel (interpret mode), whose
moments carry the bf16 hi/lo envelope of one-hot MXU products: exact
planes and histogram equal, moments within ``rtol=2e-3, atol=1e-2``, the
envelope ``tests/test_replay.py`` holds that kernel to.
"""

import jax
import numpy as np
import pytest
import torch

from anomod.ops.pallas_replay import make_pallas_window_gather_fn
from anomod.replay import ReplayConfig as JReplayConfig
from anomod.replay import make_lane_delta as jmake_lane_delta
from anomod_torch.ops import serve_kernels as sk
from anomod_torch.replay import (ReplayConfig, make_lane_delta,
                                 stage_lane_planes)

H = 16


def _chunks(L, W, n_services, n_windows, seed, dead=()):
    """Lane-stacked staged chunk columns ([L, W] each) from numpy: ids in
    [0, SW] with dead-lane padding, and the given lanes all dead."""
    sw = n_services * n_windows
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, sw + 1, (L, W)).astype(np.int32)
    for lane in dead:
        sid[lane] = sw
    valid = (sid < sw).astype(np.float32)
    dur_raw = (rng.lognormal(8.0, 1.2, (L, W)).astype(np.float32) * valid)
    dur = np.log1p(dur_raw).astype(np.float32)
    err = ((rng.random((L, W)) < 0.1) * valid).astype(np.float32)
    s5 = ((rng.random((L, W)) < 0.05) * valid).astype(np.float32)
    return dict(sid=sid, dur=dur, dur_raw=dur_raw, err=err, s5=s5,
                valid=valid, tid=np.zeros((L, W), np.int32))


def _torch(chunks):
    return {k: torch.from_numpy(v) for k, v in chunks.items()}


@pytest.mark.parametrize("L,W,dead", [(1, 64, ()), (4, 256, (2,)),
                                      (8, 1024, (0, 7))])
def test_lane_delta_plain_bit_equal_to_jax_scatter(L, W, dead):
    """Per lane, bit for bit: the scatter engine's row-order sums, with
    hi + lo taken at the end; dead lanes exact zeros."""
    S, Wn = 12, 32
    ch = _chunks(L, W, S, Wn, seed=L * 7 + W, dead=dead)
    jcfg = JReplayConfig(n_services=S, n_windows=Wn, chunk_size=W)
    da, dh = map(np.asarray,
                 jax.jit(jmake_lane_delta(jcfg, engine="scatter"))(ch))
    ta, th = make_lane_delta(ReplayConfig(n_services=S, n_windows=Wn,
                                          chunk_size=W))(_torch(ch))
    assert ta.numpy().tobytes() == da.tobytes()
    assert th.numpy().tobytes() == dh.tobytes()
    for lane in dead:
        assert (ta[lane] == 0).all() and (th[lane] == 0).all()


def test_lane_delta_independent_of_lane_count_and_position():
    sid, planes = stage_lane_planes(
        _torch(_chunks(6, 256, 5, 6, seed=3, dead=(4,))))
    full = sk.lane_delta(sid, planes, 30, H)
    for lane in range(6):
        one = sk.lane_delta(sid[lane:lane + 1].contiguous(),
                            planes[lane:lane + 1].contiguous(), 30, H)
        assert torch.equal(one[0], full[lane])
    flipped = sk.lane_delta(sid.flip(0).contiguous(),
                            planes.flip(0).contiguous(), 30, H)
    assert torch.equal(flipped.flip(0), full)


def test_lane_delta_plain_vs_pallas_interpret():
    """The Pallas lane kernel (interpret mode) on the same lanes: exact
    planes and histogram equal, moments inside its bf16 envelope."""
    cfg = JReplayConfig(n_services=5, n_windows=6, window_us=5_000_000,
                        chunk_size=256)
    ch = _chunks(4, 256, 5, 6, seed=9, dead=(3,))
    pa, ph = map(np.asarray,
                 jax.jit(jmake_lane_delta(cfg, engine="pallas"))(ch))
    ta, th = make_lane_delta(ReplayConfig(
        n_services=5, n_windows=6, window_us=5_000_000,
        chunk_size=256))(_torch(ch))
    ta, th = ta.numpy(), th.numpy()
    np.testing.assert_array_equal(ta[..., :3], pa[..., :3])
    np.testing.assert_array_equal(th, ph)
    np.testing.assert_allclose(ta[..., 3:6], pa[..., 3:6], rtol=2e-3,
                               atol=1e-2)
    assert (ta[3] == 0).all() and (th[3] == 0).all()


@pytest.mark.parametrize("T", [1, 5, 64])
def test_window_gather_plain_bit_equal_to_pallas(T):
    S, Wn, P = 12, 32, 21
    rng = np.random.default_rng(T)
    pool = rng.normal(size=(P, S * Wn, 6)).astype(np.float32)
    slots = rng.integers(0, P, T).astype(np.int32)
    cols = rng.integers(0, Wn, T).astype(np.int32)
    want = np.asarray(make_pallas_window_gather_fn(S, Wn, 6, interpret=True)(
        pool, slots, cols))
    got = sk.window_gather(torch.from_numpy(pool), torch.from_numpy(slots),
                           torch.from_numpy(cols), S, Wn).numpy()
    assert got.tobytes() == want.tobytes()


def test_cpu_tensors_do_not_count_launches():
    sk.reset_launches()
    ch = _torch(_chunks(2, 64, 3, 4, seed=1))
    make_lane_delta(ReplayConfig(n_services=3, n_windows=4,
                                 chunk_size=64))(ch)
    sk.window_gather(torch.zeros((2, 12, 6)), torch.zeros(1, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), 3, 4)
    assert sk.launches == {"lane_delta": 0, "window_gather": 0}


def test_wrappers_validate_inputs():
    sid = torch.zeros((2, 8), dtype=torch.int32)
    planes = torch.zeros((2, 6, 8))
    with pytest.raises(TypeError):
        sk.lane_delta(sid.long(), planes, 4, H)
    with pytest.raises(ValueError):
        sk.lane_delta(sid, planes[:, :5].contiguous(), 4, H)
    with pytest.raises(ValueError):
        sk.lane_delta(sid[0], planes, 4, H)
    with pytest.raises(ValueError):
        sk.window_gather(torch.zeros((2, 12, 6)),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 3, 5)
    with pytest.raises(TypeError):
        sk.window_gather(torch.zeros((2, 12, 6)),
                         torch.zeros(1, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int32), 3, 4)


def _bf16_numpy(x):
    """f32 -> bf16 -> f32, round to nearest even, on the bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _lane_delta_sorted_numpy(sid, planes, n_segments, n_hist, rows=2048,
                             warps=16):
    """The redesigned lane kernel's order of operations, in numpy.

    Per lane, the rows stream in tiles of ``rows``.  In each tile the live
    rows (``0 <= sid < SW``) are placed by a stable counting sort: each of
    ``warps`` contiguous chunks counts its rows per segment, a prefix over
    the chunks and then over the segments gives each chunk's start in a
    segment, and a row's slot adds its rank among the chunk's earlier rows
    of its segment.  Then every (segment, column) adds the rows of its
    slots, in slot order, into an f32 accumulator that starts at +0.0 and
    carries across tiles: the 9 payload columns (bf16 exact planes, bf16
    hi and lo of each moment) and the H histogram columns (bf16(valid) at
    the row's bucket, +0.0 elsewhere).  hi + lo is taken last.  All lanes
    run at once, their (lane, segment) pairs as the keys."""
    L, W = sid.shape
    F = 9 + n_hist
    SW1 = n_segments + 1
    exact = _bf16_numpy(planes[:, 0:3])                    # [L, 3, W]
    hi = _bf16_numpy(planes[:, 3:6])
    lo = _bf16_numpy(planes[:, 3:6] - hi)
    bucket = np.clip(planes[:, 4].astype(np.int32), 0, n_hist - 1)
    hist = np.zeros((L, n_hist, W), np.float32)
    np.put_along_axis(hist, bucket[:, None], exact[:, 0:1], axis=1)
    pay = np.concatenate([exact, hi, lo, hist], axis=1).transpose(0, 2, 1)
    acc = np.zeros((L * SW1, F), np.float32)
    chunk = rows // warps
    for base in range(0, W, rows):
        rid = np.arange(base, min(W, base + rows))
        s = sid[:, rid]
        live = (s >= 0) & (s < n_segments)
        key = np.where(live, np.arange(L)[:, None] * SW1 + s, -1).ravel()
        lane_of = np.repeat(np.arange(L), len(rid))
        row_of = np.tile(rid, L)
        warp_of = np.tile((rid - base) // chunk, L)
        keep = key >= 0
        key, lane_of, row_of, warp_of = (a[keep] for a in
                                         (key, lane_of, row_of, warp_of))
        # 1. per-chunk counts; 2. prefix over chunks, then over segments
        wcnt = np.zeros((warps, L * SW1), np.int64)
        np.add.at(wcnt, (warp_of, key), 1)
        woff = np.cumsum(wcnt, axis=0) - wcnt
        cnt = wcnt.sum(axis=0)
        start = np.cumsum(cnt) - cnt
        # 3. slot = start + earlier chunks + rank among earlier peers
        rank = np.zeros(len(key), np.int64)
        seen = {}
        for j, kw in enumerate(zip(key.tolist(), warp_of.tolist())):
            rank[j] = seen.get(kw, 0)
            seen[kw] = rank[j] + 1
        slot = start[key] + woff[warp_of, key] + rank
        order = np.empty(len(key), np.int64)
        order[slot] = np.arange(len(key))
        assert np.array_equal(order, np.argsort(key, kind="stable"))
        sorted_pay = pay[lane_of[order], row_of[order]]
        # 4. each (lane, segment) adds its rows in slot order, f32
        segs = np.flatnonzero(cnt)
        for j in range(int(cnt.max()) if len(segs) else 0):
            segs = segs[cnt[segs] > j]
            acc[segs] = acc[segs] + sorted_pay[start[segs] + j]
    acc = acc.reshape(L, SW1, F)[:, :n_segments]
    return np.concatenate([acc[..., 0:3], acc[..., 3:6] + acc[..., 6:9],
                           acc[..., 9:]], axis=-1)


def _adversarial_lanes(kind, L, W, S, Wn, seed):
    """Lane-stacked chunk columns whose live rows are: ``hot``, all in one
    segment; ``alternating``, alternating between two segments;
    ``dead``, none; ``spread``, spread over every segment.  Ragged dead
    tails on every other lane."""
    ch = _chunks(L, W, S, Wn, seed)
    sw = S * Wn
    sid = ch["sid"]
    if kind == "hot":
        sid[:] = sw // 3
    elif kind == "alternating":
        sid[:] = np.where(np.arange(W) % 2 == 0, 5, sw - 2)
    elif kind == "dead":
        sid[:] = sw
    for lane in range(0, L, 2):
        sid[lane, W - W // (lane + 2):] = sw
    valid = (sid < sw).astype(np.float32)
    for k in ("dur", "dur_raw", "err", "s5", "valid"):
        ch[k] = (ch[k] if k != "valid" else valid) * valid
    return ch


@pytest.mark.parametrize("kind,L,W", [
    ("hot", 1, 16384), ("hot", 7, 4096), ("alternating", 7, 16384),
    ("alternating", 32, 1024), ("dead", 1, 64), ("dead", 7, 256),
    ("spread", 32, 4096), ("spread", 1, 16384)])
def test_lane_sort_order_bit_equal_to_plain_and_jax_scatter(kind, L, W):
    """The kernel's stable counting sort and row-ordered walk, restated in
    numpy, give the same bytes as the plain version (the host's
    row-ordered index_add_) and as the JAX scatter engine, on adversarial
    lanes up to the widest serve bucket."""
    S, Wn = 12, 32
    ch = _adversarial_lanes(kind, L, W, S, Wn, seed=L * 31 + W)
    sid, planes = stage_lane_planes(_torch(ch))
    got = _lane_delta_sorted_numpy(sid.numpy(), planes.numpy(), S * Wn, H)
    plain = sk.lane_delta_plain(sid, planes, S * Wn, H).numpy()
    assert got.tobytes() == plain.tobytes()
    jcfg = JReplayConfig(n_services=S, n_windows=Wn, chunk_size=W)
    da, dh = map(np.asarray,
                 jax.jit(jmake_lane_delta(jcfg, engine="scatter"))(ch))
    assert got[..., :6].tobytes() == da.tobytes()
    assert got[..., 6:].tobytes() == dh.tobytes()
    if kind == "dead":
        assert not got.any()
    if kind == "hot":
        assert np.count_nonzero(got[..., 0].sum(axis=0)) == 1


@pytest.mark.parametrize("L,SW,n_sm,limit,want", [
    (32, 384, 132, 10_000, 43), (1, 384, 132, 10_000, 32),
    (7, 384, 132, 10_000, 32), (300, 384, 132, 10_000, 384),
    (32, 20, 132, 10_000, 20), (1, 4320, 132, 100, 32),
    (1, 20000, 132, 100, 76), (1, 4320, 1, 100, 100)])
def test_lane_segments_per_block(L, SW, n_sm, limit, want):
    """Blocks own few enough segments to give each SM two blocks at L
    lanes, at least 32 (or all SW), at most what shared memory holds."""
    assert sk.lane_segments_per_block(L, SW, n_sm, limit) == want


def test_lane_segments_per_block_raises_when_nothing_fits():
    with pytest.raises(ValueError):
        sk.lane_segments_per_block(4, 384, 132, 0)
