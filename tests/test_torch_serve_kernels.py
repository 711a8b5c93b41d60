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
