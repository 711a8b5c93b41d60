"""The replay fold kernels' plain PyTorch versions against the JAX kernels.

On the CPU the wrappers take their plain versions (``index_add_`` over the
bf16-rounded payload); the CUDA kernels themselves are held against those
plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Tolerance: count / err / 5xx / histogram
planes are small-integer f32 sums and must be EQUAL; the moment planes are
f32 sums taken in another order than the JAX kernels' and agree to
``rtol=1e-5, atol=1e-3``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from anomod.ops.pallas_replay import (make_pallas_replay_fn,
                                      make_pallas_replay_sorted_fn,
                                      pallas_replay_numpy)
from anomod.ops.pallas_replay import stage_sorted_planes as jstage_sorted
from anomod_torch.ops import replay_kernels as rk

H = 16


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
    np.testing.assert_array_equal(got[:, :3], want[:, :3])     # exact
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])     # histogram
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6],      # moments
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("inner_repeats", [1, 2])
def test_dense_plain_matches_jax_kernel_and_oracle(inner_repeats):
    SW, BLOCK, n = 300, 512, 2048
    sid, planes = _inputs(n, SW, seed=1)
    jfn = make_pallas_replay_fn(SW, H, block=BLOCK, interpret=True,
                                inner_repeats=inner_repeats)
    want = np.asarray(jfn(sid, planes))
    got = rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes),
                          SW, H, inner_repeats=inner_repeats).numpy()
    assert got.shape == (SW, 6 + H)
    _assert_planes(got, want)
    _assert_planes(got, pallas_replay_numpy(sid, planes, SW, H)
                   * inner_repeats)
    _assert_planes(got, rk.replay_planes_numpy(sid, planes, SW, H)
                   * inner_repeats)


@pytest.mark.parametrize("n,n_services,n_windows", [
    (1024, 4, 16),          # the self-scrape's chunk: SW 64
    (4096, 135, 32),        # the stream's chunk: 3S = 135, SW 4320
], ids=["selfscrape", "stream_chunk"])
def test_dense_plain_bit_equal_to_jax_chunk_step(n, n_services, n_windows):
    """The port's plain dense fold sums each moment's bf16 hi and lo
    halves apart and adds them after the sum, as the JAX chunk step does:
    state + fold equals that step (both engines) bit for bit in every
    plane, on a chunk crowded onto a few segments, as a stream chunk is."""
    import jax
    import jax.numpy as jnp
    from anomod import replay as jreplay
    cfg = jreplay.ReplayConfig(n_services=n_services, n_windows=n_windows,
                               chunk_size=n)
    SW = cfg.sw
    sid, planes = _inputs(n, SW, seed=6)
    hot = np.random.default_rng(7).integers(0, SW, 40)
    sid = np.where(sid < SW, hot[sid % 40], SW).astype(np.int32)
    chunk = dict(sid=sid, valid=planes[0], err=planes[1], s5=planes[2],
                 dur_raw=planes[3], dur=planes[4])
    agg0 = np.random.default_rng(8).normal(
        size=(SW, 6)).astype(np.float32) * 100
    out = rk.replay_dense_plain(torch.from_numpy(sid),
                                torch.from_numpy(planes), SW, H).numpy()
    for engine in ("matmul", "scatter"):
        state, _ = jax.jit(jreplay.make_chunk_step(cfg, engine=engine))(
            jreplay.ReplayState(agg=jnp.asarray(agg0),
                                hist=jnp.zeros((SW, H), jnp.float32),
                                hll=None),
            {k: jnp.asarray(v) for k, v in chunk.items()})
        assert (agg0 + out[:, :6]).tobytes() == \
            np.asarray(state.agg).tobytes(), engine
        assert out[:, 6:].tobytes() == np.asarray(state.hist).tobytes()


def test_stage_sorted_planes_matches_jax():
    sid, planes = _inputs(3000, 600, seed=2)
    for a, b in zip(rk.stage_sorted_planes(sid, planes, 600, k=128,
                                           block=256),
                    jstage_sorted(sid, planes, 600, k=128, block=256)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sorted_plain_matches_jax_kernel():
    SW, K, BLOCK = 600, 128, 256
    sid, planes = _inputs(5000, SW, seed=3)
    sid_l, planes_s, wids = rk.stage_sorted_planes(sid, planes, SW, k=K,
                                                   block=BLOCK)
    jfn = make_pallas_replay_sorted_fn(SW, H, k=K, block=BLOCK,
                                       interpret=True, inner_repeats=2)
    want = np.asarray(jfn(sid_l, planes_s, wids))
    got = rk.replay_sorted(torch.from_numpy(sid_l),
                           torch.from_numpy(planes_s),
                           torch.from_numpy(wids), SW, H, k=K, block=BLOCK,
                           inner_repeats=2).numpy()
    _assert_planes(got, want)
    _assert_planes(got, pallas_replay_numpy(sid, planes, SW, H) * 2)


def test_empty_corpus_gives_zeros():
    SW = 1440
    z32 = torch.zeros(0, dtype=torch.int32)
    zp = torch.zeros((6, 0), dtype=torch.float32)
    dense = rk.replay_dense(z32, zp, SW, H)
    srt = rk.replay_sorted(z32, zp, z32, SW, H)
    for out in (dense, srt):
        assert out.shape == (SW, 6 + H)
        assert bool((out == 0).all())


def test_stream_id_space_matches_oracle():
    """SW = 4320: the streaming detector's 3S = 135-service id space, three
    shared-memory tiles on the card (a 9 + H accumulator row: 25 floats)."""
    SW = 4320
    sid, planes = _inputs(6000, SW, seed=4)
    got = rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes),
                          SW, H).numpy()
    _assert_planes(got, pallas_replay_numpy(sid, planes, SW, H))
    # the stream's chunk: owned slices, one launch; the corpus pass:
    # clusters of 8, 16 of them on a card that holds 16
    def cap(smem):
        return 16
    assert rk.dense_plan(4096, SW, H, 132, cap) == (False, 1, 131, 33)
    assert rk.dense_plan(491_520, 1440, H, 132, cap) == (True, 128, 1, 1440)
    assert rk.dense_plan(950_000, SW, H, 132, cap) == (True, 40, 3, 1440)
    assert rk.dense_stride(H) == 25


def test_cpu_tensors_do_not_count_launches():
    rk.reset_launches()
    sid, planes = _inputs(1024, 100, seed=5)
    rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes), 100, H)
    sid_l, planes_s, wids = rk.stage_sorted_planes(sid, planes, 100,
                                                   block=256)
    rk.replay_sorted(torch.from_numpy(sid_l), torch.from_numpy(planes_s),
                     torch.from_numpy(wids), 100, H, block=256)
    for mode in rk.ABLATION_ROWS:
        rk.replay_sorted_ablation(torch.from_numpy(sid_l),
                                  torch.from_numpy(planes_s),
                                  torch.from_numpy(wids), 100, mode,
                                  block=256)
    assert rk.launches == {"replay_dense": 0, "replay_sorted": 0,
                           "replay_sorted_counts": 0,
                           "replay_sorted_no_hist": 0}


def test_wrappers_validate_inputs():
    sid, planes = _inputs(64, 10, seed=6)
    with pytest.raises(TypeError):
        rk.replay_dense(torch.from_numpy(sid).long(),
                        torch.from_numpy(planes), 10, H)
    with pytest.raises(ValueError):
        rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes[:5]),
                        10, H)
    with pytest.raises(ValueError):
        rk.replay_sorted(torch.from_numpy(sid), torch.from_numpy(planes),
                         torch.zeros(1, dtype=torch.int32), 10, H, block=48)


def test_cuda_without_gpu_raises():
    from anomod_torch import resolve_device
    from anomod_torch.replay import ReplayConfig, dead_chunk
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dead_chunk(ReplayConfig(n_services=3))



@pytest.mark.parametrize("n,sw,seed", [(0, 1440, 0), (1, 1440, 1),
                                       (5000, 600, 2), (60_000, 1440, 3),
                                       (3000, 4320, 4)])
def test_sorted_staging_writes_wids_non_decreasing(n, sw, seed):
    """The sorted reductions find each window's staged blocks by binary
    search, which needs the staging's ``wids`` non-decreasing."""
    sid, planes = _inputs(n, sw, seed)
    _, _, wids = rk.stage_sorted_planes(sid, planes, sw, k=128, block=256)
    assert (np.diff(wids) >= 0).all()
    if n == 0:
        assert wids.size == 0


def test_sorted_wrappers_reject_wids_out_of_order():
    sid, planes = _inputs(3000, 600, 5)
    staged = [torch.from_numpy(a) for a in rk.stage_sorted_planes(
        sid, planes, 600, k=128, block=256)]
    assert staged[2].numel() > 1 and staged[2][0] < staged[2][-1]
    flipped = [*staged[:2], staged[2].flip(0).contiguous()]
    with pytest.raises(ValueError, match="non-decreasing"):
        rk.replay_sorted(*flipped, 600, H, block=256)
    for mode in rk.ABLATION_ROWS:
        with pytest.raises(ValueError, match="non-decreasing"):
            rk.replay_sorted_ablation(*flipped, 600, mode, block=256)


_PLAN_ARGS = dict(n=st.integers(0, 3_000_000), sw=st.integers(1, 60_000),
                  h=st.integers(1, 64), n_sm=st.integers(1, 200),
                  capacity=st.integers(1, 40))


@settings(max_examples=300, deadline=None, database=None)
@given(**_PLAN_ARGS)
def test_dense_plan_owns_every_segment_once_within_budget(n, sw, h, n_sm,
                                                          capacity):
    """Every segment lies in exactly one tile (or owned slice), and a
    block's accumulator fits the shared-memory budget."""
    plan = rk.dense_plan(n, sw, h, n_sm, lambda smem: capacity)
    assert plan.tile_w >= 1 and plan.n_tiles >= 1
    owner = np.minimum(np.arange(sw) // plan.tile_w, plan.n_tiles)
    assert owner.max() == plan.n_tiles - 1          # no tile past the last
    assert (plan.n_tiles - 1) * plan.tile_w < sw    # every tile non-empty
    assert plan.smem_bytes(h) <= rk.DENSE_SMEM_BYTES
    assert plan.smem_bytes(h) == (plan.tile_w * ((9 + h) | 1) * 4
                                  if plan.clustered else 0)


@settings(max_examples=300, deadline=None, database=None)
@given(**_PLAN_ARGS)
def test_dense_plan_clusters_and_small_inputs(n, sw, h, n_sm, capacity):
    """A clustered grid is a whole number of clusters that fit on the card
    at once with every tile (one cluster at least); a stream-sized input,
    the empty one included, takes one launch of owned slices."""
    plan = rk.dense_plan(n, sw, h, n_sm, lambda smem: capacity)
    if n <= rk.DENSE_SLICE_SPANS:
        assert not plan.clustered and plan.n_groups == 1
        assert plan.n_tiles <= n_sm
    else:
        assert plan.clustered and plan.n_parts % rk.DENSE_CLUSTER == 0
        assert plan.n_groups == plan.n_parts // rk.DENSE_CLUSTER >= 1
        assert plan.n_groups == 1 or plan.n_groups * plan.n_tiles <= capacity
        assert plan.n_groups <= -(-n // (rk.DENSE_CLUSTER
                                         * rk.DENSE_SPANS_PER_PART))


def test_dense_plan_raises_when_no_segment_fits():
    """A clustered block holds a tile of rows in shared memory; owned
    slices keep none (their rows are added in global memory)."""
    with pytest.raises(ValueError, match="no room"):
        rk.dense_plan(10**6, 100, rk.DENSE_SMEM_BYTES, 132, lambda smem: 16)
    plan = rk.dense_plan(10, 100, rk.DENSE_SMEM_BYTES, 132, lambda smem: 16)
    assert not plan.clustered and plan.smem_bytes(rk.DENSE_SMEM_BYTES) == 0


@pytest.mark.parametrize("n,sw", [(0, 1440), (0, 4320), (5, 4320)])
def test_dense_small_inputs_give_plain_planes(n, sw):
    """An empty or tiny corpus: the owned-slice plan's shapes give zeros
    where no span lands (the CPU takes the plain version)."""
    sid, planes = _inputs(n, sw, seed=n + sw)
    got = rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes),
                          sw, H).numpy()
    _assert_planes(got, rk.replay_planes_numpy(sid, planes, sw, H))
    assert not rk.dense_plan(n, sw, H, 132, lambda smem: 16).clustered
