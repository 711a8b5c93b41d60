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
    """SW = 4320: the streaming detector's 3S = 135-service id space, two
    shared-memory tiles on the card."""
    SW = 4320
    sid, planes = _inputs(6000, SW, seed=4)
    got = rk.replay_dense(torch.from_numpy(sid), torch.from_numpy(planes),
                          SW, H).numpy()
    _assert_planes(got, pallas_replay_numpy(sid, planes, SW, H))
    assert rk.dense_grid(6000, SW, H, n_sm=132)[1:] == (2, 2160)
    assert rk.dense_grid(475_000, 1440, H, n_sm=132) == (132, 1, 1440)


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

