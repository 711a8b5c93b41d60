"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports no JAX, so on the card it runs without the
suite's JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Tolerance: count / err / 5xx / histogram planes are small-integer f32 sums
and must be EQUAL; the moment planes are f32 sums taken in another order
(shared-memory atomics in the kernel, ``index_add_`` in the plain version)
and agree to ``rtol=1e-4, atol=1e-3`` at these sizes.
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
def test_empty_corpus_gives_zeros_on_card(cuda_device):
    z32 = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    zp = torch.zeros((6, 0), dtype=torch.float32, device=cuda_device)
    for out in (rk.replay_dense(z32, zp, 1440, H),
                rk.replay_sorted(z32, zp, z32, 1440, H)):
        assert out.shape == (1440, 6 + H)
        assert bool((out == 0).all())
