"""The port's batch replay against the JAX replay on one staged corpus.

Same corpus (the generators are byte-identical), same ``stage_columns``
output; count / err / 5xx / histogram planes EQUAL, moment planes within
``rtol=1e-5, atol=1e-3`` (f32 add order differs between the packages).
"""

import numpy as np
import pytest
import torch

from anomod import replay as jreplay
from anomod_torch import replay as treplay
from anomod_torch.io.dataset import load_bench_corpus


@pytest.fixture(scope="module")
def corpus():
    batch = load_bench_corpus("TT", 30)
    jcfg = jreplay.ReplayConfig(n_services=batch.n_services, chunk_size=2048)
    tcfg = treplay.ReplayConfig(n_services=batch.n_services, chunk_size=2048)
    chunks, n = treplay.stage_columns(batch, tcfg)
    return batch, jcfg, tcfg, chunks, n


def _assert_state(agg, hist, ref_agg, ref_hist):
    agg, hist = np.asarray(agg), np.asarray(hist)
    np.testing.assert_array_equal(agg[:, :3], np.asarray(ref_agg)[:, :3])
    np.testing.assert_array_equal(hist, np.asarray(ref_hist))
    np.testing.assert_allclose(agg[:, 3:], np.asarray(ref_agg)[:, 3:],
                               rtol=1e-5, atol=1e-3)


def test_stage_columns_byte_identical(corpus):
    batch, jcfg, _, chunks, n = corpus
    want, wn = jreplay.stage_columns(batch, jcfg)
    assert n == wn and set(want) == set(chunks)
    for k in want:
        assert chunks[k].dtype == want[k].dtype
        assert chunks[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("inner_repeats", [1, 3])
def test_make_replay_fn_matches_jax(corpus, inner_repeats):
    _, jcfg, tcfg, chunks, _ = corpus
    want = jreplay.make_replay_fn(jcfg, inner_repeats=inner_repeats)(chunks)
    got = treplay.make_replay_fn(tcfg, inner_repeats=inner_repeats,
                                 device="cpu")(chunks)
    _assert_state(got.agg.numpy(), got.hist.numpy(), want.agg, want.hist)
    ref = jreplay.replay_numpy(chunks, jcfg)
    _assert_state(got.agg.numpy(), got.hist.numpy(),
                  ref.agg * inner_repeats, ref.hist * inner_repeats)


def test_chunk_step_fold_matches_whole_corpus(corpus):
    _, jcfg, tcfg, chunks, _ = corpus
    step = treplay.make_chunk_step(tcfg)
    st = treplay.zero_state(tcfg, "cpu")
    st = step(st, treplay.dead_chunk(tcfg, "cpu"))       # a no-op
    assert bool((st.agg == 0).all()) and bool((st.hist == 0).all())
    for i in range(chunks["sid"].shape[0]):
        st = step(st, {k: torch.from_numpy(v[i]) for k, v in chunks.items()})
    ref = jreplay.replay_numpy(chunks, jcfg)
    _assert_state(st.agg.numpy(), st.hist.numpy(), ref.agg, ref.hist)


@pytest.mark.parametrize("kernel", ["numpy", "matmul", "cuda",
                                    "cuda-sorted"])
def test_measure_throughput_matches_jax(corpus, kernel):
    batch, jcfg, tcfg, chunks, n = corpus
    res = treplay.measure_throughput(batch, tcfg, repeats=1, replicate=2,
                                     kernel=kernel, device="cpu")
    assert res.n_spans == 2 * n and res.spans_per_sec > 0
    assert res.kernel == kernel
    want = jreplay.make_replay_fn(jcfg, inner_repeats=2)(chunks)
    _assert_state(res.state.agg, res.state.hist, want.agg, want.hist)


def test_measure_throughput_rejects_unknown_kernel(corpus):
    with pytest.raises(ValueError):
        treplay.measure_throughput(corpus[0], corpus[2], kernel="pallas",
                                   device="cpu")


def test_percentile_from_hist_matches_jax():
    hist = np.random.default_rng(0).integers(0, 5, (40, 16)).astype(
        np.float32)
    hist[3] = 0.0
    for q in (0.5, 0.99):
        np.testing.assert_array_equal(
            treplay.percentile_from_hist(hist, q, as_us=True),
            jreplay.percentile_from_hist(hist, q, as_us=True))


def test_state_round_trip():
    from anomod_torch.state import from_numpy_state, to_numpy_state
    rng = np.random.default_rng(1)
    agg = rng.random((12, 6)).astype(np.float32)
    hist = rng.random((12, 16)).astype(np.float32)
    hll = rng.integers(0, 9, (3, 256)).astype(np.int32)
    st = from_numpy_state(agg, hist, hll, device="cpu")
    a, h, r = to_numpy_state(st)
    assert a.tobytes() == agg.tobytes() and h.tobytes() == hist.tobytes()
    assert r.tobytes() == hll.tobytes()
    agg[0, 0] = -1.0                           # inputs are copied
    assert float(st.agg[0, 0]) != -1.0
