"""The port's sketch kernels' plain versions against the JAX package.

``hll_update`` (plain: the int64-masked torch hash, then a scatter-max)
must equal the numpy HLL oracle and the Pallas HLL kernel (interpret
mode) register for register.  ``tdigest_reduce`` (plain: an
``index_add_`` of ``[w, wv]``) must give the Pallas t-digest kernel's
weights exactly (sums of integer weights) and its means within
``rtol=1e-5, atol=1e-5`` (f32 sums in another order).  ``scale_pass``
must give JAX ``_scale_pass``'s bucket rows, weights and products exactly.
Inputs are made from numpy seeds.
"""

import numpy as np
import pytest
import torch

from anomod.ops.hll import _avalanche32, _clz32, hll_add, hll_init
from anomod_torch.ops import sketch_kernels as sk
from torch_tdigest_order import tdigest_reduce_in_kernel_order

M32 = 0xFFFFFFFF


def _inv_fmix32(x: int) -> int:
    """Inverse of murmur3's fmix32 (each step is a bijection of uint32)."""
    x ^= x >> 16
    x = (x * pow(0xC2B2AE35, -1, 1 << 32)) & M32
    x ^= (x >> 13) ^ (x >> 26)
    x = (x * pow(0x85EBCA6B, -1, 1 << 32)) & M32
    return x ^ (x >> 16)


def items_with_h2_below_powers_of_two(per_power: int = 64) -> np.ndarray:
    """int32 items whose second hash ``fmix32(fmix32(x) ^ 0x9E3779B9)``
    lies just below a power of two: the inputs where a float32 log2 clz
    rounds up."""
    out = []
    for e in range(1, 33):
        for j in range(1, min(per_power, (1 << e) - (1 << (e - 1))) + 1):
            h = _inv_fmix32((1 << e) - j) ^ 0x9E3779B9
            out.append(_inv_fmix32(h))
    return np.asarray(out, np.uint32).view(np.int32)


def test_hash_is_exact_at_the_uint32_edges():
    edges = np.array([0, 1, 0x7FFF, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                      0x9E3779B9, 0xFFFFFFFE, 0xFFFFFFFF], np.uint64)
    x = torch.from_numpy(edges.astype(np.int64))
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        want = [(int(v) * c) & M32 for v in edges]
        assert sk._mul32(x, c).tolist() == want
    rng = np.random.default_rng(0)
    vals = np.concatenate([edges.astype(np.uint32),
                           rng.integers(0, 1 << 32, 5000, dtype=np.uint64
                                        ).astype(np.uint32)])
    got = sk._fmix32(torch.from_numpy(vals.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, _avalanche32(vals, np).astype(np.int64))
    clz = sk._clz32(torch.from_numpy(vals.astype(np.int64))).numpy()
    np.testing.assert_array_equal(clz, _clz32(vals, np))


@pytest.mark.parametrize("p", [4, 8, 10, 16])
def test_hll_update_plain_matches_numpy_oracle(p):
    rng = np.random.default_rng(p)
    items = rng.integers(-2**31, 2**31, 50_000, dtype=np.int64).astype(
        np.int32)
    regs = torch.zeros(1 << p, dtype=torch.int32)
    got = sk.hll_update(regs, torch.from_numpy(items), p=p)
    assert got is regs                                  # updated in place
    np.testing.assert_array_equal(got.numpy(), hll_add(hll_init(p), items,
                                                       p=p))


def test_hll_update_matches_pallas_kernel():
    """The items of the JAX package's Pallas HLL test, p = 10."""
    from anomod.ops.pallas_hll import make_pallas_hll_fn
    p = 10
    items = (np.arange(8192, dtype=np.int64) * 2654435761 % (2**31)
             ).astype(np.int32)
    want = np.asarray(make_pallas_hll_fn(p=p, block=1024,
                                         interpret=True)(items))
    got = sk.hll_update(torch.zeros(1 << p, dtype=torch.int32),
                        torch.from_numpy(items), p=p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hll_lanes_match_numpy_oracle_and_drop_outside_lanes():
    p = 10
    items = (np.arange(10_000, dtype=np.int64) * 2654435761 % (2**31)
             ).astype(np.int32)
    lane = (items % 3).astype(np.int32)
    want = hll_add(hll_init(p, lanes=3), items, p=p, lane=lane)
    got = sk.hll_update(torch.zeros((3, 1 << p), dtype=torch.int32),
                        torch.from_numpy(items), torch.from_numpy(lane), p=p)
    np.testing.assert_array_equal(got.numpy(), want)
    # lanes 3 (the dead lane) and -1 add nothing
    wild = lane.copy()
    wild[::5] = 3
    wild[1::7] = -1
    keep = (wild >= 0) & (wild < 3)
    want = hll_add(hll_init(p, lanes=3), items[keep], p=p, lane=wild[keep])
    got = sk.hll_update(torch.zeros((3, 1 << p), dtype=torch.int32),
                        torch.from_numpy(items), torch.from_numpy(wild), p=p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hll_rank_is_exact_just_below_powers_of_two():
    """Items whose rank hash sits just below a power of two: the port
    equals the numpy oracle (float64, exact), while the JAX package's
    float32 clz miscounts some of them (the reference deviation the
    port does not copy)."""
    import jax.numpy as jnp
    items = items_with_h2_below_powers_of_two()
    h2 = _avalanche32(_avalanche32(items.astype(np.uint32), np)
                      ^ np.uint32(0x9E3779B9), np)
    assert (np.log2(h2.astype(np.float64) + 1) % 1 == 0).sum() > 30
    for p in (8, 10):
        got = sk.hll_update(torch.zeros(1 << p, dtype=torch.int32),
                            torch.from_numpy(items), p=p)
        np.testing.assert_array_equal(got.numpy(),
                                      hll_add(hll_init(p), items, p=p))
    exact = _clz32(h2, np)
    f32 = np.asarray(_clz32(jnp.asarray(h2), jnp))
    assert (exact != f32).sum() > 0
    np.testing.assert_array_equal(
        sk._clz32(torch.from_numpy(h2.astype(np.int64))).numpy(), exact)


def test_f32_clz_deviation_of_the_reference():
    """The JAX package's ``_clz32`` under ``xp=jnp`` floors a float32
    ``log2``: it miscounts 780 of the 6,399 uint32 values just below a
    power of two (up to 256 below each) and 2 of 2,000,000 random ones,
    and reaches -1 at worst.  The port's clz is exact on all of them."""
    import jax.numpy as jnp
    below = np.array([(1 << e) - j for e in range(1, 33)
                      for j in range(1, min(256, 1 << (e - 1)) + 1)],
                     np.uint64).astype(np.uint32)
    rand = np.random.default_rng(0).integers(0, 1 << 32, 2_000_000,
                                             dtype=np.uint64).astype(np.uint32)
    counts = []
    for vals in (below, rand):
        exact = _clz32(vals, np)
        f32 = np.asarray(_clz32(jnp.asarray(vals), jnp))
        counts.append((vals.size, int((f32 != exact).sum()), int(f32.min())))
        np.testing.assert_array_equal(
            sk._clz32(torch.from_numpy(vals.astype(np.int64))).numpy(), exact)
    assert counts == [(6399, 780, -1), (2_000_000, 2, -1)]


def test_tdigest_reduce_plain_matches_pallas_kernel():
    from anomod.ops.pallas_tdigest import make_pallas_tdigest_fn
    rng = np.random.default_rng(5)
    R, L, K = 11, 384, 32
    bucket = np.sort(rng.integers(0, K, (R, L)), axis=1).astype(np.int32)
    bucket[0, :7] = -1                        # outside [0, K): add nothing
    bucket[1, -5:] = K
    bucket[2] //= 2                           # empty upper centroids
    w = (rng.random((R, L)) < 0.8).astype(np.float32)
    v = rng.lognormal(3.0, 1.0, (R, L)).astype(np.float32)
    wv = w * v
    mean, weight = (np.asarray(a) for a in make_pallas_tdigest_fn(
        K, L, interpret=True)(bucket, w, wv))
    got_m, got_w = sk.tdigest_reduce(torch.from_numpy(bucket),
                                     torch.from_numpy(w),
                                     torch.from_numpy(wv), K)
    np.testing.assert_array_equal(got_w.numpy(), weight)
    np.testing.assert_allclose(got_m.numpy(), mean, rtol=1e-5, atol=1e-5)
    assert (weight == 0).any()                 # empty centroids: mean 0
    np.testing.assert_array_equal(got_m.numpy()[weight == 0], 0.0)


def _digest_rows(R, L, K, seed, sorted_rows):
    """t-digest lanes from numpy: buckets with some outside [0, K), sorted
    along each row (as the scale pass writes them) or not, 0/1 weights
    with a zero padding tail, log-latency values."""
    rng = np.random.default_rng(seed)
    bucket = rng.integers(-1, K + 1, (R, L)).astype(np.int32)
    if sorted_rows:
        bucket = np.sort(bucket, axis=1)
    w = (rng.random((R, L)) < 0.85).astype(np.float32)
    w[:, L - L // 3:] = 0.0
    v = np.log1p(rng.lognormal(8.0, 1.0, (R, L))).astype(np.float32)
    return bucket, w, w * v


@pytest.mark.parametrize("R,L,K,sorted_rows", [
    (3, 1, 8, True), (5, 127, 16, True), (5, 127, 16, False),
    (11, 384, 32, True), (11, 384, 32, False), (4, 1000, 64, False),
    (2, 2944, 64, True)])
def test_tdigest_kernel_order_matches_plain(R, L, K, sorted_rows):
    """The card kernel's add order (restated in numpy): weights equal to
    the plain version's (integer sums), means within rtol=1e-5, on rows
    sorted by bucket and not, of any length (past the 128-slot steps)."""
    b, w, wv = _digest_rows(R, L, K, seed=R * L + K, sorted_rows=sorted_rows)
    mean, weight = tdigest_reduce_in_kernel_order(b, w, wv, K)
    pm, pw = sk.tdigest_reduce_plain(torch.from_numpy(b), torch.from_numpy(w),
                                     torch.from_numpy(wv), K)
    np.testing.assert_array_equal(weight, pw.numpy())
    np.testing.assert_allclose(mean, pm.numpy(), rtol=1e-5, atol=0.0)
    np.testing.assert_array_equal(mean[weight == 0], 0.0)


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_tdigest_kernel_order_matches_pallas_kernel(sorted_rows):
    from anomod.ops.pallas_tdigest import make_pallas_tdigest_fn
    R, L, K = 6, 256, 32
    b, w, wv = _digest_rows(R, L, K, seed=17, sorted_rows=sorted_rows)
    want_m, want_w = (np.asarray(a) for a in make_pallas_tdigest_fn(
        K, L, interpret=True)(b, w, wv))
    mean, weight = tdigest_reduce_in_kernel_order(b, w, wv, K)
    np.testing.assert_array_equal(weight, want_w)
    np.testing.assert_allclose(mean, want_m, rtol=1e-5, atol=1e-5)


def test_tdigest_kernel_order_adds_runs_then_tails_in_lane_order():
    """A hand-checked sub-step: one lane of 128 slots, slot 4t + u of lane
    t.  Sub-step 0 holds buckets [0]*10 + [1]*12 + [0]*10: each run sums
    in the segmented scan's tree order, and bucket 0's two run sums add
    in lane order.  Every other slot has bucket 5 and weight 0."""
    K = 8
    b = np.full((1, 128), 5, np.int32)
    w = np.zeros((1, 128), np.float32)
    v = (np.float32(1.0) + np.arange(32, dtype=np.float32)
         * np.float32(3e-7)).astype(np.float32)
    b[0, 0::4] = [0] * 10 + [1] * 12 + [0] * 10
    w[0, 0::4] = v
    mean, weight = tdigest_reduce_in_kernel_order(b, w, w, K)

    def pair(i):
        return v[i + 1] + v[i]
    run0 = ((pair(8) + pair(6)) + (pair(4) + pair(2))) + pair(0)
    run1 = ((pair(20) + pair(18)) + (pair(16) + pair(14))) \
        + (pair(12) + pair(10))
    run2 = ((pair(30) + pair(28)) + (pair(26) + pair(24))) + pair(22)
    assert weight[0, 0] == (np.float32(0.0) + run0) + run2
    assert weight[0, 1] == run1
    np.testing.assert_array_equal(mean[0, :2], [1.0, 1.0])
    assert weight[0, 5] == 0.0 and mean[0, 5] == 0.0


def test_scale_pass_matches_jax():
    import jax.numpy as jnp
    from anomod.ops.pallas_tdigest import _scale_pass
    from anomod_torch.ops.tdigest import scale_pass
    rng = np.random.default_rng(9)
    vals = rng.lognormal(3.0, 1.0, (7, 640)).astype(np.float32)
    w = np.ones_like(vals)
    w[:, 500:] = 0.0                           # padding tail
    vals[:, 500:] = 0.0
    vals[3] = np.round(vals[3])                # ties: stable order matters
    for k in (16, 64):
        jb, jw, jwv = (np.asarray(a) for a in _scale_pass(
            jnp.asarray(vals), jnp.asarray(w), k))
        tb, tw, twv = scale_pass(torch.from_numpy(vals), torch.from_numpy(w),
                                 k)
        assert tb.dtype == torch.int32
        np.testing.assert_array_equal(tb.numpy(), jb)
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(twv.numpy(), jwv)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    sk.reset_launches()
    b = torch.zeros((2, 8), dtype=torch.int32)
    f = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(TypeError):
        sk.tdigest_reduce(b.float(), f, f, 4)
    with pytest.raises(ValueError):
        sk.tdigest_reduce(b, f[:, :4], f, 4)
    with pytest.raises(ValueError):
        sk.tdigest_reduce(b.T, f.T, f.T, 4)          # not contiguous
    items = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        sk.hll_update(torch.zeros(8, dtype=torch.int32), items, p=3)
    with pytest.raises(ValueError):
        sk.hll_update(torch.zeros(1 << 8, dtype=torch.int32), items, p=10)
    with pytest.raises(ValueError):
        sk.hll_update(torch.zeros((2, 1 << 8), dtype=torch.int32), items,
                      items[:5], p=8)
    with pytest.raises(TypeError):
        sk.hll_update(torch.zeros(1 << 8, dtype=torch.int32), items.long(),
                      p=8)
    # empty inputs: no items leave the registers; no lanes give no digests
    regs = torch.full((1 << 8,), 3, dtype=torch.int32)
    sk.hll_update(regs, torch.zeros(0, dtype=torch.int32), p=8)
    assert bool((regs == 3).all())
    m, w = sk.tdigest_reduce(b[:0], f[:0], f[:0], 4)
    assert m.shape == w.shape == (0, 4)
    m, w = sk.tdigest_reduce(b[:, :0].contiguous(), f[:, :0].contiguous(),
                             f[:, :0].contiguous(), 4)
    assert bool((m == 0).all()) and bool((w == 0).all())
    assert sk.launches == {"tdigest_reduce": 0, "hll_update": 0}
