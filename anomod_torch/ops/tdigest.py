"""Fixed-capacity t-digest on the host (counterpart of the numpy path of
``anomod/ops/tdigest.py``).

A digest keeps K centroids and rebuilds by sort + quantile bucketing +
segment reduction: build sorts the values, maps each normalized rank q to
a centroid bucket with the k1 scale ``K * (asin(2q - 1) / pi + 1/2)`` and
takes the weighted mean per bucket; merge rebuilds over the concatenated
centroid sets; a quantile interpolates the centroid CDF.  The serve plane
keeps one per tenant for its admission-to-scored latency SLO.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TDigest(NamedTuple):
    mean: np.ndarray     # [..., K] float32 — centroid means (sorted)
    weight: np.ndarray   # [..., K] float32 — centroid weights (0 = empty)

    @property
    def capacity(self) -> int:
        return self.mean.shape[-1]


def _scale_bucket(q, k: int):
    """The k1 scale function mapped to integer buckets [0, k)."""
    z = np.clip(2.0 * q - 1.0, -1.0, 1.0)
    s = (np.arcsin(z) / np.pi + 0.5) * k
    return np.clip(s.astype(np.int32), 0, k - 1)


def _segment_mean(bucket, values, weights, k: int):
    """Weighted per-bucket mean and weight by one-hot reductions."""
    onehot = (bucket[..., None] == np.arange(k)[None, :]).astype(values.dtype)
    w = np.sum(onehot * weights[..., None], axis=-2)
    m = np.sum(onehot * (weights * values)[..., None], axis=-2)
    return np.where(w > 0, m / np.where(w > 0, w, 1.0), 0.0), w


def tdigest_build(values, k: int = 64, weights=None) -> TDigest:
    """Build a K-centroid digest from a value batch (last axis reduced)."""
    values = np.asarray(values, dtype=np.float32)
    if weights is None:
        weights = np.ones_like(values)
    order = np.argsort(values, axis=-1)
    v = np.take_along_axis(values, order, axis=-1)
    w = np.take_along_axis(weights, order, axis=-1)
    cum = np.cumsum(w, axis=-1)
    total = cum[..., -1:]
    q = (cum - 0.5 * w) / np.where(total > 0, total, 1.0)
    mean, weight = _segment_mean(_scale_bucket(q, k), v, w, k)
    return TDigest(mean=mean, weight=weight)


def tdigest_merge_many(digests) -> TDigest:
    """Merge digests of one capacity by a weighted rebuild."""
    mean = np.concatenate([d.mean for d in digests], axis=-1)
    weight = np.concatenate([d.weight for d in digests], axis=-1)
    return tdigest_build(mean, k=digests[0].capacity, weights=weight)


def _fill_empty_means(mean, weight):
    """Give empty centroids the nearest populated centroid's mean, so the
    CDF interpolation never lands on the 0 placeholder (populated means
    are non-decreasing: a running max fills forward, a reversed running
    min fills backward)."""
    pop = weight > 0
    ffill = np.maximum.accumulate(np.where(pop, mean, -np.inf), axis=-1)
    bfill = np.minimum.accumulate(
        np.where(pop, mean, np.inf)[..., ::-1], axis=-1)[..., ::-1]
    filled = np.where(np.isfinite(ffill), ffill, bfill)
    return np.where(np.isfinite(filled), filled, 0.0)


def tdigest_quantile(d: TDigest, q):
    """Approximate quantile(s) by interpolating the centroid CDF."""
    w = d.weight
    mean = _fill_empty_means(d.mean, w)
    total = np.sum(w, axis=-1, keepdims=True)
    cum = np.cumsum(w, axis=-1) - 0.5 * w
    target = np.asarray(q, dtype=d.mean.dtype) * np.squeeze(total, -1)
    idx = np.sum((cum < target[..., None]).astype("int32"), axis=-1)
    idx = np.clip(idx, 0, d.mean.shape[-1] - 1)
    idx0 = np.clip(idx - 1, 0, d.mean.shape[-1] - 1)
    c0 = np.take_along_axis(cum, idx0[..., None], axis=-1)[..., 0]
    c1 = np.take_along_axis(cum, idx[..., None], axis=-1)[..., 0]
    m0 = np.take_along_axis(mean, idx0[..., None], axis=-1)[..., 0]
    m1 = np.take_along_axis(mean, idx[..., None], axis=-1)[..., 0]
    t = np.where(c1 > c0, (target - c0) / np.where(c1 > c0, c1 - c0, 1.0),
                 0.0)
    t = np.clip(t, 0.0, 1.0)
    return m0 + t * (m1 - m0)
