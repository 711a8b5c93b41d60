"""Fixed-capacity t-digest (counterpart of ``anomod/ops/tdigest.py`` and
of the framework half of ``anomod/ops/pallas_tdigest.py``).

A digest keeps K centroids and rebuilds by sort + quantile bucketing +
segment reduction: build sorts the values, maps each normalized rank q to
a centroid bucket with the k1 scale ``K * (asin(2q - 1) / pi + 1/2)`` and
takes the weighted mean per bucket; merge rebuilds over the concatenated
centroid sets; a quantile interpolates the centroid CDF.

Two builds share the bucket rule, each under its own name:
- :func:`tdigest_build` / :func:`tdigest_merge_many` on numpy arrays, on
  the host (the serve plane keeps one digest per tenant for its
  admission-to-scored latency SLO, and the replay CLI merges its digest
  plane into one corpus digest);
- :func:`tdigest_build_tensor` / :func:`tdigest_merge_tensor` /
  :func:`tdigest_by_segment` on tensors, through :func:`scale_pass` (sort,
  cumsum, k1 buckets in torch) and the ``tdigest_reduce`` kernel wrapper:
  the CUDA kernel for tensors on the card, its plain version on the CPU.
  Every leading index is one digest lane.

Quantiles are queried on the host, from numpy digests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.ops import sketch_kernels


class TDigest(NamedTuple):
    # numpy arrays from the host build; tensors from the tensor build
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


def scale_pass(values: torch.Tensor, weights: torch.Tensor, k: int):
    """The build's prolog on tensors (``pallas_tdigest._scale_pass``):
    stable sort by value, f32 cumulative weight, k1 scale buckets.
    Returns ``(bucket int32, w, w * v)``, each ``[..., L]`` in sorted
    order."""
    v, order = torch.sort(values, dim=-1, stable=True)
    w = torch.gather(weights, -1, order)
    cum = torch.cumsum(w, dim=-1)
    total = cum[..., -1:]
    q = (cum - 0.5 * w) / torch.where(total > 0, total, 1.0)
    z = torch.clamp(2.0 * q - 1.0, -1.0, 1.0)
    # a true f32 division by f32(pi), as XLA and numpy divide: on the card
    # a Python-scalar divisor becomes a multiply by its reciprocal
    pi = torch.tensor(np.pi, dtype=torch.float32, device=values.device)
    s = (torch.asin(z) / pi + 0.5) * k
    bucket = torch.clamp(s.to(torch.int32), 0, k - 1)
    return bucket, w, w * v


def tdigest_build(values, k: int = 64, weights=None) -> TDigest:
    """Build a K-centroid digest from a host value batch (last axis
    reduced)."""
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
    """Merge host digests of one capacity by a weighted rebuild."""
    mean = np.concatenate([d.mean for d in digests], axis=-1)
    weight = np.concatenate([d.weight for d in digests], axis=-1)
    return tdigest_build(mean, k=digests[0].capacity, weights=weight)


def tdigest_build_tensor(values: torch.Tensor, k: int = 64,
                         weights: torch.Tensor | None = None) -> TDigest:
    """Build K-centroid digests from a value tensor (last axis reduced;
    ``tdigest_build_pallas``): :func:`scale_pass`, then one launch of the
    reduction kernel's wrapper over every leading index."""
    values = values.to(torch.float32)
    weights = (torch.ones_like(values) if weights is None
               else weights.to(torch.float32))
    lead, L = values.shape[:-1], values.shape[-1]
    R = int(np.prod(lead)) if lead else 1
    bucket, w, wv = scale_pass(values, weights, k)
    mean, weight = sketch_kernels.tdigest_reduce(
        bucket.reshape(R, L).contiguous(), w.reshape(R, L).contiguous(),
        wv.reshape(R, L).contiguous(), k)
    return TDigest(mean=mean.reshape(*lead, k),
                   weight=weight.reshape(*lead, k))


def tdigest_merge_tensor(a: TDigest, b: TDigest) -> TDigest:
    """Merge two tensor digests of one capacity by a weighted rebuild
    (``tdigest_merge_pallas``)."""
    return tdigest_build_tensor(torch.cat([a.mean, b.mean], -1),
                                k=a.capacity,
                                weights=torch.cat([a.weight, b.weight], -1))


def segment_pad(values, segment_ids, n_segments: int, pad_to: int = 1):
    """Scatter a flat value stream into padded per-segment lanes, on the
    host: sort once by segment (stable), place each segment's run in a
    ``[n_segments, L_max]`` matrix (weight 0 = padding), ``L_max`` rounded
    up to ``pad_to``.  Returns ``(padded_values, weights)`` float32; no
    values give ``[n_segments, pad_to]`` zeros."""
    values = np.asarray(values, dtype="float32")
    segment_ids = np.asarray(segment_ids)
    n = values.shape[0]
    if n == 0:
        z = np.zeros((n_segments, pad_to), dtype="float32")
        return z, np.zeros_like(z)
    order = np.argsort(segment_ids, kind="stable")
    seg_s = segment_ids[order]
    val_s = values[order]
    starts = np.searchsorted(seg_s, np.arange(n_segments))
    pos = np.arange(n) - starts[seg_s]
    counts = np.bincount(seg_s, minlength=n_segments)
    l_max = max(int(counts.max()), 1)
    l_max += (-l_max) % pad_to
    padded = np.zeros((n_segments, l_max), dtype="float32")
    weights = np.zeros((n_segments, l_max), dtype="float32")
    padded[seg_s, pos] = val_s
    weights[seg_s, pos] = 1.0
    return padded, weights


#: lane width multiple of the per-segment staging (the JAX kernel path's)
SEGMENT_PAD_TO = 128


def tdigest_by_segment(values, segment_ids, n_segments: int, k: int = 64,
                       device: DeviceLike = None) -> TDigest:
    """Per-segment digests from a flat host value stream (the contract of
    ``tdigest_by_segment_pallas``): one :func:`segment_pad` staging at
    ``pad_to=128``, then every lane in one tensor build on ``device``.
    Returns tensors ``[n_segments, K]``."""
    device = resolve_device(device)
    padded, weights = segment_pad(values, segment_ids, n_segments,
                                  pad_to=SEGMENT_PAD_TO)
    return tdigest_build_tensor(torch.from_numpy(padded).to(device), k=k,
                                weights=torch.from_numpy(weights).to(device))


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
