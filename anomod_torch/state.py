"""Replay state carried across packages.

A replay state built by the JAX package (its ``ReplayState`` fields read
back as numpy arrays) moves into the port with :func:`from_numpy_state`,
and back with :func:`to_numpy_state`; a stream can start in one package
and continue in the other.  The serve plane's tenant pool moves across
whole with :func:`load_pool`, or tenant by tenant with
:func:`load_tenant_states`.  A t-digest (``TDigest`` mean and weight
``[..., K]``) moves with :func:`from_numpy_digest` /
:func:`to_numpy_digest`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.ops.tdigest import TDigest
from anomod_torch.replay import (N_FEATS, ReplayConfig, ReplayState,
                                 TenantStatePool)


def from_numpy_state(agg, hist, hll=None,
                     device: DeviceLike = None) -> ReplayState:
    """``[S*W, 6]`` agg and ``[S*W, H]`` hist float32 (and optional
    ``[S, 2^p]`` int32 HLL registers) -> the port's state on ``device``.
    The arrays are copied."""
    device = resolve_device(device)

    def put(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return ReplayState(agg=put(agg, np.float32), hist=put(hist, np.float32),
                       hll=None if hll is None else put(hll, np.int32))


def load_pool(cfg: ReplayConfig, agg, hist, device: DeviceLike = None,
              next_slot: Optional[int] = None,
              free: Sequence[int] = ()) -> TenantStatePool:
    """A JAX ``TenantStatePool``'s planes (``pool.agg`` ``[P+1, SW, F]``
    and ``pool.hist`` ``[P+1, SW, H]`` as numpy, row 0 the dead slot) ->
    the port's pool on ``device`` with the same rows in the same slots.
    ``next_slot`` and ``free`` carry the JAX pool's ``_next`` and
    ``_free`` (default: every row in use).  The planes are copied."""
    agg = np.asarray(agg, np.float32)
    hist = np.asarray(hist, np.float32)
    if agg.ndim != 3 or agg.shape[0] < 2 \
            or agg.shape[1:] != (cfg.sw, N_FEATS) \
            or hist.shape != (agg.shape[0], cfg.sw, cfg.n_hist_buckets):
        raise ValueError(f"pool planes {agg.shape} / {hist.shape} do not "
                         f"fit SW={cfg.sw}, H={cfg.n_hist_buckets}")
    pool = TenantStatePool(cfg, capacity=agg.shape[0] - 1, device=device)
    pool.agg.copy_(torch.from_numpy(agg))
    pool.hist.copy_(torch.from_numpy(hist))
    pool._next = int(agg.shape[0] if next_slot is None else next_slot)
    pool._free = [int(s) for s in free]
    return pool


def load_tenant_states(pool: TenantStatePool,
                       states: Sequence[ReplayState]) -> List[int]:
    """Per-tenant replay states (numpy or tensors, e.g. the JAX host
    seam's) -> fresh slots of ``pool``; returns the slots in order."""
    slots = []
    for st in states:
        slot = pool.acquire()
        pool.put(slot, st)
        slots.append(slot)
    return slots


def to_numpy_state(state: ReplayState
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The port's state as host ``(agg, hist, hll)`` numpy copies."""
    def host(t):
        return None if t is None else np.array(t.cpu())
    return host(state.agg), host(state.hist), host(state.hll)


def from_numpy_digest(mean, weight, device: DeviceLike = None) -> TDigest:
    """A digest's ``[..., K]`` float32 mean and weight (e.g. the JAX
    package's ``TDigest`` read back as numpy) -> tensors on ``device``.
    The arrays are copied."""
    device = resolve_device(device)
    mean = np.asarray(mean, np.float32)
    weight = np.asarray(weight, np.float32)
    if mean.shape != weight.shape or mean.ndim < 1:
        raise ValueError(f"digest mean {mean.shape} and weight "
                         f"{weight.shape} must share a [..., K] shape")
    return TDigest(mean=torch.tensor(mean, device=device),
                   weight=torch.tensor(weight, device=device))


def to_numpy_digest(d: TDigest) -> TDigest:
    """A digest of tensors (or arrays) as host numpy copies."""
    def host(t):
        return np.array(t.cpu()) if torch.is_tensor(t) else np.array(t)
    return TDigest(mean=host(d.mean), weight=host(d.weight))
