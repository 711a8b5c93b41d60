"""Replay state carried across packages.

A replay state built by the JAX package (its ``ReplayState`` fields read
back as numpy arrays) moves into the port with :func:`from_numpy_state`,
and back with :func:`to_numpy_state`; a stream can start in one package
and continue in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.replay import ReplayState


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


def to_numpy_state(state: ReplayState
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The port's state as host ``(agg, hist, hll)`` numpy copies."""
    def host(t):
        return None if t is None else np.array(t.cpu())
    return host(state.agg), host(state.hist), host(state.hll)
