"""HyperLogLog on int32 items (counterpart of ``anomod/ops/hll.py``).

2^p registers hold the largest leading-zero rank seen per bucket; an
update is a register max, a merge an elementwise max.  The hash is two
rounds of murmur3's fmix32 (``ops.sketch_kernels.hll_hash``; torch has no
uint32 arithmetic, so it runs on int64 masked to 32 bits) and the rank's
leading-zero count is exact.  The JAX package's ``_clz32`` under
``xp=jnp`` goes through a float32 ``log2`` and miscounts some values just
below a power of two; the port follows the numpy oracle and the Pallas
kernel instead.

Updates go through the ``hll_update`` kernel wrapper (the CUDA kernel for
tensors on the card, its plain version on the CPU).  The estimate is
computed on the host in float64, as the numpy oracle computes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.ops import sketch_kernels

_ALPHA = {16: 0.673, 32: 0.697, 64: 0.709}


def _alpha(m: int) -> float:
    return _ALPHA.get(m, 0.7213 / (1.0 + 1.079 / m))


def hll_init(p: int = 12, lanes: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """Zeroed registers: ``[m]`` or ``[lanes, m]`` int32 with m = 2^p."""
    m = 1 << p
    shape = (m,) if lanes is None else (lanes, m)
    return torch.zeros(shape, dtype=torch.int32, device=resolve_device(device))


def hll_add(registers: torch.Tensor, items: torch.Tensor, p: int = 12,
            lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New registers with an int32 item batch added (``registers`` is not
    modified).  ``lane`` (int32, same shape as ``items``) scatters items
    into per-lane registers ``[L, m]``; a lane outside ``[0, L)`` drops
    its item."""
    items = items.to(torch.int32).contiguous()
    if lane is not None:
        lane = lane.to(torch.int32).contiguous()
    return sketch_kernels.hll_update(registers.clone(), items, lane, p)


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def hll_estimate(registers) -> np.ndarray:
    """Cardinality estimate with the small-range (linear counting)
    correction, per lane: float64 on the host."""
    if torch.is_tensor(registers):
        registers = registers.cpu().numpy()
    registers = np.asarray(registers)
    m = registers.shape[-1]
    regs = registers.astype(np.float64)
    inv = np.sum(np.power(2.0, -regs), axis=-1)
    raw = _alpha(m) * m * m / inv
    zeros = np.sum((registers == 0).astype(np.int32), axis=-1)
    lc = m * np.log(m / np.maximum(zeros, 1).astype(raw.dtype))
    use_lc = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_lc, lc, raw)
