"""Linear recurrence of the LRU temporal model (counterpart of
``anomod/parallel/seqscan.py``): only :func:`linear_recurrence`, the
single-device form; the sequence-parallel block scan is not ported yet.

The JAX function composes ``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)``
with ``lax.associative_scan`` (a tree over the time axis); this one walks
the time axis in order.  The two are equal up to f32 reassociation: at
the models' W = 8 windows, within ``rtol=1e-6`` of each other
(``tests/test_torch_models.py``)."""

from __future__ import annotations

import torch


def linear_recurrence(xs: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``h_t = decay * h_{t-1} + xs_t`` over axis 0 with ``h_0 = xs_0``;
    ``decay`` broadcasts to ``xs[0]``.  Returns every state ``[T, ...]``."""
    h = xs[0]
    out = [h]
    for t in range(1, xs.shape[0]):
        h = decay * h + xs[t]
        out.append(h)
    return torch.stack(out)
