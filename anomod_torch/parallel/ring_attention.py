"""Attention core of the sequence models (counterpart of
``anomod/parallel/ring_attention.py``): only :func:`full_attention`, the
single-device reference that ``TraceTransformer`` and ``LineGraphRCA``
call.  The ring (sequence-parallel) plane is not ported yet.

Written as the JAX function is (two einsums, the row max subtracted, the
exponentials normalized by their sum) so that its rounding follows the
same order; ``scaled_dot_product_attention`` would take other kernels and
round differently."""

from __future__ import annotations

import math

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention, ``[..., L, H, D] -> [..., L, H, D]``; any
    leading axes are batch axes (no mixing across them)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("...hqk,...khd->...qhd", p, v)
