"""Attention core of the sequence models and its ring plane (counterpart
of ``anomod/parallel/ring_attention.py``).

:func:`full_attention` is the single-device reference that
``TraceTransformer`` and ``LineGraphRCA`` call.  It is written as the JAX
function is (two einsums, the row max subtracted, the exponentials
normalized by their sum) so that its rounding follows the same order;
``scaled_dot_product_attention`` would take other kernels and round
differently.

Ring attention shards the sequence over a mesh axis: each rank keeps its
query block and passes its K/V block around the ring with
``collectives.ppermute``, accumulating the exact softmax with the online
max / denominator recurrence; after n steps every query block has seen
every key block (n - 1 rotations: the last step needs none).  Every
function takes the sequence axis at ``-3`` (``[..., L, H, D]``) and any
leading batch axes, as ``full_attention`` does.
"""

from __future__ import annotations

import math

import torch

from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel.mesh import Axes, Mesh


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention, ``[..., L, H, D] -> [..., L, H, D]``; any
    leading axes are batch axes (no mixing across them)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh, axis: Axes = "data") -> torch.Tensor:
    """Exact attention of this rank's blocks ``[..., L/P, H, D]`` against
    the whole sequence, whose blocks lie on the ranks of ``axis`` in
    rank order; returns this rank's output block."""
    n = mesh.axis_size(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    num = torch.zeros_like(q)
    den = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    m = torch.full(q.shape[:-1], -math.inf, dtype=q.dtype, device=q.device)
    kb, vb = k, v
    for step in range(n):
        scores = torch.einsum("...qhd,...khd->...qhk", q, kb) * scale
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        correction = torch.exp(m - m_new)
        num = num * correction[..., None] \
            + torch.einsum("...qhk,...khd->...qhd", p, vb)
        den = den * correction + p.sum(dim=-1)
        m = m_new
        if step < n - 1:
            kb = coll.ppermute(kb, mesh, axis)
            vb = coll.ppermute(vb, mesh, axis)
    return num / den[..., None]


def make_sharded_attention(local_fn, mesh: Mesh, axis: Axes = "data"):
    """The whole-sequence form of a sequence-parallel attention plane:
    ``attend(q, k, v)`` takes ``[..., L, H, D]`` (the same on every rank),
    runs ``local_fn(q, k, v, mesh, axis)`` on this rank's ``L/P`` query,
    key and value blocks and gathers the output blocks, so every rank
    returns the whole ``[..., L, H, D]``.  ``L`` must divide by the axis
    size.  Gradients: each rank's blocks are cut from replicated inputs
    (``copy_to``: their gradients summed over the ranks) and the output is
    gathered (``gather_from``)."""
    n = mesh.axis_size(axis)
    group = mesh.axis_group(axis)

    def attend(q, k, v):
        L = q.shape[-3]
        if L % n:
            raise ValueError(f"sequence-parallel attention needs the "
                             f"sequence length ({L}) divisible by the {axis} "
                             f"axis size ({n})")
        i = mesh.axis_index(axis)
        q, k, v = (coll.copy_to(t, group).chunk(n, dim=-3)[i]
                   for t in (q, k, v))
        return coll.gather_from(local_fn(q, k, v, mesh, axis), group, -3)

    return attend


def make_ring_attention(mesh: Mesh, axis: Axes = "data"):
    """Ring attention over ``axis``: ``attend(q, k, v)`` on the whole
    ``[..., L, H, D]`` (:func:`make_sharded_attention`)."""
    return make_sharded_attention(ring_attention_local, mesh, axis)
