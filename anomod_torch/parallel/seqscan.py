"""Linear recurrence of the LRU temporal model and its sequence-parallel
block scan (counterpart of ``anomod/parallel/seqscan.py``).

:func:`linear_recurrence` is the single-device form.  The JAX function
composes ``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)`` with
``lax.associative_scan`` (a tree over the time axis); this one walks the
time axis in order.  The two are equal up to f32 reassociation: at the
models' W = 8 windows, within ``rtol=1e-6`` of each other
(``tests/test_torch_models.py``).

:func:`seqpar_recurrence_local` shards the time axis over a mesh axis:
each rank scans its block with :func:`linear_recurrence`, all-gathers the
ranks' block aggregates ``(a^(T/D), h_last)``, takes the exclusive prefix
over the blocks in rank order and corrects its block by ``a^(t+1) ·
carry_in``.  :func:`make_seqpar_recurrence` is its whole-sequence form."""

from __future__ import annotations

import torch

from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel.mesh import Axes, Mesh


def linear_recurrence(xs: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``h_t = decay * h_{t-1} + xs_t`` over axis 0 with ``h_0 = xs_0``;
    ``decay`` broadcasts to ``xs[0]``.  Returns every state ``[T, ...]``."""
    h = xs[0]
    out = [h]
    for t in range(1, xs.shape[0]):
        h = decay * h + xs[t]
        out.append(h)
    return torch.stack(out)


def seqpar_recurrence_local(xs_local: torch.Tensor, decay: torch.Tensor,
                            mesh: Mesh, axis: Axes = "data") -> torch.Tensor:
    """The states of this rank's block ``xs_local [T/D, ...]`` of a time
    axis split over ``axis`` in rank order (every rank's block the same
    length)."""
    group = mesh.axis_group(axis)
    h_local = linear_recurrence(xs_local, decay)
    t_local = xs_local.shape[0]
    a = torch.broadcast_to(decay, xs_local.shape[1:])
    # the block aggregates of every rank: [D, ...] each
    all_a = coll.gather_from((a ** t_local)[None], group, 0)
    all_b = coll.gather_from(h_local[-1:], group, 0)
    carry = torch.zeros_like(all_b[0])
    for i in range(mesh.axis_index(axis)):
        carry = all_a[i] * carry + all_b[i]
    t_idx = torch.arange(1, t_local + 1, device=xs_local.device).reshape(
        (t_local,) + (1,) * (xs_local.dim() - 1))
    return h_local + (a[None] ** t_idx) * carry[None]


def make_seqpar_recurrence(mesh: Mesh, axis: Axes = "data"):
    """``fn(xs [T, ...], decay) -> [T, ...]`` over the whole sequence,
    the same on every rank: each rank runs its ``T/D`` block
    (:func:`seqpar_recurrence_local`) and the blocks are gathered.  ``T``
    must divide by the axis size."""
    n = mesh.axis_size(axis)
    group = mesh.axis_group(axis)

    def fn(xs: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
        if xs.shape[0] % n:
            raise ValueError(f"the sequence-parallel recurrence needs T "
                             f"({xs.shape[0]}) divisible by the {axis} axis "
                             f"size ({n})")
        mine = xs.chunk(n, dim=0)[mesh.axis_index(axis)]
        return coll.gather_from(
            seqpar_recurrence_local(mine, decay, mesh, axis), group, 0)

    return fn
