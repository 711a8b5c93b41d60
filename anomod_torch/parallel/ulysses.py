"""Ulysses all-to-all sequence parallelism, the second long-context plane
(counterpart of ``anomod/parallel/ulysses.py``).

Where ring attention keeps the sequence sharded and rotates K/V blocks in
n ``ppermute`` steps, the all-to-all layout swap moves activations twice
an attention call:

  [..., L/P, H, D]  --all_to_all-->  [..., L, H/P, D]   (heads sharded)
       ... ``full_attention`` over the whole sequence, per head ...
  [..., L, H/P, D]  --all_to_all-->  [..., L/P, H, D]

Each rank runs the unmodified dense attention for its heads: exact, two
collective hops whatever the ring size, but ``n_heads`` must divide by
the axis size and each rank holds full-L scores.
"""

from __future__ import annotations

import torch

from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel.mesh import Axes, Mesh
from anomod_torch.parallel.ring_attention import (full_attention,
                                                  make_sharded_attention)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh: Mesh,
                            axis: Axes = "data") -> torch.Tensor:
    """Exact attention of this rank's blocks ``[..., L/P, H, D]`` by a
    head scatter / sequence gather; ``H`` must divide by the axis size.
    Returns this rank's output block."""
    n = mesh.axis_size(axis)
    if q.shape[-2] % n:
        raise ValueError(
            f"ulysses attention needs n_heads divisible by the mesh axis: "
            f"{q.shape[-2]} heads over {n} devices")

    def seq_gather(x):          # [..., L/P, H, D] -> [..., L, H/P, D]
        return coll.all_to_all(x, mesh, axis, split_dim=-2, concat_dim=-3)

    out = full_attention(seq_gather(q), seq_gather(k), seq_gather(v))
    # head gather / sequence scatter back to the resident layout
    return coll.all_to_all(out, mesh, axis, split_dim=-3, concat_dim=-2)


def make_ulysses_attention(mesh: Mesh, axis: Axes = "data"):
    """Ulysses attention over ``axis``: ``attend(q, k, v)`` on the whole
    ``[..., L, H, D]`` (``ring_attention.make_sharded_attention``); a
    drop-in for the ring plane."""
    return make_sharded_attention(ulysses_attention_local, mesh, axis)
