"""Sequence-parallel TraceTransformer forward: the RCA scorer's attention
core swapped for a mesh plane, the parameters shared (counterpart of
``anomod/parallel/sp_transformer.py``).

The single-device ``TraceTransformer`` computes its attention through
``ring_attention.full_attention``; this builder gives the same model with
that core replaced by the ring (``ppermute`` K/V rotation) or the Ulysses
(``all_to_all`` head scatter) plane over one mesh axis.  Every rank
computes the embed, the blocks' projections and MLPs and the score head
on the whole token sequence; each rank attends with its ``L/P`` query
block and the output blocks are gathered before the next projection.
The parameters are the model's own, so a model trained on one card scores
sequence-parallel unchanged (and back).

The planes set the constraints: the axis size must divide the ``S * W``
token count, and Ulysses also needs ``n_heads`` divisible by it.
"""

from __future__ import annotations

import copy

from torch import nn

from anomod_torch.parallel.mesh import Mesh
from anomod_torch.parallel.ring_attention import make_ring_attention
from anomod_torch.parallel.ulysses import make_ulysses_attention


def make_sp_transformer(mesh: Mesh, model, plane: str = "ring"):
    """``model`` (a port ``TraceTransformer``) with its attention core
    swapped for ``plane`` over the mesh's ``data`` axis: a module whose
    forward is ``(x_swf, adj_counts) -> [B, S]``, sharing ``model``'s
    parameters (the same ``Parameter`` objects; ``model`` itself is left
    as it is).  The port's models take their widths from a batch, so the
    model is given (``rca.init_model("transformer", batch)`` is the zoo
    configuration).  An unknown ``plane`` raises ``ValueError``."""
    if plane == "ring":
        attn = make_ring_attention(mesh)
    elif plane == "ulysses":
        attn = make_ulysses_attention(mesh)
    else:
        raise ValueError(f"unknown sequence-parallel plane {plane!r}")
    sp_model = copy.copy(model)
    # fresh module tables: the blocks below replace the model's in the
    # copy only; every block copy shares its parameters' table
    sp_model._modules = dict(model._modules)
    blocks = []
    for block in model.blocks:
        twin = copy.copy(block)
        twin.attention_fn = attn
        blocks.append(twin)
    sp_model.blocks = nn.ModuleList(blocks)
    return sp_model
