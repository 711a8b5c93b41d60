"""Temporal GNN (counterpart of ``anomod/models/temporal.py``): windowed
multimodal features -> a GRU over the windows -> a 2-layer GCN scorer,
over a whole batch ``[B, S, W, F]`` (the JAX package vmaps one graph).

The GRU cell is flax's (``flax.linen.GRUCell``), not ``torch.nn.GRU``:
input kernels ``ir`` / ``iz`` / ``in`` with bias, recurrent kernels
``hr`` / ``hz`` without and ``hn`` with, ``n = tanh(in(x) + r * hn(h))``.
``torch.nn.GRU`` carries a second bias on every recurrent gate, which
AdamW's weight decay would move away from the flax model.  The recurrent
kernels start orthogonal, the input kernels ``lecun_normal``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from anomod_torch.models.gnn import Dense, GCNLayer, normalized_adjacency


class RecurrentDense(Dense):
    """A GRU recurrent kernel: drawn orthogonal, as flax's
    ``recurrent_kernel_init`` (``initializers.orthogonal()``) draws it."""

    @torch.no_grad()
    def draw_params(self, gen: torch.Generator) -> None:
        rows, cols = self.weight.shape
        a = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float64).normal_(generator=gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        self.weight.copy_(q if rows >= cols else q.T)
        if self.bias is not None:
            self.bias.zero_()


class GRUCell(nn.Module):
    """flax's ``GRUCell`` over ``[..., hidden]`` states."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ir = Dense(in_features, features)
        self.iz = Dense(in_features, features)
        self.in_ = Dense(in_features, features)
        self.hr = RecurrentDense(features, features, bias=False)
        self.hz = RecurrentDense(features, features, bias=False)
        self.hn = RecurrentDense(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class TemporalGCN(nn.Module):
    """GRU over windows, then a 2-layer GCN over the service DAG.
    ``forward(x [B,S,W,F], adj [B,S,S]) -> [B,S]``."""

    def __init__(self, in_features: int, hidden: int = 64,
                 gnn_hidden: int = 64):
        super().__init__()
        self.dense_in = Dense(in_features, hidden)
        self.gru = GRUCell(hidden, hidden)
        self.gcn = nn.ModuleList([GCNLayer(hidden, gnn_hidden),
                                  GCNLayer(gnn_hidden, gnn_hidden)])
        self.out = Dense(gnn_hidden, 1)

    def forward(self, x_swf, adj):
        x = self.dense_in(x_swf)                           # [B, S, W, h]
        h = x.new_zeros(x.shape[:2] + x.shape[3:])
        for t in range(x.shape[2]):
            h = self.gru(h, x[:, :, t])
        a = normalized_adjacency(adj)
        for layer in self.gcn:
            h = F.relu(layer(h, a))
        return self.out(h)[..., 0]
