"""LRU-style temporal model (counterpart of ``anomod/models/lru.py``):
``h_t = sigmoid(decay_logit + 1) * h_{t-1} + W x_t`` over the windows,
then a 2-layer GCN head, over a whole batch ``[B, S, W, F]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from anomod_torch.models.gnn import Dense, GCNLayer, normalized_adjacency
from anomod_torch.parallel.seqscan import linear_recurrence


class TemporalLRU(nn.Module):
    """Linear-recurrence temporal encoder + 2-layer GCN head.
    ``forward(x [B,S,W,F], adj [B,S,S]) -> [B,S]``."""

    def __init__(self, in_features: int, hidden: int = 64,
                 gnn_hidden: int = 64):
        super().__init__()
        self.dense_in = Dense(in_features, hidden)
        # learnable per-channel decay logit, drawn uniform on [0, 2)
        self.decay_logit = nn.Parameter(torch.empty(hidden))
        self.gcn = nn.ModuleList([GCNLayer(hidden, gnn_hidden),
                                  GCNLayer(gnn_hidden, gnn_hidden)])
        self.out = Dense(gnn_hidden, 1)

    @torch.no_grad()
    def draw_params(self, gen: torch.Generator) -> None:
        """Its own parameter: flax's ``uniform(2.0)``."""
        self.decay_logit.copy_(torch.empty(self.decay_logit.shape).uniform_(
            0.0, 2.0, generator=gen))

    def forward(self, x_swf, adj):
        x = self.dense_in(x_swf)                           # [B, S, W, h]
        decay = torch.sigmoid(self.decay_logit + 1.0)
        h = linear_recurrence(x.movedim(2, 0), decay)[-1]  # [B, S, h]
        a = normalized_adjacency(adj)
        for layer in self.gcn:
            h = F.relu(layer(h, a))
        return self.out(h)[..., 0]
