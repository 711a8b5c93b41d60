"""Edge-native RCA (counterpart of ``anomod/models/linegraph.py``): each
observed (caller, callee) edge is a token with its own pooled windowed
features and contrast features (its deviation from the callee's other
in-edges and the caller's other out-edges); the node channel is the
TraceTransformer's backbone.  Service scores combine the node logit with
direction-aware peak and mean readouts of the incident edges' logits.

Over a whole batch: the incidence is one-hot ``[B, E, S]`` a sample, the
padded edges' rows masked to zero, every edge <-> node exchange a batched
matmul within a sample, and a padded edge's logit ``-1e9`` (a service
with no incident edge reads 0), term by term as the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from anomod_torch.models.gnn import Dense
from anomod_torch.models.transformer import (AttentionBlock, ScoreHead,
                                             TokenEmbed)


def _pool_windows(t: torch.Tensor) -> torch.Tensor:
    """``[..., W, F] -> [..., 3F]``: mean / max / mean-positive over the
    windows."""
    return torch.cat([t.mean(dim=-2), t.amax(dim=-2),
                      F.relu(t).mean(dim=-2)], dim=-1)


class LineGraphRCA(nn.Module):
    """Edge-token culprit scorer: ``forward(x [B,S,Fs], x_t [B,S,W,Fn],
    edge_x [B,E,W,Fe], src, dst [B,E] int, mask [B,E] bool) -> [B,S]``."""

    def __init__(self, static_features: int, temporal_features: int,
                 n_services: int, edge_features: int = 4, d_model: int = 48,
                 n_heads: int = 4, n_layers: int = 2, mlp_hidden: int = 96,
                 hidden: int = 64):
        super().__init__()
        self.embed = TokenEmbed(temporal_features + static_features,
                                n_services, d_model)
        self.blocks = nn.ModuleList(
            AttentionBlock(d_model, n_heads, mlp_hidden)
            for _ in range(n_layers))
        self.head = ScoreHead(d_model, hidden)
        self.edge_in = Dense(9 * edge_features + 6 * temporal_features,
                             hidden)
        self.edge_hidden = Dense(hidden, hidden)
        self.edge_out = Dense(hidden, 1)
        self.mix_hidden = Dense(6, 16)
        self.mix_out = Dense(6 + 16, 1)

    def forward(self, x, x_t, edge_x, src, dst, mask):
        B, S, W, _ = x_t.shape
        m = mask.to(torch.float32)[..., None]                  # [B, E, 1]
        eye = torch.eye(S, dtype=torch.float32, device=x.device)
        inc_src = eye[src.long()] * m                          # [B, E, S]
        inc_dst = eye[dst.long()] * m
        src_t, dst_t = inc_src.transpose(1, 2), inc_dst.transpose(1, 2)
        deg_out = inc_src.sum(dim=1).clamp(min=1.0)[..., None]

        # node channel: the zoo's sequence backbone
        x_full = torch.cat([x_t, x[:, :, None, :].expand(-1, -1, W, -1)],
                           dim=-1)
        seq = self.embed(x_full)
        for block in self.blocks:
            seq = block(seq)
        node_logit = self.head(seq, torch.matmul(src_t, inc_dst))

        # edge channel: pooled tokens + contrast features
        pe = _pool_windows(edge_x) * m                         # [B, E, 3Fe]
        sum_out = torch.matmul(src_t, pe)                      # [B, S, 3Fe]
        sum_in = torch.matmul(dst_t, pe)
        n_out = inc_src.sum(dim=1)[..., None]
        n_in = inc_dst.sum(dim=1)[..., None]
        excl_in = (torch.matmul(inc_dst, sum_in) - pe) / (
            torch.matmul(inc_dst, n_in) - 1.0).clamp(min=1.0)
        excl_out = (torch.matmul(inc_src, sum_out) - pe) / (
            torch.matmul(inc_src, n_out) - 1.0).clamp(min=1.0)
        node_pool = _pool_windows(x_t)                         # [B, S, 3Fn]
        e_in = torch.cat([pe, pe - excl_in, pe - excl_out,
                          torch.matmul(inc_src, node_pool),
                          torch.matmul(inc_dst, node_pool)], dim=-1)
        h_e = F.relu(self.edge_in(e_in)) * m
        h_e = F.relu(self.edge_hidden(h_e)) * m
        edge_logit = self.edge_out(h_e)[..., 0]
        edge_logit = torch.where(mask, edge_logit,
                                 torch.full_like(edge_logit, -1e9))

        def peak(inc_t):
            v = torch.where(inc_t > 0, edge_logit[:, None, :],
                            torch.full_like(inc_t, -1e9)).amax(dim=-1)
            return torch.where(v < -1e8, torch.zeros_like(v), v)

        out_peak, in_peak = peak(src_t), peak(dst_t)
        masked = torch.where(mask, edge_logit, torch.zeros_like(edge_logit))
        out_mean = (torch.matmul(src_t, masked[..., None]) / deg_out)[..., 0]
        diff = out_peak - in_peak
        feats = torch.stack([node_logit, out_peak, in_peak, out_mean, diff,
                             torch.maximum(diff, torch.zeros_like(diff))],
                            dim=-1)
        hid = F.relu(self.mix_hidden(feats))
        return self.mix_out(torch.cat([feats, hid], dim=-1))[..., 0]
