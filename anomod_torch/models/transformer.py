"""TraceTransformer (counterpart of ``anomod/models/transformer.py``):
tokens are (service, window) cells of the windowed features, a service
embedding and a sinusoidal window position added; pre-LN attention blocks
over each sample's ``S * W`` tokens (no mixing across the batch axis),
then a head that pools windows, takes one adjacency hop and scores
services.  Over a whole batch ``[B, S, W, F]``.

Two flax defaults differ from PyTorch's, and these modules follow flax:
``LayerNorm`` uses eps 1e-6 and the variance ``E[x^2] - E[x]^2`` (flax's
``use_fast_variance``), and ``nn.gelu`` is the tanh approximation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anomod_torch.models.gnn import Dense, normalized_adjacency
from anomod_torch.parallel.ring_attention import full_attention


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Standard fixed sin/cos position table [n, d]."""
    pos = np.arange(n)[:, None].astype(np.float32)
    i = np.arange((d + 1) // 2)[None, :].astype(np.float32)
    angles = pos / np.power(10_000.0, 2.0 * i / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(angles)
    out[:, 1::2] = np.cos(angles[:, : d // 2])
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis: ``scale`` ones and ``bias``
    zeros at the start, eps 1e-6, variance ``E[x^2] - E[x]^2`` (clamped
    at 0), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def draw_params(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class TokenEmbed(nn.Module):
    """``[B, S, W, F]`` windowed features -> ``[B, S*W, d_model]`` tokens:
    a feature projection, a learned service embedding (drawn
    ``normal(0.02)``) and the sinusoidal window position."""

    def __init__(self, in_features: int, n_services: int, d_model: int):
        super().__init__()
        self.dense = Dense(in_features, d_model)
        self.svc_emb = nn.Parameter(torch.empty(n_services, d_model))

    @torch.no_grad()
    def draw_params(self, gen: torch.Generator) -> None:
        self.svc_emb.copy_(torch.empty(self.svc_emb.shape).normal_(
            0.0, 0.02, generator=gen))

    def service_embedding(self) -> torch.Tensor:
        """The ``[S, d_model]`` service embedding (a tensor-parallel
        embed gathers its column slices here)."""
        return self.svc_emb

    def forward(self, x_swf):
        B, S, W, _ = x_swf.shape
        svc_emb = self.service_embedding()
        d = svc_emb.shape[1]
        pos = torch.from_numpy(sinusoidal_positions(W, d)).to(x_swf.device)
        tok = self.dense(x_swf) + svc_emb[:, None, :] + pos[None]
        return tok.reshape(B, S * W, d)


class ScoreHead(nn.Module):
    """``[B, S*W, d]`` tokens + ``[B, S, S]`` adjacency -> ``[B, S]``:
    LayerNorm, window mean-pool, one adjacency hop, a scoring MLP."""

    def __init__(self, d_model: int, hidden: int = 64):
        super().__init__()
        self.ln = LayerNorm(d_model)
        self.dense = Dense(2 * d_model, hidden)
        self.out = Dense(hidden, 1)

    def forward(self, seq, adj_counts):
        B, S = adj_counts.shape[:2]
        h = self.ln(seq)
        h = h.reshape(B, S, seq.shape[1] // S, -1).mean(dim=2)
        a = normalized_adjacency(adj_counts)
        h = torch.cat([h, torch.matmul(a, h)], dim=-1)
        h = F.relu(self.dense(h))
        return self.out(h)[..., 0]


class AttentionBlock(nn.Module):
    """Pre-LN block over ``[B, L, d_model]``: ``attention_fn`` a sample
    (``[..., L, H, D]``; ``full_attention``, which
    ``parallel.sp_transformer`` swaps for a sequence-parallel plane on
    its copies of the blocks), then a tanh-GELU MLP, each with its
    residual."""

    def __init__(self, d_model: int, n_heads: int, mlp_hidden: int):
        super().__init__()
        self.n_heads = n_heads
        self.attention_fn = full_attention
        self.ln0 = LayerNorm(d_model)
        self.qkv = Dense(d_model, 3 * d_model, bias=False)
        self.proj = Dense(d_model, d_model)
        self.ln1 = LayerNorm(d_model)
        self.mlp_in = Dense(d_model, mlp_hidden)
        self.mlp_out = Dense(mlp_hidden, d_model)

    def forward(self, seq):
        B, L, d = seq.shape
        q, k, v = self.qkv(self.ln0(seq)).split(d, dim=-1)
        shape = (B, L, self.n_heads, d // self.n_heads)
        attn = self.attention_fn(q.reshape(shape), k.reshape(shape),
                                 v.reshape(shape)).reshape(B, L, d)
        seq = seq + self.proj(attn)
        h = gelu(self.mlp_in(self.ln1(seq)))
        return seq + self.mlp_out(h)


class TraceTransformer(nn.Module):
    """``forward(x [B,S,W,F], adj [B,S,S]) -> [B,S]`` culprit scores."""

    def __init__(self, in_features: int, n_services: int, d_model: int = 48,
                 n_heads: int = 4, n_layers: int = 2, mlp_hidden: int = 96,
                 hidden: int = 64):
        super().__init__()
        self.embed = TokenEmbed(in_features, n_services, d_model)
        self.blocks = nn.ModuleList(
            AttentionBlock(d_model, n_heads, mlp_hidden)
            for _ in range(n_layers))
        self.head = ScoreHead(d_model, hidden)

    def forward(self, x_swf, adj):
        seq = self.embed(x_swf)
        for block in self.blocks:
            seq = block(seq)
        return self.head(seq, adj)
