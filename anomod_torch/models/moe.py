"""Mixture-of-experts RCA scorer (counterpart of ``anomod/models/moe.py``):
the TraceTransformer's tokens through MoE MLP blocks (a softmax router,
the top-k gates renormalized, every expert run on every token: dense
dispatch), then its score head.  Over a whole batch ``[B, S, W, F]``.

The gate mask is ``gates >= kth``, ``kth`` the k-th largest gate: on
ties it keeps more than k experts, as the JAX module does (``topk``
would keep exactly k).  The expert kernels ``w1 [E, d, h]`` and ``w2
[E, h, d]`` keep flax's layout and draw ``lecun_normal`` as flax reads
that shape: the leading expert axis is a receptive field, so the fan-in
is ``E * d`` (``E * h`` for ``w2``), not ``d``.
"""

from __future__ import annotations

import torch
from torch import nn

from anomod_torch.models.gnn import Dense, lecun_normal_
from anomod_torch.models.transformer import (LayerNorm, ScoreHead,
                                             TokenEmbed, gelu)


class MoEBlock(nn.Module):
    """Pre-LN token-wise MoE MLP with its residual, ``[B, T, d] -> [B, T,
    d]``."""

    def __init__(self, d_model: int, n_experts: int = 8, d_hidden: int = 64,
                 top_k: int = 2):
        super().__init__()
        self.top_k = top_k
        self.ln = LayerNorm(d_model)
        self.router = Dense(d_model, n_experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(n_experts, d_model, d_hidden))
        self.b1 = nn.Parameter(torch.empty(n_experts, d_hidden))
        self.w2 = nn.Parameter(torch.empty(n_experts, d_hidden, d_model))
        self.b2 = nn.Parameter(torch.empty(n_experts, d_model))

    @torch.no_grad()
    def draw_params(self, gen: torch.Generator) -> None:
        """Its own parameters: the expert kernels (fan-in over the expert
        and input axes) and zero biases."""
        for w in (self.w1, self.w2):
            t = torch.empty(w.shape)
            lecun_normal_(t, w.shape[0] * w.shape[1], gen)
            w.copy_(t)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, tokens):
        h = self.ln(tokens)
        gates = torch.softmax(self.router(h), dim=-1)
        kth = torch.sort(gates, dim=-1).values[..., -self.top_k, None]
        combine = gates * (gates >= kth).to(gates.dtype)
        combine = combine / combine.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return tokens + self.mix(h, combine)

    def mix(self, h, combine):
        """Every expert on every token, combined by the gate weights
        ``combine [B, T, E]`` (an expert-parallel block runs its own
        experts here)."""
        eh = gelu(torch.einsum("btd,edh->beth", h, self.w1)
                  + self.b1[:, None, :])
        ey = torch.einsum("beth,ehd->betd", eh, self.w2) + self.b2[:, None, :]
        return torch.einsum("betd,bte->btd", ey, combine)


class MoERCA(nn.Module):
    """``forward(x [B,S,W,F], adj [B,S,S]) -> [B,S]`` culprit scores."""

    def __init__(self, in_features: int, n_services: int, d_model: int = 48,
                 n_layers: int = 2, n_experts: int = 8, d_hidden: int = 96,
                 top_k: int = 2, hidden: int = 64):
        super().__init__()
        self.embed = TokenEmbed(in_features, n_services, d_model)
        self.blocks = nn.ModuleList(
            MoEBlock(d_model, n_experts, d_hidden, top_k)
            for _ in range(n_layers))
        self.head = ScoreHead(d_model, hidden)

    def forward(self, x_swf, adj):
        seq = self.embed(x_swf)
        for block in self.blocks:
            seq = block(seq)
        return self.head(seq, adj)
