"""Sparse GNN scorers over the service DAG (counterpart of
``anomod/models/gnn.py``), as ``nn.Module``s that take a whole batch.

Every model maps a batch of graphs to per-service culprit logits
``[B, S]``.  Where the JAX package vmaps one graph's model over the batch,
these run ``[B, S, F]`` directly: GCN multiplies by the batch of
normalized adjacencies, and message passing (GraphSAGE, GAT) runs over the
``B*S`` flattened nodes, each graph's padded edge list offset by ``b*S``,
with ``index_add_`` (segment sum; on the card the sorted
``index_put_(accumulate=True)``, since the CUDA ``index_add_`` adds with
atomics in an order that changes from run to run) and
``scatter_reduce_(reduce="amax")`` (segment max).  Edges carry the call
direction (caller -> callee); messages flow both ways through the
symmetrized edge list.

Parameters start as flax initializes them, drawn from an explicit
``torch.Generator`` (:func:`init_params`, which every family's model
shares): dense kernels ``lecun_normal`` (a normal truncated at two
standard deviations, std ``sqrt(1 / fan_in) / 0.87962566``), biases zero,
GAT's attention vectors ``glorot_uniform``.  ``state.params_from_flax``
carries a flax tree across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """``y = x W^T + b`` with ``W`` [out, in] (``nn.Linear``'s layout),
    created uninitialized: :func:`init_params` draws it."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def normalized_adjacency(adj_counts: torch.Tensor,
                         add_self_loops: bool = True) -> torch.Tensor:
    """Symmetric GCN normalization D^-1/2 (A + A^T + I) D^-1/2 of a batch
    of dense call-count matrices ``[..., S, S]`` (counts binarized)."""
    a = (adj_counts > 0).to(torch.float32)
    a = torch.maximum(a, a.transpose(-1, -2))
    if add_self_loops:
        a = a + torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    d = a.sum(dim=-1)
    d_inv_sqrt = torch.where(d > 0, 1.0 / torch.sqrt(d.clamp(min=1e-9)),
                             torch.zeros_like(d))
    return a * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def segment_sum(messages: torch.Tensor, dst: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over the leading axis.  On a CUDA tensor
    the sum goes through ``index_put_(accumulate=True)``, which sorts the
    indices and adds each segment's terms in a fixed order: the CUDA
    ``index_add_`` adds them with atomics, whose order changes from run to
    run, and training amplifies those last bits into losses that drift
    apart over a few epochs."""
    out = messages.new_zeros((num_segments,) + messages.shape[1:])
    if out.is_cuda:
        return out.index_put_((dst,), messages, accumulate=True)
    return out.index_add(0, dst, messages)


def segment_max(values: torch.Tensor, dst: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` over the leading axis: a segment with no
    entries stays at -inf."""
    idx = dst.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    out = values.new_full((num_segments,) + values.shape[1:], -math.inf)
    return out.scatter_reduce(0, idx, values, reduce="amax",
                              include_self=False)


def segment_mean(messages: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    s = segment_sum(messages, dst, num_nodes)
    cnt = segment_sum(messages.new_ones(messages.shape[0]), dst, num_nodes)
    return s / cnt.clamp(min=1.0)[:, None]


def flat_edges(src: torch.Tensor, dst: torch.Tensor, n_nodes: int):
    """``[B, E]`` per-graph edge endpoints -> ``[B*E]`` indices into the
    ``B*S`` flattened nodes."""
    off = torch.arange(src.shape[0], device=src.device,
                       dtype=src.dtype)[:, None] * n_nodes
    return (src + off).reshape(-1).long(), (dst + off).reshape(-1).long()


class GCNLayer(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = Dense(in_features, features)

    def forward(self, h, a_norm):
        # dense S x S product, batched: S <= 64
        return self.dense(torch.matmul(a_norm, h))


class GCN(nn.Module):
    """2-layer GCN anomaly scorer (BASELINE.json config 3).
    ``forward(x [B,S,F], adj [B,S,S]) -> [B,S]``."""

    def __init__(self, in_features: int, hidden: int = 64,
                 n_layers: int = 2):
        super().__init__()
        dims = [in_features] + [hidden] * n_layers
        self.layers = nn.ModuleList(
            GCNLayer(dims[i], dims[i + 1]) for i in range(n_layers))
        self.out = Dense(hidden, 1)

    def forward(self, x, adj):
        a = normalized_adjacency(adj)
        h = x
        for layer in self.layers:
            h = F.relu(layer(h, a))
        return self.out(h)[..., 0]          # per-service culprit logit


def _symmetrize(edge_src, edge_dst, edge_mask, loops: Optional[int] = None):
    """``[B, E]`` edges -> both directions (and ``loops`` self loops)."""
    src = [edge_src, edge_dst]
    dst = [edge_dst, edge_src]
    mask = [edge_mask, edge_mask]
    if loops is not None:
        ar = torch.arange(loops, device=edge_src.device,
                          dtype=edge_src.dtype).expand(edge_src.shape[0], -1)
        src.append(ar)
        dst.append(ar)
        mask.append(torch.ones_like(ar, dtype=edge_mask.dtype))
    return torch.cat(src, dim=1), torch.cat(dst, dim=1), torch.cat(mask, 1)


class SAGELayer(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.self_dense = Dense(in_features, features)
        self.neigh_dense = Dense(in_features, features)


class GraphSAGE(nn.Module):
    """GraphSAGE with mean aggregation over the padded edge list.
    ``forward(x [B,S,F], edge_src, edge_dst, edge_mask [B,E]) -> [B,S]``."""

    def __init__(self, in_features: int, hidden: int = 64,
                 n_layers: int = 2):
        super().__init__()
        dims = [in_features] + [hidden] * n_layers
        self.layers = nn.ModuleList(
            SAGELayer(dims[i], dims[i + 1]) for i in range(n_layers))
        self.out = Dense(hidden, 1)

    def forward(self, x, edge_src, edge_dst, edge_mask):
        B, S, _ = x.shape
        src, dst, mask = _symmetrize(edge_src, edge_dst, edge_mask)
        src, dst = flat_edges(src, dst, S)
        mask = mask.reshape(-1).to(x.dtype)
        h = x.reshape(B * S, -1)
        for layer in self.layers:
            neigh = segment_mean(h[src] * mask[:, None], dst, B * S)
            h = F.relu(layer.self_dense(h) + layer.neigh_dense(neigh))
            h = h / torch.linalg.vector_norm(
                h, dim=-1, keepdim=True).clamp(min=1e-6)
        return self.out(h)[:, 0].reshape(B, S)


class GATLayer(nn.Module):
    def __init__(self, in_features: int, features: int, n_heads: int = 4):
        super().__init__()
        self.features, self.n_heads = features, n_heads
        self.proj = Dense(in_features, features * n_heads, bias=False)
        self.a_src = nn.Parameter(torch.empty(n_heads, features))
        self.a_dst = nn.Parameter(torch.empty(n_heads, features))

    def forward(self, h, src, dst, mask):
        """``h`` [N, F_in] flattened nodes; ``src``/``dst``/``mask`` [M]
        flattened edges."""
        N = h.shape[0]
        wh = self.proj(h).reshape(N, self.n_heads, self.features)
        e = ((wh * self.a_src).sum(-1)[src]
             + (wh * self.a_dst).sum(-1)[dst])                   # [M, Hd]
        e = F.leaky_relu(e, negative_slope=0.2)
        e = torch.where(mask[:, None], e, torch.full_like(e, -1e9))
        # segment softmax over the incoming edges of each dst
        e_max = segment_max(e, dst, N)
        e = torch.exp(e - e_max[dst]) * mask[:, None]
        denom = segment_sum(e, dst, N)
        alpha = e / denom[dst].clamp(min=1e-9)                   # [M, Hd]
        out = segment_sum(wh[src] * alpha[:, :, None], dst, N)
        return out.reshape(N, self.n_heads * self.features)


class GAT(nn.Module):
    """Graph attention RCA scorer (BASELINE.json config 4).
    ``forward(x [B,S,F], edge_src, edge_dst, edge_mask [B,E]) -> [B,S]``."""

    def __init__(self, in_features: int, hidden: int = 32, n_heads: int = 4,
                 n_layers: int = 2):
        super().__init__()
        dims = [in_features] + [hidden * n_heads] * n_layers
        self.layers = nn.ModuleList(
            GATLayer(dims[i], hidden, n_heads) for i in range(n_layers))
        self.out = Dense(hidden * n_heads, 1)

    def forward(self, x, edge_src, edge_dst, edge_mask):
        B, S, _ = x.shape
        # symmetrize + self loops so every node attends to itself
        src, dst, mask = _symmetrize(edge_src, edge_dst, edge_mask, loops=S)
        src, dst = flat_edges(src, dst, S)
        mask = mask.reshape(-1).bool()
        h = x.reshape(B * S, -1)
        for layer in self.layers:
            h = F.elu(layer(h, src, dst, mask))
        return self.out(h)[:, 0].reshape(B, S)


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Normal(0, std) truncated to [-2 std, 2 std], by inverse CDF from
    ``gen``'s uniforms (the ``lecun_normal`` draw)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(
        2 * lo - 1, 2 * hi - 1, generator=gen)
    v = torch.erfinv(u) * (math.sqrt(2.0) * std)
    with torch.no_grad():
        t.copy_(v.clamp(-2.0 * std, 2.0 * std))


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated at two of its scales,
    scaled so that its variance is ``1 / fan_in``."""
    _trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` (on the host, from ``gen``) as
    flax initializes it, then copy it to the parameter's device; returns
    ``model``.  The draw order is the modules' registration order.  A
    module draws its own parameters (not its children's) where it has a
    ``draw_params(gen)`` method; dense layers and GAT's attention vectors
    are drawn here."""
    for mod in model.modules():
        if hasattr(mod, "draw_params"):
            mod.draw_params(gen)
        elif isinstance(mod, Dense):
            w = torch.empty(mod.weight.shape)
            lecun_normal_(w, w.shape[1], gen)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, GATLayer):
            for p in (mod.a_src, mod.a_dst):
                fan_in, fan_out = p.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                p.copy_(torch.empty(p.shape).uniform_(-limit, limit,
                                                      generator=gen))
    return model
