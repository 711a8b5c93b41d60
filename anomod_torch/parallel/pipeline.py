"""Pipeline parallelism (pp): the TraceTransformer's block stack split
into stages over a ``pipe`` axis (counterpart of
``anomod/parallel/pipeline.py``).

Each ``pipe`` rank holds only its ``layers_per_stage`` attention blocks;
the token embed and the score head are replicated (a small part of the
work).  Microbatches stream through the ranks GPipe-style over ``T = M +
P - 1`` ticks: stage 0 takes microbatch ``min(t, M - 1)``, every other
stage what its predecessor sent on the tick before; every stage applies
its blocks and ``collectives.ppermute`` carries the result one stage on;
the last stage banks the output of microbatch ``t - (P - 1)`` once that is
>= 0.  The banked outputs are masked to the last stage and ``reduce_from``
makes them every rank's.  Reverse-mode autograd runs back through the
``ppermute`` Function (the reverse rotation), so there is no hand-written
backward schedule.

Every rank builds the same graph (stage choices are ``torch.where`` on the
rank's place, not Python branches), so every rank runs the rotations'
backwards in the same order and each one meets its peers.  Only stage 0
reads the embedding, so the embed's gradient is summed over ``pipe``
before the update; the head's is the same on every rank already.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from anomod_torch import rca
from anomod_torch.models.gnn import init_params
from anomod_torch.models.transformer import TraceTransformer
from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel.mesh import Mesh, make_mesh
from anomod_torch.parallel.train import LR

AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_microbatches: int = 2
    layers_per_stage: int = 1
    d_model: int = 32
    n_heads: int = 2
    mlp_hidden: int = 64
    hidden: int = 32


def make_pipe_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """This rank's 1-D ``pipe`` mesh."""
    return make_mesh(n_devices, axis=AXIS, device=device)


def _transformer(cfg: PipelineConfig, S: int, F: int,
                 n_layers: int) -> TraceTransformer:
    return TraceTransformer(F, S, cfg.d_model, cfg.n_heads, n_layers,
                            cfg.mlp_hidden, cfg.hidden)


def init_pipeline(mesh: Mesh, cfg: PipelineConfig, S: int, W: int, F: int,
                  params: Optional[Dict] = None) -> TraceTransformer:
    """This rank's stage on its device: a ``TraceTransformer`` holding the
    embed and the head (replicated) and its own ``layers_per_stage``
    blocks.  Every layer is drawn flax-style from
    ``torch.Generator().manual_seed(0)`` (the same draw on every rank)
    and this stage's blocks kept; or ``params`` is the stage's
    ``state_dict`` (``state.pipeline_params_from_flax``).  ``W`` is the
    model's window count (the head pools over it)."""
    n_stages, lps = mesh.axis_size(AXIS), cfg.layers_per_stage
    stage = _transformer(cfg, S, F, lps)
    if params is not None:
        stage.load_state_dict(params)
    else:
        full = init_params(_transformer(cfg, S, F, n_stages * lps),
                           torch.Generator().manual_seed(0))
        i = mesh.axis_index(AXIS)
        stage.load_state_dict({
            **{k: v for k, v in full.state_dict().items()
               if not k.startswith("blocks.")},
            **{f"blocks.{j}.{k}": v for j in range(lps) for k, v in
               full.blocks[i * lps + j].state_dict().items()}})
    return stage.to(mesh.device)


def make_pipeline_forward(mesh: Mesh, cfg: PipelineConfig, S: int, W: int):
    """``(forward, reference_forward)``, each ``(stage, x [B, S, W, F],
    adj [B, S, S]) -> [B, S]`` scores.  ``forward`` runs this rank's
    ``stage`` in the GPipe schedule over ``mesh``; ``reference_forward``
    is the stage's own forward on one device (given a stage holding every
    layer, the single-program oracle the pipeline must match)."""
    n_stages = mesh.axis_size(AXIS)
    group = mesh.axis_group(AXIS)
    M = cfg.n_microbatches

    def forward(stage: TraceTransformer, x, adj):
        seq = stage.embed(x)                               # [B, L, d]
        B, L, d = seq.shape
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} microbatches")
        micro = seq.reshape(M, B // M, L, d)
        idx = mesh.axis_index(AXIS)
        first = torch.tensor(idx == 0, device=seq.device)
        last = torch.tensor(idx == n_stages - 1, device=seq.device)
        state = torch.zeros_like(micro[0])
        out = [torch.zeros_like(micro[0])] * M
        T = M + n_stages - 1
        for t in range(T):
            inp = torch.where(first, micro[min(t, M - 1)], state)
            y = inp
            for block in stage.blocks:
                y = block(y)
            j = t - (n_stages - 1)           # the microbatch done this tick
            if j >= 0:
                out[j] = torch.where(last, y, out[j])
            if t < T - 1:                    # the last tick's would go unread
                state = coll.ppermute(y, mesh, AXIS)
        out = coll.reduce_from(torch.stack(out), group).reshape(B, L, d)
        return stage.head(out, adj)

    def reference_forward(stage: TraceTransformer, x, adj):
        return stage(x, adj)

    return forward, reference_forward


def sum_embed_grads(stage: TraceTransformer, mesh: Mesh) -> None:
    """Sum the embed's gradients over ``pipe``, in place: only stage 0
    reads the embedding, so only its gradient is not zero, and every
    replica of the embed must take the same update."""
    if mesh.axis_size(AXIS) == 1:
        return
    group = mesh.axis_group(AXIS)
    for p in stage.embed.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)


def make_pipeline_train_step(mesh: Mesh, cfg: PipelineConfig,
                             sample_batch: dict,
                             params: Optional[Dict] = None):
    """``(stage, optimizer, step, put_batch)``: the pp train step on chaos
    labels.  ``sample_batch`` is a stacked batch (``rca._stack``); the
    fused windowed and static features feed the pipelined transformer and
    the loss is the RCA harness's (``rca.rca_loss``).  ``params``: this
    stage's ``state_dict`` to start from (default: :func:`init_pipeline`'s
    seed-0 draw).  The optimizer is ``rca.make_optimizer`` at ``lr=1e-3``
    (``optax.adamw(1e-3)``).  ``put_batch`` puts the whole batch on this
    rank's device; ``step(batch)`` runs one update and returns the loss
    (the same on every rank)."""
    S, W = sample_batch["x_t"].shape[1:3]
    F = sample_batch["x_t"].shape[3] + sample_batch["x"].shape[2]
    forward, _ = make_pipeline_forward(mesh, cfg, S, W)
    stage = init_pipeline(mesh, cfg, S, W, F, params=params)
    optimizer = rca.make_optimizer(stage, lr=LR)

    def put_batch(batch_np: dict) -> Dict[str, torch.Tensor]:
        return rca.to_device(batch_np, mesh.device)

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad()
        loss = rca.rca_loss(forward(stage, rca.fused_features(batch),
                                    batch["adj"]), batch)
        loss.backward()
        sum_embed_grads(stage, mesh)
        optimizer.step()
        return loss.detach()

    return stage, optimizer, step, put_batch
