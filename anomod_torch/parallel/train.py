"""Distributed RCA training step: dp x tp (and ep) over a 2-D mesh
(counterpart of ``anomod/parallel/train.py``).

JAX annotates shardings and lets XLA insert the collectives; here every
collective is written out, under the convention of
``anomod_torch.parallel.collectives``:

- the batch's leading (experiment) axis is split over the mesh's dp axes
  (every axis but ``model``: ``data`` of ``make_mesh2d``, ``(dcn, data)``
  of the hybrid mesh);
- a parameter that :func:`param_spec` shards (the JAX ``_param_spec``
  rule on the port's names) lives on a rank as its ``model`` slice, and
  its layer is swapped in place for its tensor-parallel form, names
  unchanged: a column-sharded ``Dense`` multiplies by its own rows of the
  weight (``copy_to`` -> ``F.linear`` on the slice -> ``gather_from`` ->
  the replicated bias); a ``TokenEmbed`` gathers its service embedding's
  column slices; a ``MoEBlock`` runs only its own ``E/m`` experts against
  its slice of the combine weights and ``reduce_from`` sums the experts'
  outputs over ``model`` (expert parallelism);
- the loss is the whole batch's: each dp shard divides its terms by the
  whole batch's target and sample counts (``all_reduce``, no gradient), so
  the shards' losses sum to it; after the backward every gradient is
  summed over the dp axes (inner axis first), so every replica applies the
  same update and replicas stay equal bit for bit.

Unsharded (``model`` of size 1) the layers are the single-device ones, and
with one dp shard the loss is ``rca.rca_loss`` itself.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from anomod_torch import rca
from anomod_torch.models.gnn import Dense, init_params
from anomod_torch.models.moe import MoEBlock
from anomod_torch.models.transformer import TokenEmbed
from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel.mesh import Mesh, make_named_mesh
from anomod_torch.state import flax_names, shard_state_dict

#: ``put_batch``'s staging modes (the JAX names)
STAGES = ("global", "process-local")
#: the JAX step's optimizer: ``optax.adamw(1e-3)``
LR = 1e-3
#: the ``model`` axis of :func:`make_mesh2d` (the JAX default)
MODEL_AXIS = 2
_EXPERTS = ("w1", "b1", "w2", "b2")


def make_mesh2d(n_devices: int, device=None) -> Mesh:
    """This rank's ``(data, model)`` mesh over an ``n_devices`` group; the
    model axis is :data:`MODEL_AXIS`, shrunk to 1 if it does not divide
    ``n_devices``."""
    model = MODEL_AXIS if n_devices % MODEL_AXIS == 0 and n_devices > 1 \
        else 1
    return make_named_mesh([("data", n_devices // model), ("model", model)],
                           device)


def param_spec(model_name: str, state_dict, n_model: int
               ) -> Dict[str, Optional[int]]:
    """The dimension each parameter is sharded along over a ``model``
    axis of ``n_model`` (None: replicated), by the JAX ``_param_spec``
    rule read through the flax name of each key (``state.flax_names``):
    the ``MoEBlock`` expert tensors (``w1``/``b1``/``w2``/``b2``, not the
    router) shard their leading ``[E]`` axis when it divides; every other
    2-D leaf whose flax output width (its dim 1) divides is column-sharded:
    dim 0 of the port's ``[out, in]`` dense weight, dim 1 of a leaf kept in
    the flax layout (the service embedding)."""
    specs: Dict[str, Optional[int]] = {}
    for key, path, kernel in flax_names(model_name, state_dict):
        shape = tuple(state_dict[key].shape)
        flax_shape = shape[::-1] if kernel else shape
        spec = None
        if n_model > 1:
            in_expert = "MoEBlock" in "/".join(path) and "router" not in path
            if in_expert and len(shape) >= 2 and shape[0] % n_model == 0:
                spec = 0
            elif len(shape) == 2 and flax_shape[1] % n_model == 0:
                spec = 0 if kernel else 1
        specs[key] = spec
    return specs


class _ModelSlice:
    """A layer's place on the ``model`` axis: its group, size and index."""

    def _set_slice(self, group, n: int, index: int) -> None:
        self.group, self.n_model, self.model_index = group, n, index


class ColumnDense(Dense, _ModelSlice):
    """A ``Dense`` column-sharded over ``model``: the rank holds its
    ``[out/m, in]`` rows of the weight and the whole (replicated) bias."""

    def forward(self, x):
        y = F.linear(coll.copy_to(x, self.group), self.weight)
        y = coll.gather_from(y, self.group, -1)
        return y if self.bias is None else y + self.bias


class ColumnTokenEmbed(TokenEmbed, _ModelSlice):
    """A ``TokenEmbed`` whose service embedding is column-sharded: the
    rank holds ``[S, d/m]`` and gathers the columns where it is added."""

    def service_embedding(self):
        return coll.gather_from(self.svc_emb, self.group, 1)


class ExpertParallelMoEBlock(MoEBlock, _ModelSlice):
    """A ``MoEBlock`` holding its ``E/m`` experts: they run on every token
    against this rank's slice of the combine weights, and the experts'
    combined outputs are summed over ``model``."""

    def mix(self, h, combine):
        e = self.w1.shape[0]
        lo = self.model_index * e
        mine = coll.copy_to(combine, self.group)[..., lo:lo + e]
        return coll.reduce_from(
            super().mix(coll.copy_to(h, self.group), mine), self.group)


#: each sharded parameter's layer and its tensor-parallel form
_TP_FORMS = ((Dense, ("weight",), 0, ColumnDense),
             (TokenEmbed, ("svc_emb",), 1, ColumnTokenEmbed),
             (MoEBlock, _EXPERTS, 0, ExpertParallelMoEBlock))


def shard_model(model: nn.Module, specs: Dict[str, Optional[int]],
                mesh: Mesh) -> nn.Module:
    """Swap, in place, every layer that holds a sharded parameter for its
    tensor-parallel form over ``mesh``'s ``model`` axis and load this
    rank's slice of the model's parameters (``state.shard_state_dict``;
    ``state_dict`` keys unchanged).  A sharded parameter with no
    tensor-parallel form raises."""
    group = mesh.axis_group("model")
    n, index = mesh.axis_size("model"), mesh.axis_index("model")
    full = model.state_dict()
    done = set()
    for prefix, module in model.named_modules():
        for cls, names, dim, form in _TP_FORMS:
            keys = [f"{prefix}.{p}" if prefix else p for p in names]
            if type(module) is not cls or specs.get(keys[0]) is None:
                continue
            if any(specs.get(k) != dim for k in keys):
                raise ValueError(f"{prefix}: {names} are not all sharded "
                                 f"along dim {dim}")
            for p in names:
                shape = list(getattr(module, p).shape)
                shape[dim] //= n
                setattr(module, p, nn.Parameter(torch.empty(shape)))
            module.__class__ = form
            module._set_slice(group, n, index)
            done.update(keys)
    rest = sorted(k for k, d in specs.items() if d is not None and k not in
                  done)
    if rest:
        raise ValueError(f"no tensor-parallel form for {rest}")
    model.load_state_dict(shard_state_dict(full, specs, index, n))
    return model


def _psum_over(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        dist.all_reduce(x, group=group)
    return x


def make_distributed_train_step(model_name: str, sample_batch: dict,
                                mesh: Mesh, stage: str = "global",
                                params=None):
    """``(model, optimizer, step, put_batch)`` of this rank.

    ``sample_batch``: a stacked numpy batch (``rca._stack``); its leading
    axis is the dp axis and must divide by the size of the mesh's dp axes.
    ``params``: a full ``state_dict`` to start from (default: the port's
    seed-0 draw, the same on every rank); this rank keeps its ``model``
    slice of it.  The optimizer is ``rca.make_optimizer`` at ``lr=1e-3``
    (``optax.adamw(1e-3)``).  ``put_batch(batch_np)`` puts this rank's dp
    rows on its device: ``stage="global"`` takes them from the whole
    batch, ``"process-local"`` is handed them alone (each process stages
    only its own rows).  ``step(batch)`` runs one update and returns the
    whole batch's loss (the same on every rank); the gradients it applied
    stay in the parameters' ``.grad``."""
    if stage not in STAGES:
        raise ValueError(f"unknown staging mode {stage!r}")
    dp_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_dp = math.prod(mesh.shape[a] for a in dp_axes)
    n_model = mesh.shape.get("model", 1)
    n_batch = int(sample_batch["target"].shape[0])
    if n_batch % n_dp:
        raise ValueError(f"batch {n_batch} does not divide over the dp axes "
                         f"{dp_axes} ({n_dp} shards)")
    model = rca.make_model(model_name, sample_batch)
    if params is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params)
    if n_model > 1:
        shard_model(model, param_spec(model_name, model.state_dict(),
                                      n_model), mesh)
    model.to(mesh.device)
    optimizer = rca.make_optimizer(model, lr=LR)
    # gradient sums axis by axis, the inner (host-local) axis first
    dp_groups = [mesh.axis_group(a) for a in reversed(dp_axes)
                 if mesh.shape[a] > 1]
    rows = n_batch // n_dp
    lo = (mesh.axis_index(dp_axes) if dp_axes else 0) * rows
    params_list = list(model.parameters())

    def put_batch(batch_np: dict) -> Dict[str, torch.Tensor]:
        if stage == "global":
            batch_np = {k: np.asarray(v)[lo:lo + rows]
                        for k, v in batch_np.items()}
        lead = {np.asarray(v).shape[0] for v in batch_np.values()}
        if lead != {rows}:
            raise ValueError(f"this rank stages {rows} rows, got {lead}")
        return rca.to_device(batch_np, mesh.device)

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad()
        scores = rca.apply_model(model_name, model, batch)
        totals = None
        if dp_groups:
            with torch.no_grad():
                totals = _psum_over(torch.stack([
                    (batch["target"] >= 0).sum().to(scores.dtype),
                    torch.tensor(float(rows), device=scores.device)]),
                    dp_groups)
        share = rca.rca_loss(scores, batch, totals)
        share.backward()
        loss = share.detach().clone()
        if dp_groups:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params_list]
            flat = _psum_over(torch.cat([g.reshape(-1) for g in grads]),
                              dp_groups)
            for p, g in zip(params_list, flat.split([q.numel() for q in
                                                     params_list])):
                p.grad = g.view_as(p).clone()
            _psum_over(loss, dp_groups)
        optimizer.step()
        return loss

    return model, optimizer, step, put_batch
