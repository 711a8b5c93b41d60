"""Explicit collectives over the mesh (counterpart of
``anomod/parallel/collectives.py``), on ``torch.distributed``.

Every function is called by every rank of the mesh with its own shard's
tensor (on the mesh's device: a CPU tensor on an ``nccl`` mesh, or a
card tensor on a ``gloo`` one, raises):

- :func:`psum`: the plain sum over ranks (``all_reduce``), every rank
  holding the result, over the whole mesh or axis by axis;
- :func:`ring_allreduce`: the same sum written out as a ring of n - 1
  send / receive steps (``batch_isend_irecv``), adding in the JAX
  ``ppermute`` loop's order;
- :func:`reduce_scatter_state`: sum over ranks, rank r keeping the r-th
  slice of the leading dimension (``reduce_scatter_tensor``);
- :func:`pmax_merge_hll`: HLL registers merge exactly with an elementwise
  max (``all_reduce(MAX)``);
- :func:`allgather_merge_tdigests`: t-digest states are not
  sum-mergeable, so the ranks all-gather their centroids (concatenated on
  the last axis, as ``tiled=True`` does) and rebuild with the port's host
  ``tdigest_build``.

The differentiable collectives of the training, pipeline and sequence
planes (JAX inserts these from sharding annotations; the port writes each
one), each a ``torch.autograd.Function``:

- :func:`ppermute`: a ring rotation along one mesh axis (one
  ``batch_isend_irecv``); its backward is the reverse rotation;
- :func:`all_to_all`: the tiled ``lax.all_to_all`` (``all_to_all_single``
  on a contiguous buffer); its backward is the inverse swap;
- :func:`copy_to`: identity forward, ``all_reduce`` backward: on the
  input of a sharded computation;
- :func:`reduce_from`: ``all_reduce`` forward, identity backward: on a
  partial sum that becomes replicated;
- :func:`gather_from`: ``all_gather`` along a dimension forward; the
  backward keeps the rank's own slice.

They share one convention: a value that every rank of a group holds is
one value, and the loss is counted once.  Every rank computes the same
replicated loss from the same replicated values, so a gradient that
reaches a replicated value is already the whole gradient on every rank
(``gather_from`` keeps a slice of it, ``reduce_from`` passes it on); only
where ranks computed different shards of one value (``copy_to``) are the
shards' gradients summed.  ``torch.distributed.nn.functional.all_reduce``
sums again in its backward, which under this convention gives gradients
the group size times too large, so it is not used.  At group size 1
each of them is the identity and sends nothing (NCCL is not asked to
send to itself).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anomod_torch.ops.tdigest import tdigest_build
from anomod_torch.parallel.mesh import Axes, Mesh


def _on_mesh(mesh: Mesh, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != mesh.device.type:
            raise ValueError(f"a {t.device.type} tensor on a "
                             f"{mesh.backend} mesh of {mesh.device.type} "
                             "devices")


def psum(x: torch.Tensor, mesh: Mesh,
         axes: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
    """Sum of every rank's ``x``, on every rank (a new tensor): over the
    whole mesh in one ``all_reduce``, or with ``axes`` one axis after
    another in the order given (each over the rank's slice along it, an
    axis of size 1 skipped): ``("data", "dcn")`` sums over a host's local
    ranks first and crosses hosts once."""
    _on_mesh(mesh, x)
    out = x.clone()
    if axes is None:
        dist.all_reduce(out, group=mesh.group)
    for axis in axes or ():
        if mesh.axis_size(axis) > 1:
            dist.all_reduce(out, group=mesh.axis_group(axis))
    return out


def ring_allreduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Ring all-reduce: n - 1 steps, each sending the buffer received last
    to the next rank and adding what arrives from the previous one."""
    _on_mesh(mesh, x)
    n, r = mesh.world_size, mesh.rank
    acc = x.clone()
    buf = x.contiguous()
    for _ in range(n - 1):
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, (r + 1) % n, group=mesh.group),
               dist.P2POp(dist.irecv, recv, (r - 1) % n, group=mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        buf = recv
        acc = acc + buf
    return acc


def reduce_scatter_state(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Merge the ranks' states and keep this rank's ``[L/D, ...]`` slice
    of the leading dimension (half the traffic of :func:`psum` when the
    consumer is itself sharded).  ``L`` must divide by the world size."""
    _on_mesh(mesh, x)
    n = mesh.world_size
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter_state needs the leading dim "
                         f"({x.shape[0]}) divisible by the {mesh.axis} axis "
                         f"size ({n})")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=mesh.group)
    return out


def pmax_merge_hll(registers: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Exact HLL merge across ranks: the elementwise register max."""
    _on_mesh(mesh, registers)
    out = registers.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


def allgather_merge_tdigests(mean: torch.Tensor, weight: torch.Tensor,
                             mesh: Mesh, k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-rank t-digests ``[..., K]``: all-gather the centroids,
    concatenate them on the last axis in rank order, rebuild a ``k``
    (default ``K``) centroid digest on the host.  Returns the merged
    ``(mean, weight)`` on the mesh's device, the same on every rank."""
    _on_mesh(mesh, mean, weight)
    k = k or mean.shape[-1]
    n = mesh.world_size

    def gather(x):
        x = x.to(torch.float32).contiguous()
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.unsqueeze(0), group=mesh.group)
        return torch.cat(out.unbind(0), dim=-1)

    all_mean, all_weight = gather(mean), gather(weight)
    d = tdigest_build(all_mean.cpu().numpy(), k=k,
                      weights=all_weight.cpu().numpy())
    return (torch.from_numpy(np.asarray(d.mean, np.float32)).to(mean.device),
            torch.from_numpy(np.asarray(d.weight, np.float32))
            .to(mean.device))


# -- the differentiable collectives ----------------------------------------

def _rotate(x, group, ranks, index, shift):
    """Send ``x`` ``shift`` places along ``ranks`` and return what arrives
    from ``shift`` places back."""
    n = len(ranks)
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(index + shift) % n], group=group),
           dist.P2POp(dist.irecv, recv, ranks[(index - shift) % n],
                      group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ranks, index, shift):
        ctx.comm = (group, ranks, index, shift)
        return _rotate(x, group, ranks, index, shift)

    @staticmethod
    def backward(ctx, grad):
        group, ranks, index, shift = ctx.comm
        return _rotate(grad, group, ranks, index, -shift), None, None, None, \
            None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: Axes,
             shift: int = 1) -> torch.Tensor:
    """Ring rotation along ``axis``: the rank at place i of its slice
    sends ``x`` to place i + shift and returns the tensor from place i -
    shift (``lax.ppermute`` with ``[(i, (i + shift) % n)]``)."""
    _on_mesh(mesh, x)
    ranks = mesh.axis_ranks(axis)
    if shift % len(ranks) == 0:
        return x
    return _PPermute.apply(x, mesh.axis_group(axis), ranks,
                           mesh.axis_index(axis), shift)


def _swap(x, group, n, split_dim, concat_dim):
    """Block j of ``x`` along ``split_dim`` to the group's rank j; the
    blocks received, in rank order, concatenated along ``concat_dim``."""
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.comm = (group, n, split_dim, concat_dim)
        return _swap(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, n, split_dim, concat_dim = ctx.comm
        return _swap(grad, group, n, concat_dim, split_dim), None, None, \
            None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: Axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all`` along ``axis``: ``x`` is cut into n
    blocks along ``split_dim``, block j goes to place j of the slice, and
    the n blocks received are concatenated along ``concat_dim`` in place
    order.  ``split_dim`` must divide by n."""
    _on_mesh(mesh, x)
    n = mesh.axis_size(axis)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all needs dim {split_dim} "
                         f"({x.shape[split_dim]}) divisible by the {axis} "
                         f"axis size ({n})")
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.axis_group(axis), n, split_dim,
                           concat_dim)


def _summed(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.part = (n, index, dim)
        x = x.contiguous()
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.unsqueeze(0), group=group)
        return torch.cat(out.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n, index, dim = ctx.part
        return grad.chunk(n, dim=dim)[index].contiguous(), None, None, \
            None, None


def copy_to(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (None: the
    world): on a replicated input that each rank uses for its own
    shard."""
    return x if dist.get_world_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; the gradient passes
    through as it is: on a partial sum that becomes replicated."""
    return x if dist.get_world_size(group) == 1 \
        else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order;
    the backward keeps this rank's own slice of the gradient."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    return _GatherFrom.apply(x, group, n, dist.get_rank(group), dim % x.dim())
