"""Explicit collectives over the mesh (counterpart of
``anomod/parallel/collectives.py``), on ``torch.distributed``.

Every function is called by every rank of the mesh with its own shard's
tensor (on the mesh's device: a CPU tensor on an ``nccl`` mesh, or a
card tensor on a ``gloo`` one, raises):

- :func:`psum`: the plain sum over ranks (``all_reduce``), every rank
  holding the result;
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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anomod_torch.ops.tdigest import tdigest_build
from anomod_torch.parallel.mesh import Mesh


def _on_mesh(mesh: Mesh, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != mesh.device.type:
            raise ValueError(f"a {t.device.type} tensor on a "
                             f"{mesh.backend} mesh of {mesh.device.type} "
                             "devices")


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of every rank's ``x``, on every rank (a new tensor)."""
    _on_mesh(mesh, x)
    out = x.clone()
    dist.all_reduce(out, group=mesh.group)
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
