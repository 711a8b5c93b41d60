"""Multi-host meshes: the ranks of one host first, the hosts across
(counterpart of ``anomod/parallel/multihost.py``).

JAX runs one process a host over its local chips and a coordinator
between hosts; the port runs one process a device everywhere, started by
``torchrun`` (``python -m torch.distributed.run``), whose environment
names each process's place: ``RANK`` and ``WORLD_SIZE`` over all hosts,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` within its host, and the
rendezvous ``MASTER_ADDR`` / ``MASTER_PORT``.

- :func:`initialize_distributed` joins that group (``env://``);
- :func:`make_hybrid_mesh` is the ``(dcn, data)`` mesh: ``dcn`` across
  hosts, ``data`` over a host's ranks.  A sum over both axes
  (``collectives.psum(x, mesh, ("data", "dcn"))``, the train step's
  gradient sum) reduces over each host's ranks first and crosses hosts
  once, which is the point of the hybrid mesh;
- :func:`dcn_data_parallel_spec` names the axes a batch splits over;
- :func:`process_local_array` puts a rank's own rows on its device and
  :func:`replicated_value` reads a replicated tensor back.

``python -m anomod_torch.parallel.multihost [--device cpu]``, started by
``torchrun`` (or with that environment set by hand), runs the JAX
multi-host check on the hybrid mesh: the psum over both axes, the HLL
register merge over disjoint item ranges and one process-local GCN step;
each rank prints one ``MHRESULT {json}`` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.parallel.mesh import BACKENDS, Mesh, make_named_mesh

#: torchrun's environment, every key read and none guessed
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")
#: the JAX worker's HLL check: each rank's disjoint item range, p
ITEMS_PER_RANK, HLL_P = 500, 10


def initialize_distributed(device: DeviceLike = None) -> bool:
    """Join the group that ``torchrun``'s environment describes; returns
    whether it did.  With none of that environment (a single process not
    started by a launcher) it does nothing, as the JAX call does for one
    process; with part of it, it raises naming what is missing.  On
    ``cuda`` (the default; ``nccl``) the rank takes card ``LOCAL_RANK``;
    ``cpu`` runs over ``gloo``.  Under ``torchrun`` it joins even at world
    size 1: the port's collectives run over a group."""
    env = os.environ
    if not any(k in env for k in ENV_KEYS):
        return False
    missing = [k for k in ENV_KEYS if k not in env]
    if missing:
        raise ValueError(f"torchrun's environment is incomplete: "
                         f"{', '.join(missing)} unset")
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this "
                           "process")
    if dev.type == "cuda":
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group(BACKENDS[dev.type], init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


def make_hybrid_mesh(device: DeviceLike = None) -> Mesh:
    """This rank's ``(dcn, data)`` mesh over the joined group: ``data`` =
    ``LOCAL_WORLD_SIZE`` ranks a host (all of the group when the variable
    is unset: one host, as ``launch`` starts), ``dcn`` = ``WORLD_SIZE /
    LOCAL_WORLD_SIZE`` hosts; an uneven split is refused.  ``torchrun``
    numbers a host's ranks consecutively, so a host is a row of the mesh.
    One process gives ``(1, 1)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs a process group: call "
                           "initialize_distributed under torchrun, or run "
                           "under anomod_torch.parallel.launch")
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{local} local ranks")
    return make_named_mesh([("dcn", world // local), ("data", local)],
                           device)


def dcn_data_parallel_spec(mesh: Mesh) -> Tuple[str, ...]:
    """The axes a batch or stream splits over: every axis of the hybrid
    mesh (``("dcn", "data")``)."""
    return tuple(mesh.axis_names)


def process_local_array(mesh: Mesh, local) -> torch.Tensor:
    """This rank's own rows (a host array or tensor) on its device: each
    process stages only its slice of the corpus."""
    return torch.as_tensor(np.asarray(local), device=mesh.device)


def replicated_value(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that every rank holds the same of."""
    return np.array(t.detach().cpu())


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def hybrid_checks(device: DeviceLike = None) -> dict:
    """The JAX multi-host worker's checks on this rank's hybrid mesh:
    the psum of each rank's id over both axes (data first); the HLL
    registers of each rank's disjoint ``ITEMS_PER_RANK`` items, merged by
    an elementwise max; one GCN train step on a TT batch of 2 rows a rank,
    each rank staging only its own rows.  Returns what the JAX worker
    prints, plus the merged registers and a digest of the updated
    parameters (equal on every rank)."""
    from anomod_torch import rca
    from anomod_torch.ops.hll import hll_add, hll_estimate, hll_init
    from anomod_torch.parallel import collectives as coll
    from anomod_torch.parallel.train import make_distributed_train_step

    mesh = make_hybrid_mesh(device)
    dev, world, rank = mesh.device, mesh.world_size, mesh.rank
    total = coll.psum(process_local_array(mesh, np.float32([rank])), mesh,
                      ("data", "dcn"))
    regs = hll_add(hll_init(HLL_P, device=dev),
                   torch.arange(rank * ITEMS_PER_RANK,
                                (rank + 1) * ITEMS_PER_RANK,
                                dtype=torch.int32, device=dev), p=HLL_P)
    merged = replicated_value(coll.pmax_merge_hll(regs, mesh))
    samples, _ = rca.build_dataset("TT", seeds=[0], n_traces=8, n_windows=4)
    n_batch = 2 * world
    stacked = rca._stack((samples * (n_batch // len(samples) + 1))[:n_batch])
    model, _, step, put_batch = make_distributed_train_step(
        "gcn", stacked, mesh, stage="process-local")
    rows = slice(rank * 2, rank * 2 + 2)
    loss = step(put_batch({k: v[rows] for k, v in stacked.items()}))
    return {"rank": rank, "world": world, "shape": mesh.shape,
            "backend": mesh.backend, "data_ranks": mesh.axis_ranks("data"),
            "dcn_ranks": mesh.axis_ranks("dcn"),
            "psum": float(replicated_value(total)[0]),
            "expected_psum": float(sum(range(world))),
            "hll": merged.tolist(),
            "hll_estimate": float(hll_estimate(merged)),
            "true_distinct": world * ITEMS_PER_RANK,
            "train_loss": float(loss),
            "params_digest": _digest(replicated_value(t) for t in
                                     model.state_dict().values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m anomod_torch.parallel.multihost",
        description="The hybrid (dcn, data) mesh's checks on this rank "
                    "(start under torchrun)")
    ap.add_argument("--device", default=None,
                    help="cuda (default, nccl) or cpu (gloo)")
    args = ap.parse_args(argv)
    initialize_distributed(args.device)
    if not dist.is_initialized():
        print("no torchrun environment: start under "
              "python -m torch.distributed.run", file=sys.stderr)
        return 2
    try:
        print("MHRESULT " + json.dumps(hybrid_checks(args.device)),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
