"""The device mesh on ``torch.distributed`` (counterpart of
``anomod/parallel/mesh.py``), and the launcher that starts its ranks.

JAX drives N devices from one process through ``shard_map``; the port
runs one process per device instead (SPMD).  Every rank runs the same
program: it stages the same input, takes its own shard, folds it with the
port's single-device kernel and merges through a collective
(``anomod_torch.parallel.collectives``), so after a replicated merge every
rank holds the same state and runs the same detector and serve logic.

- :class:`Mesh` is what the JAX code asks of a mesh (``mesh.shape[axis]``,
  ``mesh.devices.size``) plus the rank's own place in it: its rank, its
  ``torch.device``, the backend and the process group.
- :func:`make_mesh` builds a rank's mesh inside a launched group: on
  ``cuda`` (the default; ``nccl``, one card a rank) unless the caller
  asks for ``cpu`` (``gloo``).  A mesh of more devices than are attached
  is an error, never a silent shrink.
- :func:`launch` starts the ranks: the calling process at world size 1,
  N spawned processes above, each with the group initialized through a
  ``FileStore`` in a fresh temporary directory (no TCP port, no network),
  destroyed at the end.  A rank's exception fails the launch with its
  traceback.
- :func:`shard_chunks` is the port's copy of the JAX staging split, byte
  for byte.

JAX's ``pvary_compat`` and ``shard_map_compat`` are shims over JAX API
migrations; the port has nothing of them to carry.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from anomod_torch.device import DeviceLike, resolve_device

#: the collective backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D device mesh."""
    axis: str
    world_size: int
    rank: int
    device: torch.device
    backend: str
    #: the process group the collectives run over (None: the default
    #: group)
    group: object = None

    @property
    def shape(self) -> dict:
        return {self.axis: self.world_size}

    @property
    def devices(self) -> np.ndarray:
        """The mesh's devices, one a rank (``.size`` is the world size)."""
        if self.device.type == "cuda":
            return np.array([f"cuda:{r}" for r in range(self.world_size)])
        return np.array(["cpu"] * self.world_size)


def attached_devices(device_type: str) -> int:
    """Devices a mesh of this type can span: the cards this process sees
    for ``cuda``, the launched world size for ``cpu``."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_initialized() else 1


def check_mesh_size(n_devices: int, attached: int) -> None:
    """A mesh over more devices than are attached is refused (a record
    labelled "N devices" must have run on N), in the JAX wording."""
    if not 0 < n_devices <= attached:
        raise ValueError(
            f"requested a {n_devices}-device mesh but "
            f"{attached} device(s) are attached")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: DeviceLike = None) -> Mesh:
    """This rank's 1-D mesh over the first ``n_devices`` devices (default:
    all attached).  Must run inside a launched group (:func:`launch`)
    whose world size is the mesh's and whose backend is the device's."""
    dev = resolve_device(device)
    attached = attached_devices(dev.type)
    n = attached if n_devices is None else int(n_devices)
    check_mesh_size(n, attached)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run the rank "
                           "body under anomod_torch.parallel.launch")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {n}-device mesh needs {n} ranks; the process "
                         f"group has {world}")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh runs over "
                         f"{BACKENDS[dev.type]}, not {backend}")
    rank = dist.get_rank()
    return Mesh(axis=axis, world_size=n, rank=rank,
                device=torch.device("cuda", rank) if dev.type == "cuda"
                else dev, backend=backend)


def shard_chunks(chunks: dict, n_shards: int, dead_sid: int) -> dict:
    """Split the leading (chunk) dim across shards: [N, C] -> [D, N/D, C].

    Pads the chunk count to a multiple of n_shards with dead chunks
    (sid = ``dead_sid``, valid = 0) so every shard gets identical shapes.
    ``dead_sid`` must be the config's padding id (``cfg.sw``): a fill row
    with a real segment id would count a phantom trace in the HLL plane.
    """
    out = {}
    n_chunks = next(iter(chunks.values())).shape[0]
    pad = (-n_chunks) % n_shards
    for k, v in chunks.items():
        if pad:
            fill = np.zeros((pad,) + v.shape[1:], v.dtype)
            if k == "sid":
                fill[:] = dead_sid
            v = np.concatenate([v, fill], axis=0)
        out[k] = v.reshape(n_shards, -1, *v.shape[1:])
    return out


# -- the launcher -----------------------------------------------------------

def _init_group(rank: int, world: int, backend: str, store_path: str,
                timeout_s: Optional[float]) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, **kw)


def _rank_main(rank: int, world: int, backend: str, store_path: str,
               timeout_s: Optional[float], fn: Callable, args: tuple,
               results) -> None:
    """A spawned rank: join the group, run ``fn``, send its result (or
    the traceback) home, leave the group."""
    try:
        _init_group(rank, world, backend, store_path, timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # plain pickle: the queue's own pickler would hand tensors over in
    # shared memory that dies with this process
    results.put((rank, True, pickle.dumps(out)))


def launch(fn: Callable, n_devices: int, device: DeviceLike = None,
           args: Sequence = (), timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on every rank of an ``n_devices`` group and
    return the ranks' results in rank order.

    ``device`` is ``cuda`` (the default: ``nccl``, rank r on ``cuda:r``,
    at most the attached cards) or ``cpu`` (``gloo``).  At world size 1
    ``fn`` runs in the calling process; above, in ``n_devices`` spawned
    processes (``fn``, ``args`` and the results are pickled).  The group
    rendezvous through a ``FileStore`` in a new temporary directory and
    is destroyed at the end.  A rank's exception fails the launch with
    that rank's traceback (the other ranks are stopped); ``timeout``
    seconds bound the whole launch and the group's collectives."""
    dev = resolve_device(device)
    n = int(n_devices)
    if dev.type == "cuda":
        check_mesh_size(n, attached_devices("cuda"))
    elif n < 1:
        raise ValueError(f"a launch needs >= 1 rank, got {n}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this "
                           "process; launch starts its own")
    backend = BACKENDS[dev.type]
    tmp = tempfile.mkdtemp(prefix="anomod-mesh-")
    store_path = os.path.join(tmp, "store")
    try:
        if n == 1:
            _init_group(0, 1, backend, store_path, timeout)
            try:
                return [fn(*args)]
            finally:
                dist.destroy_process_group()
        return _spawn(fn, tuple(args), n, backend, store_path, timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(fn, args, n, backend, store_path, timeout) -> list:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"anomod-rank-{r}",
                         args=(r, n, backend, store_path, timeout, fn, args,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict = {}

    def take(wait):
        rank, ok, payload = results.get(timeout=wait)
        if ok:
            got[rank] = pickle.loads(payload)
            return
        # the first failure can be a peer's broken collective: gather
        # what the other ranks report meanwhile, so the cause is named
        failed = [(rank, payload)]
        try:
            while True:
                r2, ok2, p2 = results.get(timeout=2.0)
                if not ok2:
                    failed.append((r2, p2))
        except queue.Empty:
            pass
        raise RuntimeError("\n".join(f"rank {r} of {n} failed:\n{tb}"
                                     for r, tb in sorted(failed)))

    try:
        while len(got) < n:
            try:
                take(0.1)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead:
                # its traceback may still be in flight
                try:
                    take(2.0)
                    continue
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} of {n} exited with code "
                        f"{procs[dead[0]].exitcode} and sent no result")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {n}-rank launch passed its "
                                   f"{timeout} s limit")
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    return [got[r] for r in range(n)]
