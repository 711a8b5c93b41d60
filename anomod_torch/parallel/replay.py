"""Sharded span replay over the mesh (counterpart of
``anomod/parallel/replay.py``).

Every rank stages the same corpus, takes its shard of the chunks
(:func:`stage_sharded`), folds it with the port's single-device replay
and merges the small per-rank state (``[S*W, 6+H]``) through one
collective: an ``all_reduce`` (every rank holds the whole plane) or a
``reduce_scatter`` (each keeps its ``SW/D`` rows).  The JAX package runs
the same split under ``shard_map`` with a ``psum``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from anomod_torch.device import device_name
from anomod_torch.io.prefetch import device_put_columns
from anomod_torch.ops.hll import hll_init
from anomod_torch.ops.replay_kernels import replay_dense
from anomod_torch.parallel.collectives import (pmax_merge_hll, psum,
                                               reduce_scatter_state)
from anomod_torch.parallel.mesh import Mesh, shard_chunks
from anomod_torch.replay import (F_COUNT, N_FEATS, ReplayConfig, ReplayState,
                                 ThroughputResult, hll_scatter_update,
                                 make_matmul_replay_fn, stage_columns,
                                 stage_planes)
from anomod_torch.schemas import SpanBatch

#: the per-rank folds: ``cuda`` is the counterpart of the JAX ``pallas``
#: shard body (the whole shard through the dense kernel in one launch),
#: ``matmul`` of the JAX ``xla`` one (the one-hot product a chunk)
SHARD_KERNELS = ("cuda", "matmul")


def make_sharded_replay_fn(cfg: ReplayConfig, mesh: Mesh,
                           kernel: str = "cuda", with_hll: bool = False,
                           merge: str = "replicated"):
    """``replay(shard) -> ReplayState`` over this rank's staged ``[N/D,
    C]`` chunk columns (host arrays or tensors), merged over the mesh.

    ``kernel`` picks the per-rank fold (:data:`SHARD_KERNELS`).
    ``with_hll`` adds the per-service distinct-trace registers ``[S,
    2^p]``: each rank's through :func:`hll_scatter_update` (the
    ``hll_update`` kernel), merged by :func:`pmax_merge_hll`.  ``merge``
    is ``replicated`` (every rank holds the merged ``[SW, ·]`` planes) or
    ``scattered`` (rank r keeps rows ``[r*SW/D, (r+1)*SW/D)``; needs ``SW
    % D == 0``)."""
    if kernel not in SHARD_KERNELS:
        raise ValueError(f"unknown replay kernel {kernel!r}")
    if merge not in ("replicated", "scattered"):
        raise ValueError(f"unknown merge mode {merge!r}")
    SW, H = cfg.sw, cfg.n_hist_buckets
    n_dev = int(mesh.shape[mesh.axis])
    if merge == "scattered" and SW % n_dev != 0:
        raise ValueError(
            f"merge='scattered' needs SW ({SW}) divisible by the "
            f"{mesh.axis} axis size ({n_dev})")
    dev = mesh.device
    mfn = (make_matmul_replay_fn(cfg, device=dev) if kernel == "matmul"
           else None)

    def replay(shard) -> ReplayState:
        staged = {k: torch.as_tensor(v, device=dev) for k, v in shard.items()}
        if mfn is None:
            sid, planes = stage_planes(staged, xp=torch)
            acc = replay_dense(sid.contiguous(), planes, SW, H)
        else:
            st = mfn(staged)
            acc = torch.cat([st.agg, st.hist], dim=1)
        hll = None
        if with_hll:
            hll = pmax_merge_hll(hll_scatter_update(
                hll_init(cfg.hll_p, lanes=cfg.n_services, device=dev),
                staged["sid"], staged["tid"], cfg), mesh)
        # one collective for both planes: agg and hist side by side
        acc = (reduce_scatter_state(acc, mesh) if merge == "scattered"
               else psum(acc, mesh))
        return ReplayState(agg=acc[:, :N_FEATS], hist=acc[:, N_FEATS:],
                           hll=hll)

    return replay


def stage_sharded(batch: SpanBatch, mesh: Mesh, cfg: ReplayConfig):
    """Stage the corpus, pad its chunk count to the mesh (dead chunks)
    and put this rank's ``[N/D, C]`` shard on its device; returns
    ``(shard, n_real_spans)`` (every span of the corpus)."""
    chunks, n = stage_columns(batch, cfg)
    mine = {k: v[mesh.rank] for k, v in
            shard_chunks(chunks, mesh.world_size, dead_sid=cfg.sw).items()}
    return device_put_columns(mine, mesh.device), n


def sharded_throughput(batch: SpanBatch, mesh: Mesh,
                       cfg: Optional[ReplayConfig] = None,
                       repeats: int = 3,
                       kernel: str = "cuda") -> ThroughputResult:
    """Stage, shard, warm up and time the sharded replay (replicated
    merge).  Each run ends with the merged planes read back to the host;
    ``wall_s`` is the median of the runs (``raw_wall_s``), ``compile_s``
    the first run's wall."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    cfg = cfg or ReplayConfig(n_services=len(batch.services))
    shard, n = stage_sharded(batch, mesh, cfg)
    fn = make_sharded_replay_fn(cfg, mesh, kernel=kernel)

    def run_once() -> ReplayState:
        out = fn(shard)
        return ReplayState(agg=out.agg.cpu().numpy(),
                           hist=out.hist.cpu().numpy())

    t0 = time.perf_counter()
    run_once()                                  # kernel build / warm-up
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = run_once()
        times.append(time.perf_counter() - t0)
    total = float(state.agg[:, F_COUNT].astype(np.float64).sum())
    if abs(total - n) > max(8.0, 1e-6 * n):
        raise RuntimeError(f"span count mismatch: {total} != {n}")
    wall = sorted(times)[len(times) // 2]
    return ThroughputResult(n_spans=n, wall_s=wall, spans_per_sec=n / wall,
                            compile_s=compile_s, kernel=kernel,
                            device=device_name(mesh.device),
                            raw_wall_s=tuple(times), state=state)
