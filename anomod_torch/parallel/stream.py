"""The sharded online replay: the streaming plane over the mesh
(counterpart of ``anomod/parallel/stream.py``).

Each push's staged chunks go in groups of ``world_size`` (the last group
padded with dead chunks); rank r folds chunk r of each group through the
port's chunk step (``replay.make_chunk_step``: the dense kernel on the
card), the group's delta is merged through an ``all_reduce`` and added to
the running ring, so every rank holds the same state.

:class:`ShardedStreamReplay` duck-types
:class:`anomod_torch.stream.StreamReplay` (push, ``agg_plane``, the ring
roll, the warm-up bookkeeping and the ``get_state`` read the flight
recorder's digest takes), so ``OnlineDetector(..., mesh=mesh)`` runs the whole alerting
stack over the mesh.  The plane is id-space agnostic, so edge attribution
runs over the mesh too, on the combined id space
(``stream.edge_combined_cfg``).  It carries no HLL registers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.parallel.collectives import psum
from anomod_torch.parallel.mesh import Mesh
from anomod_torch.replay import (N_FEATS, ReplayConfig, ReplayState,
                                 dead_chunk, make_chunk_step, stage_columns,
                                 zero_state)
from anomod_torch.schemas import SpanBatch
from anomod_torch.stream import plane_view, roll_ring_state


class ShardedStreamReplay:
    """Mesh-sharded drop-in for the single-device StreamReplay."""

    def __init__(self, cfg: ReplayConfig, t0_us: int, mesh: Mesh):
        self.cfg = cfg
        self.t0_us = int(t0_us)
        self.window_offset = 0     # absolute window index of plane column 0
        self.n_spans = 0
        self.mesh = mesh
        self.device = mesh.device
        self.n_dev = int(mesh.shape[mesh.axis])
        self._step = make_chunk_step(cfg)
        self._zero = zero_state(cfg, self.device)
        self.state = zero_state(cfg, self.device)
        #: one-time warm-up wall (kernel build, first launch and first
        #: collective), measured at the first push
        self.compile_s = 0.0
        self._warmed = False

    def _roll(self, k: int) -> None:
        """Evict the oldest ``k`` windows and advance the anchor by the
        FULL ``k`` (only the column shift clamps)."""
        self.state = roll_ring_state(self.state, self.cfg, k)
        self.t0_us += k * self.cfg.window_us
        self.window_offset += k

    def _fold(self, chunk: dict) -> ReplayState:
        """This rank's chunk of one group, folded and merged over the
        mesh: the group's delta, the same on every rank."""
        staged = {k: torch.as_tensor(v, device=self.device)
                  for k, v in chunk.items()}
        d = self._step(self._zero, staged)
        acc = psum(torch.cat([d.agg, d.hist], dim=1), self.mesh)
        return ReplayState(agg=acc[:, :N_FEATS], hist=acc[:, N_FEATS:])

    def _warm(self) -> None:
        """Fold one all-dead group (numerically a no-op) so push() walls
        measure the steady pipeline."""
        t0 = time.perf_counter()
        d = self._fold(dead_chunk(self.cfg, self.device))
        d.agg.cpu()                       # build + launch + merge barrier
        self.compile_s = time.perf_counter() - t0
        obs.counter("anomod_stream_compile_total", plane="sharded").inc()
        obs.counter("anomod_stream_compile_seconds_total",
                    plane="sharded").inc(self.compile_s)
        self._warmed = True

    def push(self, batch: SpanBatch) -> int:
        """Same contract as StreamReplay.push: fold, return the newest
        ABSOLUTE window binned (-1 for an empty batch)."""
        if batch.n_spans == 0:
            return -1
        if not self._warmed:
            self._warm()
        t_push = time.perf_counter()
        w_need = int((int(batch.start_us.max()) - self.t0_us)
                     // self.cfg.window_us)
        if w_need > self.cfg.n_windows - 1:
            self._roll(w_need - (self.cfg.n_windows - 1))
            w_need = self.cfg.n_windows - 1
        chunks, n = stage_columns(batch, self.cfg, t0_us=self.t0_us)
        n_chunks = chunks["sid"].shape[0]
        r = self.mesh.rank
        for lo in range(0, n_chunks, self.n_dev):
            # rank r's chunk of the group, or a dead one past its end
            mine = ({k: v[lo + r] for k, v in chunks.items()}
                    if lo + r < n_chunks else dead_chunk(self.cfg, self.device))
            delta = self._fold(mine)
            self.state = ReplayState(agg=self.state.agg + delta.agg,
                                     hist=self.state.hist + delta.hist)
        self.n_spans += n
        obs.histogram("anomod_stream_push_seconds",
                      plane="sharded").observe(time.perf_counter() - t_push)
        return self.window_offset + max(w_need, 0)

    def agg_plane(self) -> np.ndarray:
        """Host copy of the aggregate plane as [S, W, F]."""
        return plane_view(self.state, self.cfg)

    def get_state(self) -> ReplayState:
        """Host copy of the plane's (replicated) state: what the flight
        recorder's state digest reads."""
        return ReplayState(agg=self.state.agg.cpu(),
                           hist=self.state.hist.cpu())
