"""Dynamic micro-batching into fixed padded bucket shapes, with the fused
lane-stacked dispatch of the multi-tenant tick (counterpart of
``anomod/serve/batcher.py``).

Each admitted micro-batch is split at ``cfg.chunk_size`` boundaries and
its tail padded to the smallest bucket width that holds it
(:func:`split_plan`).  Per tick, same-width staged chunks from many
tenants stack into ``[lanes, width]`` dispatches of the lane kernel
(``ops.serve_kernels.lane_delta``), the lane count padded to a fixed
lane-bucket set; dead pad lanes carry all-pad rows and give zero deltas.

Parity is exact by construction:

- padding rows target the dead segment (sid = SW, valid = 0), which no
  live segment reads;
- the lane kernel sums each lane's rows in row order, whatever the lane
  count, so a lane's delta equals a one-lane dispatch of the same chunk;
  the single-chunk :meth:`BucketRunner.dispatch` IS a one-lane dispatch
  of the same kernel, so fused == sequential holds by construction;
- a delta folds into its tenant's state with one f32 add a cell, in
  dispatch order, through the device pool (``TenantStatePool``) or the
  per-tenant host seam (``replay.fold_delta``): device == host.

Staging fills pinned host scratch in the kernel's layout (``sid[L, W]``,
``planes[L, 6, W]``), by default through the C++ fill of
``anomod_torch.io.native`` (GIL released, one call a dispatch), else by
the interpreter fill, its byte-identical oracle; the copy to the card and
the launch are queued on the runner's stream: the calling thread's
current stream, or with ``own_stream`` (a serve shard's runner) a CUDA
stream of the runner's own, which the engine's shard worker makes
current around everything it runs on the runner.  At pipeline depth d up to
d - 1 dispatches stay in flight while the next one stages; a scratch slot
is refilled only after the event recorded behind the launch that read it
has completed.

Every book counter has a registry mirror under the JAX package's name
(``anomod_serve_dispatches_total``, ``_staged_rows_total``,
``_live_rows_total``, ``_pad_waste_fraction``, the fused-dispatch and
lane twins, the ``_fused_lanes`` histogram, the stage / dispatch / fold /
score seconds and ``_native_staged_total``); each shape's first-launch
wall counts as its ``anomod_serve_compile_total`` /
``anomod_serve_fused_compile_total`` (with ``_seconds_total``).

With a perf recorder (``perf``, :mod:`anomod_torch.obs.perf`) every fused
dispatch stamps its lifecycle from the clock reads its wall legs already
take: ``refill`` and ``staged`` at the scratch fill, ``submitted`` around
the copies and the launch, ``retire`` / ``materialized`` / ``folded`` at
the retire (which enqueues the pool fold and then waits on the dispatch's
event, so ``materialized`` and ``folded`` are the read after that wait),
``deferred`` at the deferred commit's barrier and ``aborted`` at
:meth:`BucketRunner.abort_lanes`.  No stamp synchronizes anything.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.io import native
from anomod_torch.ops.replay_kernels import PLANES
from anomod_torch.ops.serve_kernels import lane_delta
from anomod_torch.replay import (N_FEATS, ReplayConfig, ReplayState,
                                 TenantStatePool, fold_delta,
                                 stage_columns_fused, zero_state)
from anomod_torch.schemas import SpanBatch
from anomod_torch.config import get_config
from anomod_torch.serve.config import (validate_lane_buckets,
                                       validate_serve_buckets)
from anomod_torch.stream import StreamReplay

#: the staged columns a lane dispatch copies; the sixth plane, dur², is
#: computed at fill
PLANE_KEYS = PLANES[:5]


def split_plan(n_spans: int, chunk_size: int,
               buckets: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """(lo, hi, staged_width) slices for one micro-batch: full
    ``chunk_size`` slices first, then the tail padded to the smallest
    bucket that holds it (``chunk_size`` when every bucket is narrower)."""
    plan: List[Tuple[int, int, int]] = []
    lo = 0
    while n_spans - lo >= chunk_size:
        plan.append((lo, lo + chunk_size, chunk_size))
        lo += chunk_size
    rem = n_spans - lo
    if rem > 0:
        width = next((b for b in buckets if b >= rem and b <= chunk_size),
                     chunk_size)
        plan.append((lo, n_spans, width))
    return plan


class BucketRunner:
    """The shared dispatcher of one serve plane: bucketed staging, the
    lane kernel per (width, lane-bucket) shape, and the tenant-state fold.

    ``state="device"`` keeps tenant states in a :class:`TenantStatePool`
    on ``device`` (the retire fold is an on-device ``state + delta`` per
    slot); ``state="host"`` keeps each tenant's state as host tensors and
    folds the read-back deltas there.  Book counters (dispatches per
    width, fused dispatches per lane bucket, staged and live lanes, the
    stage/dispatch/fold/score walls, the first-launch wall per shape) feed
    the :class:`~anomod_torch.serve.engine.ServeReport`.

    ``native_stage`` fills scratch through the C++ entry of
    :mod:`anomod_torch.io.native`, built at first use (a failed build
    raises); ``native_stage=False`` keeps the interpreter fill; None
    follows ``ANOMOD_NATIVE`` (on unless ``off``).  ``buckets`` and
    ``lane_buckets`` default to ``ANOMOD_SERVE_BUCKETS`` /
    ``ANOMOD_SERVE_LANE_BUCKETS``.  ``registry`` is the metric sink
    (default: the process registry); ``perf`` a
    :class:`~anomod_torch.obs.perf.PerfRecorder` for the fused path's
    dispatch-lifecycle stamps.

    ``own_stream`` (on the card) gives the runner a CUDA stream of its
    own: its pool is allocated on it, its scratch-reuse events are
    recorded on it and :meth:`sync` waits for it alone.  The caller runs
    every use of the runner under :meth:`on_stream`, so its copies,
    launches, pool folds and gathers stay ordered on that stream while
    other runners' work runs on theirs."""

    def __init__(self, cfg: ReplayConfig,
                 buckets: Optional[Tuple[int, ...]] = None,
                 lane_buckets: Optional[Tuple[int, ...]] = None,
                 pipeline: int = 1, state: str = "device",
                 pool_slots: int = 32, device: DeviceLike = None,
                 native_stage: Optional[bool] = None, registry=None,
                 own_stream: bool = False, perf=None):
        if pipeline < 1:
            raise ValueError("pipeline depth must be >= 1")
        if state not in ("host", "device"):
            raise ValueError(f"unknown serve state mode {state!r} "
                             "(host|device)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.state_mode = state
        self.stream = (torch.cuda.Stream(self.device)
                       if own_stream and self._cuda else None)
        with self.on_stream():
            self.pool = (TenantStatePool(cfg,
                                         capacity=max(int(pool_slots), 1),
                                         device=self.device)
                         if state == "device" else None)
        self.pipeline = int(pipeline)
        app_cfg = get_config()
        self.native_stage = bool(app_cfg.native != "off"
                                 if native_stage is None else native_stage)
        if self.native_stage:
            native.library()
        self.buckets = validate_serve_buckets(
            app_cfg.serve_buckets if buckets is None else buckets)
        self.lane_buckets = validate_lane_buckets(
            app_cfg.serve_lane_buckets if lane_buckets is None
            else lane_buckets)
        #: the perf observatory's recorder (anomod_torch.obs.perf), or
        #: None: the fused path's stamps reuse the wall legs' clock reads
        self.perf = perf
        #: first-launch wall of the one-lane dispatch per width, and of
        #: the fused dispatch per (width, lane-bucket) shape
        self.compile_s_by_width: Dict[int, float] = {}
        self._lane_compile_s: Dict[Tuple[int, int], float] = {}
        self.dispatches_by_width: Dict[int, int] = {}
        self.n_dispatches = 0
        self.fused_dispatches = 0
        self.lanes_by_bucket: Dict[int, int] = {}
        self.staged_lanes = 0
        self.live_lanes = 0
        #: fused dispatches whose scratch the native fill packed
        self.native_staged = 0
        #: the tick's wall decomposition: host packing, copy + launch
        #: enqueue, fold (the retire barrier plus the state adds), and
        #: window scoring (the engine's commit phase adds there)
        self.stage_wall_s = 0.0
        self.dispatch_wall_s = 0.0
        self.fold_wall_s = 0.0
        self.score_wall_s = 0.0
        # host scratch (pinned on the card), ``pipeline`` slots per
        # (width, lanes) shape, each (sid [L, W] int32, planes [L, 6, W])
        self._scratch: Dict[Tuple[int, int, int],
                            Tuple[torch.Tensor, torch.Tensor]] = {}
        #: the native fill's marshalling plan per scratch slot
        self._stage_plans: Dict[Tuple[int, int, int],
                                native.StagePlan] = {}
        self._slot_next: Dict[Tuple[int, int], int] = {}
        #: FIFO of in-flight dispatches: (replays, out, slot key, event)
        self._inflight: "collections.deque" = collections.deque()
        # registry mirrors, handles cached: staging and the fused
        # dispatch are the serve hot path; waste = 1 - live / staged
        reg = self._reg = (registry if registry is not None
                           else obs.get_registry())
        self._obs_dispatches = reg.counter("anomod_serve_dispatches_total")
        self._obs_staged = reg.counter("anomod_serve_staged_rows_total")
        self._obs_live = reg.counter("anomod_serve_live_rows_total")
        self._obs_waste = reg.gauge("anomod_serve_pad_waste_fraction")
        self._obs_fused = reg.counter(
            "anomod_serve_fused_dispatches_total")
        self._obs_lanes = reg.histogram("anomod_serve_fused_lanes")
        self._obs_staged_lanes = reg.counter(
            "anomod_serve_staged_lanes_total")
        self._obs_live_lanes = reg.counter(
            "anomod_serve_live_lanes_total")
        self._obs_lane_waste = reg.gauge(
            "anomod_serve_lane_pad_waste_fraction")
        self._obs_stage_s = reg.counter("anomod_serve_stage_seconds_total")
        self._obs_dispatch_s = reg.counter(
            "anomod_serve_dispatch_seconds_total")
        self._obs_fold_s = reg.counter("anomod_serve_fold_seconds_total")
        self._obs_score_s = reg.counter("anomod_serve_score_seconds_total")
        self._obs_native = reg.counter("anomod_serve_native_staged_total")
        reg.gauge("anomod_serve_native_staging").set(
            1.0 if self.native_stage else 0.0)

    def on_stream(self):
        """Context making the runner's own stream current on the calling
        thread (a no-op without one)."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def leg_walls(self) -> dict:
        """Cumulative snapshot of the runner's wall and dispatch book, the
        flight recorder's per-tick delta source: ``chunks`` and
        ``by_width`` (staged chunks per width: the canonical dispatch
        plane, equal under every execution strategy), the walls and the
        lane-grouping counts (variant).  Read at the tick barrier only."""
        return {"stage_s": self.stage_wall_s,
                "dispatch_s": self.dispatch_wall_s,
                "fold_s": self.fold_wall_s,
                "score_s": self.score_wall_s,
                "chunks": self.n_dispatches,
                "fused": self.fused_dispatches,
                "native_staged": self.native_staged,
                "by_width": dict(self.dispatches_by_width)}

    def gather_rows(self, slots) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies ``([T, SW, 6], [T, SW, H])`` of whole pool rows,
        one device-to-host copy a plane, on the runner's stream."""
        with self.on_stream():
            idx = torch.as_tensor(np.asarray(slots, np.int64),
                                  device=self.device)
            return (self.pool.agg[idx].cpu().numpy(),
                    self.pool.hist[idx].cpu().numpy())

    def add_score_wall(self, dt: float) -> None:
        """Book ``dt`` seconds of window scoring (the engine's commit
        phase) in the ``score`` leg and its registry mirror."""
        self.score_wall_s += dt
        self._obs_score_s.inc(dt)

    @property
    def widths(self) -> Tuple[int, ...]:
        """Every chunk width this runner may dispatch."""
        per_bucket = tuple(b for b in self.buckets
                           if b <= self.cfg.chunk_size)
        return tuple(sorted(set(per_bucket) | {self.cfg.chunk_size}))

    @property
    def compile_s(self) -> float:
        return float(sum(self.compile_s_by_width.values()))

    @property
    def lane_compile_s(self) -> float:
        return float(sum(self._lane_compile_s.values()))

    def sync(self) -> None:
        """Wait for the runner's work: its own stream, else the device."""
        if self.stream is not None:
            self.stream.synchronize()
        elif self._cuda:
            torch.cuda.synchronize(self.device)

    def _dead_launch(self, width: int, lanes: int) -> float:
        """Wall of one all-dead dispatch of a shape (numerically a no-op
        on any state), the kernel build included on the first call."""
        t0 = time.perf_counter()
        scratch, key = self._fill_slot(width, lanes, [])
        self._launch(scratch)
        self.sync()
        return time.perf_counter() - t0

    def warm(self) -> float:
        """First-launch every width as a one-lane dispatch, outside the
        serve wall; idempotent.  Returns the total wall."""
        total = 0.0
        for width in self.widths:
            if width not in self.compile_s_by_width:
                wall = self._dead_launch(width, 1)
                self.compile_s_by_width[width] = wall
                self._reg.counter("anomod_serve_compile_total").inc()
                self._reg.counter(
                    "anomod_serve_compile_seconds_total").inc(wall)
                total += wall
        return total

    def warm_lanes(self) -> float:
        """First-launch the whole (width x lane-bucket) grid, and the
        pool's gather kernel; idempotent.  Returns the total wall."""
        total = 0.0
        for width in self.widths:
            for lanes in self.lane_buckets:
                if (width, lanes) not in self._lane_compile_s:
                    wall = self._dead_launch(width, lanes)
                    self._lane_compile_s[(width, lanes)] = wall
                    self._reg.counter(
                        "anomod_serve_fused_compile_total").inc()
                    self._reg.counter(
                        "anomod_serve_fused_compile_seconds_total").inc(wall)
                    total += wall
        if self.pool is not None:
            total += self.pool.warm()
        return total

    # -- staging ----------------------------------------------------------

    def stage_plan(self, batch: SpanBatch, t0_us: int
                   ) -> List[Tuple[int, native.StagedChunk]]:
        """Host staging of one micro-batch into its bucket plan: the
        ordered ``(width, chunk)`` pairs a push dispatches, each chunk an
        UNPADDED slice of the batch's one staging matrix
        (:class:`~anomod_torch.io.native.StagedChunk`; the pad to
        ``width`` happens at scratch fill).  The one staging definition
        of the sequential and fused paths."""
        cfg = self.cfg
        t0 = time.perf_counter()
        mat, _ = stage_columns_fused(batch, cfg, t0_us)
        plan = split_plan(batch.n_spans, cfg.chunk_size, self.buckets)
        chunks = native.staged_chunks(mat, [(lo, hi) for lo, hi, _ in plan])
        out = []
        staged_rows = 0
        for (_, _, width), chunk in zip(plan, chunks):
            out.append((width, chunk))
            self.n_dispatches += 1
            self.dispatches_by_width[width] = \
                self.dispatches_by_width.get(width, 0) + 1
            staged_rows += width
        dt = time.perf_counter() - t0
        self.stage_wall_s += dt
        self._obs_stage_s.inc(dt)
        if out:
            self._obs_dispatches.inc(len(out))
            self._obs_staged.inc(staged_rows)
            self._obs_live.inc(batch.n_spans)
            staged = self._obs_staged.value
            if staged:
                self._obs_waste.set(1.0 - self._obs_live.value / staged)
        return out

    def _fill_slot(self, width: int, lanes: int,
                   group: List[native.StagedChunk], perf=None):
        """Stage ``group`` (one unpadded chunk per live lane) into the
        next scratch slot of the (width, lanes) shape, dead-padding the
        row tails and the dead lanes, natively unless ``native_stage`` is
        off.  Any in-flight dispatch still reading the slot is retired
        first.  ``perf`` (the fused path's recorder) takes the slot's
        refill and staged stamps."""
        shape = (width, lanes)
        slot = self._slot_next.get(shape, 0)
        self._slot_next[shape] = (slot + 1) % self.pipeline
        key = (width, lanes, slot)
        while any(e[2] == key for e in self._inflight):
            self._retire_one()
        t0 = time.perf_counter()
        scratch = self._scratch.get(key)
        if scratch is None:
            pin = self._cuda
            scratch = (torch.empty((lanes, width), dtype=torch.int32,
                                   pin_memory=pin),
                       torch.empty((lanes, len(PLANES), width),
                                   dtype=torch.float32, pin_memory=pin))
            self._scratch[key] = scratch
            if self.native_stage:
                self._stage_plans[key] = native.StagePlan(
                    scratch[0].numpy(), scratch[1].numpy(), self.cfg.sw)
        elif perf is not None:
            # a reused slot: stamp the dispatch that last held it
            perf.note_refill(key, t0)
        if self.native_stage:
            self._stage_plans[key].stage(group)
        else:
            self._fill_slot_py(scratch, group)
        dt = time.perf_counter() - t0
        self.stage_wall_s += dt
        self._obs_stage_s.inc(dt)
        if perf is not None:
            perf.note_staged(key, t0, t0 + dt)
        return scratch, key

    def _fill_slot_py(self, scratch, group) -> None:
        """The interpreter fill: the oracle the native fill is pinned
        byte-identical to."""
        sid, planes = scratch[0].numpy(), scratch[1].numpy()
        sw = self.cfg.sw
        for i, cols in enumerate(group):
            m = cols["sid"].shape[0]
            sid[i, :m] = cols["sid"]
            sid[i, m:] = sw
            for p, k in enumerate(PLANE_KEYS):
                planes[i, p, :m] = cols[k]
            np.multiply(cols["dur"], cols["dur"], out=planes[i, 5, :m])
            planes[i, :, m:] = 0.0
        n_live = len(group)
        sid[n_live:] = sw
        planes[n_live:] = 0.0

    def _launch(self, scratch) -> torch.Tensor:
        """Queue the copy of a filled slot to the device and the lane
        kernel on it; returns the ``[L, SW, 6+H]`` deltas."""
        sid, planes = scratch
        if self._cuda:
            sid = sid.to(self.device, non_blocking=True)
            planes = planes.to(self.device, non_blocking=True)
        return lane_delta(sid, planes, self.cfg.sw, self.cfg.n_hist_buckets)

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream if self.stream is not None
                  else torch.cuda.current_stream(self.device))
        return ev

    def _fold(self, replays: list, out: torch.Tensor) -> None:
        """Fold a dispatch's deltas into its lanes' replay planes: one
        pool scatter-fold when every plane lives in this runner's pool,
        else per lane through the get_state/set_state seam on the host."""
        pool = self.pool
        if pool is not None and replays and all(
                getattr(r, "_slot", None) is not None
                and getattr(r, "_runner", None) is self for r in replays):
            pool.scatter_fold([r._slot for r in replays],
                              out[..., :N_FEATS], out[..., N_FEATS:])
            return
        out = out.cpu()
        for i, replay in enumerate(replays):
            replay.set_state(fold_delta(replay.get_state(),
                                        out[i, :, :N_FEATS],
                                        out[i, :, N_FEATS:]))

    # -- the single-chunk path --------------------------------------------

    def dispatch(self, replay, cols: native.StagedChunk, width: int) -> None:
        """Fold ONE staged chunk into ``replay``'s state: a one-lane
        dispatch of the lane kernel, folded before return (after every
        in-flight dispatch, so folds never leave dispatch order)."""
        self.drain_lanes()
        scratch, key = self._fill_slot(width, 1, [cols])
        t0 = time.perf_counter()
        out = self._launch(scratch)
        ev = self._event()
        t1 = time.perf_counter()
        self._fold([replay], out)
        if ev is not None:
            ev.synchronize()            # the scratch-reuse barrier
        t2 = time.perf_counter()
        self.dispatch_wall_s += t1 - t0
        self._obs_dispatch_s.inc(t1 - t0)
        self.fold_wall_s += t2 - t1
        self._obs_fold_s.inc(t2 - t1)

    # -- the fused (lane-stacked) path ------------------------------------

    def lane_plan(self, n: int) -> List[Tuple[int, int]]:
        """``(n_live, lane_bucket)`` dispatch groups covering ``n`` lanes:
        the largest bucket repeatedly, then the smallest bucket covering
        the remainder (dead-padded)."""
        out: List[Tuple[int, int]] = []
        big = self.lane_buckets[-1]
        while n > big:
            out.append((big, big))
            n -= big
        if n > 0:
            out.append((n, next(b for b in self.lane_buckets if b >= n)))
        return out

    def _account_group(self, n_live: int, lanes: int) -> None:
        self.fused_dispatches += 1
        self.lanes_by_bucket[lanes] = self.lanes_by_bucket.get(lanes, 0) + 1
        self.staged_lanes += lanes
        self.live_lanes += n_live
        self._obs_fused.inc()
        self._obs_lanes.observe(n_live)
        self._obs_staged_lanes.inc(lanes)
        self._obs_live_lanes.inc(n_live)
        self._obs_lane_waste.set(1.0 - self.live_lanes / self.staged_lanes)

    def submit_lanes(self, width: int,
                     work: List[Tuple[object, native.StagedChunk]]
                     ) -> None:
        """Stage and launch ``work`` (replay plane, unpadded chunk) pairs
        as lane-bucketed fused dispatches.  Folds are deferred until a
        dispatch retires, in dispatch order; at most ``pipeline - 1``
        stay in flight.  Callers :meth:`drain_lanes` before reading the
        planes."""
        pos = 0
        for n_live, lanes in self.lane_plan(len(work)):
            group = work[pos:pos + n_live]
            pos += n_live
            scratch, key = self._fill_slot(width, lanes,
                                           [cols for _, cols in group],
                                           perf=self.perf)
            t0 = time.perf_counter()
            out = self._launch(scratch)
            self._inflight.append(([replay for replay, _ in group], out,
                                   key, self._event()))
            dt = time.perf_counter() - t0
            self.dispatch_wall_s += dt
            self._obs_dispatch_s.inc(dt)
            if self.perf is not None:
                self.perf.note_submitted(key, t0, t0 + dt)
            self._account_group(n_live, lanes)
            if self.native_stage:
                self.native_staged += 1
                self._obs_native.inc()
            while len(self._inflight) > self.pipeline - 1:
                self._retire_one()

    def _retire_one(self) -> None:
        """Retire the OLDEST in-flight dispatch: fold its deltas, then
        wait on its event, after which its scratch slot may refill.  The
        perf stamps reuse the fold leg's two clock reads: ``retire`` at
        the first, ``materialized`` and ``folded`` at the read after the
        wait (the fold was enqueued before it)."""
        replays, out, key, ev = self._inflight.popleft()
        t0 = time.perf_counter()
        self._fold(replays, out)
        if ev is not None:
            ev.synchronize()
        dt = time.perf_counter() - t0
        self.fold_wall_s += dt
        self._obs_fold_s.inc(dt)
        prf = self.perf
        if prf is not None:
            prf.note_retire(key, t0)
            prf.note_materialized(key, t0 + dt)
            prf.note_folded(key, t0 + dt)

    def drain_lanes(self) -> None:
        """Retire every in-flight dispatch (the tick-end barrier)."""
        while self._inflight:
            self._retire_one()

    def mark_deferred(self, t0: float, t1: float) -> None:
        """Stamp every in-flight dispatch's deferred leg: issued at
        ``t0``, left in flight under the next tick's coordinator work
        until the commit barrier read it at ``t1`` (the deferred-commit
        engine calls this at the barrier, before :meth:`drain_lanes`)."""
        if self.perf is None:
            return
        for _, _, key, _ in self._inflight:
            self.perf.note_deferred(key, t0, t1)

    def abort_lanes(self) -> None:
        """Failed-tick cleanup: wait for every in-flight dispatch (its
        scratch must not refill under it) WITHOUT folding, so the planes
        keep their last-folded states; an aborted dispatch's perf record
        is dropped and counted."""
        while self._inflight:
            _, _, key, ev = self._inflight.popleft()
            if ev is not None:
                ev.synchronize()
            if self.perf is not None:
                self.perf.note_aborted(key)

    @property
    def inflight_dispatches(self) -> int:
        return len(self._inflight)

    def book_snapshot(self) -> dict:
        """The runner's cumulative dispatch-count book, which the shard
        supervisor checkpoints and restores around a recovery
        re-execution, so re-executed slices do not count twice in the
        journal's dispatch plane or the report.  Walls and first-launch
        walls stay out: recovery work is real work."""
        return {"n_dispatches": self.n_dispatches,
                "dispatches_by_width": dict(self.dispatches_by_width),
                "fused_dispatches": self.fused_dispatches,
                "native_staged": self.native_staged,
                "staged_lanes": self.staged_lanes,
                "live_lanes": self.live_lanes,
                "lanes_by_bucket": dict(self.lanes_by_bucket)}

    def book_restore(self, book: dict) -> None:
        """Install a :meth:`book_snapshot` (checkpoint restore)."""
        self.n_dispatches = book["n_dispatches"]
        self.dispatches_by_width = dict(book["dispatches_by_width"])
        self.fused_dispatches = book["fused_dispatches"]
        self.native_staged = book["native_staged"]
        self.staged_lanes = book["staged_lanes"]
        self.live_lanes = book["live_lanes"]
        self.lanes_by_bucket = dict(book["lanes_by_bucket"])

    @property
    def lane_pad_waste(self) -> float:
        """Dead-lane fraction of every fused dispatch so far."""
        return (1.0 - self.live_lanes / self.staged_lanes
                if self.staged_lanes else 0.0)


class BucketedStreamReplay(StreamReplay):
    """A :class:`~anomod_torch.stream.StreamReplay` whose dispatch rides a
    shared :class:`BucketRunner`; its state is host tensors (the host
    seam).  Same ring and anchor bookkeeping as the parent (``_roll`` is
    inherited); :meth:`plan_push` exposes the staging half alone, for the
    fused engine's lane-stacked dispatch."""

    def __init__(self, cfg: ReplayConfig, t0_us: int, runner: BucketRunner):
        if runner.cfg != cfg:
            raise ValueError("runner cfg disagrees with the replay cfg")
        # not super().__init__: the runner owns the kernel dispatch and
        # the device; this plane holds only its state and ring anchor
        self.cfg = cfg
        self.device = runner.device
        self.t0_us = int(t0_us)
        self.window_offset = 0
        self.n_spans = 0
        self._step = None
        self.compile_s = 0.0
        self._warmed = False
        self._runner = runner
        self.state = zero_state(cfg, "cpu")

    def _warm(self) -> None:
        self._runner.warm()
        self.compile_s = self._runner.compile_s
        self._warmed = True

    def plan_push(self, batch: SpanBatch):
        """The staging half of :meth:`push`: roll the ring, account the
        spans, stage the bucket plan, WITHOUT dispatching.  Returns
        ``(newest absolute window, ordered (width, columns) chunks)``."""
        if batch.n_spans == 0:
            return -1, []
        if not self._warmed:
            self._warm()
        w_need = int((int(batch.start_us.max()) - self.t0_us)
                     // self.cfg.window_us)
        if w_need > self.cfg.n_windows - 1:
            self._roll(w_need - (self.cfg.n_windows - 1))
            w_need = self.cfg.n_windows - 1
        plan = self._runner.stage_plan(batch, self.t0_us)
        self.n_spans += batch.n_spans
        return self.window_offset + max(w_need, 0), plan

    def push(self, batch: SpanBatch) -> int:
        w_ret, plan = self.plan_push(batch)
        for width, cols in plan:
            self._runner.dispatch(self, cols, width)
        return w_ret


class PooledStreamReplay(BucketedStreamReplay):
    """A :class:`BucketedStreamReplay` whose state lives in the runner's
    device pool.  ``state`` stays the official surface (reads gather the
    slot to the host, writes put it back) but the hot paths never touch
    it: the lane fold is the pool's scatter-fold, the ring roll runs on
    the pool row, and batched scoring gathers only the scored columns."""

    def __init__(self, cfg: ReplayConfig, t0_us: int, runner: BucketRunner):
        if runner.pool is None:
            raise ValueError("runner keeps host-seam states (state='host'); "
                             "use BucketedStreamReplay")
        self._slot = runner.pool.acquire()
        try:
            super().__init__(cfg, t0_us, runner)
        except BaseException:
            # a failed construction hands its slot back
            runner.pool.release(self._slot)
            self._slot = None
            raise

    def _live_slot(self) -> int:
        # a released plane must fail loud, never read or write a slot
        # another tenant may own by now
        if self._slot is None:
            raise ValueError("pool slot was released; this "
                             "PooledStreamReplay is dead")
        return self._slot

    @property
    def state(self) -> ReplayState:
        return self._runner.pool.gather(self._live_slot())

    @state.setter
    def state(self, st: ReplayState) -> None:
        self._runner.pool.put(self._live_slot(), st)

    def _roll(self, k: int) -> None:
        self._runner.pool.roll(self._live_slot(), k)
        self.t0_us += k * self.cfg.window_us
        self.window_offset += k

    def release(self) -> None:
        """Hand the slot back to the pool, zeroed (a supervised restore's
        or a migration's teardown half).  Not idempotent: a second
        release would free a slot another tenant may own."""
        self._runner.pool.release(self._live_slot())
        self._slot = None
