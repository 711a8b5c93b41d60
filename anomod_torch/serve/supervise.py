"""Shard supervision: checkpoint, restore and no-score-gap recovery for
the serve plane (counterpart of ``anomod/serve/supervise.py``).

- **Checkpoint** (``ANOMOD_SERVE_CKPT_EVERY``, default 32 ticks): every
  Nth tick the supervisor snapshots every tenant (the replay state
  through the ``get_state`` seam, the detector's host bookkeeping) and
  every runner's dispatch-count book.  Pool-resident states are read
  with their runner's other residents: one device-to-host copy of the
  resident rows a plane and runner (:func:`snapshot_replays`), split
  per tenant on the host.  Between checkpoints the coordinator keeps
  every tick's served batches (the re-execution input).
- **Recovery**: a shard failure at the tick barrier restores the shard
  (its planes dropped, the checkpoint reinstalled through ``set_state``
  on the shard runner's own stream, that stream synced) and re-executes
  the kept slices, the failed tick's included, on the respawned worker
  when the worker died.  Scoring is a function of (state, slices) alone,
  so the recovered run's states, alerts, SLO, shed and canonical flight
  journal equal a fault-free run's byte for byte.
- **Degradation**: a slice that fails ``ANOMOD_SERVE_RETRIES``
  consecutive times is quarantined (dropped from the log, counted,
  journaled); a shard whose worker dies past
  ``ANOMOD_SERVE_MAX_RESPAWNS`` is dead and its tenants migrate to the
  survivors through the same seams.

On the happy path the supervisor only reads (snapshots) and keeps host
books (the log), so a chaos-off supervised run's decisions equal the
unsupervised engine's.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.replay import ReplayState

__all__ = ["ShardSupervisor", "snapshot_replay", "snapshot_replays",
           "restore_replay", "snapshot_detector", "restore_detector"]


# -- tenant snapshot / restore through the state seams ------------------

def _pooled(rep) -> bool:
    return getattr(rep, "_slot", None) is not None \
        and getattr(getattr(rep, "_runner", None), "pool", None) is not None


def _host_arrays(st):
    """A replay state as host numpy arrays owned by the snapshot: a pure
    read, never a view of a live plane."""
    return type(st)(*[None if x is None else
                      (x.detach().cpu().numpy().copy()
                       if torch.is_tensor(x) else np.array(x))
                      for x in st])


def _ring(rep) -> dict:
    return {"t0_us": rep.t0_us, "window_offset": rep.window_offset,
            "n_spans": rep.n_spans}


def snapshot_replay(rep) -> dict:
    """One tenant replay plane's restorable state: its ``get_state`` as
    host numpy arrays (only host data crosses a process pipe) plus the
    ring bookkeeping ``plan_push`` advances."""
    return {"state": _host_arrays(rep.get_state()), **_ring(rep)}


def snapshot_replays(replays: Dict[int, object]) -> Dict[int, dict]:
    """:func:`snapshot_replay` of every tenant, with pool-resident planes
    read a runner at a time: ONE device-to-host copy of the resident
    rows a plane (``BucketRunner.gather_rows``, on the runner's stream),
    split per tenant on the host.  Equal to the per-tenant walk byte for
    byte; host-seam planes are read through ``get_state``."""
    pooled: Dict[int, Tuple[object, List[int]]] = {}
    out: Dict[int, dict] = {}
    for tid, rep in replays.items():
        if _pooled(rep):
            pooled.setdefault(id(rep._runner), (rep._runner, []))[1].append(
                tid)
        else:
            out[tid] = snapshot_replay(rep)
    for runner, tids in pooled.values():
        agg, hist = runner.gather_rows([replays[t]._slot for t in tids])
        for i, t in enumerate(tids):
            out[t] = {"state": ReplayState(agg=agg[i], hist=hist[i]),
                      **_ring(replays[t])}
    return out


def restore_replay(rep, snap: dict) -> None:
    """Install a :func:`snapshot_replay` into a fresh plane.  A pool put
    copies into the pool's rows; the host seam installs references, so
    the arrays are copied on the way in (the fold must never write into
    the checkpoint, which a later restore reads again)."""
    rep.t0_us = snap["t0_us"]
    rep.window_offset = snap["window_offset"]
    rep.n_spans = snap["n_spans"]
    st = snap["state"]
    if not _pooled(rep):
        st = type(st)(*[None if x is None else torch.from_numpy(np.array(x))
                        for x in st])
    rep.set_state(st)


def _copy_state_val(v):
    """Structured copy of detector host state: arrays and containers
    copy (folds mutate them in place), scalars and frozen records
    (alerts) are shared; anything else falls back to ``deepcopy``."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if v is None or isinstance(v, (int, float, bool, str, bytes,
                                   frozenset)):
        return v
    if isinstance(v, tuple):
        return tuple(_copy_state_val(x) for x in v)
    if isinstance(v, list):
        return [_copy_state_val(x) for x in v]
    if isinstance(v, dict):
        return {k: _copy_state_val(x) for k, x in v.items()}
    if isinstance(v, set):
        return set(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type) \
            and v.__dataclass_params__.frozen:
        return v
    return copy.deepcopy(v)


def snapshot_detector(det) -> dict:
    """The detector's host bookkeeping (alerts, streaks, CUSUM,
    calibration): everything but its replay plane, which snapshots
    through its own seam."""
    return {k: _copy_state_val(v) for k, v in det.__dict__.items()
            if k != "replay"}


def restore_detector(det, snap: dict) -> None:
    det.__dict__.update({k: _copy_state_val(v)
                         for k, v in snap.items()})


class _ReplayFailed(Exception):
    """A recovery re-execution failed at one log slice."""

    def __init__(self, tick: int, exc: BaseException):
        super().__init__(f"re-execution failed at tick {tick}: {exc}")
        self.tick = tick
        self.exc = exc


class _Checkpoint:
    __slots__ = ("tick", "tenants", "books")

    def __init__(self, tick: int, tenants: dict, books: list):
        self.tick = tick
        self.tenants = tenants          # tid -> (replay_snap, det_snap)
        self.books = books              # per-runner book_snapshot()


class ShardSupervisor:
    """The checkpoint cadence, the recovery log, the retry / quarantine
    policy and the dead-shard migration of one
    :class:`~anomod_torch.serve.engine.ServeEngine`.  ``sleep_fn`` is the
    retry backoff's clock (injectable, so tests need no wall time)."""

    def __init__(self, engine, ckpt_every: int, retries: int,
                 backoff_s: float, max_respawns: int, sleep_fn=None):
        if ckpt_every < 1:
            raise ValueError("supervision needs ckpt_every >= 1 "
                             "(0 disables it at the engine)")
        self.engine = engine
        self.ckpt_every = int(ckpt_every)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.max_respawns = int(max_respawns)
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep
        self._ckpt: Optional[_Checkpoint] = None
        #: (tick, served) since the last checkpoint: the re-execution input
        self._log: List[Tuple[int, list]] = []
        self._quarantined_seqs: set = set()
        #: consecutive recovery failures per (shard, origin tick) slice
        self._fail_counts: Dict[Tuple[int, int], int] = {}
        self._respawns: Dict[int, int] = {}
        self.dead_shards: set = set()
        #: recovery events for the flight journal's variant tier
        self._events: List[dict] = []
        self.n_checkpoints = 0
        self.n_crashes = 0
        self.n_respawns = 0
        self.n_restored_ticks = 0
        self.n_quarantined = 0
        self.quarantined_spans = 0
        self.n_migrated = 0
        self.ckpt_wall_s = 0.0
        self.recovery_wall_s = 0.0
        self._obs_ckpt = obs.counter("anomod_serve_ckpt_total")
        self._obs_ckpt_s = obs.counter("anomod_serve_ckpt_seconds_total")
        self._obs_crashes = obs.counter(
            "anomod_serve_shard_crashes_total")
        self._obs_respawns = obs.counter(
            "anomod_serve_shard_respawns_total")
        self._obs_restored = obs.counter(
            "anomod_serve_restored_ticks_total")
        self._obs_quarantined = obs.counter(
            "anomod_serve_quarantined_batches_total")
        self._obs_migrated = obs.counter(
            "anomod_serve_migrated_tenants_total")
        self._obs_recovery_s = obs.counter(
            "anomod_serve_recovery_seconds_total")

    # -- the per-tick protocol ---------------------------------------------

    def begin_tick(self, served: list) -> None:
        """Log this tick's served batches before scoring runs (a failed
        tick re-executes from the log).  The baseline checkpoint is
        taken here on the first call: after the warm-up, before any
        scoring."""
        if self._ckpt is None:
            self._checkpoint()
        self._log.append((self.engine.clock.ticks, served))

    def end_tick(self) -> None:
        """Checkpoint at the cadence (0-based tick t checkpoints when
        ``(t + 1) % every == 0``), after the tick's commit barrier."""
        if (self.engine.clock.ticks + 1) % self.ckpt_every == 0:
            self._checkpoint()
        if self.engine.flight_recorder is None and self._events:
            # no journal drains them: the counters carry the story
            self._events.clear()

    def drain_events(self) -> List[dict]:
        ev, self._events = self._events, []
        return ev

    def note_topology_change(self) -> None:
        """The elastic policy changed the shard set (a scale edge or a
        rebalance): take a fresh baseline checkpoint now.  The
        checkpoint's runner books and placements index the current shard
        set, so the recovery log never spans a topology change."""
        self._checkpoint()

    # -- checkpointing -----------------------------------------------------

    def _checkpoint(self) -> None:
        t0 = time.perf_counter()
        eng = self.engine
        if eng.worker_mode == "process":
            # the states live in the children: each runs the same
            # snapshot seams over its tenants and ships the pairs
            tenants = eng._snapshot_tenants_proc()
        else:
            reps = snapshot_replays(eng._tenant_replay)
            tenants = {}
            for tid, snap in reps.items():
                det = eng._tenant_det.get(tid)
                tenants[tid] = (snap, snapshot_detector(det)
                                if det is not None else None)
        tier = eng._tier
        if tier is not None:
            # demoted tenants are fleet state too: warm snapshots by
            # reference (never written after demotion), cold entries by
            # content address (the store only grows); the detector
            # bookkeeping is copied, it mutates once the tenant promotes
            for tid in tier.tids():
                det = tier.ckpt_det(tid)
                tenants[tid] = (tier.ckpt_snap(tid),
                                snapshot_detector(det)
                                if det is not None else None)
        books = [r.book_snapshot() for r in eng._runners]
        self._ckpt = _Checkpoint(eng.clock.ticks, tenants, books)
        self._log = []
        self.n_checkpoints += 1
        self._obs_ckpt.inc()
        dt = time.perf_counter() - t0
        self.ckpt_wall_s += dt
        self._obs_ckpt_s.inc(dt)

    # -- recovery ----------------------------------------------------------

    def recover(self, failures: List[Tuple[int, BaseException]],
                origin_tick: Optional[int] = None) -> None:
        """Recover every shard that failed this tick's barrier.  Raises
        the original error only when recovery is impossible: retries and
        quarantine spent and no surviving shard to migrate to."""
        t0 = time.perf_counter()
        try:
            for shard_id, exc in failures:
                if not isinstance(exc, Exception):
                    raise exc     # an operator interrupt, never a fault
                self._recover_shard(shard_id, exc,
                                    origin_tick=origin_tick)
        finally:
            dt = time.perf_counter() - t0
            self.recovery_wall_s += dt
            self._obs_recovery_s.inc(dt)

    def _recover_shard(self, s: int, exc: BaseException,
                       origin_tick: Optional[int] = None) -> None:
        eng = self.engine
        tick = eng.clock.ticks
        self.n_crashes += 1
        self._obs_crashes.inc()
        event = {"kind": "recovered", "tick": tick, "shard": s,
                 "error": f"{type(exc).__name__}: {exc}",
                 "attempts": 0, "respawns": 0, "restored_ticks": 0,
                 "quarantined": 0}
        # the live failure is attempt 1 against the slice that failed
        fail_key = (s, tick if origin_tick is None else origin_tick)
        self._fail_counts[fail_key] = \
            self._fail_counts.get(fail_key, 0) + 1
        last = exc
        attempt = 0
        while True:
            if self._worker_dead_past_budget(s):
                # migrate before any quarantine: a fault that follows the
                # shard runs clean on the new owners
                self._migrate_dead_shard(s, last)
                return
            if self._fail_counts.get(fail_key, 0) >= self.retries:
                event["quarantined"] += self._quarantine(s, fail_key[1])
            if self.backoff_s > 0:
                self._sleep(min(self.backoff_s * (2 ** attempt), 5.0))
            self._respawn_worker(s, event)
            try:
                restored = self._restore_and_replay(s, event)
            except _ReplayFailed as rf:
                attempt += 1
                last = rf.exc
                fail_key = (s, rf.tick)
                self._fail_counts[fail_key] = \
                    self._fail_counts.get(fail_key, 0) + 1
                continue
            event["attempts"] = attempt + 1
            event["restored_ticks"] = restored
            self._events.append(event)
            # the incident is over: every slice ran clean, so the
            # shard's failure streaks are broken
            self._fail_counts = {k: v for k, v in
                                 self._fail_counts.items() if k[0] != s}
            return

    def _worker_dead_past_budget(self, s: int) -> bool:
        eng = self.engine
        return (eng._workers is not None
                and not eng._workers[s].alive
                and self._respawns.get(s, 0) >= self.max_respawns)

    def _respawn_worker(self, s: int, event: dict) -> None:
        """Respawn shard ``s``'s worker if it died (the budget was
        checked by the caller).  The inline engine has none."""
        eng = self.engine
        if eng._workers is None:
            return
        w = eng._workers[s]
        if w.alive:
            return
        w.close()
        # a fresh process child starts empty: the restore below
        # reinstalls the checkpoint into it
        eng._workers[s] = eng._make_worker(s)
        self._respawns[s] = self._respawns.get(s, 0) + 1
        self.n_respawns += 1
        self._obs_respawns.inc()
        event["respawns"] += 1

    def _drop_shard_planes(self, s: int) -> None:
        """Discard shard ``s``'s (suspect, possibly half-folded) tenant
        planes and in-flight dispatches: the restore's teardown half."""
        eng = self.engine
        if eng.worker_mode == "process":
            eng._drop_shard_proc(s)
            return
        runner = eng._runners[s]
        with runner.on_stream():
            for tid in [t for t in list(eng._tenant_replay)
                        if eng.shard_of.get(t, 0) == s]:
                rep = eng._tenant_replay.pop(tid)
                eng._tenant_det.pop(tid, None)
                if hasattr(rep, "release"):
                    rep.release()        # hand the pool slot back
            runner.abort_lanes()

    def _install_tenant(self, tid: int, snap: tuple) -> None:
        """Recreate one tenant's planes on its owning shard and install
        the checkpoint through the state seams, on that shard runner's
        stream (the caller syncs it before anything reads the pool)."""
        eng = self.engine
        if eng.worker_mode == "process":
            eng._install_tenant_proc(tid, snap)
            return
        rep_snap, det_snap = snap
        tier = eng._tier
        if tier is not None:
            # the checkpoint supersedes any live tier entry: the restore
            # rebuilds the tenant resident, and a stale entry would
            # shadow it at the tenant's next scoring gate
            tier.discard(tid)
            if "__tier_cold__" in rep_snap:
                rep_snap = tier.load_cold(rep_snap["__tier_cold__"])
        with eng._runners[eng.shard_of.get(tid, 0)].on_stream():
            rep = eng._replay_for(tid)
            restore_replay(rep, rep_snap)
        if det_snap is not None:
            restore_detector(eng._detector_for(tid), det_snap)

    def _restore_and_replay(self, s: int, event: Optional[dict] = None
                            ) -> int:
        """Restore shard ``s`` to the checkpoint and re-execute its kept
        slices, oldest first, quarantined batches left out.  Returns the
        slices re-executed; raises :class:`_ReplayFailed` naming the
        slice that failed."""
        eng = self.engine
        ck = self._ckpt
        self._drop_shard_planes(s)
        eng._restore_book(s, ck.books[s])
        for tid, snap in ck.tenants.items():
            if eng.shard_of.get(tid, 0) == s:
                self._install_tenant(tid, snap)
        if eng.worker_mode != "process":
            eng._runners[s].sync()
        restored = 0
        for tick, served in self._log:
            slice_ = [qb for qb in served
                      if eng.shard_of.get(qb.tenant_id, 0) == s
                      and qb.seq not in self._quarantined_seqs]
            if not slice_:
                continue
            # a respawn is set-up, outside the try: its failure is not
            # the slice's and must not charge the slice's budget
            self._ensure_worker_alive(s, event)
            try:
                self._exec_slice(s, slice_, tick)
            except Exception as e:       # interrupts propagate raw
                raise _ReplayFailed(tick, e)
            restored += 1
        self.n_restored_ticks += restored
        self._obs_restored.inc(restored)
        return restored

    def _ensure_worker_alive(self, s: int,
                             event: Optional[dict] = None) -> None:
        """Respawn shard ``s``'s worker if it is dead (a kill mid-replay,
        or a migration target whose own failure is still queued); the
        respawn lands in the caller's recovery event."""
        eng = self.engine
        if eng._workers is not None and not eng._workers[s].alive:
            self._respawn_worker(
                s, event if event is not None else {"respawns": 0})

    def _exec_slice(self, s: int, slice_: list, tick: int) -> None:
        """Re-execute one logged slice on shard ``s``: in its child, on
        its worker thread under its runner's stream, or inline on the
        1-shard engine.  An exception here is the slice's failure."""
        eng = self.engine
        if eng.worker_mode == "process":
            eng._exec_slice_proc(s, slice_, tick)
        elif eng._workers is not None:
            w = eng._workers[s]
            w.submit(partial(eng._on_shard, s, eng._score_shard, s, slice_,
                             tick))
            w.join()
        else:
            eng._score_shard(s, slice_, tick)

    def _quarantine(self, s: int, tick: int) -> int:
        """Drop shard ``s``'s slice of origin ``tick`` from the log (it
        failed ``retries`` consecutive attempts); counted per batch."""
        eng = self.engine
        dropped = spans = 0
        for t, served in self._log:
            if t != tick:
                continue
            for qb in served:
                if eng.shard_of.get(qb.tenant_id, 0) == s \
                        and qb.seq not in self._quarantined_seqs:
                    self._quarantined_seqs.add(qb.seq)
                    self.quarantined_spans += qb.n_spans
                    spans += qb.n_spans
                    dropped += 1
        self.n_quarantined += dropped
        self._obs_quarantined.inc(dropped)
        self._events.append({"kind": "quarantine", "tick": tick,
                             "shard": s, "batches": dropped,
                             "spans": spans})
        return dropped

    # -- dead-shard migration ------------------------------------------------

    def _migrate_dead_shard(self, s: int, last: BaseException) -> None:
        """Shard ``s`` is dead past its respawn budget: move its tenants
        to the survivors (checkpoint state in, kept slices re-executed on
        the new owners) and route all later work away from it."""
        from anomod_torch.serve.shard import rendezvous_shard
        eng = self.engine
        tick = eng.clock.ticks
        survivors = [x for x in range(eng.shards)
                     if x != s and x not in self.dead_shards]
        if not survivors:
            raise last
        self.dead_shards.add(s)
        moved = sorted(t for t, sh in eng.shard_of.items() if sh == s)
        self._drop_shard_planes(s)
        eng._restore_book(s, self._ckpt.books[s])
        # a fresh idle worker parks in the dead slot, so the engine's
        # all-alive check stays quiet; it never receives work
        if eng._workers is not None:
            eng._workers[s].close()
            eng._workers[s] = eng._make_worker(s)
        # rendezvous over the survivors: a function of (tenant, survivor
        # set) alone, so a replay of the script migrates the same way
        for tid in moved:
            eng.shard_of[tid] = rendezvous_shard(tid, eng.shards,
                                                 candidates=survivors)
            self.n_migrated += 1
            self._obs_migrated.inc()
        if eng.rca and len(eng._rca_planes) > 1:
            src = eng._rca_planes[s]
            for tid in moved:
                src.move_tenant_evidence(
                    eng._rca_planes[eng.shard_of[tid]], tid)
        for tid in moved:
            snap = self._ckpt.tenants.get(tid)
            if snap is not None:
                self._install_tenant(tid, snap)
        if eng.worker_mode != "process":
            for x in survivors:
                eng._runners[x].sync()
        moved_set = set(moved)
        mig_event = {"kind": "migrate", "tick": tick, "shard": s,
                     "to": survivors, "tenants": len(moved),
                     "respawns": 0,
                     "error": f"{type(last).__name__}: {last}"}
        #: targets whose nested recovery replayed the whole log already
        #: (their restore held the migrated tenants' every slice): the
        #: walk below skips them, or later slices would fold twice
        recovered: set = set()
        outer_counts: Dict[int, int] = {}
        for t, served in self._log:
            by_shard: Dict[int, list] = {}
            for qb in served:
                if qb.tenant_id in moved_set \
                        and qb.seq not in self._quarantined_seqs \
                        and eng.shard_of[qb.tenant_id] not in recovered:
                    by_shard.setdefault(
                        eng.shard_of[qb.tenant_id], []).append(qb)
            for tgt in sorted(by_shard):
                self._ensure_worker_alive(tgt, mig_event)
                try:
                    self._exec_slice(tgt, by_shard[tgt], t)
                except Exception as e2:      # interrupts propagate raw
                    # the fault followed the batch: quarantine it and
                    # recover the target the normal way
                    for qb in by_shard[tgt]:
                        self._quarantined_seqs.add(qb.seq)
                        self.quarantined_spans += qb.n_spans
                    self.n_quarantined += len(by_shard[tgt])
                    self._obs_quarantined.inc(len(by_shard[tgt]))
                    self._events.append(
                        {"kind": "quarantine", "tick": t, "shard": tgt,
                         "batches": len(by_shard[tgt]),
                         "spans": sum(qb.n_spans for qb in by_shard[tgt]),
                         "during": "migration"})
                    # the nested recovery replays the whole log: the
                    # walk's counts for tgt are superseded
                    self.n_restored_ticks -= outer_counts.pop(tgt, 0)
                    self._recover_shard(tgt, e2, origin_tick=t)
                    recovered.add(tgt)
                    continue
                self.n_restored_ticks += 1
                outer_counts[tgt] = outer_counts.get(tgt, 0) + 1
                self._obs_restored.inc()
        self._events.append(mig_event)
