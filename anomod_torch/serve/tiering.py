"""Tenant-state tiering: the device hot pool, a host warm tier and a
content-addressed disk cold tier, with re-admission that never blocks
the tick (counterpart of ``anomod/serve/tiering.py``).

- **Demote** (the engine's tick end): while more than
  ``ANOMOD_SERVE_TIER_HOT`` tenants are pool-resident, the coldest
  residents past ``ANOMOD_SERVE_TIER_DEMOTE_AFTER`` idle ticks (the
  census tracker's ``coldest_candidates`` order) are read out through
  :func:`anomod_torch.serve.supervise.snapshot_replay` (one device-to-host
  copy on the owning runner's stream) and their pool slot released.  The
  warm tier keeps the host snapshot.  Past the
  ``ANOMOD_SERVE_TIER_WARM_BYTES`` budget the coldest warm entries'
  arrays spill to a content-addressed ``.npc`` entry under
  ``ANOMOD_SERVE_TIER_COLD_DIR`` (the ingest cache's payload format and
  atomic tmp-rename publish): published first, the host copy dropped
  only after, so a kill in between leaves the warm entry intact and a
  reader never sees a torn file.  The detector's host bookkeeping stays
  in the entry either way.
- **Promote** (the engine's scoring gate): a demoted tenant's next
  drained batch re-admits it.  A warm promotion is a host-to-device put
  through :func:`~anomod_torch.serve.supervise.restore_replay`.  A cold
  promotion is deferred exactly one tick: the disk read is issued on the
  prefetch lane (a thread pool over host files; only numpy crosses it),
  the tenant's batches park for one tick as a counted, journaled
  ``tier_miss``, and the next tick's gate joins the read.  The deferral
  never depends on wall time, so every tier decision is a function of
  seed and config: ``audit replay`` reproduces demotions, promotions and
  misses.  How many cold reads had finished at their join
  (``prefetch_hidden``) is wall telemetry, reported and never decisive.

A tiered run's final states, alerts, SLO and shed equal a never-evicted
run's byte for byte: parking keeps each tenant's push order, and
scoring is a function of (state, slices).
"""

from __future__ import annotations

import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from anomod_torch.io.cache import (_atomic_publish, _read_payload,
                                   _write_payload, cache_key, entry_paths)

__all__ = ["TierPlane", "TIER_FORMAT"]

#: cold-entry payload format (bump to invalidate published entries)
TIER_FORMAT = 1


class _TierStateShim:
    """A demoted tenant's stand-in for the flight recorder's
    ``state_digest`` walk: exposes exactly the ``get_state`` /
    ``window_offset`` / ``n_spans`` surface the digest reads, backed by
    the warm snapshot (cheap references) or a cold-tier load (digest
    ticks only, bounded by the demoted set)."""

    __slots__ = ("_get", "window_offset", "n_spans")

    def __init__(self, get_state, window_offset: int, n_spans: int):
        self._get = get_state
        self.window_offset = window_offset
        self.n_spans = n_spans

    def get_state(self):
        return self._get()


class TierPlane:
    """The warm/cold store and its counters.  Pure mechanism — WHO
    demotes (the coldest-candidates policy, backlog/parked exclusions)
    and WHEN promotions install (the scoring gate) live in the engine;
    this class owns the entries, the bytes accounting, the cold-tier
    publish/load and the prefetch lane."""

    def __init__(self, warm_budget_bytes: int, cold_dir: Optional[Path],
                 prefetch_depth: int, slot_nbytes: int):
        self.warm_budget_bytes = int(warm_budget_bytes)
        self.cold_dir = Path(cold_dir) if cold_dir else None
        self.prefetch_depth = int(prefetch_depth)
        self.slot_nbytes = int(slot_nbytes)
        #: tid -> entry.  A WARM entry holds {"replay": snapshot_replay
        #: dict, "det": detector, "cold_key": None}; a COLD entry's
        #: replay slot is the retained scalar meta instead of arrays
        #: ({"meta": ..., "leaves": n, "none": [...]}) and "cold_key"
        #: addresses the published payload.  Insertion order is
        #: last-demoted order; demotion re-inserts, so the FRONT is the
        #: coldest warm entry — the spill ordering.
        self._entries: Dict[int, dict] = {}
        self._state_cls = None          # the get_state pytree type
        self._pool: Optional[ThreadPoolExecutor] = None
        self._fetching: Dict[int, Future] = {}
        # canonical counters (functions of seed+config — parity surface)
        self.demotions_warm = 0
        self.demotions_cold = 0
        self.promotions = 0
        self.misses = 0
        # wall-side telemetry (variant surface): how many cold joins
        # found the fetch already complete
        self.prefetch_hits = 0
        #: demote/promote/miss events for the flight journal's
        #: ``tiering`` VARIANT key (drained per tick by the engine);
        #: wall-free, so the stream is byte-equal across reruns
        self.events: List[dict] = []
        self.warm_state_bytes = 0       # exact array bytes, warm only

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, tid: int) -> bool:
        return tid in self._entries

    def tids(self):
        return self._entries.keys()

    def status(self, tid: int) -> Optional[str]:
        e = self._entries.get(tid)
        if e is None:
            return None
        return "cold" if e["cold_key"] is not None else "warm"

    # -- demotion ---------------------------------------------------------

    def demote(self, tick: int, tid: int, replay_snap: dict,
               detector, idle_ticks: int) -> None:
        """Accept one demoted tenant (the engine already snapshotted it
        through the state seams and released its pool slot), then spill
        past the warm budget."""
        if tid in self._entries:
            raise RuntimeError(f"tenant {tid} is already tiered")
        if self._state_cls is None:
            self._state_cls = type(replay_snap["state"])
        self._entries[tid] = {"replay": replay_snap, "det": detector,
                              "cold_key": None}
        self.warm_state_bytes += self.slot_nbytes
        self.demotions_warm += 1
        self.events.append({"kind": "demote", "tier": "warm",
                            "tick": int(tick), "tenant": int(tid),
                            "idle_ticks": int(idle_ticks)})
        self._spill(tick)

    def _spill(self, tick: int) -> None:
        """Spill the coldest warm entries' arrays to the cold tier
        until the warm budget holds.  No cold dir → the warm tier is
        terminal and the budget is advisory;
        a refused publish (OSError) keeps the entry warm — the budget
        is a target, data loss is not an option."""
        if self.cold_dir is None:
            return
        while self.warm_state_bytes > self.warm_budget_bytes:
            victim = next((t for t, e in self._entries.items()
                           if e["cold_key"] is None), None)
            if victim is None:
                return
            if not self._publish_cold(tick, victim):
                return

    def _publish_cold(self, tick: int, tid: int) -> bool:
        e = self._entries[tid]
        snap = e["replay"]
        leaves = list(snap["state"])
        arrays = {f"c{i}": np.ascontiguousarray(leaf)
                  for i, leaf in enumerate(leaves) if leaf is not None}
        crc = 0
        for name in arrays:
            crc = zlib.crc32(arrays[name].tobytes(), crc)
        meta = {"tenant": int(tid), "tier_format": TIER_FORMAT,
                "t0_us": int(snap["t0_us"]),
                "window_offset": int(snap["window_offset"]),
                "n_spans": int(snap["n_spans"]),
                "n_leaves": len(leaves),
                "none": [i for i, leaf in enumerate(leaves)
                         if leaf is None]}
        key = cache_key({**meta, "crc": crc})
        payload_path, _ = entry_paths(self.cold_dir, key)
        try:
            payload_path.parent.mkdir(parents=True, exist_ok=True)
            # atomic publish FIRST; the host arrays drop only after the
            # rename lands, so a kill anywhere in between leaves the
            # entry warm and intact (tmp leftovers are never read)
            _atomic_publish(payload_path,
                            lambda f: _write_payload(f, arrays, meta))
        except OSError:
            return False
        e["cold_key"] = key
        e["replay"] = meta
        self.warm_state_bytes -= self.slot_nbytes
        self.demotions_cold += 1
        self.events.append({"kind": "demote", "tier": "cold",
                            "tick": int(tick), "tenant": int(tid)})
        return True

    # -- the prefetch lane ------------------------------------------------

    def prefetch(self, tid: int) -> None:
        """Issue the cold-tier read on the async lane (offer-time hook:
        the fetch overlaps this tick's admission/drain/SLO phases and
        the full deferral tick).  Idempotent; a warm or unknown tid is
        a no-op."""
        e = self._entries.get(tid)
        if e is None or e["cold_key"] is None or tid in self._fetching:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.prefetch_depth,
                thread_name_prefix="anomod-torch-tier-prefetch")
        self._fetching[tid] = self._pool.submit(
            self._read_cold, e["cold_key"])

    def _read_cold(self, key: str) -> tuple:
        payload_path, _ = entry_paths(self.cold_dir, key)
        try:
            with open(payload_path, "rb") as f:
                data = f.read()
            arrays, meta = _read_payload(data)
        except Exception as exc:
            # a published entry is complete by construction (atomic
            # rename, publish-before-drop) — an unreadable one is real
            # data loss and must fail LOUD, never re-derive silently
            raise RuntimeError(
                f"cold-tier entry {key} unreadable ({exc!r}): the "
                f"publish-before-drop protocol makes this impossible "
                f"short of on-disk corruption or an external delete"
            ) from exc
        return arrays, meta

    # -- promotion --------------------------------------------------------

    def take(self, tick: int, tid: int, deferred: bool = False) -> tuple:
        """Remove and return ``(replay_snap, detector)`` for one
        promoting tenant.  Warm: the snapshot comes straight back.
        Cold: joins the prefetch future (or reads synchronously when
        none was issued — the run-end promote-all path), rebuilding the
        ``get_state`` pytree from the payload columns."""
        e = self._entries.pop(tid)
        tier = "cold" if e["cold_key"] is not None else "warm"
        if tier == "warm":
            self.warm_state_bytes -= self.slot_nbytes
            snap = e["replay"]
        else:
            fut = self._fetching.pop(tid, None)
            if fut is not None:
                if fut.done():
                    self.prefetch_hits += 1
                arrays, meta = fut.result()
            else:
                arrays, meta = self._read_cold(e["cold_key"])
            snap = self._snap_from_payload(arrays, meta)
        self.promotions += 1
        self.events.append({"kind": "promote", "tier": tier,
                            "tick": int(tick), "tenant": int(tid),
                            "deferred": bool(deferred)})
        return snap, e["det"]

    def _snap_from_payload(self, arrays: dict, meta: dict) -> dict:
        leaves = [None if i in set(meta["none"])
                  else np.array(arrays[f"c{i}"])
                  for i in range(int(meta["n_leaves"]))]
        return {"state": self._state_cls(*leaves),
                "t0_us": meta["t0_us"],
                "window_offset": meta["window_offset"],
                "n_spans": meta["n_spans"]}

    def miss(self, tick: int, tid: int, n_batches: int,
             n_spans: int) -> None:
        """Count + journal one deterministic cold-promotion deferral."""
        self.misses += 1
        self.events.append({"kind": "miss", "tick": int(tick),
                            "tenant": int(tid),
                            "batches": int(n_batches),
                            "spans": int(n_spans)})

    # -- checkpoint/restore hooks (anomod_torch.serve.supervise) ----------

    def ckpt_snap(self, tid: int) -> dict:
        """A checkpoint-ready replay snapshot for one tiered tenant.
        Warm: the held snapshot BY REFERENCE — immutable after
        demotion (promotion copies OUT of it through restore_replay,
        never into it), so the checkpoint and the live entry can share
        it.  Cold: a marker naming the content-addressed entry — the
        store is append-only (promotion pops the index entry but never
        unlinks the payload), so the key stays loadable for the
        checkpoint's lifetime."""
        e = self._entries[tid]
        if e["cold_key"] is None:
            return e["replay"]
        return {"__tier_cold__": e["cold_key"]}

    def ckpt_det(self, tid: int):
        return self._entries[tid]["det"]

    def load_cold(self, key: str) -> dict:
        """Synchronously load one cold entry into a replay snapshot —
        the supervised-restore path (recovery is already off the hot
        loop; a blocking read here is the point, not a miss)."""
        arrays, meta = self._read_cold(key)
        return self._snap_from_payload(arrays, meta)

    def discard(self, tid: int) -> None:
        """Drop one entry WITHOUT promotion accounting — the supervised
        restore path, where the checkpoint view supersedes the tier
        entry (the restore rebuilds the tenant RESIDENT and re-executes
        the retained log against that state; a surviving stale entry
        would shadow it at the next gate).  Unknown tid is a no-op."""
        e = self._entries.pop(tid, None)
        if e is not None and e["cold_key"] is None:
            self.warm_state_bytes -= self.slot_nbytes
        self._fetching.pop(tid, None)

    # -- read-side shims --------------------------------------------------

    def state_shim(self, tid: int) -> _TierStateShim:
        """The ``state_digest`` stand-in for a demoted tenant (see
        :class:`_TierStateShim`).  Cold states load from disk ONLY when
        the digest actually reads them (digest-cadence ticks), without
        promoting the entry."""
        e = self._entries[tid]
        if e["cold_key"] is None:
            snap = e["replay"]
            return _TierStateShim(lambda: snap["state"],
                                  snap["window_offset"],
                                  snap["n_spans"])
        meta = e["replay"]
        key = e["cold_key"]

        def _load():
            arrays, m = self._read_cold(key)
            return self._snap_from_payload(arrays, m)["state"]

        return _TierStateShim(_load, meta["window_offset"],
                              meta["n_spans"])

    def drain_events(self) -> List[dict]:
        out, self.events = self.events, []
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._fetching.clear()
