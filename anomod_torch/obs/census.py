"""The fleet census observatory: deterministic resident-bytes accounting,
the hot-set census and the registered-fleet sweep (counterpart of
``anomod/obs/census.py``).

The census says what the serve plane holds, per plane and per byte, and
which of its costs scale with the registered fleet rather than the active
one.  Every instrument is a read-side consumer: census on or off leaves
every serve decision and the canonical flight journal byte-identical.

- **Resident bytes** (:func:`collect_resident_bytes`): per (shard, plane)
  byte counts from tensor and array shapes and container lengths, never
  an RSS reading and never a tensor's data, so a census causes no device
  synchronization and no device-to-host copy, and one seed gives the same
  bytes on every rerun and on any device.  The planes: each runner's
  state pool (or the host-seam states, the same per-slot shape), each
  runner's pinned lane scratch, the admission plane (queued span arrays
  exact, the registered fleet's spec table exact, per-active bookkeeping
  at the nominal entry sizes below), the SLO digests, the online-RCA
  evidence buffers, the tier plane, and the flight and perf recorders'
  retentions.  The pool total must equal ``(capacity + 1) x`` the
  per-slot bytes (row 0 is the dead slot): ``pool_reconciled`` says
  whether it does.  Records drain at the tick barrier onto the flight
  journal's ``census`` variant key, which carries no wall clock.
- **The hot-set census** (:class:`CensusTracker`): each tenant's
  last-served tick, cumulative served spans and a lazily decayed
  served-span EWMA, fed only by admission's served decisions, so the
  hot-set document (tenants served within each ``ANOMOD_CENSUS_DECAY_
  TICKS`` threshold, a Zipf fit of the served counts, occupancy, the
  coldest ``ANOMOD_CENSUS_COLDEST_K`` residents) is equal across shard
  counts, residencies and elastic episodes.  Its
  :meth:`~CensusTracker.coldest_candidates` is the one eviction order:
  state tiering (:mod:`anomod_torch.serve.tiering`) demotes by it.
- **The registered-fleet sweep** (:func:`fleet_probe`): engines with a
  growing registered fleet and a fixed hot traffic set, fitting the tick
  wall and the resident bytes against the registered count
  (:func:`fit_slope`); :func:`diff_census` (``census diff``) compares two
  captures' census blocks, bytes exactly, the wall slope within the
  noise tolerance.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: census-timeline document format (the ``census record`` dump)
CENSUS_FORMAT = 1

#: the census plane names, in the (shard, plane) drain order's plane
#: axis — one row per (shard, plane) per census tick
CENSUS_PLANES = ("admission", "flight", "perf", "pool", "rca",
                 "scratch", "slo", "tier")

#: per-tick decay of the served-span EWMA (applied lazily per idle
#: tick, so updates stay O(served) and reads O(reported))
CENSUS_EWMA_DECAY = 0.9

# ---------------------------------------------------------------------------
# nominal bookkeeping entry sizes (documented LOGICAL bytes)
#
# Array planes are priced exactly (shape × itemsize).  Python-object
# bookkeeping (dict entries, heap tuples, dataclass rows) is priced at
# the nominal per-entry sizes below — deterministic functions of
# container LENGTH, which is what the census is for: it prices GROWTH
# (does this structure scale with registered or with active tenants?),
# not CPython malloc details.  One RSS sample
# (:func:`process_resident_bytes`) is the order-of-magnitude cross-check;
# these constants are the comparable, replayable surface.  They are the
# JAX package's, so the two censuses compare plane by plane.
# ---------------------------------------------------------------------------

#: one queued micro-batch's bookkeeping beyond its span arrays: the
#: QueuedBatch row (7 fields), its _alive dict entry and its two heap
#: tuples (drain + evict)
QUEUE_ENTRY_BYTES = 224

#: per ACTIVE (ever-offered) tenant in the admission plane: the
#: TenantCounters row (8 ints) and the backlog / last-finish
#: bookkeeping dict entries, all created on a tenant's first offer, so
#: this prices the active set.  The per-REGISTERED remainder is the
#: columnar spec table, priced exactly from its array bytes
#: (:meth:`anomod_torch.serve.queues.AdmissionController.
#: spec_table_nbytes`).
ADMISSION_TENANT_BYTES = 256

#: one lazily-deleted heap tuple (3 slots + tuple header)
HEAP_ENTRY_BYTES = 48

#: per-tenant SLO bookkeeping beyond the digest arrays and the sample
#: buffer: the _TenantSLO row + its dict entry
SLO_TENANT_BYTES = 128

#: per-tenant RCA evidence bookkeeping beyond the buffered span
#: arrays: the buffer list + high-water dict entries
RCA_TENANT_BYTES = 112

#: one flight tick record's nominal retained size (the ring holds dict
#: records whose serialized size varies with topology and wall floats;
#: the census prices the RING LENGTH at this schema-derived nominal so
#: the byte stream stays deterministic)
FLIGHT_RECORD_BYTES = 2048

#: one retained perf-timeline event: its EVENT_FIELDS slots of 8 bytes
#: plus dict overhead (anomod_torch.obs.perf.EVENT_FIELDS)
PERF_EVENT_BYTES = 256

#: one warm-tier entry's bookkeeping beyond its exact state arrays:
#: the dict entry, the record row and the detector-snapshot scaffolding
#: (anomod_torch.serve.tiering — alert rows inside the snapshot are
#: already O(alerts), not per-tenant, and stay unpriced like the
#: detector's own)
TIER_WARM_ENTRY_BYTES = 192

#: one cold-tier index entry: the content-address key string (64 hex
#: chars) + its dict entry + the retained scalar meta
TIER_COLD_INDEX_BYTES = 160


def plane_nbytes(arr) -> int:
    """Exact byte size of one tensor or array from its shape and element
    size (``numel() * element_size()`` for a torch tensor); never reads
    the data, so a tensor on the card costs no synchronization."""
    item = (arr.element_size() if hasattr(arr, "element_size")
            else np.dtype(arr.dtype).itemsize)
    return math.prod(arr.shape) * int(item)


#: exact bytes per span row across the 9 SpanBatch columns
#: (anomod_torch.schemas: trace/parent/service/endpoint int32,
#: start/duration int64, is_error bool, status int16, kind int8), derived
#: from the schema dtypes once so the per-queued-batch census walk is
#: O(1) a batch
SPAN_ROW_BYTES = (4 * np.dtype(np.int32).itemsize
                  + 2 * np.dtype(np.int64).itemsize
                  + np.dtype(np.bool_).itemsize
                  + np.dtype(np.int16).itemsize
                  + np.dtype(np.int8).itemsize)


def span_batch_nbytes(batch) -> int:
    """Exact byte size of a SpanBatch's column arrays (the string
    tables are shared interned tuples and deliberately excluded):
    ``n_spans × SPAN_ROW_BYTES`` — the schema is fixed-width, so the
    per-row constant IS the per-array sum (pinned)."""
    return batch.n_spans * SPAN_ROW_BYTES


def pool_slot_nbytes(cfg) -> int:
    """Per-slot bytes of one tenant's replay state: the [SW, F] f32
    agg row plus the [SW, H] f32 hist row — the SAME shape whether the
    state lives in a device pool slot or a host-seam pytree."""
    from anomod_torch.replay import N_FEATS
    return cfg.sw * (N_FEATS + cfg.n_hist_buckets) * 4


def tdigest_nbytes(digest) -> int:
    if digest is None:
        return 0
    return plane_nbytes(digest.mean) + plane_nbytes(digest.weight)


def process_resident_bytes() -> Optional[int]:
    """One informational RSS sample of this process (``statm``): the
    order-of-magnitude cross-check beside the deterministic census
    total.  Never a pin, never compared (it moves with allocator
    behavior, the CUDA runtime's buffers and import history); None where
    it cannot be read."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# resident-bytes accounting (the per-tick census drain)
# ---------------------------------------------------------------------------

def collect_resident_bytes(engine) -> Tuple[List[dict], Dict[str, int],
                                            int, bool]:
    """One deterministic resident-bytes census of a live
    :class:`~anomod_torch.serve.engine.ServeEngine` (thread workers or
    the inline engine: the process workers' planes live in their
    children, and the engine refuses the census beside them).

    Returns ``(planes, by_plane, total_bytes, pool_reconciled)`` where
    ``planes`` is the per-(shard, plane) record list in (shard, plane)
    order (coordinator-owned planes use shard ``-1``), ``by_plane``
    sums bytes per plane name, and ``pool_reconciled`` is the pin that
    every state pool's array bytes equal ``(capacity + 1) × per-slot
    nbytes`` exactly.  A pure read: no clocks, no RNG, no mutation —
    the same engine state always censuses to the same bytes."""
    planes: List[dict] = []
    reconciled = True
    cfg = engine.cfg
    slot_b = pool_slot_nbytes(cfg)

    # tenant states: device pools per shard runner, or the host seam's
    # per-tenant pytrees (same per-slot shape — counted per owned
    # resident replay, NEVER read through .state: a pooled gather
    # would copy megabytes for a byte count the shapes already give)
    owned: Dict[int, int] = {}
    for tid in engine._tenant_replay:
        s = engine.shard_of.get(tid, 0)
        owned[s] = owned.get(s, 0) + 1
    for s, runner in enumerate(engine._runners):
        pool = runner.pool
        if pool is not None:
            arr_b = plane_nbytes(pool.agg) + plane_nbytes(pool.hist)
            expect = (pool.capacity + 1) * slot_b
            ok = arr_b == expect
            reconciled = reconciled and ok
            planes.append({"shard": s, "plane": "pool",
                           "mode": "device", "bytes": arr_b,
                           "slots_used": int(pool.live_slots),
                           "capacity": int(pool.capacity),
                           "slot_bytes": slot_b, "reconciled": ok})
        else:
            n = owned.get(s, 0)
            planes.append({"shard": s, "plane": "pool", "mode": "host",
                           "bytes": n * slot_b, "slots_used": n,
                           "capacity": n, "slot_bytes": slot_b,
                           "reconciled": True})
        # the runner's pinned scratch: a (sid [L, W] int32, planes
        # [L, 6, W] f32) pair a slot, 28 B a lane row as the JAX
        # runner's seven 4-byte staged columns
        scratch_b = 0
        n_bufs = 0
        for slot in runner._scratch.values():
            for buf in slot:
                scratch_b += plane_nbytes(buf)
                n_bufs += 1
        planes.append({"shard": s, "plane": "scratch",
                       "bytes": scratch_b, "buffers": n_bufs})

    # admission (coordinator): queued span arrays exact + the columnar
    # spec table's array bytes exact (the per-REGISTERED remainder) +
    # per-ACTIVE bookkeeping at nominal entry sizes
    adm = engine.admission
    alive = list(adm._alive.values())
    queued_b = sum(span_batch_nbytes(qb.spans) for qb in alive) \
        + len(alive) * QUEUE_ENTRY_BYTES
    heap_b = (len(adm._drain_heap) + len(adm._evict_heap)) \
        * HEAP_ENTRY_BYTES
    reg_b = adm.spec_table_nbytes()
    active_b = len(adm.counters) * ADMISSION_TENANT_BYTES
    planes.append({"shard": -1, "plane": "admission",
                   "bytes": queued_b + heap_b + reg_b + active_b,
                   "queued_batches": len(alive),
                   "queued_spans": int(adm.backlog_spans),
                   "queued_bytes": queued_b,
                   "registered": len(adm.specs),
                   "registered_bytes": reg_b,
                   "active": len(adm.counters),
                   "active_bytes": active_b})

    # SLO digests (coordinator): one _TenantSLO per tenant that has
    # recorded a latency (an O(active) plane)
    slo_b = 0
    n_digests = 0
    for slo in engine._slo.values():
        d = tdigest_nbytes(slo.digest)
        if d:
            n_digests += 1
        slo_b += d + len(slo._buf) * 8 + SLO_TENANT_BYTES
    planes.append({"shard": -1, "plane": "slo", "bytes": slo_b,
                   "tenants": len(engine._slo), "digests": n_digests})

    # tenant-state tier (coordinator): warm entries' state arrays exact
    # (the snapshot copies ARE the resident bytes) + nominal per-entry
    # bookkeeping; cold entries live on disk and are priced as index
    # entries only — that residency drop is the tier's whole point
    tier = getattr(engine, "_tier", None)
    if tier is not None:
        planes.append({"shard": -1, "plane": "tier",
                       "bytes": tier.resident_nbytes(),
                       "warm": tier.n_warm, "cold": tier.n_cold,
                       "warm_state_bytes": tier.warm_state_bytes})

    # RCA evidence buffers: per shard plane, buffered span arrays exact
    for s, plane in enumerate(engine._rca_planes):
        rca_b = 0
        n_batches = 0
        for buf in plane._buf.values():
            for b in buf:
                rca_b += span_batch_nbytes(b)
                n_batches += 1
        rca_b += len(plane._buf) * RCA_TENANT_BYTES
        planes.append({"shard": s, "plane": "rca", "bytes": rca_b,
                       "tenants": len(plane._buf),
                       "batches": n_batches})

    # recorder retentions (coordinator): container length × nominal
    # record size (deterministic — the serialized records themselves
    # carry wall floats whose width varies run to run)
    fr = engine.flight_recorder
    n_rec = len(fr.records()) if fr is not None else 0
    planes.append({"shard": -1, "plane": "flight",
                   "bytes": n_rec * FLIGHT_RECORD_BYTES,
                   "records": n_rec})
    n_ev = len(engine.perf_events)
    planes.append({"shard": -1, "plane": "perf",
                   "bytes": n_ev * PERF_EVENT_BYTES, "events": n_ev})

    planes.sort(key=lambda r: (r["shard"], r["plane"]))
    by_plane: Dict[str, int] = {}
    for r in planes:
        by_plane[r["plane"]] = by_plane.get(r["plane"], 0) + r["bytes"]
    total = sum(by_plane.values())
    return planes, by_plane, total, reconciled


# ---------------------------------------------------------------------------
# hot-set census
# ---------------------------------------------------------------------------

class CensusTracker:
    """Coordinator-side hot-set bookkeeping: per-tenant last-served
    tick, cumulative served spans and a lazily-decayed served-span
    EWMA.  ``observe`` is O(served batches) per tick; the census doc
    (:meth:`hot_doc`) walks only ever-served tenants.  Fed ONLY by
    admission's served decisions, so every number here is canonical:
    identical across shard counts, residencies and elastic episodes.
    Under state tiering it runs with the census off too: its ordering
    is the demotion policy's input."""

    def __init__(self, decay_ticks: Sequence[int] = (4, 16, 64, 256),
                 coldest_k: int = 8, every: int = 8):
        self.decay_ticks = tuple(int(t) for t in decay_ticks)
        self.coldest_k = int(coldest_k)
        self.every = int(every)
        self.last_served: Dict[int, int] = {}
        self.served_total: Dict[int, int] = {}
        self._ewma: Dict[int, float] = {}

    def observe(self, tick: int, served) -> None:
        """Fold one tick's served batches (the tick-barrier hook)."""
        per_tenant: Dict[int, int] = {}
        for qb in served:
            per_tenant[qb.tenant_id] = \
                per_tenant.get(qb.tenant_id, 0) + qb.n_spans
        for tid, n in per_tenant.items():
            self._ewma[tid] = self.ewma_at(tid, tick) + float(n)
            self.last_served[tid] = tick
            self.served_total[tid] = self.served_total.get(tid, 0) + n

    def ewma_at(self, tid: int, tick: int) -> float:
        """The tenant's served-span EWMA decayed to ``tick`` (lazy:
        the stored value is anchored at the tenant's last-served
        tick)."""
        got = self._ewma.get(tid)
        if got is None:
            return 0.0
        gap = max(tick - self.last_served.get(tid, tick), 0)
        return got * CENSUS_EWMA_DECAY ** gap

    def due(self, tick: int) -> bool:
        """Whether ``tick`` (0-based) is a census tick — the flight
        digest-cadence contract."""
        return (tick + 1) % self.every == 0

    def coldest_candidates(self, tick: int,
                           resident: Sequence[int]) -> List[int]:
        """Ever-served RESIDENT tenants, coldest first: oldest
        last-served tick, then the weaker EWMA, then the tenant id.
        THE one eviction ordering — the ``hot_doc`` coldest-K preview
        and the tiering demotion policy (anomod_torch.serve.tiering) both
        read it here, so the preview can never disagree with what the
        policy actually evicts."""
        return sorted(
            (tid for tid in resident if tid in self.last_served),
            key=lambda tid: (self.last_served[tid],
                             self.ewma_at(tid, tick), tid))

    def hot_doc(self, tick: int, registered: int,
                resident: Sequence[int]) -> dict:
        """The hot-set census document (all-canonical content)."""
        hot_by_decay = {
            str(th): sum(1 for t in self.last_served.values()
                         if tick - t <= th)
            for th in self.decay_ticks}
        counts = sorted((c for c in self.served_total.values() if c > 0),
                        reverse=True)
        # coldest-K among RESIDENT tenants: the eviction-candidate
        # preview, in the demotion policy's own ordering
        cands = self.coldest_candidates(tick, resident)
        coldest = [{"tenant": int(t),
                    "last_served_tick": int(self.last_served[t]),
                    "idle_ticks": int(tick - self.last_served[t]),
                    "rate_ewma": round(self.ewma_at(t, tick), 6)}
                   for t in cands[:self.coldest_k]]
        n_res = len(list(resident))
        return {"registered": int(registered),
                "ever_served": len(self.last_served),
                "resident": n_res,
                "occupancy_vs_registered":
                    round(n_res / registered, 6) if registered else 0.0,
                "hot_by_decay": hot_by_decay,
                "zipf_alpha": fit_zipf(counts),
                "coldest": coldest}


def fit_zipf(counts: Sequence[int]) -> Optional[float]:
    """Zipf rank-frequency skew: least-squares slope of log(count) vs
    log(rank) over the descending positive counts; returns the alpha
    estimate (``count ∝ rank^-alpha``), or None below 3 points."""
    counts = [c for c in counts if c > 0]
    if len(counts) < 3:
        return None
    r = np.log(np.arange(1, len(counts) + 1, dtype=np.float64))
    c = np.log(np.asarray(sorted(counts, reverse=True), np.float64))
    slope = np.polyfit(r, c, 1)[0]
    return round(float(-slope), 6)


def fit_slope(xs: Sequence[float],
              ys: Sequence[float]) -> Tuple[float, float]:
    """Least-squares ``(slope, intercept)`` of ys over xs (float64)."""
    a, b = np.polyfit(np.asarray(xs, np.float64),
                      np.asarray(ys, np.float64), 1)
    return float(a), float(b)


# ---------------------------------------------------------------------------
# cost attribution: the registered-fleet sweep
# ---------------------------------------------------------------------------

def fleet_probe(sizes: Optional[Sequence[int]] = None, hot: int = 1000,
                ticks: int = 8, tick_s: float = 1.0,
                capacity_spans_per_s: float = 2000.0, seed: int = 0,
                n_services: int = 4, warmup_ticks: int = 2,
                tier_hot: Optional[int] = None,
                tier_demote_after: Optional[int] = None,
                device=None) -> dict:
    """The registered-fleet sweep: engines with ``registered`` tenants
    (``sizes``; default ``ANOMOD_CENSUS_SWEEP``) but a FIXED ``hot``-
    tenant traffic set, measuring per-tick wall and census resident
    bytes at each size and fitting both slopes vs the registered count.

    Host-seam state and ``score=False`` keep the probe about the
    bookkeeping planes (the spec table, which is the one per-registered
    cost the admission plane keeps; detector scoring is O(served));
    wall medians drop ``warmup_ticks`` leading ticks.  The lane kernel
    runs on ``device`` (the card unless ``"cpu"``); the bytes do not
    depend on it.  ``tier_hot`` / ``tier_demote_after`` run the sweep
    with state tiering on, so the pool plane stays hot-bounded too.
    """
    from anomod_torch.config import get_config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    from anomod_torch.serve.queues import TenantSpec
    from anomod_torch.serve.traffic import PowerLawTraffic
    sizes = [int(s) for s in
             (sizes if sizes is not None else get_config().census_sweep)]
    if int(ticks) < 1:
        raise ValueError("fleet_probe needs ticks >= 1 (zero measured "
                         "ticks would fit a slope over NaN walls)")
    rows: List[dict] = []
    for registered in sizes:
        hot_n = min(int(hot), registered)
        traffic = PowerLawTraffic(
            n_tenants=hot_n,
            total_rate_spans_per_s=float(capacity_spans_per_s),
            alpha=1.2, seed=seed, n_services=n_services)
        specs = list(traffic.specs) + [
            TenantSpec(tenant_id=i, name=f"cold{i:07d}", priority=2)
            for i in range(hot_n, registered)]
        cfg = ReplayConfig(n_services=n_services, n_windows=16,
                           window_us=int(5e6), chunk_size=4096)
        tier_kw = {} if tier_hot is None else dict(
            tier_hot=int(tier_hot),
            tier_demote_after=int(tier_demote_after)
            if tier_demote_after is not None else None)
        eng = ServeEngine(
            specs, traffic.services, cfg,
            capacity_spans_per_s=float(capacity_spans_per_s),
            tick_s=tick_s, buckets=(64, 256), lane_buckets=(1, 2, 4),
            max_backlog=int(8 * capacity_spans_per_s), score=False,
            rca=False, state="host", shards=1, census=True,
            census_every=max(int(ticks), 1), device=device, **tier_kw)
        try:
            eng.runner.warm()               # first launches outside the walls
            if eng.fuse:
                eng.runner.warm_lanes()
            for _ in range(int(ticks)):
                lo = eng.clock.now_s
                eng.tick(traffic.arrivals(lo, lo + tick_s))
        finally:
            eng.close()
        walls = eng.tick_walls[min(warmup_ticks, len(eng.tick_walls) - 1):]
        resident = eng.census_resident
        rows.append({
            "registered": registered, "hot": hot_n, "ticks": int(ticks),
            "median_tick_wall_s": round(float(np.median(walls)), 6),
            "mean_tick_wall_s": round(float(np.mean(walls)), 6),
            "resident_bytes": resident.get("total", 0),
            "bytes_by_plane": dict(resident.get("by_plane", {})),
            "pool_reconciled": resident.get("pool_reconciled")})
    # the wall slope fits over the per-size MEDIANS: one straggler tick
    # (GC, allocator growth) skews a mean
    wall_slope, wall_icpt = fit_slope(
        sizes, [r["median_tick_wall_s"] for r in rows])
    bytes_slope, bytes_icpt = fit_slope(
        sizes, [r["resident_bytes"] for r in rows])
    return {
        "sizes": sizes, "hot": int(hot), "ticks": int(ticks),
        "seed": int(seed), "rows": rows,
        # the O(registered) baseline curve: seconds of tick wall and
        # resident bytes PER REGISTERED TENANT — what tiering flattens
        "wall_slope_s_per_registered": round(wall_slope, 12),
        "wall_intercept_s": round(wall_icpt, 6),
        "bytes_slope_per_registered": round(bytes_slope, 4),
        "bytes_intercept": round(bytes_icpt, 1),
    }


# ---------------------------------------------------------------------------
# ``census diff``: the before/after judge
# ---------------------------------------------------------------------------

def default_slope_tolerance() -> float:
    """Wall-slope comparisons reuse the perf observatory's noise model
    (ANOMOD_PERF_NOISE_FLOOR): one explicit noise hedge, not two."""
    from anomod_torch.config import get_config
    return get_config().perf_noise_floor


def diff_census(a: dict, b: dict,
                tolerance: Optional[float] = None) -> dict:
    """Compare two bench captures' ``census`` blocks.

    BYTE counts are deterministic, so they compare EXACTLY: every
    per-plane delta is real (never noise) and any growth in B is a
    regression.  The bytes SLOPE is a fit over those deterministic
    points, so it compares exactly too.  The WALL slope is wall clock:
    B regresses only when it exceeds A's slope by more than
    ``tolerance`` (default: the ANOMOD_PERF_NOISE_FLOOR noise
    model).  Returns the verdict document ``census diff``
    prints; ``status`` is ``ok`` / ``bytes-regression`` /
    ``slope-regression`` / ``census-missing``."""
    tol = default_slope_tolerance() if tolerance is None \
        else float(tolerance)
    ca = a.get("census") if isinstance(a.get("census"), dict) else None
    cb = b.get("census") if isinstance(b.get("census"), dict) else None
    if ca is None or cb is None:
        return {"check": "anomod_census_diff",
                "status": "census-missing",
                "missing_in": [side for side, c
                               in (("a", ca), ("b", cb)) if c is None]}
    pa = (ca.get("resident_bytes") or {}).get("by_plane", {})
    pb = (cb.get("resident_bytes") or {}).get("by_plane", {})
    plane_rows = []
    bytes_regressions = []
    for plane in sorted(set(pa) | set(pb)):
        va, vb = pa.get(plane), pb.get(plane)
        row = {"plane": plane, "a": va, "b": vb,
               "delta": (vb - va) if va is not None and vb is not None
               else None}
        plane_rows.append(row)
        if va is not None and vb is not None and vb > va:
            bytes_regressions.append(row)
    sa, sb = ca.get("sweep") or {}, cb.get("sweep") or {}
    # the flat-baseline floor: once tiering SUCCEEDS, the baseline
    # wall slope sits at ~0 (the least-squares fit may even dip
    # negative on noisy walls) and a pure ratio test would never flag
    # the O(registered) cost creeping back.  A regression therefore
    # also flags when B's slope alone would add more than ``tol`` ×
    # A's intercept of wall at the sweep's largest size — scale-aware,
    # so slope noise on a genuinely flat curve stays below it.
    max_size = max(sa.get("sizes") or [0])
    icpt_a = abs(sa.get("wall_intercept_s") or 0.0)
    slope_floor = (tol * icpt_a / max_size) if max_size else float("inf")
    slopes = []
    slope_regressions = []
    for key, exact in (("bytes_slope_per_registered", True),
                       ("wall_slope_s_per_registered", False)):
        va, vb = sa.get(key), sb.get(key)
        if va is None or vb is None:
            continue
        ratio = vb / va if va else None
        if exact:
            regressed = vb > va
        else:
            regressed = vb > max(va, 0.0) * (1.0 + tol) + slope_floor
        row = {"slope": key, "a": va, "b": vb,
               "ratio": round(ratio, 4) if ratio is not None else None,
               "exact": exact, "regressed": bool(regressed)}
        slopes.append(row)
        if regressed:
            slope_regressions.append(row)
    comparable = bool(sa.get("sizes")) and sa.get("sizes") == \
        sb.get("sizes") and sa.get("hot") == sb.get("hot")
    notes = []
    if not comparable:
        notes.append("sweep shapes differ (sizes/hot): slope rows are "
                     "informational, not a verdict")
        slope_regressions = []
    status = ("bytes-regression" if bytes_regressions
              else "slope-regression" if slope_regressions else "ok")
    return {
        "check": "anomod_census_diff",
        "tolerance": tol,
        "note": "byte counts are deterministic — every delta is real; "
                "wall slopes regress only past 1 + tolerance "
                "(ANOMOD_PERF_NOISE_FLOOR, docs/BENCHMARKS.md)",
        "planes": plane_rows,
        "bytes_regressions": bytes_regressions,
        "total_a": (ca.get("resident_bytes") or {}).get("total"),
        "total_b": (cb.get("resident_bytes") or {}).get("total"),
        "slopes": slopes,
        "slope_regressions": slope_regressions,
        "sweep_comparable": comparable,
        "notes": notes,
        "status": status,
    }
