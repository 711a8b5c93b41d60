"""The serving engine: virtual-clock tick loop over admission -> dynamic
batching -> the lane kernel -> per-tenant SLO accounting (counterpart of
``anomod/serve/engine.py``).

Deterministic by construction: a virtual clock advances in fixed ticks,
arrivals come from a seeded traffic source, and every admission,
shedding and serving decision is host bookkeeping, so a seeded overload
replay is bit-reproducible.  Wall time is measured (never waited on)
around the serving path only, for the sustained spans/s the report gives.

Each tenant runs the span-only ``OnlineDetector`` over a replay plane of
the shared :class:`~anomod_torch.serve.batcher.BucketRunner`.  With
``fuse`` (the default) one tick's drained batches coalesce per tenant,
stage once, and run as lane-stacked dispatches of the lane kernel,
pipelined ``pipeline`` deep; window scoring then runs for every tenant
at once, fed by one pool gather per closed window.  The host legs run
in C++ by default: the runner fills its scratch through
``anomod_torch.io.native`` (``native_stage``) and admission drains through
the native columnar SFQ book (``drain_engine``); ``native_stage=False`` and
``drain_engine="heap"`` or ``"numpy"`` are their byte-identical oracles.
Tenant states live in the runner's device pool (``state="device"``, the
default) or as host tensors (``state="host"``); both give byte-identical
states and alerts.
Admission-to-scored latency per micro-batch folds into per-tenant
t-digests, so the report's p50/p99 are sketch-backed and mergeable.

Telemetry (``anomod_torch.obs``, on unless ``ANOMOD_OBS_ENABLED=0``):
every tenant digest chunk also merges into the process registry's
``anomod_serve_admit_to_scored_seconds``; the tick records its wall
(``anomod_serve_tick_seconds``), the tick count and the active tenants,
and the registry is scraped once per virtual second on the virtual
clock, inside the measured wall; admission and the runner mirror their
books into the registry.  With the registry on, a
``Tracer("anomod-serve")`` times the tick's legs (``serve.run``,
``serve.modality``, ``serve.admit``, ``serve.drain``, ``serve.score_fused``,
``serve.score_shard``, ``serve.score``, ``serve.rca``).

Online RCA (``rca=True`` or ``ANOMOD_SERVE_RCA``): when a tenant's
detector fires, the alert queues for culprit inference over that
tenant's served spans (``anomod_torch.serve.rca``), at most
``rca_budget`` runs a tick, the rest drained at the run's end; a pure
read-side consumer, so every decision is byte-identical with it on or
off.

Shards (``shards`` or ``ANOMOD_SERVE_SHARDS``, thread workers of
:mod:`anomod_torch.serve.shard`): the score plane fans out by tenant
ownership (``plan_shards``) to N worker threads, each with its own
:class:`~anomod_torch.serve.batcher.BucketRunner` (its pool sized to the
tenants it owns, its own registry and, on the card, its own CUDA
stream) and its own online-RCA plane; admission, drain, shedding and
SLO stay on the coordinator, and the tick joins at a barrier that folds
the shard registries into the process registry (``fold``: ``sparse`` or
``dense``).  Every decision, state and alert equals the 1-shard run's.
``shards=1`` is the inline engine.

The flight recorder (``flight`` or ``ANOMOD_FLIGHT``, default on,
:mod:`anomod_torch.obs.flight`): every tick journals its admission
deltas, staged-chunk counts, cadenced state digest and alert / verdict
digests into a bounded ring, inside the measured wall; the canonical
journal of a seed is byte-identical across reruns, shard counts,
pipeline depths, state residencies and devices, and equals the JAX
engine's.

Process workers (``worker="process"`` or ``ANOMOD_SERVE_WORKER``,
:mod:`anomod_torch.serve.procshard`): each shard's whole score plane
(detectors, replay states, its runner, pool and registry) lives in a
spawned worker process, driven by a picklable command a tick; the
coordinator keeps admission, SLO, online RCA (one plane) and the
flight recorder, and mirrors of each child's runner book and alert
lists.  Every decision and the canonical journal equal the thread
engine's.

Chaos and supervision (``chaos`` / ``ANOMOD_SERVE_CHAOS``,
:mod:`anomod_torch.serve.chaos`; ``ckpt_every`` /
``ANOMOD_SERVE_CKPT_EVERY``, default 32, :mod:`anomod_torch.serve.
supervise`): scripted faults fire at the score path's phase boundaries,
keyed on the slice's origin tick; the supervisor checkpoints every
tenant and runner book at the cadence, keeps the served batches since,
and on a shard failure restores the shard and re-executes them, so a
recovered run's decisions and journal equal a fault-free run's.
``ckpt_every=0`` turns supervision off: a shard fault then fails the
tick.

The elastic policy (``policy`` or ``ANOMOD_SERVE_POLICY``, ``off`` by
default, :mod:`anomod_torch.serve.policy`): at every tick end an
``ElasticPolicy`` folds the tick's canonical signals (served spans, the
runners' staged-chunk books, backlog, shed) and its scale-up,
scale-down, rebalance and brownout decisions run through the
live-migration seams (a tenant's state copied out of its old pool on
the old runner's stream and put into the new pool on the new runner's
stream); a new shard is a new runner with its own stream, pool,
registry, RCA plane and worker (a spawned child with process workers).
The scaling schedule is a function of the seed, and an elastic run's
decisions and canonical journal equal a static run's.

The deferred-commit tick (``async_commit`` or
``ANOMOD_SERVE_ASYNC_COMMIT``, off by default): tick t's lane dispatches
are issued on the shard streams and left in flight; tick t+1's
admission, drain, shed and SLO (host state) run meanwhile, and tick t
commits (drain, fold, scoring, then its RCA, journal record and policy
step) at a barrier before tick t+1 issues.  Checkpoint ticks commit at
once.  Decisions and the canonical journal equal the synchronous
engine's.

State tiering (``tier_hot`` or ``ANOMOD_SERVE_TIER_HOT``, 0 = off,
:mod:`anomod_torch.serve.tiering`): past ``tier_hot`` pool-resident
tenants, the coldest idle ones demote at tick end to a host warm tier
and, past its byte budget, to a content-addressed disk cold tier; a
demoted tenant's next batch promotes it (a cold one one tick later, its
batches parked).  States, alerts, SLO and shed equal a never-evicted
run's.  Tiering refuses the deferred commit; process workers refuse
both.

The multimodal sidecar (``multimodal`` with ``testbed``): each tenant's
detector is a ``MultimodalDetector`` on its pooled replay, and
:meth:`offer_modality` pushes log / metric / API batches (a traffic
source's ``modality_arrivals``) into its host planes before the tick's
span admission, counted in ``modality_events``.  The policy, tiering,
supervision and process workers turn themselves off beside it.

The mesh plane (``mesh``, an ``anomod_torch.parallel.Mesh``, every rank
of the group running the same engine): each tenant's replay is a
:class:`~anomod_torch.parallel.stream.ShardedStreamReplay`, its chunks
folded across the ranks and merged by an ``all_reduce``, so every rank
holds every state and takes every decision.  Fusion is off beside it, and
it refuses what touches the runners' seams as the JAX engine does: more
than one shard, the deferred commit, the policy, the device state pool,
tiering, process workers and supervision (an explicit request raises, an
env-sourced one is off; ``shards`` and ``state="device"`` always raise).

The observatories, both read-side (every decision and the canonical
journal are byte-identical with them on or off) and both refused by
process workers:

- the perf observatory (``perf`` or ``ANOMOD_PERF``, off by default,
  :mod:`anomod_torch.obs.perf`): one ``PerfRecorder`` a shard runner
  stamps every fused dispatch's lifecycle from the wall legs' own clock
  reads; the tick barrier drains the recorders in shard order, inside
  the measured wall, runs the overlap analyzer and puts the events on
  the journal's ``perf`` variant key (``fold_wait_s``,
  ``overlap_headroom_s`` and ``bubble_fractions`` in the report);
- the census (``census`` or ``ANOMOD_CENSUS``, off by default, every
  ``census_every`` ticks and at the run's end,
  :mod:`anomod_torch.obs.census`): a resident-bytes census of every plane
  from shapes and container lengths, and the hot-set document, onto the
  journal's ``census`` variant key (wall-free: byte-equal across reruns)
  and eleven ``anomod_census_*`` gauges.

The serve plane's shape knobs (buckets, lane buckets, fuse, pipeline,
state, backlog bound, the native fill and drain) default from
:class:`anomod_torch.config.Config` when left None.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch import obs
from anomod_torch.config import get_config
from anomod_torch.device import DeviceLike, device_name, resolve_device
from anomod_torch.ops.tdigest import (TDigest, tdigest_build,
                                      tdigest_merge_many, tdigest_quantile)
from anomod_torch.replay import N_FEATS, ReplayConfig
from anomod_torch.schemas import concat_span_batches
from anomod_torch.serve.batcher import (BucketedStreamReplay, BucketRunner,
                                        PooledStreamReplay)
from anomod_torch.serve.queues import (AdmissionController, QueuedBatch,
                                       TenantSpec)
from anomod_torch.serve.traffic import PowerLawTraffic, TenantFault
from anomod_torch.stream import OnlineDetector, score_closed_windows_batched

#: t-digest centroid capacity for the latency sketches
_DIGEST_K = 32
#: latency samples buffered per tenant before folding into the digest
_FOLD_EVERY = 256


class VirtualClock:
    """Tick-based deterministic time (no wall sleeps)."""

    def __init__(self, tick_s: float = 1.0, t0_s: float = 0.0):
        if tick_s <= 0:
            raise ValueError("tick_s must be positive")
        self.tick_s = float(tick_s)
        self.now_s = float(t0_s)
        self.ticks = 0

    def advance(self) -> float:
        self.now_s += self.tick_s
        self.ticks += 1
        return self.now_s


class _TenantSLO:
    """Per-tenant latency sketch.  Every fold also merges the new digest
    chunk into the process registry's ``hist_name`` histogram, so the
    registry's fleet-wide sketch is the fold of these private digests."""

    def __init__(self,
                 hist_name: str = "anomod_serve_admit_to_scored_seconds"):
        self.digest: Optional[TDigest] = None
        self._buf: List[float] = []
        self.n_samples = 0
        self.max_latency_s = 0.0
        self._obs_hist = obs.histogram(hist_name)

    def record(self, latency_s: float) -> None:
        self._buf.append(float(latency_s))
        self.n_samples += 1
        self.max_latency_s = max(self.max_latency_s, float(latency_s))
        if len(self._buf) >= _FOLD_EVERY:
            self.fold()

    def fold(self) -> None:
        if not self._buf:
            return
        d = tdigest_build(np.asarray(self._buf, np.float32), k=_DIGEST_K)
        self._obs_hist.merge_digest(d)
        self.digest = d if self.digest is None else \
            tdigest_merge_many([self.digest, d])
        self._buf = []

    def quantile(self, q: float) -> Optional[float]:
        self.fold()
        if self.digest is None or float(self.digest.weight.sum()) <= 0:
            return None
        return float(tdigest_quantile(self.digest, q))


class _LazySLO(dict):
    """Per-tenant SLO sketches created on a tenant's first sample."""

    def __missing__(self, tid: int) -> _TenantSLO:
        s = self[tid] = _TenantSLO()
        return s


def _merged_quantiles(slos: Sequence[_TenantSLO],
                      qs=(0.5, 0.99)) -> Dict[str, Optional[float]]:
    digests = []
    for s in slos:
        s.fold()
        if s.digest is not None and float(s.digest.weight.sum()) > 0:
            digests.append(s.digest)
    if not digests:
        return {f"p{int(q * 100)}_latency_s": None for q in qs}
    merged = digests[0] if len(digests) == 1 else \
        tdigest_merge_many(digests)
    return {f"p{int(q * 100)}_latency_s":
            round(float(tdigest_quantile(merged, q)), 6) for q in qs}


def _runner_stats(r) -> dict:
    """One runner's cumulative book and walls: the one shape the report
    sums and an elastic scale-down keeps of the runner it retires."""
    return {"book": r.book_snapshot(),
            "compile_s": r.compile_s,
            "lane_compile_s": r.lane_compile_s,
            "stage_wall_s": r.stage_wall_s,
            "dispatch_wall_s": r.dispatch_wall_s,
            "fold_wall_s": r.fold_wall_s,
            "score_wall_s": r.score_wall_s}


def _plane_col_gather(work):
    """The ``gather_cols`` backend of one batched scoring pass
    (:func:`~anomod_torch.stream.score_closed_windows_batched`): ONE pool
    gather per scored window when every plane lives in the same runner's
    pool, so only the scored ``[T, S, F]`` columns leave the device; host
    planes are read per tenant, cached across the pass's windows."""
    planes: Dict[int, np.ndarray] = {}

    def gather(items):
        reps = [work[i][0].replay for i, _ in items]
        # anomod-lint: disable=S301 — the one blessed fused-gather exception: slots are only COLLECTED here and handed to pool.gather_window, which owns the always-copy contract
        if reps and all(type(r) is PooledStreamReplay for r in reps) \
                and all(r._runner is reps[0]._runner for r in reps):
            return reps[0]._runner.pool.gather_window(
                [r._slot for r in reps], [c for _, c in items])
        out = np.empty((len(items), reps[0].cfg.n_services, N_FEATS),
                       np.float32)
        for j, (i, c) in enumerate(items):
            pl = planes.get(i)
            if pl is None:
                pl = planes[i] = np.asarray(
                    work[i][0].replay.agg_plane(), np.float32)
            out[j] = pl[:, c]
        return out

    return gather


def onset_eligible(window: int, onset_window: int) -> bool:
    """An alert at absolute window ``w`` can belong to a fault whose onset
    falls in ``onset_window`` iff ``w >= onset_window``."""
    return window >= onset_window


def onset_eligible_alerts(alerts, onset_window: int) -> list:
    return [a for a in alerts if onset_eligible(a.window, onset_window)]


@dataclasses.dataclass
class ServeReport:
    """The serving run's quality/throughput document (JSON-able); the
    fields of the ported planes carry the JAX report's names."""
    n_tenants: int
    duration_s: float
    ticks: int
    capacity_spans_per_s: float
    offered_spans: int
    admitted_spans: int
    served_spans: int
    shed_spans: int
    shed_fraction: float
    served_batches: int
    peak_backlog_spans: int
    max_backlog: int
    buckets: Tuple[int, ...]
    dispatches_by_width: Dict[int, int]
    fused: bool                                  # lane-stacked dispatch on?
    fused_dispatches: int                        # fused dispatches launched
    lane_buckets: Tuple[int, ...]
    lanes_by_bucket: Dict[int, int]              # fused dispatches per bucket
    lane_pad_waste: float                        # dead-lane fraction
    compile_s: float                             # first-launch walls
    lane_compile_s: float
    native_staging: bool                         # C++ scratch fill?
    native_staged_dispatches: int                # fused dispatches so packed
    serve_state: str                             # tenant states: host|device
    stage_wall_s: float                          # host packing wall
    dispatch_wall_s: float                       # copy + launch enqueue wall
    fold_wall_s: float                           # retire barrier + fold wall
    score_wall_s: float                          # window-scoring wall
    pipeline: int                                # in-flight dispatch depth
    shards: int                                  # engine-worker shard count
    shard_tenants: Dict[int, int]                # tenants owned per shard
    shard_spans: Dict[int, int]                  # spans scored per shard
    shard_imbalance: float                       # max shard load / mean
    latency: Dict[str, Optional[float]]          # aggregate p50/p99
    per_priority: Dict[int, dict]
    modality_events: Dict[str, int]              # multimodal sidecar volume
    n_alerts: int
    n_tenants_alerted: int
    fault_detection: Optional[dict]
    rca_enabled: bool                            # online RCA plane on?
    n_rca_runs: int                              # alert->culprit inferences
    rca_topk_hits: Dict[int, int]                # k -> fault tenants hit@k
    rca_eligible: int                            # fault tenants w/ verdict
    rca_latency: Dict[str, Optional[float]]      # wall p50/p99 per RCA run
    rca_alert_to_culprit_s: Dict[str, Optional[float]]  # virtual queue delay
    rca_wall_s: float                            # total RCA wall
    supervised: bool                             # checkpoint/recovery on?
    ckpt_every: int                              # snapshot cadence (ticks)
    n_checkpoints: int                           # snapshots taken
    ckpt_wall_s: float                           # snapshot wall
    n_shard_crashes: int                         # tick-barrier failures
    n_respawns: int                              # workers respawned
    n_restored_ticks: int                        # slices re-executed
    n_quarantined: int                           # batches dropped after K
    #                                              consecutive failures
    n_migrated_tenants: int                      # moved off dead shards
    recovery_wall_s: float                       # restore + re-exec wall
    policy: str                                  # elastic mode: off|auto|
    #                                              script
    n_scale_ups: int                             # executed up episodes
    n_scale_downs: int                           # executed down episodes
    n_rebalances: int                            # executed rebalances
    n_policy_migrations: int                     # tenants moved by policy
    brownout_ticks: int                          # ticks at ladder level>=1
    peak_shards: int                             # most workers the run held
    policy_wall_s: float                         # policy step + migration
    #                                              wall
    flight_enabled: bool                         # flight recorder on?
    flight_recorded_ticks: int                   # journal records written
    flight_dropped_ticks: int                    # ring evictions
    perf_enabled: bool                           # dispatch timeline on?
    perf_events_recorded: int                    # lifecycle events taken
    overlap_headroom_s: float                    # retire wait the next
    #                                              dispatches' staging
    #                                              could hide (upper bound)
    fold_wait_s: float                           # measured retire wait
    bubble_fractions: Dict[str, float]           # per-leg dead-time shares
    census_enabled: bool                         # fleet census on?
    census_ticks: int                            # census drains taken
    census_hot_set: Dict[str, object]            # hot-set document
    #                                              (canonical)
    census_resident_bytes: Dict[str, object]     # resident bytes (follow
    #                                              the pool and scratch
    #                                              topology)
    census_wall_s: float                         # census drain wall
    tier_hot: int                                # hot-pool tenant capacity
    #                                              (0 = tiering off)
    n_tier_demotions_warm: int                   # pool -> host demotions
    n_tier_demotions_cold: int                   # warm -> disk spills
    n_tier_promotions: int                       # tier -> pool re-admissions
    n_tier_misses: int                           # one-tick cold deferrals
    tier_prefetch_hidden: int                    # cold joins already read
    tier_wall_s: float                           # gate + demote-step wall
    async_commit: bool                           # deferred-commit tick on?
    async_ticks: int                             # ticks that deferred
    commit_defer_wall_s: float                   # wall dispatches stayed in
    #                                              flight under the next
    #                                              tick's coordinator work
    fold_payload_bytes: int                      # barrier registry deltas
    worker: str                                  # shard workers: thread|
    #                                              process
    fold: str                                    # barrier fold: sparse|dense
    device: str                                  # where the kernels ran
    serve_wall_s: float
    sustained_spans_per_sec: float

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        d["lane_buckets"] = list(self.lane_buckets)
        d["dispatches_by_width"] = {str(k): v for k, v
                                    in self.dispatches_by_width.items()}
        d["lanes_by_bucket"] = {str(k): v for k, v
                                in self.lanes_by_bucket.items()}
        d["per_priority"] = {str(k): v for k, v
                             in self.per_priority.items()}
        d["shard_tenants"] = {str(k): v for k, v
                              in self.shard_tenants.items()}
        d["shard_spans"] = {str(k): v for k, v
                            in self.shard_spans.items()}
        d["rca_topk_hits"] = {str(k): v for k, v
                              in self.rca_topk_hits.items()}
        return d


#: ServeReport fields that are walls or follow the lane GROUPING (which
#: tenants share a fused stack) or the shard topology: they differ between
#: fused and unfused, across pipeline depths or across shard counts on one
#: seed; every other field is a decision
VARIANT_REPORT_FIELDS = (
    "fused", "fused_dispatches", "lanes_by_bucket", "lane_pad_waste",
    "compile_s", "lane_compile_s", "native_staging",
    "native_staged_dispatches", "serve_state", "stage_wall_s",
    "dispatch_wall_s", "fold_wall_s", "score_wall_s", "pipeline",
    "serve_wall_s", "sustained_spans_per_sec", "rca_latency", "rca_wall_s",
    "shards", "shard_tenants", "shard_spans", "shard_imbalance",
    "fold_payload_bytes", "ckpt_wall_s", "recovery_wall_s", "worker",
    "fold",
    # elastic topology (a static run's peak is its shard count) and the
    # policy, deferral and tiering walls; whether a cold read had
    # finished before its join is wall luck
    "peak_shards", "policy_wall_s", "commit_defer_wall_s",
    "tier_prefetch_hidden", "tier_wall_s",
    # the perf observatory's counts follow the lane grouping and its
    # waits are walls; the census's bytes follow the pool and scratch
    # topology and its wall is a wall (the hot-set document and the
    # census tick count are decisions)
    "perf_events_recorded", "overlap_headroom_s", "fold_wait_s",
    "bubble_fractions", "census_resident_bytes", "census_wall_s")

#: the elastic policy's report fields: they differ between a policy-on
#: and a policy-off run of one seed (``n_checkpoints`` too: every scale
#: edge takes a fresh baseline checkpoint)
POLICY_REPORT_FIELDS = ("policy", "n_scale_ups", "n_scale_downs",
                        "n_rebalances", "n_policy_migrations",
                        "brownout_ticks", "n_checkpoints")

#: the deferred-commit tick's report fields (the mode and its tick count)
ASYNC_REPORT_FIELDS = ("async_commit", "async_ticks")

#: state tiering's configuration and canonical counters; a tiered run's
#: other fields equal a never-evicted run's (``dispatches_by_width``
#: aside when a cold miss regroups the lanes of a deferred tick)
TIERING_REPORT_FIELDS = ("tier_hot", "n_tier_demotions_warm",
                         "n_tier_demotions_cold", "n_tier_promotions",
                         "n_tier_misses")

#: the supervision configuration's report fields: they differ between a
#: supervised and an unsupervised run of one seed
SUPERVISION_REPORT_FIELDS = ("supervised", "ckpt_every", "n_checkpoints")

#: the recovery counters: they differ between a fault-free run and one
#: that recovered from injected faults, every decision field is equal
RECOVERY_REPORT_FIELDS = ("n_shard_crashes", "n_respawns",
                          "n_restored_ticks", "n_quarantined",
                          "n_migrated_tenants")

#: the report fields the flight recorder adds: they differ between a
#: flight-on and a flight-off run of one seed
FLIGHT_REPORT_FIELDS = ("flight_enabled", "flight_recorded_ticks",
                        "flight_dropped_ticks")

#: the report fields the RCA plane adds: they differ between an RCA-on
#: and an RCA-off run of one seed, every other decision field is equal
RCA_REPORT_FIELDS = ("rca_enabled", "n_rca_runs", "rca_topk_hits",
                     "rca_eligible", "rca_latency",
                     "rca_alert_to_culprit_s", "rca_wall_s")


def serve_plane_cfg(n_services: int = 12, window_s: float = 5.0,
                    n_windows: int = 32) -> ReplayConfig:
    """The serve bench's replay-plane shape."""
    return ReplayConfig(n_services=n_services, n_windows=n_windows,
                        window_us=int(window_s * 1e6), chunk_size=4096)


def replay_served_sequentially(engine: "ServeEngine",
                               served_log: Sequence[List[QueuedBatch]]
                               ) -> Dict[int, OnlineDetector]:
    """The fused engine's parity oracle: every tick's served batches
    (``engine.tick``'s returns, in order), coalesced per tenant in
    arrival order as the fused tick coalesces them, pushed tenant by
    tenant through a fresh detector whose replay rides a fresh runner of
    the same shape, one single-lane dispatch per chunk.  Returns the
    finished detectors by tenant; their states and alert streams equal
    the fused engine's byte for byte."""
    r = engine.runner
    runner = BucketRunner(engine.cfg, r.buckets, lane_buckets=r.lane_buckets,
                          pipeline=1, state=engine.serve_state,
                          pool_slots=max(len(engine.specs), 1),
                          device=engine.device,
                          native_stage=r.native_stage)
    cls = PooledStreamReplay if runner.pool is not None \
        else BucketedStreamReplay
    dets: Dict[int, OnlineDetector] = {}
    for served in served_log:
        per_tenant: Dict[int, List[QueuedBatch]] = {}
        for qb in served:
            per_tenant.setdefault(qb.tenant_id, []).append(qb)
        for tid, qbs in per_tenant.items():
            det = dets.get(tid)
            if det is None:
                det = dets[tid] = OnlineDetector(
                    engine.services, engine.cfg, engine.t0_us,
                    replay=cls(engine.cfg, engine.t0_us, runner),
                    **engine._det_kw)
            det.push(qbs[0].spans if len(qbs) == 1 else
                     concat_span_batches([qb.spans for qb in qbs]))
    for det in dets.values():
        det.finish()
    return dets


def power_law_traffic(n_tenants: int, n_services: int,
                      capacity_spans_per_s: float, overload: float,
                      duration_s: float, seed: int, alpha: float,
                      window_s: float, baseline_windows: int,
                      fault_tenants: int):
    """The serve run's traffic: a power-law tenant fleet offering
    ``overload`` x the capacity, with the ``fault_tenants`` busiest
    tenants given a latency fault on service 1 once calibration is past
    (none when the run is too short for a fault phase)."""
    onset_s = (baseline_windows + 2) * window_s
    if duration_s <= onset_s + 2 * window_s:
        fault_tenants = 0
    faults = {t: TenantFault("latency", service=1, onset_s=onset_s,
                             factor=10.0)
              for t in range(min(fault_tenants, n_tenants))}
    return PowerLawTraffic(
        n_tenants=n_tenants,
        total_rate_spans_per_s=capacity_spans_per_s * overload,
        alpha=alpha, seed=seed, n_services=n_services, faults=faults)


def run_power_law(n_tenants: int = 200, n_services: int = 8,
                  capacity_spans_per_s: float = 20_000.0,
                  overload: float = 1.0, duration_s: float = 120.0,
                  tick_s: float = 1.0, seed: int = 0, alpha: float = 1.2,
                  window_s: float = 5.0, baseline_windows: int = 4,
                  z_threshold: float = 4.0,
                  buckets: Optional[Tuple[int, ...]] = None,
                  max_backlog: Optional[int] = None,
                  fault_tenants: int = 2, score: bool = True,
                  n_windows: int = 32, fuse: Optional[bool] = None,
                  lane_buckets: Optional[Tuple[int, ...]] = None,
                  pipeline: Optional[int] = None,
                  state: Optional[str] = None, device: DeviceLike = None,
                  native_stage: Optional[bool] = None,
                  drain_engine: str = "native",
                  native_drain: Optional[str] = None,
                  rca: Optional[bool] = None,
                  tracer=None, shards: Optional[int] = None,
                  fold: Optional[str] = None,
                  flight: Optional[bool] = None,
                  flight_digest_every: Optional[int] = None,
                  flight_max_ticks: Optional[int] = None,
                  perf: Optional[bool] = None,
                  census: Optional[bool] = None,
                  census_every: Optional[int] = None,
                  chaos: Optional[str] = None,
                  ckpt_every: Optional[int] = None,
                  retries: Optional[int] = None,
                  retry_backoff_s: Optional[float] = None,
                  max_respawns: Optional[int] = None,
                  worker: Optional[str] = None,
                  policy: Optional[str] = None,
                  policy_script: Optional[str] = None,
                  min_shards: Optional[int] = None,
                  max_shards: Optional[int] = None,
                  target_imbalance: Optional[float] = None,
                  cooldown_ticks: Optional[int] = None,
                  async_commit: Optional[bool] = None,
                  tier_hot: Optional[int] = None,
                  tier_demote_after: Optional[int] = None,
                  tier_warm_bytes: Optional[int] = None,
                  tier_cold_dir=None,
                  tier_prefetch: Optional[int] = None, mesh=None
                  ) -> Tuple["ServeEngine", "ServeReport"]:
    """The canonical seeded serve run: :func:`power_law_traffic` against
    an engine of ``capacity_spans_per_s``, so one run measures sustained
    throughput, shedding and alert latency under load.  With the flight
    recorder on, its header's ``run`` holds these arguments, every
    defaulted knob resolved, for ``audit replay`` to re-execute."""
    traffic = power_law_traffic(n_tenants, n_services, capacity_spans_per_s,
                                overload, duration_s, seed, alpha, window_s,
                                baseline_windows, fault_tenants)
    cfg = serve_plane_cfg(n_services, window_s, n_windows)
    engine = ServeEngine(traffic.specs, traffic.services, cfg,
                         capacity_spans_per_s=capacity_spans_per_s,
                         tick_s=tick_s, buckets=buckets,
                         max_backlog=max_backlog, score=score,
                         baseline_windows=baseline_windows,
                         z_threshold=z_threshold, fuse=fuse,
                         lane_buckets=lane_buckets, pipeline=pipeline,
                         state=state, device=device,
                         native_stage=native_stage,
                         drain_engine=drain_engine, native_drain=native_drain,
                         rca=rca, tracer=tracer,
                         shards=shards, fold=fold, flight=flight,
                         flight_digest_every=flight_digest_every,
                         flight_max_ticks=flight_max_ticks, perf=perf,
                         census=census, census_every=census_every,
                         chaos=chaos, ckpt_every=ckpt_every, retries=retries,
                         retry_backoff_s=retry_backoff_s,
                         max_respawns=max_respawns, worker=worker,
                         policy=policy, policy_script=policy_script,
                         min_shards=min_shards, max_shards=max_shards,
                         target_imbalance=target_imbalance,
                         cooldown_ticks=cooldown_ticks,
                         async_commit=async_commit, tier_hot=tier_hot,
                         tier_demote_after=tier_demote_after,
                         tier_warm_bytes=tier_warm_bytes,
                         tier_cold_dir=tier_cold_dir,
                         tier_prefetch=tier_prefetch, mesh=mesh)
    if engine.flight_recorder is not None:
        pol = engine.policy
        # native_stage and drain_engine stay as passed: their oracles are
        # byte-identical, so they cannot move a canonical plane
        engine.flight_recorder.header["run"] = dict(
            n_tenants=n_tenants, n_services=n_services,
            capacity_spans_per_s=capacity_spans_per_s, overload=overload,
            duration_s=duration_s, tick_s=tick_s, seed=seed, alpha=alpha,
            window_s=window_s, baseline_windows=baseline_windows,
            z_threshold=z_threshold, buckets=list(engine.runner.buckets),
            max_backlog=engine.max_backlog, fault_tenants=fault_tenants,
            score=score, n_windows=n_windows, fuse=engine.fuse,
            lane_buckets=list(engine.runner.lane_buckets),
            pipeline=engine.pipeline, state=engine.serve_state,
            native_stage=native_stage, drain_engine=drain_engine,
            native_drain=native_drain,
            rca=engine.rca, shards=engine.shards, fold=engine.fold_mode,
            flight=True,
            flight_digest_every=engine.flight_recorder.digest_every,
            flight_max_ticks=engine.flight_recorder.max_ticks,
            # the observatories resolved: a replay re-records the timeline
            # and re-takes the same census
            perf=engine.perf, census=engine.census,
            census_every=engine.census_every,
            # a replay of a chaos run re-injects the script and recovers
            # again: its journal equals the original's (both equal the
            # fault-free journal)
            chaos=(engine._chaos.script if engine._chaos is not None
                   else ""),
            ckpt_every=engine.ckpt_every, retries=engine.retries,
            retry_backoff_s=engine.retry_backoff_s,
            max_respawns=engine.max_respawns, worker=engine.worker_mode,
            # the policy knobs resolved: a replay re-evaluates the same
            # canonical signals and scales on the same schedule
            policy=pol.mode if pol is not None else "off",
            policy_script=pol.script if pol is not None else "",
            min_shards=pol.min_shards if pol is not None else None,
            max_shards=pol.max_shards if pol is not None else None,
            target_imbalance=(pol.target_imbalance if pol is not None
                              else None),
            cooldown_ticks=pol.cooldown_ticks if pol is not None else None,
            async_commit=engine.async_commit,
            # the tier geometry decides demotions, spills and which tick
            # a missed tenant's deltas land in: a replay serves with it
            tier_hot=engine.tier_hot,
            tier_demote_after=engine.tier_demote_after,
            tier_warm_bytes=engine.tier_warm_bytes,
            tier_cold_dir=(str(engine.tier_cold_dir)
                           if engine.tier_cold_dir is not None else None),
            tier_prefetch=engine.tier_prefetch)
    report = engine.run(traffic, duration_s=duration_s)
    return engine, report


class ServeEngine:
    """Multi-tenant serving plane over the streaming detectors, on one
    device (``cuda`` unless the caller asks for ``cpu``).  ``buckets``,
    ``lane_buckets``, ``fuse``, ``pipeline``, ``state``, ``max_backlog``,
    ``native_stage``, ``native_drain``, ``rca``, ``shards``, ``fold``,
    ``worker``, ``flight``, ``perf``, ``census``, ``chaos``,
    ``ckpt_every``, ``policy``, ``async_commit``, ``tier_hot`` and the
    ``rca_*`` / ``flight_*`` / ``census_every`` / supervision / policy /
    ``tier_*`` knobs default from ``anomod_torch.config`` when None;
    ``tracer`` defaults to a ``Tracer("anomod-serve")`` when the process
    registry is enabled."""

    def __init__(self, specs: Sequence[TenantSpec], services: Sequence[str],
                 cfg: Optional[ReplayConfig] = None, t0_us: int = 0,
                 capacity_spans_per_s: float = 20_000.0, tick_s: float = 1.0,
                 buckets: Optional[Tuple[int, ...]] = None,
                 max_backlog: Optional[int] = None,
                 score: bool = True, baseline_windows: int = 4,
                 z_threshold: float = 4.0, consecutive: int = 1,
                 min_count: float = 5.0, multimodal: bool = False,
                 testbed: Optional[str] = None,
                 fuse: Optional[bool] = None,
                 lane_buckets: Optional[Tuple[int, ...]] = None,
                 pipeline: Optional[int] = None,
                 state: Optional[str] = None, device: DeviceLike = None,
                 native_stage: Optional[bool] = None,
                 drain_engine: str = "native",
                 native_drain: Optional[str] = None, tracer=None,
                 rca: Optional[bool] = None,
                 rca_buckets: Optional[tuple] = None,
                 rca_topk: Optional[int] = None,
                 rca_budget: Optional[int] = None,
                 rca_windows: Optional[int] = None,
                 shards: Optional[int] = None, fold: Optional[str] = None,
                 flight: Optional[bool] = None,
                 flight_digest_every: Optional[int] = None,
                 flight_max_ticks: Optional[int] = None,
                 perf: Optional[bool] = None,
                 census: Optional[bool] = None,
                 census_every: Optional[int] = None,
                 chaos=None, ckpt_every: Optional[int] = None,
                 retries: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 max_respawns: Optional[int] = None,
                 worker: Optional[str] = None,
                 policy: Optional[str] = None,
                 policy_script: Optional[str] = None,
                 min_shards: Optional[int] = None,
                 max_shards: Optional[int] = None,
                 target_imbalance: Optional[float] = None,
                 cooldown_ticks: Optional[int] = None,
                 async_commit: Optional[bool] = None,
                 tier_hot: Optional[int] = None,
                 tier_demote_after: Optional[int] = None,
                 tier_warm_bytes: Optional[int] = None,
                 tier_cold_dir=None,
                 tier_prefetch: Optional[int] = None, mesh=None):
        if capacity_spans_per_s <= 0:
            raise ValueError("capacity must be positive")
        #: the mesh plane (an ``anomod_torch.parallel.Mesh``): every
        #: tenant's replay is a ShardedStreamReplay over it, on its device
        self.mesh = mesh
        if mesh is not None and device is not None \
                and resolve_device(device).type != mesh.device.type:
            raise ValueError(f"device {device} disagrees with the mesh's "
                             f"{mesh.device}")
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.specs = list(specs)
        self.services = tuple(services)
        self.cfg = cfg or ReplayConfig(n_services=len(self.services),
                                       chunk_size=4096)
        if self.cfg.n_services != len(self.services):
            raise ValueError("cfg.n_services disagrees with the service "
                             "table")
        self.t0_us = int(t0_us)
        self.capacity_spans_per_s = float(capacity_spans_per_s)
        self.clock = VirtualClock(tick_s)
        app_cfg = get_config()
        self.max_backlog = int(app_cfg.serve_max_backlog
                               if max_backlog is None else max_backlog)
        # ANOMOD_SERVE_NATIVE_DRAIN (or ``native_drain``) ``off`` picks the
        # heap oracle; ``auto`` and ``on`` keep ``drain_engine``
        native_drain = (app_cfg.serve_native_drain if native_drain is None
                        else str(native_drain).strip().lower())
        if native_drain not in ("auto", "on", "off"):
            raise ValueError(f"native_drain must be auto, on or off, got "
                             f"{native_drain!r}")
        self.admission = AdmissionController(
            self.specs, max_backlog=self.max_backlog,
            drain_engine="heap" if native_drain == "off" else drain_engine)
        self.score = bool(score)
        #: the multimodal sidecar: each tenant's detector is a
        #: ``MultimodalDetector`` whose log / metric / API planes take
        #: :meth:`offer_modality` batches beside the span queue.  Its
        #: planes live outside the runner's snapshot and migration seams,
        #: so the policy, tiering, supervision and process workers each
        #: turn themselves off beside it (an explicit request raises)
        self.multimodal = bool(multimodal)
        self.testbed = testbed
        #: pushed log / metric / API events per modality kind
        self.modality_events: Dict[str, int] = {}
        #: tenant-fused scoring: per tick, drained same-tenant batches
        #: coalesce into one staging and same-width chunks across tenants
        #: run as lane-stacked dispatches.  The mesh plane manages its own
        #: sharded dispatch, so fusion applies to the bucket-runner plane
        #: only
        self.fuse = bool(app_cfg.serve_fuse if fuse is None else fuse)
        self._fused = self.fuse and mesh is None
        #: tenant sharding: the score plane fans out to ``shards``
        #: workers by tenant ownership; 1 is the inline engine
        self.shards = int(app_cfg.serve_shards if shards is None else shards)
        if self.shards < 1:
            raise ValueError("shards must be >= 1")
        if mesh is not None and self.shards > 1:
            raise ValueError(
                "the mesh plane manages its own sharded dispatch; "
                "run it with shards=1 (ANOMOD_SERVE_SHARDS=1)")
        fold_mode = (app_cfg.serve_fold if fold is None
                     else str(fold).strip().lower() or "sparse")
        if fold_mode not in ("dense", "sparse"):
            raise ValueError(f"unknown serve fold mode {fold_mode!r} "
                             "(dense|sparse)")
        self.fold_mode = fold_mode
        #: the deferred-commit tick: tick t's dispatches are issued and
        #: left in flight on the shard streams while tick t+1's
        #: admission, drain, shed and SLO run; tick t commits at a
        #: barrier before tick t+1 issues.  Every decision input is taken
        #: at tick t, so decisions and the canonical journal equal the
        #: synchronous engine's (the oracle); only walls move.  The mesh
        #: plane has no issue / commit seam to split: an explicit request
        #: beside it raises, an env-sourced one is off
        async_on = bool(app_cfg.serve_async_commit if async_commit is None
                        else async_commit)
        if mesh is not None and async_on:
            if async_commit is not None:
                raise ValueError(
                    "the deferred-commit tick splits the bucket-runner "
                    "issue/commit seam; the mesh plane manages its own "
                    "sharded dispatch (ANOMOD_SERVE_ASYNC_COMMIT=0)")
            async_on = False
        self.async_commit = async_on
        #: the deferred tick's snapshotted context (None: nothing
        #: deferred): every input its commit tail reads, taken at issue
        self._deferred: Optional[dict] = None
        #: ticks whose commit deferred past issue
        self.async_ticks = 0
        #: wall the issued dispatches stayed in flight under coordinator
        #: work before their barrier read them
        self.commit_defer_wall_s = 0.0
        #: the elastic policy (anomod_torch.serve.policy): ``off`` is the
        #: static engine; ``auto`` / ``script`` evaluate an ElasticPolicy
        #: at every tick end and run its decisions through the
        #: live-migration seams (the mesh plane and the multimodal sidecar
        #: keep state outside them: beside either, an explicit policy
        #: raises and an env-sourced one is off)
        policy_mode = (app_cfg.serve_policy if policy is None
                       else str(policy).strip().lower() or "off")
        if policy_mode not in ("off", "auto", "script"):
            raise ValueError(f"unknown serve policy mode "
                             f"{policy_mode!r} (off|auto|script)")
        if (mesh is not None or self.multimodal) and policy_mode != "off":
            if policy is not None:
                raise ValueError(
                    "the elastic policy migrates tenants through the "
                    "bucket-runner state seams; "
                    + ("the mesh plane manages its own sharded state"
                       if mesh is not None else
                       "the multimodal sidecar planes are not covered "
                       "by the migration seams")
                    + " (ANOMOD_SERVE_POLICY=off)")
            policy_mode = "off"
        self._elastic = policy_mode != "off"
        self.policy = None
        if self._elastic:
            from anomod_torch.serve.policy import ElasticPolicy
            self.policy = ElasticPolicy(
                policy_mode,
                int(app_cfg.serve_policy_min_shards
                    if min_shards is None else min_shards),
                int(app_cfg.serve_policy_max_shards
                    if max_shards is None else max_shards),
                float(app_cfg.serve_policy_target_imbalance
                      if target_imbalance is None else target_imbalance),
                int(app_cfg.serve_policy_cooldown_ticks
                    if cooldown_ticks is None else cooldown_ticks),
                script=(app_cfg.serve_policy_script
                        if policy_script is None else policy_script))
            if not (self.policy.min_shards <= self.shards
                    <= self.policy.max_shards):
                raise ValueError(
                    f"shards={self.shards} is outside the elastic "
                    f"envelope [{self.policy.min_shards}, "
                    f"{self.policy.max_shards}] "
                    "(ANOMOD_SERVE_POLICY_MIN/MAX_SHARDS)")
        self.policy_wall_s = 0.0
        #: spans resident in the states the policy's migrations moved
        self.policy_migrated_spans = 0
        self._peak_shards = self.shards
        self._policy_events: List[dict] = []
        self._policy_prev_chunks: Optional[List[int]] = None
        self._policy_prev_shed = 0
        #: books and walls of the runners a scale-down retired: the
        #: report's dispatch counts and walls cover the whole run
        self._retired_runners: List[dict] = []
        #: state tiering (anomod_torch.serve.tiering): past ``tier_hot``
        #: pool-resident tenants the coldest idle ones demote to the host
        #: warm tier and on to the disk cold tier.  The mesh plane keeps
        #: its state outside the snapshot seams, the multimodal sidecar's
        #: planes have no demotion copier and the deferred commit would
        #: demote states with folds in flight: tiering refuses all three
        #: (an explicit request raises, an env-sourced one is off)
        tier_hot_n = (app_cfg.serve_tier_hot if tier_hot is None
                      else int(tier_hot))
        if tier_hot is not None and tier_hot_n < 0:
            raise ValueError("tier_hot must be >= 0 (0 = tiering off)")
        if tier_hot_n > 0 and (mesh is not None or self.multimodal
                               or self.async_commit):
            if tier_hot is not None:
                raise ValueError(
                    "state tiering demotes tenants through the "
                    "bucket-runner snapshot seams; "
                    + ("the mesh plane manages its own sharded state"
                       if mesh is not None else
                       "the multimodal sidecar planes are not covered by "
                       "the demotion copier" if self.multimodal else
                       "the deferred-commit tick leaves folds in flight "
                       "at the demotion point")
                    + " (ANOMOD_SERVE_TIER_HOT=0)")
            tier_hot_n = 0
        self.tier_hot = int(tier_hot_n)
        self.tier_demote_after = int(
            app_cfg.serve_tier_demote_after if tier_demote_after is None
            else tier_demote_after)
        if self.tier_demote_after < 1:
            raise ValueError("tier_demote_after must be >= 1 tick")
        self.tier_warm_bytes = int(
            app_cfg.serve_tier_warm_bytes if tier_warm_bytes is None
            else tier_warm_bytes)
        if self.tier_warm_bytes < 0:
            raise ValueError("tier_warm_bytes must be >= 0")
        cold = (app_cfg.serve_tier_cold_dir if tier_cold_dir is None
                else tier_cold_dir)
        from pathlib import Path
        self.tier_cold_dir = Path(cold).expanduser() if cold else None
        self.tier_prefetch = int(app_cfg.serve_tier_prefetch
                                 if tier_prefetch is None else tier_prefetch)
        if not 1 <= self.tier_prefetch <= 256:
            raise ValueError("tier_prefetch must be in [1, 256]")
        self._tier = None
        #: a cold-promoting tenant's drained batches, parked one tick and
        #: scored first at the next tick's gate, in park order
        self._tier_parked: Dict[int, list] = {}
        self.tier_wall_s = 0.0
        if self.tier_hot:
            from anomod_torch.serve.tiering import TierPlane
            self._tier = TierPlane(
                self.tier_warm_bytes, self.tier_cold_dir,
                self.tier_prefetch,
                slot_nbytes=self.cfg.sw
                * (N_FEATS + self.cfg.n_hist_buckets) * 4,
                hot_capacity=self.tier_hot,
                demote_after=self.tier_demote_after)
        #: the perf observatory (anomod_torch.obs.perf): one recorder a
        #: shard runner, drained at the tick barrier in shard order; the
        #: retained timeline is bounded and every eviction counted
        self.perf = bool(app_cfg.perf if perf is None else perf)
        self.perf_max_events = int(app_cfg.perf_max_events)
        self.perf_events: list = []
        self.perf_events_recorded = 0
        self.perf_events_dropped = 0
        self.perf_headroom_s = 0.0
        self.perf_wait_s = 0.0
        #: undrained events of the runners a scale-down retired
        self._perf_pending: list = []
        self._perf_tick_doc: Optional[dict] = None
        self._perf_recs: list = []
        if self.perf:
            from anomod_torch.obs.perf import PerfRecorder
            self._perf_recs = [PerfRecorder(s) for s in range(self.shards)]
            # metric handles only when the plane is live: a perf-off run
            # registers no perf series
            self._obs_perf_events = obs.counter("anomod_perf_events_total")
            self._obs_perf_dropped = obs.counter(
                "anomod_perf_dropped_events_total")
            self._obs_fold_wait = obs.counter(
                "anomod_serve_fold_wait_seconds_total")
            self._obs_headroom = obs.counter(
                "anomod_serve_overlap_headroom_seconds_total")
        #: the fleet census (anomod_torch.obs.census): every
        #: ``census_every``-th tick and at the run's end, resident bytes
        #: from shapes and the hot-set document
        self.census = bool(app_cfg.census if census is None else census)
        self.census_every = int(app_cfg.census_every
                                if census_every is None else census_every)
        if self.census_every < 1:
            raise ValueError("census_every must be >= 1 tick")
        self._census_tick_doc: Optional[dict] = None
        self.census_ticks = 0
        self.census_hot_set: Dict[str, object] = {}
        self.census_resident: Dict[str, object] = {}
        self.census_peak_bytes = 0
        self.census_wall_s = 0.0
        self._census_reconciled = True
        #: the hot-set bookkeeping: the census's, and under tiering the
        #: demotion order's input (the drain stays gated on ``census``)
        self._census_tracker = None
        if self.census or self.tier_hot:
            from anomod_torch.obs.census import CensusTracker
            self._census_tracker = CensusTracker(
                app_cfg.census_decay_ticks, app_cfg.census_coldest_k,
                self.census_every)
        if self.census:
            self._obs_census = {
                "total": obs.gauge("anomod_census_resident_bytes"),
                "pool": obs.gauge("anomod_census_pool_bytes"),
                "scratch": obs.gauge("anomod_census_scratch_bytes"),
                "admission": obs.gauge("anomod_census_admission_bytes"),
                "slo": obs.gauge("anomod_census_slo_bytes"),
                "rca": obs.gauge("anomod_census_rca_bytes"),
                "recorder": obs.gauge("anomod_census_recorder_bytes"),
                "registered": obs.gauge(
                    "anomod_census_registered_tenants"),
                "resident": obs.gauge("anomod_census_resident_tenants"),
                "hot": obs.gauge("anomod_census_hot_tenants"),
                "occupancy": obs.gauge(
                    "anomod_census_slot_occupancy_fraction"),
            }
            self._obs_census_ticks = obs.counter(
                "anomod_census_ticks_total")
        #: the shard workers' kind: ``thread`` (the byte-parity oracle)
        #: or ``process`` (anomod_torch.serve.procshard: each shard's
        #: whole score plane in a spawned process, behind the same
        #: submit / join / close / alive seam).  A plane that shares
        #: coordinator memory with the score plane cannot cross the
        #: process boundary: an explicit ``worker="process"`` beside one
        #: is refused, an env-sourced one falls back to threads
        #: (:meth:`_process_blockers`).
        worker_mode = (app_cfg.serve_worker if worker is None
                       else str(worker).strip().lower() or "thread")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown serve worker mode {worker_mode!r} "
                             "(thread|process)")
        if worker_mode == "process":
            blockers = self._process_blockers()
            if blockers:
                if worker is not None:
                    raise ValueError(
                        "process shard workers own their score plane in a "
                        "separate interpreter; " + blockers[0]
                        + " (ANOMOD_SERVE_WORKER=thread)")
                worker_mode = "thread"
        self.worker_mode = worker_mode
        self._worker_start_timeout_s = float(
            app_cfg.serve_worker_start_timeout_s)
        #: a process worker's chaos fired-counts, from its last reply: a
        #: respawned child resumes its faults' repeat budgets there
        self._chaos_fired: Dict[int, list] = {}
        #: lane-kernel launches made in the children, summed from their
        #: replies (each child counts in its own wrappers)
        self.worker_launches: Dict[str, int] = {}
        #: wall of the children's start-up (spawn, imports, the
        #: sub-engine, the kernel libraries' load), outside the serve wall
        self.worker_start_s = 0.0
        #: elastic engines run the sharded machinery at every count, so a
        #: scale-up never converts an inline engine mid-run
        self._use_workers = (self.shards > 1 or self._elastic
                             or self.worker_mode == "process")
        self._proc_registry = obs.get_registry()
        #: structural bytes the barrier's registry folds shipped
        #: (``obs.registry.delta_nbytes``)
        self.fold_payload_bytes = 0
        self._obs_fold_payload = (
            obs.counter("anomod_serve_fold_payload_bytes_total")
            if self._use_workers else None)
        pipeline = int(app_cfg.serve_pipeline if pipeline is None
                       else pipeline)
        if mesh is not None:
            # the mesh plane keeps its own sharded state: beside it
            # ``device`` (passed or from ANOMOD_SERVE_STATE) raises and
            # ``auto`` is the host seam
            state = app_cfg.serve_state if state is None else state
            if state == "device":
                raise ValueError(
                    "the mesh plane manages its own sharded state; "
                    "a device state pool cannot apply "
                    "(ANOMOD_SERVE_STATE=host or auto)")
            if state not in ("auto", "host"):
                raise ValueError(f"unknown serve state mode {state!r} "
                                 "(auto|host|device)")
            state = "host"
        elif state is None:
            # ANOMOD_SERVE_STATE: ``auto`` is the device pool
            state = app_cfg.serve_state
            state = "device" if state == "auto" else state
        # each runner owns (and validates) the pipeline depth and the
        # state mode; the recipe a scale-up builds a runner from
        self._runner_kw = dict(
            lane_buckets=(app_cfg.serve_lane_buckets if lane_buckets is None
                          else lane_buckets),
            pipeline=pipeline, state=state, device=self.device,
            native_stage=bool(app_cfg.native != "off" if native_stage is None
                              else native_stage))
        buckets = app_cfg.serve_buckets if buckets is None else buckets
        self._buckets_arg = buckets
        self._shard_regs = []
        if self._use_workers:
            from anomod_torch.serve.shard import plan_shards
            self.shard_of = plan_shards(self.specs, self.shards,
                                        self.capacity_spans_per_s)
        else:
            # the inline engine owns every tenant on shard 0 (every read
            # of the placement map is ``.get(tid, 0)``)
            self.shard_of = {}
        if self.worker_mode == "process":
            # the runners live in the children; the coordinator keeps a
            # mirror a shard of every runner fact its planes read, from
            # the children's barrier replies (their registry deltas come
            # over the pipe, so there are no coordinator shard registries)
            from anomod_torch.serve.procshard import RunnerMirror
            self._runners = [RunnerMirror(self.cfg, buckets,
                                          **self._runner_kw)
                             for _ in range(self.shards)]
        elif self._use_workers:
            # each shard owns a whole scoring plane: its runner (scratch,
            # a pool sized to the tenants it owns, or to its share of the
            # hot capacity under tiering, on the card a stream of its
            # own) records into its own registry, folded into the
            # process registry at the tick barrier
            self._shard_regs = [
                obs.Registry(enabled=self._proc_registry.enabled)
                for _ in range(self.shards)]
            owned = [0] * self.shards
            for sh in self.shard_of.values():
                owned[sh] += 1
            self._runners = [
                BucketRunner(self.cfg, buckets, registry=reg,
                             pool_slots=max(min(owned[s], self.tier_hot)
                                            if self.tier_hot else owned[s],
                                            1),
                             own_stream=True,
                             perf=self._perf_recs[s] if self.perf else None,
                             **self._runner_kw)
                for s, reg in enumerate(self._shard_regs)]
        else:
            n = len(self.specs)
            self._runners = [BucketRunner(
                self.cfg, buckets,
                pool_slots=max(min(n, self.tier_hot) if self.tier_hot
                               else n, 1),
                perf=self._perf_recs[0] if self.perf else None,
                **self._runner_kw)]
        self._fold_state = [dict() for _ in self._shard_regs]
        self.runner = self._runners[0]
        self._workers = None
        self._last_failures = None
        self.pipeline = self.runner.pipeline
        self.serve_state = self.runner.state_mode
        self._det_kw = dict(baseline_windows=baseline_windows,
                            z_threshold=z_threshold,
                            consecutive=consecutive, min_count=min_count)
        # per-tenant detector/replay state, built at first served batch
        # (process mode: residency stubs and alert mirrors)
        self._tenant_replay: Dict[int, object] = {}
        self._tenant_det: Dict[int, OnlineDetector] = {}
        self._slo: Dict[int, _TenantSLO] = _LazySLO()
        self._credit = 0.0
        #: widest batch ever served: the legitimate overdraw envelope of
        #: the per-tick credit clamp
        self._max_served_batch = 0
        self.serve_wall_s = 0.0
        #: per-tick serve walls (the ``raw_wall_s`` samples ``perf diff``
        #: bootstraps over, and the fleet probe's medians)
        self.tick_walls: List[float] = []
        self.n_spans_served = 0
        #: online RCA: a pure read-side consumer of the alert stream
        self.rca = bool(app_cfg.serve_rca if rca is None else rca)
        if self.rca and not self.score:
            raise ValueError("online RCA consumes the detectors' alert "
                             "stream; it needs score=True")
        self.rca_budget = int(app_cfg.serve_rca_budget
                              if rca_budget is None else rca_budget)
        if self.rca_budget < 1:
            raise ValueError("rca_budget must be >= 1 run per tick")
        self._rca_planes: list = []
        self._rca_seen: Dict[int, int] = {}
        self._rca_queue: "collections.deque" = collections.deque()
        self._rca_seq = 0
        self.rca_verdicts: list = []
        self.rca_wall_s = 0.0
        # metric handles only when the plane is live: an RCA-off run
        # registers no RCA series
        self._rca_slo = None
        if self.rca:
            self._rca_slo = _TenantSLO("anomod_serve_rca_seconds")
            self._obs_rca_queued = obs.counter(
                "anomod_serve_rca_queued_total")
            # one plane a thread shard, recording into the shard's
            # registry; the inline engine and process workers keep one
            # coordinator plane recording into the process registry (the
            # evidence is buffered on the coordinator, so it survives a
            # child's crash)
            #: the RCA-plane recipe a scale-up builds a shard plane from
            self._rca_kw = dict(
                buckets=(app_cfg.serve_rca_buckets if rca_buckets is None
                         else rca_buckets),
                topk=int(app_cfg.serve_rca_topk if rca_topk is None
                         else rca_topk),
                windows=int(app_cfg.serve_rca_windows
                            if rca_windows is None else rca_windows))
            self._rca_planes = [self._make_rca_plane(reg)
                                for reg in (self._shard_regs or [None])]
        # tracing is on by default, gated on the one telemetry switch, so
        # "telemetry off" means off end to end; an explicit Tracer forces
        # it on
        if tracer is None and obs.get_registry().enabled:
            from anomod_torch.utils.tracing import Tracer
            tracer = Tracer("anomod-serve")
        self.tracer = tracer
        # self-scrape plumbing: cached handles for the tick loop, and one
        # registry scrape per virtual second on the VIRTUAL clock, so a
        # seeded run's telemetry timeline is deterministic
        self._registry = self._proc_registry
        self._obs_tick = obs.histogram("anomod_serve_tick_seconds")
        self._obs_ticks = obs.counter("anomod_serve_ticks_total")
        self._obs_tenants = obs.gauge("anomod_serve_active_tenants")
        self._scrape_every = max(1, int(round(1.0 / self.clock.tick_s)))
        #: the flight recorder: a pure read-side consumer, every decision
        #: above is byte-identical with it on or off
        self.flight = bool(app_cfg.flight if flight is None else flight)
        self.flight_recorder = None
        self._flight_dump_dir = app_cfg.flight_dump_dir
        self._flight_dumped = False
        if self.flight:
            from anomod_torch.obs.flight import (FlightRecorder,
                                                 config_snapshot, versions)
            self.flight_recorder = FlightRecorder(
                {"engine": {
                    "n_tenants": len(self.specs),
                    "n_services": len(self.services),
                    "capacity_spans_per_s": self.capacity_spans_per_s,
                    "tick_s": self.clock.tick_s,
                    "max_backlog": self.max_backlog,
                    "buckets": list(self.runner.buckets),
                    "lane_buckets": list(self.runner.lane_buckets),
                    "shards": self.shards,
                    "pipeline": self.pipeline,
                    "serve_state": self.serve_state,
                    "fused": self._fused,
                    "score": self.score,
                    "rca": self.rca,
                    "native_staging": self.runner.native_stage,
                    "multimodal": self.multimodal,
                    "drain_engine": self.admission.drain_engine,
                    "fold": self.fold_mode,
                    "worker": self.worker_mode,
                    "policy": (self.policy.mode
                               if self.policy is not None else "off"),
                    "async_commit": self.async_commit,
                    "tier_hot": self.tier_hot,
                    "perf": self.perf,
                    "census": self.census,
                    "device": device_name(self.device)},
                 "config": config_snapshot(),
                 "versions": versions(self.device)},
                max_ticks=flight_max_ticks,
                digest_every=flight_digest_every)
            #: the brownout ladder's restore point: level 2 coarsens the
            #: digest cadence 4x, relaxing back to this
            self._flight_digest_base = self.flight_recorder.digest_every
            self._flight_prev_tot = None
            self._flight_prev_legs = None
            self._flight_alert_seen: Dict[int, int] = {}
            self._flight_alert_total = 0
            self._flight_score_crc = 0
            self._flight_rca_seen = 0
            self._flight_rca_crc = 0
        #: scripted serve-plane fault injection (anomod_torch.serve.chaos),
        #: off by default: a script string or a prebuilt ServeChaos
        chaos = app_cfg.serve_chaos if chaos is None else chaos
        if isinstance(chaos, str):
            if chaos.strip():
                from anomod_torch.serve.chaos import ServeChaos
                chaos = ServeChaos(chaos)
            else:
                chaos = None
        self._chaos = chaos
        if self._chaos is not None:
            # a fault aimed at a shard this engine lacks never fires:
            # warned, not refused (`audit replay --shards 1` re-executes a
            # 2-shard chaos journal, whose extra faults are inert); the
            # serve CLI refuses it
            reachable = (self.policy.max_shards
                         if self.policy is not None else self.shards)
            bad = sorted({f.shard for f in self._chaos.faults
                          if f.kind != "surge" and f.shard >= reachable})
            if bad:
                import warnings
                warnings.warn(
                    f"chaos script targets shard(s) {bad} but the "
                    f"engine has {reachable} shard(s) (ids 0.."
                    f"{reachable - 1}); those faults will never "
                    "fire", RuntimeWarning, stacklevel=2)
        #: shard supervision (anomod_torch.serve.supervise), on unless
        #: ckpt_every is 0: cadenced checkpoints and a served-batch log
        #: make a mid-tick shard failure recoverable with no score gap;
        #: the snapshots are pure reads
        self.ckpt_every = int(app_cfg.serve_ckpt_every
                              if ckpt_every is None else ckpt_every)
        if self.ckpt_every < 0:
            raise ValueError("ckpt_every must be >= 0 (0 = supervision "
                             "off)")
        if (mesh is not None or self.multimodal) and self.ckpt_every:
            # the mesh plane's state and the sidecar's modality planes
            # live outside the snapshot seams
            if ckpt_every is not None:
                raise ValueError(
                    "shard supervision cannot checkpoint the "
                    + ("mesh plane's sharded" if mesh is not None
                       else "multimodal sidecar") +
                    " state; run with ckpt_every=0 "
                    "(ANOMOD_SERVE_CKPT_EVERY=0)")
            self.ckpt_every = 0
        self.retries = int(app_cfg.serve_retries if retries is None
                           else retries)
        if self.retries < 1:
            raise ValueError("retries must be >= 1")
        self.retry_backoff_s = float(app_cfg.serve_retry_backoff_s
                                     if retry_backoff_s is None
                                     else retry_backoff_s)
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        self.max_respawns = int(app_cfg.serve_max_respawns
                                if max_respawns is None else max_respawns)
        if self.max_respawns < 0:
            raise ValueError("max_respawns must be >= 0")
        self._supervisor = None
        if self.ckpt_every:
            from anomod_torch.serve.supervise import ShardSupervisor
            self._supervisor = ShardSupervisor(
                self, ckpt_every=self.ckpt_every, retries=self.retries,
                backoff_s=self.retry_backoff_s,
                max_respawns=self.max_respawns)

    def _process_blockers(self) -> List[str]:
        """The planes of this engine that cannot cross a process boundary
        (each keeps state the score plane shares in-process), in the JAX
        engine's order and words."""
        out = []
        if self.mesh is not None:
            out.append("the mesh plane manages its own sharded dispatch")
        if self.multimodal:
            out.append("the multimodal sidecar planes share coordinator "
                       "memory")
        if self.async_commit:
            out.append("the deferred-commit seam keeps folds in flight "
                       "inside one interpreter")
        if self.tier_hot:
            out.append("state tiering's demotion copier reads the pool "
                       "in-process")
        if self.perf:
            out.append("the perf observatory rides the runners in-process")
        if self.census:
            out.append("the census walks resident planes in-process")
        return out

    @property
    def _rca_plane(self):
        """Shard 0's (or the one coordinator) online-RCA plane."""
        return self._rca_planes[0] if self._rca_planes else None

    def _make_rca_plane(self, registry):
        """One online-RCA plane recording into ``registry`` (None: the
        process registry), from the constructor's recipe."""
        from anomod_torch.serve.rca import OnlineRCA, RcaRunner
        kw = self._rca_kw
        return OnlineRCA(self.services, self.cfg.window_us, self.t0_us,
                         RcaRunner(kw["buckets"], registry=registry,
                                   device=self.device),
                         topk=kw["topk"], windows=kw["windows"])

    # -- per-tenant plane construction ------------------------------------

    def _replay_for(self, tenant_id: int):
        got = self._tenant_replay.get(tenant_id)
        if got is None and self.mesh is not None:
            from anomod_torch.parallel.stream import ShardedStreamReplay
            got = self._tenant_replay[tenant_id] = ShardedStreamReplay(
                self.cfg, self.t0_us, self.mesh)
        elif got is None:
            # the tenant's plane rides its shard's runner (its pool slot
            # in device mode)
            runner = self._runners[self.shard_of.get(tenant_id, 0)]
            cls = (PooledStreamReplay if runner.pool is not None
                   else BucketedStreamReplay)
            got = self._tenant_replay[tenant_id] = cls(
                self.cfg, self.t0_us, runner)
        return got

    def _detector_for(self, tenant_id: int) -> OnlineDetector:
        got = self._tenant_det.get(tenant_id)
        if got is None:
            if self.multimodal:
                from anomod_torch.stream import MultimodalDetector
                got = MultimodalDetector(
                    self.services, self.cfg, self.t0_us,
                    testbed=self.testbed,
                    replay=self._replay_for(tenant_id), **self._det_kw)
            else:
                got = OnlineDetector(self.services, self.cfg, self.t0_us,
                                     replay=self._replay_for(tenant_id),
                                     **self._det_kw)
            self._tenant_det[tenant_id] = got
        return got

    # -- the multimodal sidecar --------------------------------------------

    def offer_modality(self, tenant_id: int, kind: str, batch) -> None:
        """Admit a tenant's log / metric / API micro-batch.

        Modality planes are per-window host aggregates, a fraction of
        the span volume: they bypass the weighted-fair span queue and
        push straight into the tenant's ``MultimodalDetector``.  A window
        closes only when a later span is pushed, and queued spans can
        only delay that, so a modality batch admitted on arrival is in
        place before its window scores."""
        if not (self.multimodal and self.score):
            raise ValueError("offer_modality needs multimodal=True and "
                             "score=True")
        det = self._detector_for(tenant_id)
        if kind == "logs":
            n = batch.n_lines
            det.push_logs(batch)
        elif kind == "metrics":
            n = batch.n_samples
            det.push_metrics(batch)
        elif kind == "api":
            n = batch.n_records
            det.push_api(batch)
        else:
            raise ValueError(f"unknown modality kind {kind!r}")
        self.modality_events[kind] = self.modality_events.get(kind, 0) + n

    # -- state tiering (anomod_torch.serve.tiering) -----------------------

    def _tier_gate(self, served: List[QueuedBatch]) -> List[QueuedBatch]:
        """The promotion gate between drain and scoring.  Returns what
        scores this tick: last tick's parked batches first, in park order
        (their tenants' cold reads join here), then this tick's batches,
        less those of a tenant still cold (parked, its read issued, one
        ``tier_miss`` counted a tenant and tick).  A warm tenant promotes
        in place."""
        tier = self._tier
        score_list: List[QueuedBatch] = []
        if self._tier_parked:
            parked, self._tier_parked = self._tier_parked, {}
            for tid, batches in parked.items():
                # a supervised restore may have reinstalled the tenant
                # from a checkpoint: its batches still score
                if tid in tier:
                    self._tier_promote(tid, deferred=True)
                score_list.extend(batches)
        fresh = self._tier_parked
        for qb in served:
            tid = qb.tenant_id
            if tid in fresh:
                fresh[tid].append(qb)
            elif tid not in tier:
                score_list.append(qb)
            elif tier.status(tid) == "warm":
                self._tier_promote(tid, deferred=False)
                score_list.append(qb)
            else:
                tier.prefetch(tid)
                fresh[tid] = [qb]
        for tid, batches in fresh.items():
            tier.miss(self.clock.ticks, tid, len(batches),
                      sum(qb.n_spans for qb in batches))
        return score_list

    def _tier_promote(self, tid: int, deferred: bool) -> None:
        """Re-admit one demoted tenant: its snapshot from the tier (a cold
        entry's read joined), put into a fresh pool slot on the owning
        runner's stream, and the kept detector pointed at the new
        plane."""
        from anomod_torch.serve.supervise import restore_replay
        snap, det = self._tier.take(self.clock.ticks, tid, deferred)
        with self._runners[self.shard_of.get(tid, 0)].on_stream():
            rep = self._replay_for(tid)
            restore_replay(rep, snap)
        if det is not None:
            det.replay = rep
            self._tenant_det[tid] = det

    def _tier_demote_step(self) -> None:
        """Tick-end eviction: while more than ``tier_hot`` tenants are
        pool-resident, demote the coldest residents past
        ``tier_demote_after`` idle ticks, in the census tracker's
        ``coldest_candidates`` order.  A tenant with queued backlog or
        parked batches is skipped (it would promote straight back), so
        every input is coordinator state and the schedule is a function
        of seed and config.  The read-out is one device-to-host copy on
        the owning runner's stream, the slot released after it."""
        resident = self._tenant_replay
        n_over = len(resident) - self.tier_hot
        if n_over <= 0:
            return
        from anomod_torch.serve.supervise import snapshot_replay
        tracker = self._census_tracker
        t_idx = self.clock.ticks
        for tid in tracker.coldest_candidates(t_idx, resident):
            idle = t_idx - tracker.last_served[tid]
            if idle < self.tier_demote_after:
                break                  # coldest first: the rest is hotter
            if (self.admission.tenant_backlog(tid)
                    or tid in self._tier_parked):
                continue
            rep = resident.pop(tid)
            with self._runners[self.shard_of.get(tid, 0)].on_stream():
                snap = snapshot_replay(rep)
                if hasattr(rep, "release"):
                    rep.release()      # hand the pool slot back
            det = self._tenant_det.pop(tid, None)
            self._tier.demote(t_idx, tid, snap, det, idle)
            n_over -= 1
            if n_over <= 0:
                return

    # -- the tick loop ----------------------------------------------------

    def _span(self, name: str, **tags):
        return (self.tracer.span(name, **tags) if self.tracer is not None
                else contextlib.nullcontext())

    def tick(self, arrivals, modality_arrivals=()) -> List[QueuedBatch]:
        """One virtual tick: admit this tick's arrivals (the multimodal
        sidecar's batches first: their windows must be filled before a
        span push can close them), drain up to the tick's capacity budget
        in weighted-fair order, score every drained batch, advance the
        clock.  Returns the served batches.  Under the
        deferred commit the second half is :meth:`_tick_async_tail`: this
        tick's dispatches are issued and the previous tick commits first,
        with the same decisions."""
        t_wall = time.perf_counter()
        now = self.clock.now_s + self.clock.tick_s   # decisions at tick end
        if self._chaos is not None:
            # a scripted surge: a function of the tick index alone, so
            # the amplified arrivals are the same on every rerun
            factor = self._chaos.surge_factor(self.clock.ticks)
            if factor > 1:
                arrivals = [(tid, concat_span_batches([spans] * factor))
                            for tid, spans in arrivals]
        if modality_arrivals:
            with self._span("serve.modality"):
                for tenant_id, kind, batch in modality_arrivals:
                    self.offer_modality(tenant_id, kind, batch)
        with self._span("serve.admit"):
            for tenant_id, spans in arrivals:
                # one shared service table per engine
                if spans.n_spans and spans.services != self.services:
                    raise ValueError(
                        f"tenant {tenant_id} batch carries a different "
                        "service table than the engine's")
                self.admission.offer(tenant_id, spans, now)
        # capacity credit: unused budget banks at most one tick's worth
        budget = self.capacity_spans_per_s * self.clock.tick_s
        self._credit = min(self._credit, 0.0) + budget
        with self._span("serve.drain"):
            served = self.admission.drain(self._credit)
        for qb in served:
            self._credit -= qb.n_spans
        # the residual is physically bounded by one tick's budget above
        # and the widest batch ever served below; clamp it and snap
        # sub-span dust, so float rounding cannot drift the schedule
        for qb in served:
            if qb.n_spans > self._max_served_batch:
                self._max_served_batch = qb.n_spans
        self._credit = min(
            max(self._credit, -max(budget, float(self._max_served_batch))),
            budget)
        if -1e-9 < self._credit < 1e-9:
            self._credit = 0.0
        if self.async_commit:
            # admission, drain and shed above ran while the previous
            # tick's dispatches were in flight
            return self._tick_async_tail(t_wall, now, served)
        # the tiering gate: a demoted tenant is pool-resident before its
        # batches score (warm: at once; cold: parked one tick while its
        # read runs).  Only the scoring list changes: ``served`` feeds
        # SLO, RCA, the journal and the policy below, and parked batches
        # score first next tick, so each tenant's push order is kept
        if self._tier is not None:
            t0 = time.perf_counter()
            with self._span("serve.tier"):
                score_list = self._tier_gate(served)
            self.tier_wall_s += time.perf_counter() - t0
        else:
            score_list = served
        # the recorders' tick stamp, written while the workers are idle
        for rec_ in self._perf_recs:
            rec_.tick = self.clock.ticks
        if score_list:
            sup = self._supervisor
            if sup is not None:
                # the log holds this tick's scoring slices before they
                # score: a failed tick re-executes them
                sup.begin_tick(score_list)
            self._last_failures = None
            try:
                self._score_now(score_list)
            except BaseException as e:
                # an interrupt is the operator stopping the run, never a
                # shard fault; unsupervised, the failure list stays
                # parked for the caller
                if sup is None or not isinstance(e, Exception):
                    raise
                failures = self._last_failures or [(0, e)]
                self._last_failures = None
                with self._span("serve.recover"):
                    sup.recover(failures)
        if self._supervisor is not None:
            # the checkpoint after the commit barrier: nothing is in
            # flight on any shard stream
            self._supervisor.end_tick()
        # SLO accounting after scoring in both paths: the samples depend
        # only on admission times and the tick clock
        for qb in served:
            self._slo[qb.tenant_id].record(now - qb.enqueued_s)
            self.n_spans_served += qb.n_spans
        self._tick_tail(self._tail_ctx(now, served, 0.0), t_wall)
        self._end_tick(t_wall, now)
        return served

    def _tail_ctx(self, now: float, served: List[QueuedBatch],
                  coord_wall: float) -> dict:
        """What a tick's tail (:meth:`_tick_tail`) reads, taken once the
        tick's admission and drain are done: the tick index, admission
        totals and backlog.  The deferred commit keeps it across the
        next tick's admission, which moves the live values."""
        return {"tick": self.clock.ticks, "now": now, "served": served,
                "tot": self.admission.totals(),
                "backlog": self.admission.backlog_spans,
                "coord_wall": coord_wall}

    def _tick_tail(self, d: dict, t_from: float) -> None:
        """A tick's tail once its folds have committed, in one order for
        the synchronous tick and the deferred commit's barrier: RCA, the
        perf drain, the census, the journal record, the policy step, then
        tier demotion.  ``d`` is :meth:`_tail_ctx`'s context; the journal's
        wall is ``d["coord_wall"]`` plus the time since ``t_from``."""
        now, served = d["now"], d["served"]
        if self.rca:
            self._rca_step(now, served)
        if self.perf:
            # inside the measured wall: the recorder's cost is priced
            self._perf_tick_doc = self._perf_drain()
        if self._census_tracker is not None:
            # hot-set bookkeeping every tick, the census drain on its
            # cadence (after the perf drain, so the retentions it counts
            # are this tick's); without the census the tracker is
            # tiering's demotion input and its wall tiering's
            t0 = time.perf_counter()
            self._census_tracker.observe(d["tick"], served)
            if self.census and self._census_tracker.due(d["tick"]):
                self._census_tick_doc = self._census_drain(d["tick"])
            if self.census:
                self.census_wall_s += time.perf_counter() - t0
            else:
                self.tier_wall_s += time.perf_counter() - t0
        if self.flight_recorder is not None:
            # the journal entry rides inside the measured wall: the
            # recorder's cost is priced, never hidden
            self._flight_tick(now, served,
                              d["coord_wall"]
                              + (time.perf_counter() - t_from),
                              t_idx=d["tick"], tot=d["tot"])
        if self.policy is not None:
            # after the journal record (a scale-down must not retire a
            # runner whose deltas are not journaled yet); its events ride
            # the next record's ``scaling`` key, its wall the tick's
            t0 = time.perf_counter()
            with self._span("serve.policy"):
                self._policy_step(served, d["tick"], d["backlog"],
                                  d["tot"].shed_spans)
            self.policy_wall_s += time.perf_counter() - t0
        if self._tier is not None:
            # demotion at the tick end, after the journal record and the
            # policy step; its events ride the next record's ``tiering``
            t0 = time.perf_counter()
            with self._span("serve.tier_demote"):
                self._tier_demote_step()
            self.tier_wall_s += time.perf_counter() - t0

    def _score_now(self, score_list: List[QueuedBatch]) -> None:
        """Score a tick's slices synchronously on the engine's path."""
        if self._use_workers:
            with self._span("serve.score_sharded"):
                self._score_sharded(score_list)
        elif self._fused:
            with self._span("serve.score_fused"):
                self._score_fused(score_list)
        else:
            self._score_shard(0, score_list)

    def _end_tick(self, t_wall: float, now: float) -> None:
        """Advance the clock and record the tick's telemetry, inside the
        measured wall (the on/off overhead prices the scrape)."""
        self.clock.advance()
        self._obs_tick.observe(time.perf_counter() - t_wall)
        self._obs_ticks.inc()
        self._obs_tenants.set(len(self._tenant_det)
                              or len(self._tenant_replay))
        if self.clock.ticks % self._scrape_every == 0:
            self._registry.scrape(now_s=now)
        t_tick = time.perf_counter() - t_wall
        self.serve_wall_s += t_tick
        self.tick_walls.append(t_tick)

    # -- the deferred-commit tick ------------------------------------------

    def _tick_async_tail(self, t_wall: float, now: float,
                         served: List[QueuedBatch]) -> List[QueuedBatch]:
        """The second half of a deferred-commit tick.

        1. SLO first: its samples are functions of admission times and
           the tick clock, recorded in the same order.
        2. The barrier (:meth:`_commit_deferred`): the previous tick's
           dispatches ran under this tick's admission, drain, shed and
           SLO; they commit now, then that tick's RCA, journal record and
           policy step run on its snapshotted inputs.  The barrier comes
           before this tick's issue, so no pinned scratch slot is
           refilled under a dispatch still in flight.
        3. Issue: this tick's lane dispatches are staged and submitted on
           the shard streams, not drained.  The unfused path has no seam
           to split and scores in place.
        4. The tail's context (:meth:`_tail_ctx`) is taken now.

        Stage and dispatch faults surface at issue, as in the synchronous
        tick; fold, score and commit faults at the barrier, keyed and
        recovered on their origin tick.  A checkpoint tick commits at
        once, so the snapshot holds its folds."""
        for qb in served:
            self._slo[qb.tenant_id].record(now - qb.enqueued_s)
            self.n_spans_served += qb.n_spans
        self._commit_deferred()
        # the recorders' tick stamp, after the barrier joined the workers
        for rec_ in self._perf_recs:
            rec_.tick = self.clock.ticks
        pending = None
        sup = self._supervisor
        if served:
            if sup is not None:
                sup.begin_tick(served)
            self._last_failures = None
            try:
                if self._fused:
                    pending = self._dispatch_tick(served)
                else:
                    self._score_now(served)
            except BaseException as e:
                if sup is None or not isinstance(e, Exception):
                    raise
                failures = self._last_failures or [(0, e)]
                self._last_failures = None
                with self._span("serve.recover"):
                    sup.recover(failures)
                # recovery re-executed the tick synchronously
                pending = None
        t_issue = time.perf_counter()
        self._deferred = dict(self._tail_ctx(now, served, t_issue - t_wall),
                              pending=pending, t_issue=t_issue)
        self.async_ticks += 1
        if sup is not None and (self.clock.ticks + 1) % self.ckpt_every == 0:
            # end_tick checkpoints on this cadence: commit first, so the
            # snapshot holds this tick's folds
            self._commit_deferred()
        if sup is not None:
            sup.end_tick()
        self._end_tick(t_wall, now)
        return served

    def _commit_deferred(self) -> None:
        """The deferred tick's barrier (a no-op when nothing is deferred):
        drain, fold and score its dispatches, then run its tail
        (:meth:`_tick_tail`) on the context taken at issue.  The policy
        runs here, not at issue, so a scale-down never retires a runner
        with work in flight."""
        d = self._deferred
        if d is None:
            return
        self._deferred = None
        t_barrier = time.perf_counter()
        pending = d["pending"]
        if pending is not None and any(pending):
            self.commit_defer_wall_s += max(0.0, t_barrier - d["t_issue"])
            if self.perf:
                for r in self._runners:
                    r.mark_deferred(d["t_issue"], t_barrier)
            sup = self._supervisor
            self._last_failures = None
            try:
                if self._use_workers:
                    self._join_commits(pending, d["tick"])
                else:
                    self._commit_shard(0, pending[0], d["tick"])
            except BaseException as e:
                if sup is None or not isinstance(e, Exception):
                    raise
                failures = self._last_failures or [(0, e)]
                self._last_failures = None
                with self._span("serve.recover"):
                    sup.recover(failures, origin_tick=d["tick"])
        self._tick_tail(d, t_barrier)

    def _dispatch_tick(self, served: List[QueuedBatch]) -> list:
        """The issue half of a fused tick: every shard stages and submits
        its lane dispatches under its runner's stream, WITHOUT waiting for
        them; returns the per-shard pending work lists the barrier
        completes.  Shard registries fold at the join; a failure list is
        parked for the supervisor and the first failure raised."""
        origin = self.clock.ticks
        if not self._use_workers:
            with self._span("serve.issue_tick"):
                return [self._dispatch_shard(0, served, origin)]
        parts: Dict[int, List[QueuedBatch]] = {}
        for qb in served:
            parts.setdefault(self.shard_of[qb.tenant_id], []).append(qb)
        pending: list = [None] * self.shards

        def issue(s: int, part: List[QueuedBatch]) -> None:
            pending[s] = self._dispatch_shard(s, part, origin)

        with self._span("serve.issue_tick"):
            failures = self._fan_out({s: (issue, s, part)
                                      for s, part in parts.items()},
                                     sync=False)
        if failures:
            self._last_failures = failures
            raise failures[0][1]
        return pending

    def _dispatch_shard(self, shard_id: int, served: List[QueuedBatch],
                        origin_tick: int) -> list:
        """One shard's stage and submit with the drain deferred; the
        chaos ``stage`` and ``dispatch`` points fire here, at issue, as in
        :meth:`_score_shard`."""
        hook = self._chaos_hook(shard_id, origin_tick)
        if hook is not None:
            hook("stage")
        with self._span("serve.dispatch_shard", shard=shard_id,
                        pipeline=self.pipeline):
            pending = self._stage_pending(served)
            self._dispatch_rounds(pending, self._runners[shard_id],
                                  chaos_hook=hook, defer=True)
        return pending

    def _commit_shard(self, shard_id: int, pending: list,
                      origin_tick: int) -> None:
        """One shard's barrier: drain the deferred dispatches (the wait
        the deferral hides; a failure discards them unfolded), then the
        window scoring.  The chaos ``fold``, ``score`` and ``commit``
        points fire here, keyed on the origin tick."""
        runner = self._runners[shard_id]
        hook = self._chaos_hook(shard_id, origin_tick)
        try:
            with self._span("serve.commit_shard", shard=shard_id):
                runner.drain_lanes()
        except BaseException:
            runner.abort_lanes()
            raise
        if hook is not None:
            hook("fold")
        self._commit_pending(pending, runner, chaos_hook=hook)
        if hook is not None:
            hook("commit")

    def _join_commits(self, pending: list, origin_tick: int) -> None:
        """The barrier on thread shards: each shard with deferred work
        commits on its worker under its stream, synced before the join;
        registries fold, a failure list is parked and the first raised."""
        failures = self._fan_out({
            s: (self._commit_shard, s, work, origin_tick)
            for s, work in enumerate(pending) if work})
        if failures:
            self._last_failures = failures
            raise failures[0][1]

    def _chaos_hook(self, shard_id: int, tick: Optional[int]):
        """The chaos injector's hook for one shard's slice of ``tick``
        (the clock's tick when None), or None without a script."""
        chaos = self._chaos
        if chaos is None:
            return None
        tick = self.clock.ticks if tick is None else tick

        def hook(phase):
            chaos.hit(phase, tick, shard_id)
        return hook

    def _score_fused(self, served: List[QueuedBatch]) -> None:
        """Tenant-fused scoring of one tick's drained batches on the
        inline engine: :meth:`_score_shard` on shard 0, so the inline and
        sharded engines share one definition."""
        self._score_shard(0, served)

    def _score_shard(self, shard_id: int, served: List[QueuedBatch],
                     origin_tick: Optional[int] = None) -> None:
        """One shard's slice of one tick's served batches (on its worker
        thread in the sharded engine, inline on the 1-shard engine, in
        the child of a process worker, and as the supervisor's
        re-execution entry, where ``origin_tick`` names the tick the
        slice was drained on: the chaos hooks key on it).  Fused:
        coalesce and plan (host), lane-stacked dispatches per chunk round
        through the shard's runner, then batched window scoring (the
        commit).  Unfused: one push per batch, in served order."""
        runner = self._runners[shard_id]
        hook = self._chaos_hook(shard_id, origin_tick)
        if hook is not None:
            hook("stage")
        if self._fused:
            with self._span("serve.score_shard", shard=shard_id,
                            pipeline=self.pipeline):
                pending = self._stage_pending(served)
                self._dispatch_rounds(pending, runner, chaos_hook=hook)
                if hook is not None:
                    hook("fold")
                self._commit_pending(pending, runner, chaos_hook=hook)
            if hook is not None:
                hook("commit")
            return
        # the unfused path has two real boundaries: the phases collapse
        # onto them (dispatch before the pushes, the rest after), so
        # every scripted fault still fires
        if hook is not None:
            hook("dispatch")
        for qb in served:
            with self._span("serve.score"):
                if self.score:
                    self._detector_for(qb.tenant_id).push(qb.spans)
                else:
                    self._replay_for(qb.tenant_id).push(qb.spans)
        if hook is not None:
            hook("fold")
            hook("score")
            hook("commit")

    def _stage_pending(self, served: List[QueuedBatch]) -> list:
        """Same-tenant batches concatenate in arrival order into one
        staging; returns the ordered ``(det, replay, n_spans, w_ret,
        plan)`` work list."""
        per_tenant: Dict[int, List[QueuedBatch]] = {}
        for qb in served:
            per_tenant.setdefault(qb.tenant_id, []).append(qb)
        pending = []
        for tid, qbs in per_tenant.items():
            batch = qbs[0].spans if len(qbs) == 1 else \
                concat_span_batches([qb.spans for qb in qbs])
            if self.score:
                det = self._detector_for(tid)
                replay = det.replay
            else:
                det = None
                replay = self._replay_for(tid)
            t0 = time.perf_counter()
            rb = det.replay_batch(batch) if det is not None else batch
            w_ret, plan = replay.plan_push(rb)
            if det is not None:
                det.push_wall_s += time.perf_counter() - t0
            pending.append((det, replay, batch.n_spans, w_ret, plan))
        return pending

    def _dispatch_rounds(self, pending: list, runner: BucketRunner,
                         chaos_hook=None, defer: bool = False) -> None:
        """Per chunk round (a tenant's own chunks apply in order),
        same-width chunks lane-stack into fused dispatches through the
        runner's pipelined submit path, drained before scoring unless
        ``defer`` (the deferred commit's issue half: up to ``pipeline -
        1`` dispatches stay in the runner's in-flight queue for the
        barrier's drain).  The chaos ``dispatch`` point fires after the
        submits, with up to ``pipeline - 1`` dispatches in flight.  A
        failure discards the in-flight dispatches unfolded."""
        try:
            rnd = 0
            while True:
                groups: Dict[int, List[int]] = {}
                for i, (_, _, _, _, plan) in enumerate(pending):
                    if rnd < len(plan):
                        groups.setdefault(plan[rnd][0], []).append(i)
                if not groups:
                    break
                for width in sorted(groups):
                    runner.submit_lanes(
                        width, [(pending[i][1], pending[i][4][rnd][1])
                                for i in groups[width]])
                rnd += 1
            if chaos_hook is not None:
                chaos_hook("dispatch")
            if not defer:
                runner.drain_lanes()
        except BaseException:
            runner.abort_lanes()
            raise

    def _commit_pending(self, pending: list, runner: BucketRunner,
                        chaos_hook=None) -> None:
        """Per tenant, the detector's post-replay half: window
        bookkeeping, then every newly closed window of every tenant
        scored in one vectorized pass per window, fed by one pool
        gather.  The chaos ``score`` point fires between the two.  The
        wall lands in the runner's ``score`` leg."""
        t0 = time.perf_counter()
        work = []
        for det, _, n_in, w_ret, _ in pending:
            if det is None:
                continue
            if det.batch_scorable:
                through = det.note_bookkeep(n_in, w_ret)
                rng = (det.scoring_window_range(through)
                       if through is not None else None)
                if rng is not None:
                    work.append((det, rng[0], rng[1]))
            else:
                det.note_pushed(n_in, w_ret)
        if chaos_hook is not None:
            chaos_hook("score")
        if work:
            score_closed_windows_batched(work, _plane_col_gather(work))
        runner.add_score_wall(time.perf_counter() - t0)

    # -- the sharded score path (anomod_torch.serve.shard / procshard) ----

    def _on_shard(self, shard_id: int, fn, *args,
                  sync: bool = True) -> None:
        """Run ``fn(*args)`` as shard ``shard_id``'s work: under its
        runner's stream, which it waits for before returning (failed or
        not), so the coordinator reads nothing the shard still has in
        flight.  ``sync=False`` is the deferred commit's issue half: the
        launches stay in flight, their events in the runner's queue,
        until the barrier's drain."""
        runner = self._runners[shard_id]
        with runner.on_stream():
            if not sync:
                fn(*args)
                return
            try:
                fn(*args)
            finally:
                runner.sync()

    def _make_worker(self, s: int):
        """One shard worker of the engine's kind: the one construction
        point of the engine and of the supervisor's respawn."""
        if self.worker_mode == "process":
            from anomod_torch.serve.procshard import ProcShardWorker
            return ProcShardWorker(
                s, self._procshard_init(s),
                start_timeout_s=self._worker_start_timeout_s)
        from anomod_torch.serve.shard import ShardWorker
        return ShardWorker(s)

    def _procshard_init(self, s: int) -> dict:
        """Shard ``s``'s child's init payload: every knob of its 1-shard
        sub-engine, resolved here (the child never re-reads its
        environment, the device included)."""
        import torch
        r = self._runners[s]
        return {"shard_id": s,
                "specs": [spec for spec in self.specs
                          if self.shard_of.get(spec.tenant_id, 0) == s],
                "services": self.services, "cfg": self.cfg,
                "t0_us": self.t0_us,
                "capacity_spans_per_s": self.capacity_spans_per_s,
                "tick_s": self.clock.tick_s, "buckets": tuple(r.buckets),
                "lane_buckets": tuple(r.lane_buckets),
                "max_backlog": self.max_backlog, "score": self.score,
                "fuse": self.fuse, "pipeline": self.pipeline,
                "native": bool(r.native_stage), "state": self.serve_state,
                "drain_engine": self.admission.drain_engine,
                "det_kw": dict(self._det_kw), "device": str(self.device),
                "torch_threads": torch.get_num_threads(),
                "registry_enabled": bool(self._proc_registry.enabled),
                "chaos_script": (self._chaos.script
                                 if self._chaos is not None else None),
                "chaos_fired": self._chaos_fired.get(s)}

    def _prepare_children(self) -> None:
        """Build what the children load before any is spawned: the C++
        host entries and, on the card, the serve kernels, so the
        children only open the libraries."""
        if self.runner.native_stage:
            from anomod_torch.io import native
            native.library()
        if self.device.type == "cuda":
            from anomod_torch.ops import _build
            _build.build(["serve"])

    def _ensure_workers(self) -> None:
        if self._workers is not None and all(w.alive for w in self._workers):
            return
        if self.worker_mode == "process":
            if self._workers is None:
                self._prepare_children()
                from anomod_torch.serve.procshard import start_workers
                t0 = time.perf_counter()
                self._workers = start_workers(
                    [(s, self._procshard_init(s))
                     for s in range(self.shards)],
                    self._worker_start_timeout_s)
                self.worker_start_s += time.perf_counter() - t0
                return
            # replace only the dead children: a live one holds its
            # shard's states (a respawned child starts empty; the
            # supervisor restores it, an unsupervised engine has lost
            # that shard's states)
            for s, w in enumerate(self._workers):
                if not w.alive:
                    w.close()
                    self._workers[s] = self._make_worker(s)
            return
        if self._workers is not None:
            self._close_workers()
        self._workers = [self._make_worker(s) for s in range(self.shards)]

    def _fan_out(self, tasks: Dict[int, tuple], sync: bool = True) -> list:
        """Submit ``{shard: (fn, *args)}`` to the shard worker threads and
        join them all (the barrier completes before any error
        propagates), then fold the shard registries.  Returns ``[(shard,
        exc), ...]`` in shard order.  ``sync`` as :meth:`_on_shard`."""
        self._ensure_workers()
        submitted = []
        for s, task in sorted(tasks.items()):
            self._workers[s].submit(partial(self._on_shard, s, *task,
                                            sync=sync))
            submitted.append(s)
        failures = []
        for s in submitted:
            try:
                self._workers[s].join()
            except BaseException as e:    # noqa: BLE001 - re-raised below
                failures.append((s, e))
        self._fold_shard_registries()
        return failures

    def _score_sharded(self, served: List[QueuedBatch]) -> None:
        """Fan one tick's drained batches out to the shard workers by
        tenant ownership and join at the barrier.  Each worker scores
        only the tenants it owns, through its own runner, so per-tenant
        results equal the 1-shard engine's.  A failed shard fails the
        tick: the failure list is parked in ``_last_failures`` (the
        supervisor recovers each) and the first failure re-raises."""
        parts: Dict[int, List[QueuedBatch]] = {}
        for qb in served:
            parts.setdefault(self.shard_of[qb.tenant_id], []).append(qb)
        if self.worker_mode == "process":
            failures = self._submit_parts_proc(parts)
        else:
            failures = self._fan_out({s: (self._score_shard, s, part)
                                      for s, part in parts.items()})
        if failures:
            self._last_failures = failures
            raise failures[0][1]

    def _submit_parts_proc(self, parts: Dict[int, List[QueuedBatch]],
                           origin_tick: Optional[int] = None) -> list:
        """The process barrier: every ``score`` command is sent before
        any reply is read (the children overlap), then the replies are
        read in shard order.  Each reply's mirror, alert and registry
        payloads fold whether or not its slice succeeded; a shipped
        error is rebuilt as the exception the thread worker raises.
        Returns ``[(shard, exc), ...]`` in shard order."""
        from anomod_torch.serve.procshard import rebuild_exc
        self._ensure_workers()
        tick = self.clock.ticks if origin_tick is None else origin_tick
        sent = []
        for s in sorted(parts):
            try:
                self._workers[s].send({"op": "score", "served": parts[s],
                                       "origin_tick": tick,
                                       "fold": self.fold_mode})
                sent.append((s, None))
            except BaseException as e:          # noqa: BLE001
                sent.append((s, e))
        failures, deltas = [], []
        for s, send_err in sent:
            if send_err is not None:
                failures.append((s, send_err))
                continue
            try:
                rep = self._workers[s].recv()
            except BaseException as e:          # noqa: BLE001
                failures.append((s, e))
                continue
            self._apply_shard_reply(s, rep)
            if rep.get("reg_delta") is not None:
                deltas.append((s, rep["reg_delta"]))
            if rep.get("error") is not None:
                failures.append((s, rebuild_exc(rep["error"])))
        self._fold_shard_registries(deltas=deltas)
        return failures

    def _apply_shard_reply(self, s: int, rep: dict) -> None:
        """Fold one child reply into the coordinator's mirrors: the
        runner book and walls, newly resident tenants, the alert suffixes,
        the chaos fired counts and the child's kernel launches.  Registry
        deltas go through :meth:`_fold_shard_registries`."""
        from anomod_torch.serve.procshard import DetMirror
        if "book" in rep:
            self._runners[s].apply(rep)
        for tid in rep.get("resident_new", ()):
            # a residency stub: the state lives in the child
            self._tenant_replay.setdefault(tid, None)
        for tid in rep.get("det_new", ()):
            if tid not in self._tenant_det:
                self._tenant_det[tid] = DetMirror()
        for tid, base, new in rep.get("alerts", ()):
            det = self._tenant_det.get(tid)
            if det is None:
                det = self._tenant_det[tid] = DetMirror()
            del det.alerts[base:]
            det.alerts.extend(new)
        if rep.get("chaos_fired") is not None:
            self._chaos_fired[s] = list(rep["chaos_fired"])
        for k, n in rep.get("launches", {}).items():
            self.worker_launches[k] = self.worker_launches.get(k, 0) + n

    def _fold_shard_registries(self, final: bool = False,
                               deltas: Optional[list] = None) -> None:
        """The barrier's registry merge: each shard's delta since the last
        fold (``delta_snapshot`` of a thread shard's registry, or handed
        in from a child's reply), combined through the deterministic fold
        tree in shard order and applied to the process registry
        (``apply_delta``, gauges shard-labelled); the payload's
        structural bytes are counted."""
        from anomod_torch.obs.registry import delta_nbytes
        from anomod_torch.serve.shard import fold_tree
        if deltas is None:
            deltas = [(s, reg.delta_snapshot(self._fold_state[s],
                                             mode=self.fold_mode,
                                             final=final))
                      for s, reg in enumerate(self._shard_regs)]
        merged = fold_tree([[(s, d)] for s, d in deltas if d is not None],
                           lambda a, b: a + b)
        if not merged:
            return
        nbytes = 0
        for s, d in merged:
            self._proc_registry.apply_delta(d, shard=str(s))
            nbytes += delta_nbytes(d)
        self.fold_payload_bytes += nbytes
        if self._obs_fold_payload is not None and nbytes:
            self._obs_fold_payload.inc(nbytes)

    # -- the supervisor's process-mode seams (the states live in the
    # -- children) -----------------------------------------------------------

    def _snapshot_tenants_proc(self) -> dict:
        """The checkpoint over the pipes: each live child runs the same
        snapshot seams over its tenants and ships ``tid -> (replay_snap,
        det_snap)``; a dead child's tenants are absent."""
        tenants: dict = {}
        for w in self._workers or ():
            if not w.alive:
                continue
            try:
                tenants.update(w.call({"op": "snapshot"})["tenants"])
            except RuntimeError:
                continue
        return tenants

    def _drop_shard_proc(self, s: int) -> None:
        """The restore's teardown, process kind: clear shard ``s``'s stubs
        and alert mirrors, and tell a listening child to drop its
        planes (a respawned child is empty already)."""
        for tid in [t for t in list(self._tenant_replay)
                    if self.shard_of.get(t, 0) == s]:
            self._tenant_replay.pop(tid, None)
            self._tenant_det.pop(tid, None)
        if self._workers is not None and self._workers[s].alive:
            try:
                self._workers[s].call({"op": "drop"})
            except RuntimeError:
                pass

    def _restore_book(self, s: int, book: dict) -> None:
        """Install a checkpoint's runner book on shard ``s``: on its
        runner, and with process workers on the mirror and the child's
        live runner too, so re-executed slices count from the checkpoint
        where the dispatches happen."""
        self._runners[s].book_restore(book)
        if (self.worker_mode == "process" and self._workers is not None
                and self._workers[s].alive):
            try:
                self._workers[s].call({"op": "book_restore", "book": book})
            except RuntimeError:
                pass

    def _install_tenant_proc(self, tid: int, snap: tuple) -> None:
        """Reinstall one checkpointed tenant into its owning child and
        rewind the coordinator's alert mirror to the checkpoint."""
        from anomod_torch.serve.procshard import DetMirror
        rep_snap, det_snap = snap
        s = self.shard_of.get(tid, 0)
        self._ensure_workers()
        rep = self._workers[s].call({"op": "install_tenant", "tid": tid,
                                     "replay": rep_snap, "det": det_snap})
        self._apply_shard_reply(s, rep)
        self._tenant_replay.setdefault(tid, None)
        if det_snap is not None:
            det = self._tenant_det.get(tid)
            if det is None:
                det = self._tenant_det[tid] = DetMirror()
            det.alerts[:] = list(det_snap.get("alerts", ()))

    def _exec_slice_proc(self, s: int, slice_: list, tick: int) -> None:
        """Re-execute one logged slice in shard ``s``'s child (the chaos
        hooks key on ``tick``, its origin); a shipped failure raises here
        so the recovery loop charges the slice."""
        from anomod_torch.serve.procshard import rebuild_exc
        w = self._workers[s]
        w.send({"op": "score", "served": slice_, "origin_tick": tick,
                "fold": self.fold_mode})
        rep = w.recv()
        self._apply_shard_reply(s, rep)
        if rep.get("reg_delta") is not None:
            self._fold_shard_registries(deltas=[(s, rep["reg_delta"])])
        if rep.get("error") is not None:
            raise rebuild_exc(rep["error"])

    def _warm_proc(self) -> None:
        """First launches in the children, outside the wall: shard 0
        alone, then the others together (every send before any read).
        The replies carry each child's first-launch walls."""
        from anomod_torch.serve.procshard import rebuild_exc
        self._ensure_workers()
        reps: List[Optional[dict]] = [None] * self.shards
        for group in ([0], range(1, self.shards)):
            for s in group:
                self._workers[s].send({"op": "warm"})
            for s in group:
                reps[s] = self._workers[s].recv()
        for s, rep in enumerate(reps):
            self._apply_shard_reply(s, rep)
        for rep in reps:
            if rep.get("error") is not None:
                raise rebuild_exc(rep["error"])

    def _finish_proc(self) -> None:
        """``finish()`` of every child's detectors over the pipes; the
        replies carry the last windows' alerts and registry deltas.  A
        dead child (crashed, unsupervised) is skipped: its detectors died
        with it."""
        from anomod_torch.serve.procshard import rebuild_exc
        sent = []
        for s, w in enumerate(self._workers or ()):
            if not w.alive:
                continue
            try:
                w.send({"op": "finish", "fold": self.fold_mode})
                sent.append((s, w))
            except RuntimeError:
                continue
        deltas, first_err = [], None
        for s, w in sent:
            try:
                rep = w.recv()
            except RuntimeError:
                continue
            self._apply_shard_reply(s, rep)
            if rep.get("reg_delta") is not None:
                deltas.append((s, rep["reg_delta"]))
            if rep.get("error") is not None and first_err is None:
                first_err = rebuild_exc(rep["error"])
        self._fold_shard_registries(deltas=deltas)
        if first_err is not None:
            raise first_err

    def _final_fold_proc(self) -> None:
        """The run-end registry drain over the pipes (final folds)."""
        deltas = []
        for s, w in enumerate(self._workers or ()):
            if not w.alive:
                continue
            try:
                rep = w.call({"op": "reg_delta", "fold": self.fold_mode,
                              "final": True})
            except RuntimeError:
                continue
            if rep.get("delta") is not None:
                deltas.append((s, rep["delta"]))
        self._fold_shard_registries(deltas=deltas, final=True)

    def _state_digest_proc(self) -> int:
        """The state digest with the states in the children: each live
        child ships ``(tid, crc, len)`` fragments of its tenants, folded
        here in global sorted-tenant order through ``crc32_combine``, so
        it equals the sequential walk of a thread engine."""
        from anomod_torch.obs.flight import fold_digest_parts
        parts = []
        for w in self._workers or ():
            if not w.alive:
                continue
            try:
                parts.extend(w.call({"op": "digest"})["parts"])
            except RuntimeError:
                continue
        return fold_digest_parts(parts)

    def _warm_shard(self, shard_id: int) -> None:
        runner = self._runners[shard_id]
        runner.warm()
        if self.fuse:
            runner.warm_lanes()
        if self.rca:
            self._rca_planes[shard_id].runner.warm()

    def close(self) -> None:
        """Stop the shard workers and the tier's prefetch lane
        (idempotent; the next sharded tick starts the workers again).  A
        deferred tick not yet committed is aborted: its dispatches are
        waited for and never folded (``run`` always commits first).
        Every worker closes before a deferred task error propagates."""
        if self._deferred is not None:
            self._deferred = None
            for r in self._runners:
                with r.on_stream():
                    r.abort_lanes()
        if self._tier is not None:
            self._tier.close()
        self._close_workers()

    def _close_workers(self) -> None:
        workers, self._workers = self._workers or [], None
        errs = []
        for w in workers:
            try:
                w.close()
            except BaseException as e:    # noqa: BLE001 - re-raised below
                errs.append(e)
        if errs:
            raise errs[0]

    # -- the elastic policy (anomod_torch.serve.policy) --------------------

    def _policy_step(self, served: List[QueuedBatch], tick: int,
                     backlog_spans: int, shed_spans: int) -> None:
        """One tick-end policy evaluation on the coordinator: fold the
        tick's canonical signals (served spans, the runners' staged-chunk
        books, backlog, shed, never a wall) into the EWMAs, execute the
        decisions through the migration seams, journal what ran.
        ``tick``, ``backlog_spans`` and ``shed_spans`` are taken at the
        origin tick (:meth:`_tail_ctx`), so the schedule does not depend
        on the deferral."""
        from anomod_torch.serve.policy import TickSignals
        served_by_tenant: Dict[int, int] = {}
        for qb in served:
            served_by_tenant[qb.tenant_id] = \
                served_by_tenant.get(qb.tenant_id, 0) + qb.n_spans
        chunks = [r.n_dispatches for r in self._runners]
        # re-read after every topology change below, so never stale
        prev = self._policy_prev_chunks or [0] * len(chunks)
        self.policy.observe(TickSignals(
            tick=tick, served_by_tenant=served_by_tenant,
            per_shard_chunks=[c - p for c, p in zip(chunks, prev)],
            backlog_spans=backlog_spans, max_backlog=self.max_backlog,
            shed_delta=shed_spans - self._policy_prev_shed,
            budget_spans=self.capacity_spans_per_s * self.clock.tick_s))
        self._policy_prev_shed = shed_spans
        topology_changed = False
        for d in self.policy.decide(tick, self.shards):
            topology_changed |= self._execute_decision(d, tick)
        if topology_changed and self._supervisor is not None:
            # the recovery log never spans a topology change
            self._supervisor.note_topology_change()
        self._policy_prev_chunks = [r.n_dispatches for r in self._runners]
        if self.flight_recorder is None and self._policy_events:
            # no journal drains them: the counters carry the story
            self._policy_events.clear()

    def _execute_decision(self, d: dict, tick: int) -> bool:
        """Execute one decision against the live envelope; returns
        whether the shard set changed.  A decision the envelope refuses
        is journaled as skipped, never counted."""
        pol = self.policy
        act = d["action"]
        if act == "up":
            if self.shards >= pol.max_shards:
                self._policy_events.append(
                    {"kind": "scale_up", "tick": tick,
                     "skipped": f"at max_shards={pol.max_shards}"})
                return False
            moved = self._scale_up()
            self._peak_shards = max(self._peak_shards, self.shards)
            self._policy_events.append(
                {"kind": "scale_up", "tick": tick,
                 "from": self.shards - 1, "to": self.shards,
                 "tenants": len(moved), "moved": moved})
            pol.note_executed("up", tick, migrated=len(moved),
                              shards=self.shards)
            return True
        if act == "down":
            if self.shards <= pol.min_shards:
                self._policy_events.append(
                    {"kind": "scale_down", "tick": tick,
                     "skipped": f"at min_shards={pol.min_shards}"})
                return False
            moved = self._scale_down()
            self._policy_events.append(
                {"kind": "scale_down", "tick": tick,
                 "from": self.shards + 1, "to": self.shards,
                 "tenants": len(moved), "moved": moved})
            pol.note_executed("down", tick, migrated=len(moved),
                              shards=self.shards)
            return True
        if act == "rebalance":
            from anomod_torch.serve.policy import plan_rebalance
            dead = (self._supervisor.dead_shards
                    if self._supervisor is not None else ())
            moves = plan_rebalance(self.shard_of, self.shards, self.specs,
                                   pol.rate_ewma, self.capacity_spans_per_s,
                                   int(d.get("k", 1)), dead=dead)
            if not moves:
                pol.note_noop(tick)
                self._policy_events.append(
                    {"kind": "rebalance", "tick": tick,
                     "skipped": "already balanced"})
                return False
            imb_before = pol.imbalance()
            for tid, dst in moves:
                self._move_tenant(tid, dst)
            self._policy_events.append(
                {"kind": "rebalance", "tick": tick, "tenants": len(moves),
                 "moved": [t for t, _ in moves],
                 "imbalance_ewma": round(imb_before, 4)})
            pol.note_executed("rebalance", tick, migrated=len(moves))
            return True
        # brownout: the RCA budget at level >= 1 (applied at the
        # _rca_tick call), the digest cadence at level >= 2 (here)
        from anomod_torch.serve.policy import MAX_BROWNOUT_LEVEL
        level = max(0, min(int(d.get("level", 1)), MAX_BROWNOUT_LEVEL))
        prev = pol.brownout_level
        if level == prev:
            self._policy_events.append(
                {"kind": "brownout", "tick": tick,
                 "skipped": f"already at level {prev}"})
            return False
        fr = self.flight_recorder
        if fr is not None:
            fr.digest_every = (self._flight_digest_base * 4 if level >= 2
                               else self._flight_digest_base)
        self._policy_events.append(
            {"kind": "brownout", "tick": tick, "from": prev, "to": level})
        pol.note_executed("brownout", tick, level=level)
        return False

    def _scale_up(self) -> List[int]:
        """Grow the shard set by one and migrate the rendezvous delta:
        only the tenants the new shard wins under the grown set move.  A
        thread shard gets a new runner (its own stream, pool and
        registry), RCA plane and worker, warmed on that worker inside the
        tick wall; a process shard a runner mirror and a spawned child,
        warmed the same way.  Returns the moved tenant ids."""
        from anomod_torch.serve.shard import rendezvous_shard
        s = self.shards
        moved = [tid for tid in sorted(self.shard_of)
                 if rendezvous_shard(tid, s + 1) == s]
        if self.worker_mode == "process":
            from anomod_torch.serve.procshard import RunnerMirror
            self._runners.append(RunnerMirror(self.cfg, self._buckets_arg,
                                              **self._runner_kw))
            self.shards = s + 1
            if self._workers is not None:
                w = self._make_worker(s)
                self._workers.append(w)
                self._apply_shard_reply(s, w.call({"op": "warm"}))
        else:
            reg = obs.Registry(enabled=self._proc_registry.enabled)
            prec = None
            if self.perf:
                from anomod_torch.obs.perf import PerfRecorder
                prec = PerfRecorder(s)
                prec.tick = self.clock.ticks
                self._perf_recs.append(prec)
            self._runners.append(BucketRunner(
                self.cfg, self._buckets_arg, registry=reg,
                pool_slots=max(len(moved), 1), own_stream=True, perf=prec,
                **self._runner_kw))
            self._shard_regs.append(reg)
            self._fold_state.append(dict())
            if self.rca:
                self._rca_planes.append(self._make_rca_plane(reg))
            self.shards = s + 1
            if self._workers is not None:
                self._workers.append(self._make_worker(s))
                self._workers[s].submit(partial(self._on_shard, s,
                                                self._warm_shard, s))
                self._workers[s].join()
            else:
                self._on_shard(s, self._warm_shard, s)
        for tid in moved:
            self._move_tenant(tid, s)
        return moved

    def _scale_down(self) -> List[int]:
        """Drain the highest shard through the migration seam and retire
        it: its tenants re-place by rendezvous over the survivors (only
        they move), its registry takes a final fold (a child's over the
        pipe before it exits), and its book and walls are kept for the
        report.  Returns the moved tenant ids."""
        from anomod_torch.serve.shard import rendezvous_shard
        s = self.shards - 1
        dead = (self._supervisor.dead_shards
                if self._supervisor is not None else set())
        candidates = [x for x in range(s) if x not in dead]
        moved = sorted(tid for tid, sh in self.shard_of.items() if sh == s)
        for tid in moved:
            self._move_tenant(
                tid, rendezvous_shard(tid, s, candidates=candidates))
        errs = []
        if self.worker_mode == "process" and self._workers is not None:
            w = self._workers[s]
            if w.alive:
                try:
                    rep = w.call({"op": "reg_delta", "fold": self.fold_mode,
                                  "final": True})
                    if rep.get("delta") is not None:
                        self._fold_shard_registries(
                            deltas=[(s, rep["delta"])], final=True)
                except RuntimeError:
                    pass                      # died mid-drain: close it
        if self._workers is not None:
            try:
                self._workers.pop().close()
            except BaseException as e:        # noqa: BLE001 - re-raised
                errs.append(e)
        if self.worker_mode != "process":
            self._proc_registry.fold_from(self._shard_regs.pop(),
                                          self._fold_state.pop(),
                                          shard=str(s), final=True,
                                          mode=self.fold_mode)
            if self.rca:
                self._rca_planes.pop()
        self._retired_runners.append(_runner_stats(self._runners.pop()))
        if len(self._perf_recs) > s:
            # the retired runner's undrained events join the next drain,
            # so the timeline covers the whole run
            self._perf_pending.extend(self._perf_recs.pop().drain())
        if self._supervisor is not None:
            self._supervisor.dead_shards.discard(s)
        self.shards = s
        if errs:
            raise errs[0]
        return moved

    def _move_tenant(self, tid: int, dst: int) -> None:
        """Live-migrate one tenant between shards through the state
        seams: its state copied out of the old pool on the old runner's
        stream (the slot released after the copy), put into the new pool
        on the new runner's stream, that stream synced; the detector
        repointed and its RCA evidence carried.  Across children the same
        seams run in them (``take_tenant`` / ``put_tenant``).  Tenant
        bits do not depend on placement, so no scored byte moves."""
        src = self.shard_of.get(tid, 0)
        if src == dst:
            return
        self.shard_of[tid] = dst
        if self.worker_mode == "process":
            if self._workers is not None:
                self._ensure_workers()
                taken = self._workers[src].call({"op": "take_tenant",
                                                 "tid": tid})
                self._apply_shard_reply(src, taken)
                snap = taken.get("snap")
                if snap is not None:
                    rep_snap, det_snap = snap
                    self.policy_migrated_spans += int(rep_snap["n_spans"])
                    self._apply_shard_reply(dst, self._workers[dst].call(
                        {"op": "put_tenant", "tid": tid,
                         "replay": rep_snap, "det": det_snap}))
            return
        rep = self._tenant_replay.pop(tid, None)
        if rep is not None:
            from anomod_torch.serve.supervise import (restore_replay,
                                                      snapshot_replay)
            with self._runners[src].on_stream():
                snap = snapshot_replay(rep)
                if hasattr(rep, "release"):
                    rep.release()            # hand the pool slot back
            self.policy_migrated_spans += int(snap["n_spans"])
            dst_runner = self._runners[dst]
            with dst_runner.on_stream():
                new_rep = self._replay_for(tid)
                restore_replay(new_rep, snap)
            dst_runner.sync()
            det = self._tenant_det.get(tid)
            if det is not None:
                det.replay = new_rep
        if self.rca and len(self._rca_planes) > max(src, dst):
            self._rca_planes[src].move_tenant_evidence(
                self._rca_planes[dst], tid)

    # -- the online alert->culprit pass (anomod_torch.serve.rca) -----------

    def _rca_step(self, now: float, served: List[QueuedBatch]) -> None:
        """One tick's RCA pass, inside the measured tick wall: this tick's
        new alerts enqueue first, then the served spans buffer into the
        owning shard's plane on the coordinator, pruned no further back
        than each tenant's OLDEST queued alert window (so a
        budget-delayed run still finds its whole evidence window), then
        up to ``rca_budget`` queued runs."""
        self._rca_enqueue(now)
        floor: Dict[int, int] = {}
        for _, tid, w, _ in self._rca_queue:
            floor[tid] = min(floor.get(tid, w), w)
        one = len(self._rca_planes) == 1
        for qb in served:
            self._rca_planes[0 if one else self.shard_of[qb.tenant_id]].buffer(
                qb.tenant_id, qb.spans, keep_window=floor.get(qb.tenant_id))
        # brownout level >= 1 tightens the budget to one run a tick: the
        # item set and verdicts do not depend on the budget, only
        # ``scored_s`` moves
        self._rca_tick(now, budget=(
            1 if self.policy is not None
            and self.policy.brownout_level >= 1 else None))

    def _rca_enqueue(self, now: float) -> None:
        """Queue one RCA item per (tenant, batch of new alerts), keyed by
        the NEWEST new alert window; the ``_rca_seen`` high-water mark
        makes repeated calls within a tick no-ops."""
        for tid in sorted(self._tenant_det):
            det = self._tenant_det[tid]
            n = len(det.alerts)
            seen = self._rca_seen.get(tid, 0)
            if n > seen:
                w = max(a.window for a in det.alerts[seen:])
                self._rca_queue.append((self._rca_seq, tid, w, now))
                self._rca_seq += 1
                self._obs_rca_queued.inc()
                self._rca_seen[tid] = n

    def _rca_tick(self, now: float, budget: Optional[int] = None) -> None:
        """Enqueue, then run up to ``budget`` queued items (default: the
        per-tick ``rca_budget``) in enqueue order: inline on the 1-shard
        engine, on the owning shards' workers otherwise, the verdicts
        folded in enqueue order (``fold_verdicts``) either way.  A tenant
        that keeps alerting while earlier items queue gets a NEW item per
        tick-batch of alerts, so the item set, and the verdict stream, is
        the same at any budget and shard count; the budget moves only
        ``scored_s``."""
        self._rca_enqueue(now)
        if not self._rca_queue:
            return
        burst = min(budget if budget is not None else self.rca_budget,
                    len(self._rca_queue))
        items = [self._rca_queue.popleft() for _ in range(burst)]
        folded: list = []
        with self._span("serve.rca"):
            if self._use_workers and self.worker_mode == "thread":
                from anomod_torch.serve.shard import fold_verdicts
                parts: Dict[int, list] = {}
                for it in items:
                    parts.setdefault(self.shard_of[it[1]], []).append(it)
                results: List[list] = [[] for _ in range(self.shards)]
                failures = self._fan_out({
                    s: (self._rca_run_items, self._rca_planes[s], part,
                        results[s], now) for s, part in parts.items()})
                if failures:
                    self._last_failures = failures
                    raise failures[0][1]
                folded = fold_verdicts(results)
            else:
                self._rca_run_items(self._rca_planes[0], items, folded, now)
        for _, verdict, wall in folded:
            self.rca_verdicts.append(verdict)
            self._rca_slo.record(wall)
            self.rca_wall_s += wall

    def _rca_run_items(self, plane, items: list, out: list,
                       now: float) -> None:
        """Append ``(seq, verdict, wall_s)`` of each queued item."""
        for seq, tid, w, enq in items:
            det = self._tenant_det.get(tid)
            alerts = det.alerts if det is not None else []
            verdict, wall = plane.run(tid, w, alerts, enqueued_s=enq,
                                      scored_s=now)
            out.append((seq, verdict, wall))

    # -- the observatories (anomod_torch.obs.perf, anomod_torch.obs.census)

    def _perf_drain(self) -> Optional[dict]:
        """The tick barrier's drain of the shard recorders: fold in
        (shard, seq) order, run the overlap analyzer, accumulate the run's
        totals, retain the events (bounded, evictions counted) and return
        the journal's ``perf`` doc, or None with no flight recorder."""
        from anomod_torch.obs.perf import (analyze_events, fold_perf_records,
                                           round_events)
        parts = [self._perf_pending] + [r.drain() for r in self._perf_recs]
        self._perf_pending = []
        events = fold_perf_records(parts)
        stats = analyze_events(events, self.pipeline)
        n = len(events)
        self.perf_events_recorded += n
        self.perf_headroom_s += stats["headroom_s"]
        self.perf_wait_s += stats["wait_s"]
        if n:
            self._obs_perf_events.inc(n)
            self._obs_fold_wait.inc(stats["wait_s"])
            self._obs_headroom.inc(stats["headroom_s"])
        self.perf_events.extend(events)
        over = len(self.perf_events) - self.perf_max_events
        if over > 0:
            del self.perf_events[:over]
            self.perf_events_dropped += over
            self._obs_perf_dropped.inc(over)
        if self.flight_recorder is None:
            return None
        return {"events": round_events(events),
                "headroom_s": round(stats["headroom_s"], 6),
                "wait_s": round(stats["wait_s"], 6)}

    def _census_drain(self, t_idx: int) -> dict:
        """One census at the tick barrier (the workers are idle): the
        resident-bytes walk over shapes and container lengths, the hot-set
        document, the gauges, and the journal's ``census`` doc for tick
        ``t_idx``.  No clock, no RNG, no tensor read."""
        from anomod_torch.obs.census import collect_resident_bytes
        planes, by_plane, total, reconciled = collect_resident_bytes(self)
        tracker = self._census_tracker
        hot = tracker.hot_doc(t_idx, len(self.specs),
                              list(self._tenant_replay))
        self.census_ticks += 1
        self._census_reconciled = self._census_reconciled and reconciled
        self.census_peak_bytes = max(self.census_peak_bytes, total)
        self.census_hot_set = hot
        self.census_resident = {
            "total": total, "peak_total": self.census_peak_bytes,
            "by_plane": by_plane,
            "pool_reconciled": self._census_reconciled}
        g = self._obs_census
        g["total"].set(total)
        for plane in ("pool", "scratch", "admission", "slo", "rca"):
            g[plane].set(by_plane.get(plane, 0))
        g["recorder"].set(by_plane.get("flight", 0)
                          + by_plane.get("perf", 0))
        g["registered"].set(len(self.specs))
        g["resident"].set(hot["resident"])
        g["hot"].set(hot["hot_by_decay"].get(
            str(min(tracker.decay_ticks)), 0))
        g["occupancy"].set(hot["occupancy_vs_registered"])
        self._obs_census_ticks.inc()
        return {"tick": t_idx, "planes": planes,
                "total_bytes": total, "pool_reconciled": reconciled,
                "hot": hot}

    # -- the flight recorder (anomod_torch.obs.flight) ----------------------

    def _flight_tick(self, now: float, served: List[QueuedBatch],
                     tick_wall_s: float, final: bool = False,
                     t_idx: Optional[int] = None, tot=None) -> None:
        """Journal one tick.  The canonical planes: the admission deltas
        and a crc32 over the served decision set in drain order, the
        staged-chunk counts per width (the one staging definition, so
        equal at every shard count, depth and residency), the tenant
        count and the cadenced state digest, running digests of the
        alert and RCA-verdict streams; the crc texts are the JAX
        engine's, in its order.  The variant keys: the tick's wall legs
        and the per-shard leg records, folded in shard order.
        ``final=True`` is the run-end settlement record, with a forced
        state digest.  The deferred commit's barrier passes ``t_idx`` and
        ``tot`` as taken at the origin tick (by then the next tick's
        admission has moved the live ones): the same values, so the
        canonical journal does not depend on the deferral."""
        from anomod_torch.obs.flight import crc_text, state_digest
        from anomod_torch.serve.shard import fold_leg_records
        fr = self.flight_recorder
        if t_idx is None:
            t_idx = self.clock.ticks
        if tot is None:
            tot = self.admission.totals()
        prev = self._flight_prev_tot

        def delta(field):
            return getattr(tot, field) - (getattr(prev, field)
                                          if prev is not None else 0)

        crc = 0
        for qb in served:
            crc = crc_text(f"{qb.tenant_id}:{qb.seq}:{qb.n_spans}:"
                           f"{qb.priority}:{qb.enqueued_s!r}", crc)
        admission = {"offered": delta("offered_spans"),
                     "admitted": delta("admitted_spans"),
                     "served": delta("served_spans"),
                     "shed": delta("shed_spans"),
                     "evicted": delta("evicted_batches"),
                     "served_batches": delta("served_batches"),
                     "digest": crc}
        self._flight_prev_tot = tot
        legs = [r.leg_walls() for r in self._runners]
        prev_legs = self._flight_prev_legs or [{} for _ in legs]
        if len(prev_legs) < len(legs):
            # a scale-up added runners since the last record: their whole
            # books are this tick's delta
            prev_legs = prev_legs + [{}] * (len(legs) - len(prev_legs))
        by_width: Dict[int, int] = {}
        chunks = 0
        shard_legs = []
        walls = dict.fromkeys(("stage_s", "dispatch_s", "fold_s",
                               "score_s"), 0.0)
        fused_d = native_staged = 0
        for s, (leg, pleg) in enumerate(zip(legs, prev_legs)):
            pw = pleg.get("by_width", {})
            for w, n in leg["by_width"].items():
                dn = n - pw.get(w, 0)
                if dn:
                    by_width[w] = by_width.get(w, 0) + dn
            dchunks = leg["chunks"] - pleg.get("chunks", 0)
            dfused = leg["fused"] - pleg.get("fused", 0)
            dnative = leg["native_staged"] - pleg.get("native_staged", 0)
            dwalls = {k: leg[k] - pleg.get(k, 0.0) for k in walls}
            chunks += dchunks
            fused_d += dfused
            native_staged += dnative
            for k, v in dwalls.items():
                walls[k] += v
            shard_legs.append({"shard": s, "chunks": dchunks,
                               "fused": dfused, "native_staged": dnative,
                               **{k: round(v, 6) for k, v in dwalls.items()}})
        self._flight_prev_legs = legs
        # the fold plane covers the whole fleet: pool-resident planes and
        # the demoted ones, read through the tier's shims (a cold entry
        # from disk) only on a digest tick
        do_digest = final or fr.digest_tick(t_idx)
        reps = self._tenant_replay
        n_states = len(reps)
        if self._tier is not None and len(self._tier):
            n_states += len(self._tier)
            if do_digest:
                reps = dict(reps)
                for tid in self._tier.tids():
                    reps[tid] = self._tier.state_shim(tid)
        digest = None
        if do_digest:
            digest = (self._state_digest_proc()
                      if self.worker_mode == "process"
                      else state_digest(reps))
        fold = {"tenants": n_states, "state_digest": digest}
        new_alerts = 0
        crc = self._flight_score_crc
        for tid in sorted(self._tenant_det):
            alerts = self._tenant_det[tid].alerts
            seen = self._flight_alert_seen.get(tid, 0)
            for a in alerts[seen:]:
                crc = crc_text(
                    f"{tid}:{a.window}:{a.service}:{a.service_name}:"
                    f"{a.score!r}:{a.z_latency!r}:{a.z_error!r}:"
                    f"{a.z_drop!r}:{a.z_drop_cum!r}:{a.evidence}", crc)
                new_alerts += 1
            self._flight_alert_seen[tid] = len(alerts)
        self._flight_score_crc = crc
        self._flight_alert_total += new_alerts
        score = {"alerts": new_alerts,
                 "alerts_total": self._flight_alert_total,
                 "digest": crc}
        new_verdicts = self.rca_verdicts[self._flight_rca_seen:]
        crc = self._flight_rca_crc
        for v in new_verdicts:
            crc = crc_text(repr(v.to_dict()), crc)
        self._flight_rca_seen = len(self.rca_verdicts)
        self._flight_rca_crc = crc
        rca = {"verdicts": len(new_verdicts),
               "verdicts_total": self._flight_rca_seen,
               "digest": crc}
        leg_sum = sum(walls.values())
        scaling, self._policy_events = self._policy_events, []
        perf_doc, self._perf_tick_doc = self._perf_tick_doc, None
        census_doc, self._census_tick_doc = self._census_tick_doc, None
        rec = {
            "tick": t_idx, "now_s": now,
            "admission": admission,
            "dispatch": {"chunks": chunks,
                         "by_width": {str(w): by_width[w]
                                      for w in sorted(by_width)}},
            "fold": fold, "score": score, "rca": rca,
            "walls": {"tick_s": round(tick_wall_s, 6),
                      **{k: round(v, 6) for k, v in walls.items()},
                      "other_s": round(max(0.0, tick_wall_s - leg_sum), 6)},
            "topology": {"fused_dispatches": fused_d,
                         "native_staged": native_staged,
                         "shard_legs": fold_leg_records(shard_legs)},
            # what crashed, respawned, was quarantined or migrated: the
            # variant tier, so the canonical planes stay equal to a
            # fault-free run's
            "recovery": (self._supervisor.drain_events()
                         if self._supervisor is not None else []),
            # what scaled, when, and which tenants moved: topology, so
            # the canonical planes stay equal to a static run's
            "scaling": scaling,
            # the perf timeline (walls) and the census (wall-free, but
            # its bytes follow the pool and scratch topology): present
            # and empty off-cadence or with the plane off
            "perf": (perf_doc if perf_doc is not None else
                     {"events": [], "headroom_s": 0.0, "wait_s": 0.0}),
            "census": (census_doc if census_doc is not None else
                       {"planes": [], "hot": {}}),
            # demotions, spills, promotions and misses: a function of
            # seed and config, variant because a miss moves the tick a
            # parked tenant's deltas land in
            "tiering": (self._tier.drain_events()
                        if self._tier is not None else []),
        }
        if final:
            rec["final"] = True
        fr.record(rec)
        # the first tick with a new alert publishes ONE forensic bundle
        # (ANOMOD_FLIGHT_DUMP_DIR), once a run
        if (self._flight_dump_dir is not None and new_alerts
                and not self._flight_dumped):
            self._flight_dumped = True
            from pathlib import Path
            fr.forensic(Path(self._flight_dump_dir)
                        / f"flight_forensic_tick{t_idx:06d}.json",
                        registry=self._registry, tracer=self.tracer,
                        reason=f"{new_alerts} new alert(s) at tick {t_idx}")

    def run(self, traffic, duration_s: float,
            warm: bool = True) -> "ServeReport":
        """Drive the engine from a traffic source for ``duration_s``
        virtual seconds, then close every tenant's last window.  A failed
        run stops its shard workers (process children included) and the
        tier's prefetch lane, and aborts a deferred tick, before its error
        propagates."""
        try:
            return self._run(traffic, duration_s, warm)
        except BaseException:
            try:
                self.close()
            except Exception:         # noqa: BLE001 - the run's error wins
                pass
            raise

    def _run(self, traffic, duration_s: float, warm: bool) -> "ServeReport":
        # the mesh plane builds its kernels at each plane's first push
        if warm and self.mesh is None:
            # first launches outside the wall, shard by shard: shard 0
            # alone (the kernel libraries load there), then the others
            # together on their own workers
            if self.worker_mode == "process":
                self._warm_proc()
                if self.rca:
                    self._rca_planes[0].runner.warm()
            elif self._use_workers:
                from anomod_torch.serve.shard import join_all
                self._ensure_workers()
                for group in ([0], range(1, self.shards)):
                    for s in group:
                        self._workers[s].submit(partial(
                            self._on_shard, s, self._warm_shard, s))
                    join_all([self._workers[s] for s in group])
            else:
                self._warm_shard(0)
        n_ticks = max(int(round(duration_s / self.clock.tick_s)), 1)
        mod_src = (getattr(traffic, "modality_arrivals", None)
                   if self.multimodal else None)
        with self._span("serve.run"):
            for _ in range(n_ticks):
                lo = self.clock.now_s
                hi = lo + self.clock.tick_s
                self.tick(traffic.arrivals(lo, hi),
                          mod_src(lo, hi) if mod_src is not None else ())
        if self._deferred is not None:
            # the last deferred tick commits before finish() reads any
            # state; its wall joins the serve wall
            t0 = time.perf_counter()
            self._commit_deferred()
            self.serve_wall_s += time.perf_counter() - t0
        t_wall = time.perf_counter()
        if self._tier is not None:
            self._tier_settle()
        if self.score and self.worker_mode == "process":
            # the detectors live in the children; the replies carry the
            # closing windows' alerts back
            self._finish_proc()
        elif self.score:
            for tid, det in self._tenant_det.items():
                # the last windows score on the owning runner's stream
                with self._runners[self.shard_of.get(tid, 0)].on_stream():
                    det.finish()
        if self.rca:
            # end-of-run settlement: alerts raised by finish() still get
            # culprits, and whatever the per-tick budget deferred drains
            self._rca_tick(self.clock.now_s, budget=len(self._tenant_det)
                           + len(self._rca_queue) + 1)
            while self._rca_queue:
                self._rca_tick(self.clock.now_s,
                               budget=len(self._rca_queue))
        self.serve_wall_s += time.perf_counter() - t_wall
        if self.perf:
            # events the last drain window left, into the settlement
            self._perf_tick_doc = self._perf_drain()
        if self.census:
            # every census-on run ends on a full census, whatever the
            # cadence
            t0 = time.perf_counter()
            self._census_tick_doc = self._census_drain(self.clock.ticks)
            self.census_wall_s += time.perf_counter() - t0
        if self.flight_recorder is not None:
            # the settlement record: finish() alerts and drained verdicts
            # land here, and its forced digest anchors the full end state
            self._flight_tick(self.clock.now_s, [],
                              time.perf_counter() - t_wall, final=True)
        if self._use_workers:
            # the shard histograms drain into the process registry
            if self.worker_mode == "process":
                self._final_fold_proc()
            else:
                self._fold_shard_registries(final=True)
            self.close()
        elif self._tier is not None:
            self._tier.close()
        return self.report(traffic=traffic)

    def _tier_settle(self) -> None:
        """The run-end tier settlement: batches whose one-tick deferral
        crossed the run's end score through the tick's own path, in park
        order, and every demoted tenant promotes back (sorted), so
        ``finish`` closes the whole fleet's last windows and the
        settlement record's digest covers every state."""
        if self._tier_parked:
            parked, self._tier_parked = self._tier_parked, {}
            leftovers: List[QueuedBatch] = []
            for tid, batches in parked.items():
                if tid in self._tier:
                    self._tier_promote(tid, deferred=True)
                leftovers.extend(batches)
            if leftovers:
                sup = self._supervisor
                if sup is not None:
                    sup.begin_tick(leftovers)
                self._score_now(leftovers)
                if sup is not None:
                    sup.end_tick()
        for tid in sorted(self._tier.tids()):
            self._tier_promote(tid, deferred=False)

    # -- reporting --------------------------------------------------------

    def alerts_for(self, tenant_id: int,
                   onset_window: Optional[int] = None):
        """A tenant's alert stream, optionally only the alerts that pass
        :func:`onset_eligible`."""
        det = self._tenant_det.get(tenant_id)
        alerts = list(det.alerts) if det is not None else []
        if onset_window is not None:
            alerts = onset_eligible_alerts(alerts, onset_window)
        return alerts

    def _fault_detection(self, traffic) -> Optional[dict]:
        faults = getattr(traffic, "faults", None)
        if not faults:
            return None
        win_s = self.cfg.window_us / 1e6
        lat = []
        hits = 0
        for tid, fault in sorted(faults.items()):
            det = self._tenant_det.get(tid)
            onset_w = int(fault.onset_s // win_s)
            fw = None
            if det is not None:
                ws = [a.window
                      for a in onset_eligible_alerts(det.alerts, onset_w)
                      if a.service_name == self.services[fault.service]]
                fw = min(ws) if ws else None
            if fw is not None:
                hits += 1
                lat.append(fw - onset_w)
        return {
            "n_fault_tenants": len(faults),
            "n_detected": hits,
            "median_alert_latency_windows":
                (float(np.median(lat)) if lat else None),
        }

    def _rca_hits(self, traffic) -> Tuple[Dict[int, int], int]:
        """Top-k hit counts against the traffic's injected faults: per
        fault tenant, its FIRST onset-eligible verdict (triggering alert
        at or after the onset window, :func:`onset_eligible`) is checked
        for the culprit in its top-1/3/5."""
        faults = getattr(traffic, "faults", None) \
            if traffic is not None else None
        hits = {1: 0, 3: 0, 5: 0}
        eligible = 0
        if not (self.rca and faults):
            return hits, eligible
        win_s = self.cfg.window_us / 1e6
        by_tenant: Dict[int, list] = {}
        for v in self.rca_verdicts:
            by_tenant.setdefault(v.tenant_id, []).append(v)
        for tid, fault in sorted(faults.items()):
            onset_w = int(fault.onset_s // win_s)
            vs = [v for v in by_tenant.get(tid, ())
                  if onset_eligible(v.alert_window, onset_w)]
            if not vs:
                continue
            eligible += 1
            first = min(vs, key=lambda v: (v.alert_window, v.scored_s))
            culprit = self.services[fault.service]
            for k in hits:
                if culprit in first.services[:k]:
                    hits[k] += 1
        return hits, eligible

    def report(self, traffic=None) -> ServeReport:
        tot = self.admission.totals()
        shed_fraction = (tot.shed_spans / tot.offered_spans
                         if tot.offered_spans else 0.0)
        pri_slos: Dict[int, List[_TenantSLO]] = {}
        for tid, slo in self._slo.items():
            pri_slos.setdefault(self.admission.priority_of(tid),
                                []).append(slo)
        per_pri = {}
        for pri, c in sorted(self.admission.per_priority().items()):
            per_pri[pri] = {
                "offered_spans": c.offered_spans,
                "served_spans": c.served_spans,
                "shed_spans": c.shed_spans,
                "shed_fraction": (c.shed_spans / c.offered_spans
                                  if c.offered_spans else 0.0),
                **_merged_quantiles(pri_slos.get(pri, ())),
            }
        # runner books sum over the shard runners (the inline engine's
        # list is [self.runner]) and the runners a scale-down retired, so
        # they cover the whole run; lane grouping depends on shard
        # membership, the staged chunks per width do not
        stats = [_runner_stats(r) for r in self._runners] \
            + self._retired_runners
        books = [st["book"] for st in stats]
        by_width: Dict[int, int] = {}
        lanes_by_bucket: Dict[int, int] = {}
        for book in books:
            for w, n in book["dispatches_by_width"].items():
                by_width[w] = by_width.get(w, 0) + n
            for b, n in book["lanes_by_bucket"].items():
                lanes_by_bucket[b] = lanes_by_bucket.get(b, 0) + n
        staged_lanes = sum(b["staged_lanes"] for b in books)
        live_lanes = sum(b["live_lanes"] for b in books)

        def total(key):
            return round(sum(st[key] for st in stats), 4)
        shard_tenants = {s: 0 for s in range(self.shards)}
        shard_spans = {s: 0 for s in range(self.shards)}
        shard_tenants[0] += len(self.specs) - len(self.shard_of)
        for sh in self.shard_of.values():
            shard_tenants[sh] += 1
        for tid, c in self.admission.counters.items():
            shard_spans[self.shard_of.get(tid, 0)] += c.served_spans
        total_spans = sum(shard_spans.values())
        imbalance = (max(shard_spans.values()) / (total_spans / self.shards)
                     if total_spans else 1.0)
        rca_hits, rca_eligible = self._rca_hits(traffic)
        delays = [v.scored_s - v.enqueued_s for v in self.rca_verdicts]
        rca_delay = {
            q: (round(float(np.quantile(delays, p)), 6) if delays
                else None)
            for q, p in (("p50_s", 0.5), ("p99_s", 0.99))}
        rca_lat = {}
        for q, p in (("p50_s", 0.5), ("p99_s", 0.99)):
            got = self._rca_slo.quantile(p) \
                if self._rca_slo is not None else None
            rca_lat[q] = round(got, 6) if got is not None else None
        fr = self.flight_recorder
        sup = self._supervisor
        pol = self.policy
        tier = self._tier
        tier_n = ((tier.demotions_warm, tier.demotions_cold,
                   tier.promotions, tier.misses, tier.prefetch_hits)
                  if tier is not None else (0,) * 5)
        from anomod_torch.obs.perf import bubble_fractions
        fold_wall = sum(st["fold_wall_s"] for st in stats)
        return ServeReport(
            n_tenants=len(self.specs),
            duration_s=round(self.clock.now_s, 6),
            ticks=self.clock.ticks,
            capacity_spans_per_s=self.capacity_spans_per_s,
            offered_spans=tot.offered_spans,
            admitted_spans=tot.admitted_spans,
            served_spans=tot.served_spans,
            shed_spans=tot.shed_spans,
            shed_fraction=round(shed_fraction, 6),
            served_batches=tot.served_batches,
            peak_backlog_spans=self.admission.peak_backlog_spans,
            max_backlog=self.admission.max_backlog,
            buckets=self.runner.buckets,
            dispatches_by_width=by_width,
            fused=self._fused,
            fused_dispatches=sum(b["fused_dispatches"] for b in books),
            lane_buckets=self.runner.lane_buckets,
            lanes_by_bucket=lanes_by_bucket,
            lane_pad_waste=round(1.0 - live_lanes / staged_lanes
                                 if staged_lanes else 0.0, 6),
            compile_s=total("compile_s"),
            lane_compile_s=total("lane_compile_s"),
            native_staging=self.runner.native_stage,
            native_staged_dispatches=sum(b["native_staged"] for b in books),
            serve_state=self.serve_state,
            stage_wall_s=total("stage_wall_s"),
            dispatch_wall_s=total("dispatch_wall_s"),
            fold_wall_s=total("fold_wall_s"),
            score_wall_s=total("score_wall_s"),
            pipeline=self.pipeline,
            shards=self.shards,
            shard_tenants=shard_tenants,
            shard_spans=shard_spans,
            shard_imbalance=round(imbalance, 6),
            latency=_merged_quantiles(list(self._slo.values())),
            per_priority=per_pri,
            modality_events=dict(self.modality_events),
            n_alerts=sum(len(d.alerts) for d in self._tenant_det.values()),
            n_tenants_alerted=sum(1 for d in self._tenant_det.values()
                                  if d.alerts),
            fault_detection=self._fault_detection(traffic),
            rca_enabled=self.rca,
            n_rca_runs=len(self.rca_verdicts),
            rca_topk_hits=rca_hits,
            rca_eligible=rca_eligible,
            rca_latency=rca_lat,
            rca_alert_to_culprit_s=rca_delay,
            rca_wall_s=round(self.rca_wall_s, 4),
            supervised=sup is not None,
            ckpt_every=self.ckpt_every,
            n_checkpoints=sup.n_checkpoints if sup is not None else 0,
            ckpt_wall_s=round(sup.ckpt_wall_s if sup is not None else 0.0,
                              4),
            n_shard_crashes=sup.n_crashes if sup is not None else 0,
            n_respawns=sup.n_respawns if sup is not None else 0,
            n_restored_ticks=sup.n_restored_ticks if sup is not None else 0,
            n_quarantined=sup.n_quarantined if sup is not None else 0,
            n_migrated_tenants=sup.n_migrated if sup is not None else 0,
            recovery_wall_s=round(sup.recovery_wall_s if sup is not None
                                  else 0.0, 4),
            policy=pol.mode if pol is not None else "off",
            n_scale_ups=pol.n_scale_ups if pol is not None else 0,
            n_scale_downs=pol.n_scale_downs if pol is not None else 0,
            n_rebalances=pol.n_rebalances if pol is not None else 0,
            n_policy_migrations=pol.n_migrated if pol is not None else 0,
            brownout_ticks=pol.brownout_ticks if pol is not None else 0,
            peak_shards=max(self._peak_shards, self.shards),
            policy_wall_s=round(self.policy_wall_s, 4),
            flight_enabled=self.flight,
            flight_recorded_ticks=fr.n_recorded if fr is not None else 0,
            flight_dropped_ticks=fr.n_dropped if fr is not None else 0,
            perf_enabled=self.perf,
            perf_events_recorded=self.perf_events_recorded,
            overlap_headroom_s=round(self.perf_headroom_s, 6),
            fold_wait_s=round(self.perf_wait_s, 6),
            bubble_fractions=(bubble_fractions(
                self.perf_wait_s, self.perf_headroom_s, fold_wall,
                self.serve_wall_s) if self.perf else {}),
            census_enabled=self.census,
            census_ticks=self.census_ticks,
            census_hot_set=dict(self.census_hot_set),
            census_resident_bytes=dict(self.census_resident),
            census_wall_s=round(self.census_wall_s, 4),
            tier_hot=self.tier_hot,
            n_tier_demotions_warm=tier_n[0], n_tier_demotions_cold=tier_n[1],
            n_tier_promotions=tier_n[2], n_tier_misses=tier_n[3],
            tier_prefetch_hidden=tier_n[4],
            tier_wall_s=round(self.tier_wall_s, 4),
            async_commit=self.async_commit,
            async_ticks=self.async_ticks,
            commit_defer_wall_s=round(self.commit_defer_wall_s, 6),
            fold_payload_bytes=self.fold_payload_bytes,
            worker=self.worker_mode,
            fold=self.fold_mode,
            device=device_name(self.device),
            serve_wall_s=round(self.serve_wall_s, 4),
            sustained_spans_per_sec=round(
                self.n_spans_served / max(self.serve_wall_s, 1e-9), 1),
        )
