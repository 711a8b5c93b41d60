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
``serve.admit``, ``serve.drain``, ``serve.score_fused``,
``serve.score_shard``, ``serve.score``, ``serve.rca``).

Online RCA (``rca=True`` or ``ANOMOD_SERVE_RCA``): when a tenant's
detector fires, the alert queues for culprit inference over that
tenant's served spans (``anomod_torch.serve.rca``), at most
``rca_budget`` runs a tick, the rest drained at the run's end; a pure
read-side consumer, so every decision is byte-identical with it on or
off.

This is the 1-shard thread engine of the JAX package's default
configuration; its other planes (shards, chaos and supervision, elastic
policy, async commit, tiering, flight, perf and census, the multimodal
sidecar) are not part of this engine, nor are their metric series.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
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
from anomod_torch.serve.config import (DEFAULT_SERVE_MAX_BACKLOG,
                                       DEFAULT_SERVE_PIPELINE)
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


def _plane_col_gather(work):
    """The ``gather_cols`` backend of one batched scoring pass
    (:func:`~anomod_torch.stream.score_closed_windows_batched`): ONE pool
    gather per scored window when every plane lives in the same runner's
    pool, so only the scored ``[T, S, F]`` columns leave the device; host
    planes are read per tenant, cached across the pass's windows."""
    planes: Dict[int, np.ndarray] = {}

    def gather(items):
        reps = [work[i][0].replay for i, _ in items]
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
    latency: Dict[str, Optional[float]]          # aggregate p50/p99
    per_priority: Dict[int, dict]
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
        d["rca_topk_hits"] = {str(k): v for k, v
                              in self.rca_topk_hits.items()}
        return d


#: ServeReport fields that are walls or follow the lane GROUPING (which
#: tenants share a fused stack): they differ between fused and unfused or
#: across pipeline depths on one seed; every other field is a decision
VARIANT_REPORT_FIELDS = (
    "fused", "fused_dispatches", "lanes_by_bucket", "lane_pad_waste",
    "compile_s", "lane_compile_s", "native_staging",
    "native_staged_dispatches", "serve_state", "stage_wall_s",
    "dispatch_wall_s", "fold_wall_s", "score_wall_s", "pipeline",
    "serve_wall_s", "sustained_spans_per_sec", "rca_latency", "rca_wall_s")

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
                  n_windows: int = 32, fuse: bool = True,
                  lane_buckets: Optional[Tuple[int, ...]] = None,
                  pipeline: Optional[int] = None, state: str = "device",
                  device: DeviceLike = None, native_stage: bool = True,
                  drain_engine: str = "native", rca: Optional[bool] = None,
                  tracer=None) -> Tuple["ServeEngine", "ServeReport"]:
    """The canonical seeded serve run: :func:`power_law_traffic` against
    an engine of ``capacity_spans_per_s``, so one run measures sustained
    throughput, shedding and alert latency under load."""
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
                         drain_engine=drain_engine, rca=rca, tracer=tracer)
    report = engine.run(traffic, duration_s=duration_s)
    return engine, report


class ServeEngine:
    """Multi-tenant serving plane over the streaming detectors, on one
    device (``cuda`` unless the caller asks for ``cpu``).  ``rca`` and the
    ``rca_*`` knobs default from ``anomod_torch.config``; ``tracer``
    defaults to a ``Tracer("anomod-serve")`` when the process registry is
    enabled."""

    def __init__(self, specs: Sequence[TenantSpec], services: Sequence[str],
                 cfg: Optional[ReplayConfig] = None, t0_us: int = 0,
                 capacity_spans_per_s: float = 20_000.0, tick_s: float = 1.0,
                 buckets: Optional[Tuple[int, ...]] = None,
                 max_backlog: Optional[int] = None,
                 score: bool = True, baseline_windows: int = 4,
                 z_threshold: float = 4.0, consecutive: int = 1,
                 min_count: float = 5.0, fuse: bool = True,
                 lane_buckets: Optional[Tuple[int, ...]] = None,
                 pipeline: Optional[int] = None, state: str = "device",
                 device: DeviceLike = None, native_stage: bool = True,
                 drain_engine: str = "native", tracer=None,
                 rca: Optional[bool] = None,
                 rca_buckets: Optional[tuple] = None,
                 rca_topk: Optional[int] = None,
                 rca_budget: Optional[int] = None,
                 rca_windows: Optional[int] = None):
        if capacity_spans_per_s <= 0:
            raise ValueError("capacity must be positive")
        self.device = resolve_device(device)
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
        self.max_backlog = int(DEFAULT_SERVE_MAX_BACKLOG
                               if max_backlog is None else max_backlog)
        self.admission = AdmissionController(self.specs,
                                             max_backlog=self.max_backlog,
                                             drain_engine=drain_engine)
        self.score = bool(score)
        #: tenant-fused scoring: per tick, drained same-tenant batches
        #: coalesce into one staging and same-width chunks across tenants
        #: run as lane-stacked dispatches
        self.fuse = bool(fuse)
        # the runner owns (and validates) the pipeline depth and the
        # state mode
        self.runner = BucketRunner(
            self.cfg, buckets, lane_buckets=lane_buckets,
            pipeline=(DEFAULT_SERVE_PIPELINE if pipeline is None
                      else pipeline),
            state=state, pool_slots=max(len(self.specs), 1),
            device=self.device, native_stage=native_stage)
        self.pipeline = self.runner.pipeline
        self.serve_state = self.runner.state_mode
        self._det_kw = dict(baseline_windows=baseline_windows,
                            z_threshold=z_threshold,
                            consecutive=consecutive, min_count=min_count)
        # per-tenant detector/replay state, built at first served batch
        self._tenant_replay: Dict[int, object] = {}
        self._tenant_det: Dict[int, OnlineDetector] = {}
        self._slo: Dict[int, _TenantSLO] = _LazySLO()
        self._credit = 0.0
        #: widest batch ever served: the legitimate overdraw envelope of
        #: the per-tick credit clamp
        self._max_served_batch = 0
        self.serve_wall_s = 0.0
        self.n_spans_served = 0
        app_cfg = get_config()
        #: online RCA: a pure read-side consumer of the alert stream
        self.rca = bool(app_cfg.serve_rca if rca is None else rca)
        if self.rca and not self.score:
            raise ValueError("online RCA consumes the detectors' alert "
                             "stream; it needs score=True")
        self.rca_budget = int(app_cfg.serve_rca_budget
                              if rca_budget is None else rca_budget)
        if self.rca_budget < 1:
            raise ValueError("rca_budget must be >= 1 run per tick")
        self._rca_plane = None
        self._rca_seen: Dict[int, int] = {}
        self._rca_queue: "collections.deque" = collections.deque()
        self._rca_seq = 0
        self.rca_verdicts: list = []
        self.rca_wall_s = 0.0
        # metric handles only when the plane is live: an RCA-off run
        # registers no RCA series
        self._rca_slo = None
        if self.rca:
            from anomod_torch.serve.rca import OnlineRCA, RcaRunner
            self._rca_slo = _TenantSLO("anomod_serve_rca_seconds")
            self._obs_rca_queued = obs.counter(
                "anomod_serve_rca_queued_total")
            self._rca_plane = OnlineRCA(
                self.services, self.cfg.window_us, self.t0_us,
                RcaRunner(app_cfg.serve_rca_buckets if rca_buckets is None
                          else rca_buckets, device=self.device),
                topk=int(app_cfg.serve_rca_topk if rca_topk is None
                         else rca_topk),
                windows=int(app_cfg.serve_rca_windows if rca_windows is None
                            else rca_windows))
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
        self._registry = obs.get_registry()
        self._obs_tick = obs.histogram("anomod_serve_tick_seconds")
        self._obs_ticks = obs.counter("anomod_serve_ticks_total")
        self._obs_tenants = obs.gauge("anomod_serve_active_tenants")
        self._scrape_every = max(1, int(round(1.0 / self.clock.tick_s)))

    # -- per-tenant plane construction ------------------------------------

    def _replay_for(self, tenant_id: int):
        got = self._tenant_replay.get(tenant_id)
        if got is None:
            cls = (PooledStreamReplay if self.runner.pool is not None
                   else BucketedStreamReplay)
            got = self._tenant_replay[tenant_id] = cls(
                self.cfg, self.t0_us, self.runner)
        return got

    def _detector_for(self, tenant_id: int) -> OnlineDetector:
        got = self._tenant_det.get(tenant_id)
        if got is None:
            got = self._tenant_det[tenant_id] = OnlineDetector(
                self.services, self.cfg, self.t0_us,
                replay=self._replay_for(tenant_id), **self._det_kw)
        return got

    # -- the tick loop ----------------------------------------------------

    def _span(self, name: str, **tags):
        return (self.tracer.span(name, **tags) if self.tracer is not None
                else contextlib.nullcontext())

    def tick(self, arrivals) -> List[QueuedBatch]:
        """One virtual tick: admit this tick's arrivals, drain up to the
        tick's capacity budget in weighted-fair order, score every drained
        batch, advance the clock.  Returns the served batches."""
        t_wall = time.perf_counter()
        now = self.clock.now_s + self.clock.tick_s   # decisions at tick end
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
        if served:
            if self.fuse:
                with self._span("serve.score_fused"):
                    self._score_fused(served)
            else:
                for qb in served:
                    with self._span("serve.score"):
                        if self.score:
                            self._detector_for(qb.tenant_id).push(qb.spans)
                        else:
                            self._replay_for(qb.tenant_id).push(qb.spans)
        # SLO accounting after scoring in both paths: the samples depend
        # only on admission times and the tick clock
        for qb in served:
            self._slo[qb.tenant_id].record(now - qb.enqueued_s)
            self.n_spans_served += qb.n_spans
        if self.rca:
            self._rca_step(now, served)
        self.clock.advance()
        # telemetry stays INSIDE the measured wall: the on/off overhead
        # prices the scrape
        self._obs_tick.observe(time.perf_counter() - t_wall)
        self._obs_ticks.inc()
        self._obs_tenants.set(len(self._tenant_det)
                              or len(self._tenant_replay))
        if self.clock.ticks % self._scrape_every == 0:
            self._registry.scrape(now_s=now)
        self.serve_wall_s += time.perf_counter() - t_wall
        return served

    def _score_fused(self, served: List[QueuedBatch]) -> None:
        """Tenant-fused scoring of one tick's drained batches: coalesce
        and plan (host), lane-stacked dispatches per chunk round, then
        batched window scoring (the commit)."""
        with self._span("serve.score_shard", shard=0,
                        pipeline=self.pipeline):
            pending = self._stage_pending(served)
            self._dispatch_rounds(pending)
            self._commit_pending(pending)

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

    def _dispatch_rounds(self, pending: list) -> None:
        """Per chunk round (a tenant's own chunks apply in order),
        same-width chunks lane-stack into fused dispatches through the
        runner's pipelined submit path, drained before scoring.  A
        failure discards the in-flight dispatches unfolded."""
        runner = self.runner
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
            runner.drain_lanes()
        except BaseException:
            runner.abort_lanes()
            raise

    def _commit_pending(self, pending: list) -> None:
        """Per tenant, the detector's post-replay half: window
        bookkeeping, then every newly closed window of every tenant
        scored in one vectorized pass per window, fed by one pool
        gather.  The wall lands in the ``score`` leg."""
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
        if work:
            score_closed_windows_batched(work, _plane_col_gather(work))
        self.runner.add_score_wall(time.perf_counter() - t0)

    # -- the online alert->culprit pass (anomod_torch.serve.rca) -----------

    def _rca_step(self, now: float, served: List[QueuedBatch]) -> None:
        """One tick's RCA pass, inside the measured tick wall: this tick's
        new alerts enqueue first, then the served spans buffer, pruned no
        further back than each tenant's OLDEST queued alert window (so a
        budget-delayed run still finds its whole evidence window), then
        up to ``rca_budget`` queued runs."""
        self._rca_enqueue(now)
        floor: Dict[int, int] = {}
        for _, tid, w, _ in self._rca_queue:
            floor[tid] = min(floor.get(tid, w), w)
        for qb in served:
            self._rca_plane.buffer(qb.tenant_id, qb.spans,
                                   keep_window=floor.get(qb.tenant_id))
        self._rca_tick(now)

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
        per-tick ``rca_budget``) in enqueue order.  A tenant that keeps
        alerting while earlier items queue gets a NEW item per tick-batch
        of alerts, so the item set, and the verdict stream, is the same
        at any budget; the budget moves only ``scored_s``."""
        self._rca_enqueue(now)
        if not self._rca_queue:
            return
        burst = min(budget if budget is not None else self.rca_budget,
                    len(self._rca_queue))
        items = [self._rca_queue.popleft() for _ in range(burst)]
        with self._span("serve.rca"):
            runs = self._rca_run_items(items, now)
        for verdict, wall in runs:
            self.rca_verdicts.append(verdict)
            self._rca_slo.record(wall)
            self.rca_wall_s += wall

    def _rca_run_items(self, items: list, now: float) -> list:
        """``(verdict, wall_s)`` of each queued item, in order."""
        out = []
        for _, tid, w, enq in items:
            det = self._tenant_det.get(tid)
            alerts = det.alerts if det is not None else []
            out.append(self._rca_plane.run(tid, w, alerts, enqueued_s=enq,
                                           scored_s=now))
        return out

    def run(self, traffic, duration_s: float,
            warm: bool = True) -> "ServeReport":
        """Drive the engine from a traffic source for ``duration_s``
        virtual seconds, then close every tenant's last window."""
        if warm:
            self.runner.warm()          # first launches outside the wall
            if self.fuse:
                self.runner.warm_lanes()
            if self.rca:
                self._rca_plane.runner.warm()
        n_ticks = max(int(round(duration_s / self.clock.tick_s)), 1)
        with self._span("serve.run"):
            for _ in range(n_ticks):
                lo = self.clock.now_s
                self.tick(traffic.arrivals(lo, lo + self.clock.tick_s))
        t_wall = time.perf_counter()
        if self.score:
            for det in self._tenant_det.values():
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
        return self.report(traffic=traffic)

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
        r = self.runner
        dev = device_name(self.device)
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
            buckets=r.buckets,
            dispatches_by_width=dict(r.dispatches_by_width),
            fused=self.fuse,
            fused_dispatches=r.fused_dispatches,
            lane_buckets=r.lane_buckets,
            lanes_by_bucket=dict(r.lanes_by_bucket),
            lane_pad_waste=round(r.lane_pad_waste, 6),
            compile_s=round(r.compile_s, 4),
            lane_compile_s=round(r.lane_compile_s, 4),
            native_staging=r.native_stage,
            native_staged_dispatches=r.native_staged,
            serve_state=self.serve_state,
            stage_wall_s=round(r.stage_wall_s, 4),
            dispatch_wall_s=round(r.dispatch_wall_s, 4),
            fold_wall_s=round(r.fold_wall_s, 4),
            score_wall_s=round(r.score_wall_s, 4),
            pipeline=self.pipeline,
            latency=_merged_quantiles(list(self._slo.values())),
            per_priority=per_pri,
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
            device=dev,
            serve_wall_s=round(self.serve_wall_s, 4),
            sustained_spans_per_sec=round(
                self.n_spans_served / max(self.serve_wall_s, 1e-9), 1),
        )
