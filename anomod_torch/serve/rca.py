"""Online root-cause inference inside the serve tick: alert -> culprit
(counterpart of ``anomod/serve/rca.py``).

When a tenant's ``OnlineDetector`` fires during a tick, a culprit scorer
runs over that tenant's LIVE service graph and emits a ranked culprit
list (:class:`RCAVerdict`).  Inference runs in a fixed grid of padded
``(nodes, neighbors)`` bucket shapes (``ANOMOD_SERVE_RCA_BUCKETS``); each
bucket's first launch happens at :meth:`RcaRunner.warm`, outside the
serve wall, and is counted in ``anomod_serve_rca_compile_total`` (the
JAX package's ``lower().compile()`` seam; the port has no compile, so
the count is of first launches).  Neighbor lists are sampled: each node
keeps at most K seeded-uniformly-sampled callees, padded to the
bucket's K.

Determinism contract (the JAX package's, held by
``tests/test_torch_serve_rca.py``):

- the neighbor sampler is numpy ``default_rng((RCA_SEED, tenant_id,
  alert_window))``, the JAX package's own draws, and a verdict's
  evidence window is anchored to its TRIGGERING alert window, so
  reruns and budget-delayed runs produce byte-identical rankings;
- RCA is a pure READ-side consumer of the alert stream and its own span
  buffers: detector states, alerts, admission, SLO and shed decisions
  are byte-identical with RCA on or off.

Node features come from the shared offline/online feature module
(``anomod_torch.rca_features.windowed_features``) plus two alert-evidence
channels; the scorer is training-free blame propagation: per-node
evidence ``e = x . W`` (fixed weights), then ``RCA_ROUNDS`` rounds of
``h = e - BLAME_SHIFT * max(mean(sampled callee h), 0)``.  It is plain
XLA in the JAX package (no Pallas kernel), so here it is torch ops on
tensors of the runner's device, every sum written out as elementwise
adds in the order the JAX package's CPU run adds them: the card and the
CPU give the JAX package's f32 bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.config import get_config, validate_rca_buckets
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.graph import build_service_graph
from anomod_torch.rca_features import windowed_features
from anomod_torch.replay import ReplayConfig
from anomod_torch.schemas import SpanBatch, concat_span_batches, take_spans

#: feature width of the scorer's node inputs: 4 per-window means + 4
#: recent-vs-early trend deltas (anomod_torch.rca_features) + 2 alert
#: evidence channels (max alert ranking score, max raw z)
N_RCA_FEATS = 10

#: the sampler seed root: verdicts depend only on (tenant stream, alert
#: window), never on run order
RCA_SEED = 0x52CA

#: fixed evidence weights over the N_RCA_FEATS columns
#: [cnt_mean, err_mean, lat_mean, 5xx_mean,
#:  cnt_trend, err_trend, lat_trend, 5xx_trend, alert_score, alert_zmax]:
#: means carry no blame, trends do (a count DROP through the negative
#: weight), the detector's own alert evidence dominates
EVIDENCE_WEIGHTS = np.array(
    [0.0, 0.0, 0.0, 0.0, -0.5, 2.0, 1.0, 2.0, 1.0, 0.25], np.float32)

#: blame handed from a caller to its sampled callees per round
BLAME_SHIFT = 0.5
#: message-pass rounds (2 ~ the call depth of the testbed graphs)
RCA_ROUNDS = 2


@dataclasses.dataclass(frozen=True)
class RCAVerdict:
    """One alert->culprit inference result (JSON-able, byte-comparable:
    no wall-clock fields; the run wall rides the engine's RCA SLO
    digest)."""
    tenant_id: int
    alert_window: int          # absolute window of the triggering alert
    alert_close_s: float       # virtual close time of that window
    enqueued_s: float          # virtual tick the alert entered the queue
    scored_s: float            # virtual tick the verdict was produced
    services: Tuple[str, ...]  # ranked culprits, best first (top-k)
    scores: Tuple[float, ...]  # their scores, same order
    n_spans: int               # evidence spans in the feature window
    n_edges: int               # live service-graph edges
    bucket: Tuple[int, int]    # (nodes, neighbors) shape it ran in

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["services"] = list(self.services)
        d["scores"] = list(self.scores)
        d["bucket"] = list(self.bucket)
        return d


def _chain_sum(cols: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a left-to-right chain of elementwise f32
    adds (the JAX package's CPU reduction order), one order on every
    device where a reduction kernel's order is the device's own."""
    acc = cols[..., 0]
    for j in range(1, cols.shape[-1]):
        acc = acc + cols[..., j]
    return acc


def _evidence(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the N_RCA_FEATS = 10 columns, added in the tree the
    JAX package's CPU dot adds them in: the first eight columns as a
    pairwise tree, ``((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))``,
    then ``+ (p8 + p9)``; elementwise ops, so the card adds in the same
    order.  The weights are powers of two or zero, so each product is
    exact and the tree fixes every bit."""
    p = x * w
    c = [p[..., j] for j in range(N_RCA_FEATS)]
    head = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]))
    return head + (c[8] + c[9])


def make_culprit_scorer():
    """The fixed-shape scorer on tensors: evidence + sampled-neighbor blame
    propagation.  Inputs are one bucket's padded arrays (``x [N, F]`` f32,
    ``neigh [N, K]`` int64, ``nmask [N, K]`` f32, ``node_mask [N]`` f32)
    on one device; dead pad rows score ``-inf`` so they never enter a
    ranking."""

    def score(x, neigh, nmask, node_mask):
        w = torch.as_tensor(EVIDENCE_WEIGHTS, device=x.device)
        e = _evidence(x, w) * node_mask
        deg = torch.clamp(_chain_sum(nmask), min=1.0)
        h = e
        for _ in range(RCA_ROUNDS):
            agg = _chain_sum(h[neigh] * nmask) / deg
            # only POSITIVE callee evidence de-blames the caller
            h = e - BLAME_SHIFT * torch.clamp(agg, min=0.0)
        return torch.where(node_mask > 0, h,
                           torch.full_like(h, -float("inf")))

    return score


def sample_neighbors(g, k: int,
                     rng: np.random.Generator) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """``([S, k] callee ids, [S, k] f32 mask)``: each node's observed
    callees sampled WITHOUT replacement down to ``k`` (seeded; kept in CSR
    order, so a node at or below the cap is exact, not resampled)."""
    S = g.n_services
    neigh = np.zeros((S, k), np.int32)
    mask = np.zeros((S, k), np.float32)
    for i in range(S):
        cal = g.neighbors[i][g.neighbor_mask[i]]
        if cal.shape[0] > k:
            sel = np.sort(rng.choice(cal.shape[0], size=k, replace=False))
            cal = cal[sel]
        m = cal.shape[0]
        neigh[i, :m] = cal
        mask[i, :m] = 1.0
    return neigh, mask


def online_node_features(batch: Optional[SpanBatch], services,
                         cfg: ReplayConfig) -> np.ndarray:
    """[S, 8] online node features: per-window means + recent-vs-early
    trend deltas of the shared windowed extractor
    (``anomod_torch.rca_features.windowed_features``, the offline
    harness's feature code)."""
    S = len(services)
    if batch is None or batch.n_spans == 0:
        return np.zeros((S, 8), np.float32)
    wf = windowed_features(batch, tuple(services), cfg)       # [S, W, 4]
    q = max(cfg.n_windows // 4, 1)
    mean = wf.mean(axis=1)
    trend = wf[:, -q:].mean(axis=1) - wf[:, :q].mean(axis=1)
    return np.concatenate([mean, trend], axis=-1).astype(np.float32)


class RcaRunner:
    """The culprit-scorer dispatcher over the (nodes, neighbors) bucket
    grid, on ``device`` (``cuda`` unless the caller asks for ``cpu``).
    Each bucket's first launch (:meth:`warm`, on dead inputs) stands for
    the JAX package's compile and is counted in the runner
    (``compile_s_by_bucket``) and the registry
    (``anomod_serve_rca_compile_total`` / ``_seconds_total``); each run
    in ``runs_by_bucket`` and ``anomod_serve_rca_runs_total``."""

    def __init__(self, buckets: Optional[tuple] = None, registry=None,
                 device: DeviceLike = None):
        if buckets is None:
            buckets = get_config().serve_rca_buckets
        self.buckets = validate_rca_buckets(buckets)
        self.device = resolve_device(device)
        self._reg = registry if registry is not None else obs.get_registry()
        self._fn = make_culprit_scorer()
        self.compile_s_by_bucket: Dict[Tuple[int, int], float] = {}
        self.runs_by_bucket: Dict[Tuple[int, int], int] = {}
        self._obs_runs = self._reg.counter("anomod_serve_rca_runs_total")

    def bucket_for(self, n_services: int) -> Tuple[int, int]:
        """The smallest bucket whose node count holds ``n_services``."""
        for n, k in self.buckets:
            if n >= n_services:
                return (n, k)
        raise ValueError(
            f"no RCA bucket holds {n_services} services (grid "
            f"{self.buckets}; raise ANOMOD_SERVE_RCA_BUCKETS)")

    def _dead_args(self, n: int, k: int) -> tuple:
        return (np.zeros((n, N_RCA_FEATS), np.float32),
                np.zeros((n, k), np.int32),
                np.zeros((n, k), np.float32),
                np.zeros(n, np.float32))

    def _launch(self, x, neigh, nmask, node_mask) -> np.ndarray:
        """Copy one bucket's host arrays to the device, score, and bring
        the scores back in one device-to-host copy."""
        dev = self.device
        out = self._fn(torch.from_numpy(x).to(dev),
                       torch.from_numpy(neigh).to(dev, torch.int64),
                       torch.from_numpy(nmask).to(dev),
                       torch.from_numpy(node_mask).to(dev))
        return out.cpu().numpy()

    def _first_launch(self, key: Tuple[int, int]) -> float:
        t0 = time.perf_counter()
        self._launch(*self._dead_args(*key))
        wall = time.perf_counter() - t0
        self.compile_s_by_bucket[key] = wall
        self._reg.counter("anomod_serve_rca_compile_total").inc()
        self._reg.counter("anomod_serve_rca_compile_seconds_total").inc(wall)
        return wall

    def warm(self) -> float:
        """First-launch the whole bucket grid on dead inputs (outside any
        measured wall); returns the total wall; idempotent."""
        return sum(self._first_launch(key) for key in self.buckets
                   if key not in self.compile_s_by_bucket)

    @property
    def compile_s(self) -> float:
        return float(sum(self.compile_s_by_bucket.values()))

    @property
    def bucket_shapes(self) -> set:
        """Every (nodes, neighbors) bucket first-launched so far."""
        return set(self.compile_s_by_bucket)

    def score(self, x: np.ndarray, neigh: np.ndarray, nmask: np.ndarray,
              node_mask: np.ndarray) -> np.ndarray:
        """Score one padded bucket; returns the host scores."""
        key = (int(x.shape[0]), int(neigh.shape[1]))
        if key not in self.compile_s_by_bucket:
            self._first_launch(key)
        out = self._launch(x, neigh, nmask, node_mask)
        self.runs_by_bucket[key] = self.runs_by_bucket.get(key, 0) + 1
        self._obs_runs.inc()
        return out


class OnlineRCA:
    """The online-RCA plane: bounded span buffers (the live service-graph
    source) + the bucketed culprit scorer.

    The engine buffers each tenant's SERVED spans here and, when that
    tenant's detector fires, calls :meth:`run`.  A verdict's evidence is
    anchored to its triggering alert window: the feature extractor reads
    exactly the ``windows`` windows ENDING at the alert window, so a
    budget-delayed run scores the same evidence a same-tick run would.
    """

    def __init__(self, services: Sequence[str], window_us: int, t0_us: int,
                 runner: RcaRunner, topk: int = 5, windows: int = 8,
                 seed: int = RCA_SEED):
        self.services = tuple(services)
        S = len(self.services)
        self._svc_index = {s: i for i, s in enumerate(self.services)}
        self.cfg = ReplayConfig(n_services=S, n_windows=int(windows),
                                window_us=int(window_us), chunk_size=4096)
        self.runner = runner
        runner.bucket_for(S)        # fail loud at construction, not mid-tick
        self.topk = min(int(topk), S)
        self.windows = int(windows)
        self.window_us = int(window_us)
        self.t0_us = int(t0_us)
        self.seed = int(seed)
        self._buf: Dict[int, List[SpanBatch]] = {}
        self._buf_hi: Dict[int, int] = {}

    def buffer(self, tenant_id: int, batch: SpanBatch,
               keep_window: Optional[int] = None) -> None:
        """Append a served micro-batch to the tenant's evidence buffer,
        pruning batches that fell entirely out of feature reach (one
        window of slack).  ``keep_window`` floors the pruning at the
        oldest QUEUED alert window of this tenant, so a budget-delayed
        run still finds its whole ``[keep_window + 1 - windows,
        keep_window + 1)`` evidence range."""
        if batch.n_spans == 0:
            return
        buf = self._buf.setdefault(tenant_id, [])
        buf.append(batch)
        hi = max(self._buf_hi.get(tenant_id, 0), int(batch.start_us.max()))
        self._buf_hi[tenant_id] = hi
        cutoff = hi - (self.windows + 1) * self.window_us
        if keep_window is not None:
            cutoff = min(
                cutoff,
                self.t0_us + (keep_window + 1 - self.windows)
                * self.window_us)
        while buf and int(buf[0].start_us.max()) < cutoff:
            buf.pop(0)

    def move_tenant_evidence(self, other: "OnlineRCA",
                             tenant_id: int) -> None:
        """Hand one tenant's evidence buffer (and its high-water mark) to
        ``other``, the migration seam of the JAX package's supervision and
        elastic planes (none is ported yet).  A tenant with no buffered
        evidence is a no-op; batches move by reference."""
        buf = self._buf.pop(tenant_id, None)
        hi = self._buf_hi.pop(tenant_id, None)
        if buf is not None:
            other._buf[tenant_id] = buf
        if hi is not None:
            other._buf_hi[tenant_id] = hi

    def _evidence_batch(self, tenant_id: int,
                        alert_window: int) -> Optional[SpanBatch]:
        lo = self.t0_us + (alert_window + 1 - self.windows) * self.window_us
        hi = self.t0_us + (alert_window + 1) * self.window_us
        parts = []
        for b in self._buf.get(tenant_id, ()):
            m = (b.start_us >= lo) & (b.start_us < hi)
            if m.any():
                parts.append(take_spans(b, m))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else concat_span_batches(parts)

    def run(self, tenant_id: int, alert_window: int, alerts,
            enqueued_s: float,
            scored_s: float) -> Tuple[RCAVerdict, float]:
        """One alert->culprit inference; returns ``(verdict, wall_s)``
        (the wall kept out of the verdict so verdicts stay
        byte-comparable)."""
        t0 = time.perf_counter()
        S = len(self.services)
        batch = self._evidence_batch(tenant_id, alert_window)
        feats = online_node_features(batch, self.services, self.cfg)
        ev = np.zeros((S, 2), np.float32)
        lo_w = alert_window - self.windows
        for a in alerts:
            if not (lo_w < a.window <= alert_window):
                continue
            i = self._svc_index.get(a.service_name)
            if i is None:
                continue
            ev[i, 0] = max(ev[i, 0], np.float32(a.score))
            ev[i, 1] = max(ev[i, 1], np.float32(
                max(a.z_latency, a.z_error, a.z_drop, a.z_drop_cum)))
        x = np.concatenate([feats, ev], axis=-1)
        n, k = self.runner.bucket_for(S)
        xp = np.zeros((n, N_RCA_FEATS), np.float32)
        xp[:S] = x
        node_mask = np.zeros(n, np.float32)
        node_mask[:S] = 1.0
        neigh = np.zeros((n, k), np.int32)
        nmask = np.zeros((n, k), np.float32)
        n_edges = 0
        if batch is not None:
            g = build_service_graph(batch, services=self.services)
            n_edges = g.n_edges
            rng = np.random.default_rng(
                (self.seed, tenant_id, alert_window))
            sn, sm = sample_neighbors(g, k, rng)
            neigh[:S] = sn
            nmask[:S] = sm
        scores = self.runner.score(xp, neigh, nmask, node_mask)[:S]
        # stable descending rank, ties to the lower service index
        order = np.lexsort((np.arange(S), -scores))[:self.topk]
        verdict = RCAVerdict(
            tenant_id=int(tenant_id),
            alert_window=int(alert_window),
            alert_close_s=round(
                (self.t0_us + (alert_window + 1) * self.window_us) / 1e6, 6),
            enqueued_s=round(float(enqueued_s), 6),
            scored_s=round(float(scored_s), 6),
            services=tuple(self.services[i] for i in order),
            scores=tuple(round(float(scores[i]), 6) for i in order),
            n_spans=int(batch.n_spans) if batch is not None else 0,
            n_edges=int(n_edges),
            bucket=(n, k))
        return verdict, time.perf_counter() - t0
