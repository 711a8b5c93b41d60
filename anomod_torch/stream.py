"""Online (streaming) detection over the replay plane (counterpart of
``anomod/stream.py``).

- :class:`StreamReplay` folds span micro-batches (arrival order) through
  the replay's chunk step (``replay.make_chunk_step``: the dense CUDA
  kernel on the card), so the incremental planes equal a one-shot replay
  of the same spans up to f32 add order.
- :class:`OnlineDetector` scores each *closed* 60 s window per service
  with four plane-derived z statistics (SE-of-mean log-latency, smoothed
  binomial error rate, per-window drop, recovery-resetting CUSUM) and
  raises :class:`Alert` rows; culprit ranking sums alert scores under
  dependency-chain attribution over the observed call graph, with the
  out-edge plane (node ids ⊕ self-edge slots ⊕ out-edge slots, 3S rows)
  naming link-fault culprits.

- :class:`MultimodalDetector` fuses log, metric and API planes (host
  per-window accumulators, three more per-service z signals) with the
  span statistics; :func:`stream_experiment_multimodal` slices all four
  modalities on one clock.  Its ranking adds the branches only modality
  evidence reaches: per-(caller, callee) concentration verdicts and the
  plane-corroboration tier.  The pair accumulators behind the verdicts
  fill only in the multimodal detector: on span evidence alone the
  verdicts are never read.

As in the JAX package, ``ANOMOD_RANK_TIER=0`` turns the corroboration
tier's reorder off and ``ANOMOD_EDGE_DEBUG`` prints the out-edge plane's
leader each scored window.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from anomod_torch import obs
from anomod_torch.device import DeviceLike, resolve_device
from anomod_torch.io.prefetch import iter_chunk_dicts, prefetch_to_device
from anomod_torch.replay import (F_COUNT, F_ERR, F_LOGLAT, F_LOGLAT2,
                                 N_FEATS, ReplayConfig, ReplayState,
                                 dead_chunk, make_chunk_step, stage_columns,
                                 zero_state)
from anomod_torch.schemas import LOG_ERROR, SpanBatch, take_spans
from anomod_torch.synth import endpoint_owner


@dataclasses.dataclass(frozen=True)
class Alert:
    window: int            # closed window index that scored anomalous
    service: int           # service id (index into the batch's table)
    service_name: str
    score: float           # RANKING score: max of the latency/error z and
    #                        the drop z's weighted by their deficit FRACTION
    z_latency: float       # standard-error z on the window's log-latency mean
    z_error: float         # binomial z on the window's error rate
    z_drop: float          # per-window z on missing throughput
    z_drop_cum: float = 0.0  # CUSUM z over the current deficit run
    evidence: str = ""       # which signal won the ranking score


def roll_ring_state(state: ReplayState, cfg: ReplayConfig,
                    k: int) -> ReplayState:
    """Evict the oldest ``k`` windows from a ring-shaped state: shift the
    plane columns left on the device, zero the tail (anchor bookkeeping is
    the caller's).  Values pass through verbatim."""
    shift = min(k, cfg.n_windows)
    S, W = cfg.n_services, cfg.n_windows

    def roll2(x, width):
        x = x.reshape(S, W, width)
        out = torch.zeros_like(x)
        if shift < W:
            out[:, :W - shift] = x[:, shift:]
        return out.reshape(cfg.sw, width)

    return state._replace(agg=roll2(state.agg, N_FEATS),
                          hist=roll2(state.hist, cfg.n_hist_buckets))


def plane_view(state: ReplayState, cfg: ReplayConfig) -> np.ndarray:
    """Host copy of the aggregate plane as [S, W, F]."""
    agg = state.agg
    agg = agg.cpu().numpy() if torch.is_tensor(agg) else np.asarray(agg)
    return agg.reshape(cfg.n_services, cfg.n_windows, N_FEATS)


def edge_combined_cfg(cfg: ReplayConfig, n_services: int) -> ReplayConfig:
    """The COMBINED-id-space config an edge-attributing detector runs its
    replay on: node ids ⊕ self-edge slots ⊕ out-edge slots = 3S rows."""
    return dataclasses.replace(cfg, n_services=3 * n_services)


def _binom_tail_z(x: int, n: int, p: float) -> float:
    """z-equivalent of the upper binomial tail P(X >= x | n, p): exact
    summation at small counts, normal approximation once n*p is large,
    converted through the standard-normal survival function."""
    if x <= 0 or n <= 0:
        return 0.0
    if n > 60 and n * p > 10.0:
        return float((x - n * p) / math.sqrt(max(n * p * (1.0 - p), 1e-9)))
    tail = 0.0
    for k in range(int(x), int(n) + 1):
        tail += math.comb(int(n), k) * p ** k * (1.0 - p) ** (int(n) - k)
    if tail >= 0.5:
        return 0.0
    lo, hi = 0.0, 40.0
    for _ in range(60):                      # bisection on the survival fn
        mid = 0.5 * (lo + hi)
        if 0.5 * math.erfc(mid / math.sqrt(2.0)) > tail:
            lo = mid
        else:
            hi = mid
    return lo


def resolve_parent_services(batch: SpanBatch) -> np.ndarray:
    """Per-span PARENT-service id (-1 for roots).  ``parent`` holds
    batch-global row indices, so this runs on the FULL corpus before any
    row slicing."""
    psvc = np.full(batch.n_spans, -1, np.int32)
    has = batch.parent >= 0
    psvc[has] = batch.service[batch.parent[has]]
    return psvc


def window_span_z(col_plane: np.ndarray, b: dict, cusum, cusum_k,
                  min_count, drop_memory) -> dict:
    """THE per-closed-window span-plane z math.

    ``col_plane`` is the window's aggregate column ``[..., K, F]``, ``b``
    the frozen calibration snapshot with ``[..., K]`` fields,
    ``cusum``/``cusum_k`` the CUSUM carry state.  Elementwise numpy, so a
    leading batch axis prepends freely (the sequential and the batched
    scorer run the identical per-element arithmetic).

    Returns ``dict(zl, ze, zd, zdc, frac_w, frac_t, cusum, cusum_k)``
    with the CUSUM state advanced (the caller installs it).
    """
    n_w = col_plane[..., F_COUNT]
    safe = np.maximum(n_w, 1.0)
    ok = (n_w >= min_count) & b["calibrated"]
    zl = np.where(ok, (col_plane[..., F_LOGLAT] / safe - b["mu_l"])
                  / np.sqrt(b["var_span"] / safe + b["var_bl"]), 0.0)
    ze = np.where(ok, (col_plane[..., F_ERR] / safe - b["p_err"])
                  / np.sqrt(b["err_var"] / safe + b["var_be"]), 0.0)
    zd = np.where(b["active"], (b["rate0"] - n_w) / b["sd_cnt"], 0.0)
    # CUSUM on missing throughput: the slack keeps healthy jitter from
    # accumulating; a window back at the baseline rate RESETS the run
    healthy = n_w >= b["rate0"]
    slack = 0.25 * b["sd_cnt"]
    cusum = np.where(healthy, 0.0,
                     np.maximum(0.0, cusum + b["rate0"] - n_w - slack))
    cusum_k = np.where(cusum > 0,
                       np.minimum(cusum_k + 1, drop_memory),
                       0).astype(np.int32)
    k_run = np.maximum(cusum_k, 1)
    zdc = np.where(b["cum_active"],
                   cusum / (b["sd_cnt"] * np.sqrt(k_run)), 0.0)
    frac_t = np.clip(cusum / np.maximum(k_run * b["rate0"], 1e-9),
                     0.0, 1.0)
    frac_w = np.clip(1.0 - n_w / np.maximum(b["rate0"], 1e-9), 0.0, 1.0)
    return dict(zl=zl, ze=ze, zd=zd, zdc=zdc, frac_w=frac_w,
                frac_t=frac_t, cusum=cusum, cusum_k=cusum_k)


#: ranking-evidence channel order of the span planes
SPAN_EV_NAMES = ("latency", "error", "drop", "cusum")


class StreamReplay:
    """Incremental replay state over arrival-ordered span micro-batches.

    ``t0_us`` anchors the window grid at stream start.  The grid ROLLS: a
    push whose spans start past the last column evicts the oldest windows
    and advances the anchor; ``window_offset`` is the absolute index of
    plane column 0.  The state lives on ``device``; each staged chunk is
    folded by the chunk step, the dense CUDA kernel's wrapper;
    ``with_hll`` adds per-service distinct-trace registers (``state.hll``,
    one ``hll_update`` launch per chunk), which a roll leaves untouched.
    """

    def __init__(self, cfg: ReplayConfig, t0_us: int,
                 device: DeviceLike = None, with_hll: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.t0_us = int(t0_us)
        self.window_offset = 0     # absolute window index of plane column 0
        self.n_spans = 0
        self._step = make_chunk_step(cfg, with_hll=with_hll)
        self.state = zero_state(cfg, self.device, with_hll=with_hll)
        #: one-time warm-up wall (kernel build + first launch), measured
        #: at the first push
        self.compile_s = 0.0
        self._warmed = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm(self) -> None:
        """Run the chunk step on an all-dead chunk (numerically a no-op)
        so push() walls measure the steady pipeline, not the kernel
        build."""
        t0 = time.perf_counter()
        self.state = self._step(self.state, dead_chunk(self.cfg, self.device))
        self._sync()
        self.compile_s = time.perf_counter() - t0
        obs.counter("anomod_stream_compile_total").inc()
        obs.counter("anomod_stream_compile_seconds_total").inc(
            self.compile_s)
        self._warmed = True

    def _roll(self, k: int) -> None:
        """Evict the oldest ``k`` windows and advance the anchor by the
        FULL ``k`` (only the column shift clamps)."""
        self.state = roll_ring_state(self.state, self.cfg, k)
        self.t0_us += k * self.cfg.window_us
        self.window_offset += k

    def push(self, batch: SpanBatch) -> int:
        """Fold a micro-batch into the plane.  Returns the newest ABSOLUTE
        window the batch's spans were binned into (-1 for an empty
        batch)."""
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
        pipe = prefetch_to_device(iter_chunk_dicts(chunks), self.device)
        try:
            for staged in pipe:
                self.state = self._step(self.state, staged)
        finally:
            pipe.close()
        self.n_spans += n
        obs.histogram("anomod_stream_push_seconds").observe(
            time.perf_counter() - t_push)
        return self.window_offset + max(w_need, 0)

    def agg_plane(self) -> np.ndarray:
        """Host copy of the aggregate plane as [S, W, F] (column w holds
        absolute window ``window_offset + w``)."""
        return plane_view(self.state, self.cfg)

    def get_state(self) -> ReplayState:
        """The replay plane's current state (gather seam)."""
        return self.state

    def set_state(self, state: ReplayState) -> None:
        """Install an externally-advanced state (scatter seam).  The
        caller owns the parity contract."""
        self.state = state


class OnlineDetector:
    """Window-closed z-score alerting over a :class:`StreamReplay`.

    The first ``baseline_windows`` closed windows per service calibrate
    the baselines (faults start at window 10 on the default grid).  A
    window is closed once a pushed span starts in a LATER window.
    ``consecutive`` windows above ``z_threshold`` are required before
    alerting.  With ``edge_attribution`` (default on for the detector's
    own plane) the replay id space widens to 3S rows: every span is
    pushed twice, keyed once by its service and once by its edge slot
    (the caller's out-edge slot 2S+p for a cross-service parent, else its
    own self-edge slot S+c).  ``replay`` injects a pre-built plane with
    the same contract; otherwise the detector builds its own as
    ``replay_factory(cfg, t0_us, device=device, with_hll=with_hll)`` (a
    :class:`StreamReplay` unless the caller supplies another);
    ``with_hll`` gives that plane distinct-trace registers.  ``mesh`` (an
    ``anomod_torch.parallel.Mesh``) builds the detector's own plane as a
    :class:`~anomod_torch.parallel.stream.ShardedStreamReplay` over it,
    on the mesh's device.
    """

    def __init__(self, batch_services: Sequence[str], cfg: ReplayConfig,
                 t0_us: int, baseline_windows: int = 8,
                 z_threshold: float = 4.0, min_count: float = 5.0,
                 consecutive: int = 1, drop_memory: int = 8,
                 call_edges: Optional[set] = None, replay=None,
                 with_hll: bool = False,
                 edge_attribution: Optional[bool] = None,
                 edge_pool: int = 12, edge_mass: float = 8.0,
                 device: DeviceLike = None,
                 replay_factory: Callable = StreamReplay, mesh=None):
        if baseline_windows < 2:
            raise ValueError("need >= 2 baseline windows for a sigma")
        if baseline_windows >= cfg.n_windows:
            raise ValueError("baseline must fit inside the window ring "
                             f"({baseline_windows} >= {cfg.n_windows})")
        if consecutive < 1:
            raise ValueError("consecutive must be >= 1 (0 would alert "
                             "every service in every window)")
        if replay is not None and with_hll:
            raise ValueError("with_hll configures the detector's OWN "
                             "plane; an injected replay manages its own "
                             "HLL state")
        if mesh is not None and replay is not None:
            raise ValueError("give a mesh OR a pre-built replay, not both")
        if mesh is not None and with_hll:
            raise ValueError("the mesh streaming plane carries no HLL "
                             "state (psum-merged agg/hist only)")
        if mesh is not None and device is not None \
                and resolve_device(device).type != mesh.device.type:
            raise ValueError(f"device {device} disagrees with the mesh's "
                             f"{mesh.device}")
        self.services = tuple(batch_services)
        S = len(self.services)
        self._n_svc = S
        self.edge_attribution = (replay is None) if edge_attribution is None \
            else bool(edge_attribution)
        if edge_pool < 1:
            raise ValueError("edge_pool must be >= 1 window")
        if edge_mass < 1:
            raise ValueError("edge_mass must be >= 1 span")
        self.edge_pool = edge_pool      # max window REACH of the edge pool
        self.edge_mass = edge_mass      # span-mass target the pool walks to
        if self.edge_attribution:
            K = 3 * S
            cfg = edge_combined_cfg(cfg, S)
            self._edge_hot: dict = {}       # caller id -> summed hot score
            self._self_hot = np.zeros(S, bool)
            # per-(caller, callee) pair accumulators [n, sum log1p dur,
            # n_err] keyed caller*S+callee, split at the calibration
            # boundary (MultimodalDetector._accumulate_pairs fills them)
            self._pair_base: dict = {}
            self._pair_anom: dict = {}
        else:
            K = S
        self._K = K
        if replay is not None and (replay.cfg != cfg
                                   or replay.t0_us != int(t0_us)):
            raise ValueError(
                "injected replay's cfg/t0 disagree with the detector's"
                + (" (edge attribution widens the id space: build the "
                   f"replay with n_services = 3*S = {K})"
                   if self.edge_attribution else ""))
        if replay is None and mesh is not None:
            from anomod_torch.parallel.stream import ShardedStreamReplay
            replay = ShardedStreamReplay(cfg, t0_us, mesh)
        self.replay = replay if replay is not None else \
            replay_factory(cfg, t0_us, device=device, with_hll=with_hll)
        #: spans fed by the caller (the combined-id replay counts each
        #: span twice internally)
        self.n_spans_in = 0
        self.baseline_windows = baseline_windows
        self.z_threshold = z_threshold
        self.min_count = min_count
        self.consecutive = consecutive
        self.drop_memory = drop_memory
        #: observed caller→callee service-id pairs (self-loops ignored)
        self.call_edges = {(a, b) for a, b in (call_edges or set())
                           if a != b}
        self.alerts: List[Alert] = []
        #: accumulated wall time inside push() (staging + chunk folds +
        #: window scoring)
        self.push_wall_s = 0.0
        self._scored_through = -1          # last closed ABSOLUTE window scored
        self._max_seen = -1                # newest absolute window with data
        self._callees_cache: dict = {}
        self._streak = np.zeros(self._K, np.int32)
        self._baseline = None              # frozen calibration snapshot
        self._cusum = np.zeros(self._K, np.float64)
        self._cusum_k = np.zeros(self._K, np.int32)

    def _callees_of(self, p: int) -> frozenset:
        """Observed callees of service ``p`` (from ``call_edges``)."""
        got = self._callees_cache.get(p)
        if got is None:
            got = frozenset(c for a, c in self.call_edges if a == p)
            self._callees_cache[p] = got
        return got

    def _edge_ids(self, svc: np.ndarray,
                  psvc: Optional[np.ndarray]) -> np.ndarray:
        """Edge slot per span: the CALLER's out-edge slot 2S+p for spans
        whose parent belongs to a different service, else the service's
        self-edge slot S+c."""
        S = self._n_svc
        out = (S + svc).astype(np.int32)
        if psvc is None:
            return out
        cross = (psvc >= 0) & (psvc != svc)
        if cross.any():
            out[cross] = (2 * S + psvc[cross]).astype(np.int32)
        return out

    _DUP_FIELDS = ("trace", "parent", "endpoint", "start_us",
                   "duration_us", "is_error", "status", "kind")

    def _pair_verdict(self, p: int) -> Optional[tuple]:
        """Concentration verdict for caller ``p``'s per-pair heat:
        ``("concentrated", callee)`` when one callee carries >= 60% of
        the degradation mass, ``("spread", -1)`` when it is spread, and
        ``None`` when there is not enough pair data to tell.  Spread heat
        is the link-fault signature; concentrated heat points at a node
        culprit."""
        S = self._n_svc
        deltas: List[tuple] = []
        n_obs = 0
        for k, (n_a, d_a, e_a) in self._pair_anom.items():
            if k // S != p or n_a < 3:
                continue
            base = self._pair_base.get(k)
            if not base or base[0] < 3:
                continue
            n_obs += 1
            d = max(d_a / n_a - base[1] / base[0], 0.0) \
                + 5.0 * max(e_a / n_a - base[2] / base[0], 0.0)
            if d > 0:
                deltas.append((d, int(k % S)))
        if n_obs < 2 or not deltas:
            return None          # one observed pair: spread undefined
        tot = sum(d for d, _ in deltas)
        d0, c0 = max(deltas)
        return ("concentrated", c0) if d0 >= 0.6 * tot else ("spread", -1)

    def push(self, batch: SpanBatch,
             parent_service: Optional[np.ndarray] = None) -> List[Alert]:
        """Feed a micro-batch; returns alerts for newly closed windows
        (ABSOLUTE window indices).  ``parent_service`` (len n_spans, -1 =
        root, resolved on the FULL corpus) feeds the edge plane."""
        if batch.n_spans and not self.replay._warmed:
            self.replay._warm()          # build outside the timed wall
        t0 = time.perf_counter()
        try:
            w_max = self.replay.push(
                self.replay_batch(batch, parent_service))
            return self.note_pushed(batch.n_spans, w_max)
        finally:
            self.push_wall_s += time.perf_counter() - t0

    def replay_batch(self, batch: SpanBatch,
                     parent_service: Optional[np.ndarray] = None
                     ) -> SpanBatch:
        """The EXACT batch push() hands the replay plane: edge-id
        duplication applied (the identity when edge attribution is
        off)."""
        if not (self.edge_attribution and batch.n_spans):
            return batch
        svc = batch.service.astype(np.int32)
        psvc = None if parent_service is None else \
            np.asarray(parent_service, np.int32)
        eids = self._edge_ids(svc, psvc)
        return batch._replace(
            service=np.concatenate([svc, eids]),
            **{f: np.concatenate([getattr(batch, f)] * 2)
               for f in self._DUP_FIELDS})

    def note_pushed(self, n_spans: int, w_max: int) -> List[Alert]:
        """Post-replay half of :meth:`push`: bookkeeping plus scoring of
        the newly closed windows."""
        through = self.note_bookkeep(n_spans, w_max)
        if through is None:
            return []
        return self._score_through(through)

    def note_bookkeep(self, n_spans: int, w_max: int) -> Optional[int]:
        """Span count + window high-water mark; returns the ``through``
        bound scoring would scan, or None for an empty push."""
        if w_max < 0:
            return None
        self.n_spans_in += n_spans
        self._max_seen = max(self._max_seen, w_max)
        return self._max_seen - 1

    def scoring_window_range(self, through: int):
        """The closed-window range ``(start, through)`` to score, or None
        after recording the no-op advance."""
        start = max(self._scored_through + 1, self.baseline_windows)
        if through < start:
            self._scored_through = max(self._scored_through, through)
            return None
        return start, through

    def ensure_baseline(self, plane: np.ndarray) -> dict:
        """The frozen calibration snapshot, computed from ``plane`` on
        first need (reads only columns ``[0, B)``)."""
        if self._baseline is None:
            self._baseline = self._calibrate(plane)
        return self._baseline

    @property
    def batch_scorable(self) -> bool:
        """True when scoring is exactly the node span-plane math (no edge
        rows, no modality planes), so :func:`score_closed_windows_batched`
        can score this detector with byte-identical results."""
        return type(self) is OnlineDetector and not self.edge_attribution

    def finish(self) -> List[Alert]:
        """End of stream: the newest window with data counts as closed."""
        return self._score_through(self._max_seen)

    # -- scoring ----------------------------------------------------------

    def _calibrate(self, plane: np.ndarray) -> dict:
        """Freeze baseline statistics from plane columns [0, B)."""
        B = self.baseline_windows
        if self.replay.window_offset > 0:
            raise RuntimeError(
                "stream jumped past the calibration phase before "
                f"{B} baseline windows closed (ring already rolled)")
        cnt = plane[..., F_COUNT]
        # pooled baseline per service (count-weighted, all B windows)
        C0 = np.maximum(cnt[:, :B].sum(axis=1), 1.0)
        mu_l = plane[:, :B, F_LOGLAT].sum(axis=1) / C0
        var_span = np.maximum(
            plane[:, :B, F_LOGLAT2].sum(axis=1) / C0 - mu_l ** 2, 1e-4)
        # Laplace-smoothed error rate (+1/+2 prior)
        p_err = (plane[:, :B, F_ERR].sum(axis=1) + 1.0) / (C0 + 2.0)
        err_var = np.maximum(p_err * (1.0 - p_err), 1e-6)
        rate0 = cnt[:, :B].mean(axis=1)          # spans per baseline window
        # between-window baseline variance over windows with traffic
        bsafe = np.maximum(cnt[:, :B], 1.0)
        bvalid = cnt[:, :B] >= self.min_count
        nb = np.maximum(bvalid.sum(axis=1), 1)

        def _between_var(per_window):
            m = (per_window * bvalid).sum(axis=1) / nb
            return ((per_window - m[:, None]) ** 2 * bvalid).sum(axis=1) / nb

        # sparse-row drift variance for the POOLED edge z: drift from ALL
        # non-empty windows minus the sampling noise of a window mean
        bvalid1 = cnt[:, :B] >= 1.0
        nb1 = np.maximum(bvalid1.sum(axis=1), 1)
        nbar1 = np.maximum((cnt[:, :B] * bvalid1).sum(axis=1) / nb1, 1.0)

        def _between_var_any(per_window):
            m = (per_window * bvalid1).sum(axis=1) / nb1
            return ((per_window - m[:, None]) ** 2
                    * bvalid1).sum(axis=1) / nb1

        drift_l = np.maximum(
            _between_var_any(plane[:, :B, F_LOGLAT] / bsafe)
            - var_span / nbar1, 0.0)
        drift_e = np.maximum(
            _between_var_any(plane[:, :B, F_ERR] / bsafe)
            - err_var / nbar1, 0.0)
        var_bl = _between_var(plane[:, :B, F_LOGLAT] / bsafe)
        var_be = _between_var(plane[:, :B, F_ERR] / bsafe)

        out = dict(
            mu_l=mu_l, var_span=var_span, p_err=p_err, err_var=err_var,
            rate0=rate0, C0=C0,
            var_bl_pool=np.where(var_bl > 0, var_bl, drift_l),
            var_be_pool=np.where(var_be > 0, var_be, drift_e),
            active=rate0 >= self.min_count,   # per-window drop needs traffic
            cum_active=rate0 >= 1.0,
            calibrated=C0 >= 2.0 * self.min_count,
            var_bl=var_bl, var_be=var_be,
            sd_cnt=np.sqrt(np.maximum(cnt[:, :B].var(axis=1),
                                      np.maximum(rate0, 1.0))))
        if self.edge_attribution:
            out.update(self._calibrate_edges(plane))
        return out

    def _calibrate_edges(self, plane: np.ndarray) -> dict:
        """Empirical-Bayes shrunk baselines for the SPARSE edge rows
        [S, 3S): self-edge rows borrow their service's node row, out-edge
        rows the pooled out-edge population; the error channel gets a
        fleet null scored by exact binomial tail."""
        B = self.baseline_windows
        S = self._n_svc
        tau = 1.2 * self.min_count
        cnt = plane[..., F_COUNT]
        c = cnt[S:3 * S, :B].sum(axis=1)             # raw, unclamped
        s1 = plane[S:3 * S, :B, F_LOGLAT].sum(axis=1)
        s2 = plane[S:3 * S, :B, F_LOGLAT2].sum(axis=1)
        csafe = np.maximum(c, 1.0)
        own_mu = s1 / csafe
        own_var = np.maximum(s2 / csafe - own_mu ** 2, 1e-4)
        # borrowed population per row
        node_mu = np.tile(plane[:S, :B, F_LOGLAT].sum(axis=1)
                          / np.maximum(cnt[:S, :B].sum(axis=1), 1.0), 2)
        node_c = np.maximum(cnt[:S, :B].sum(axis=1), 1.0)
        node_var = np.tile(np.maximum(
            plane[:S, :B, F_LOGLAT2].sum(axis=1) / node_c
            - (node_mu[:S]) ** 2, 1e-4), 2)
        oc = c[S:]                                   # out-edge rows
        o_tot = max(float(oc.sum()), 1.0)
        mu_pop_out = float(s1[S:].sum()) / o_tot
        var_pop_out = max(float(s2[S:].sum()) / o_tot - mu_pop_out ** 2,
                          1e-4)
        good = oc >= 4
        if int(good.sum()) >= 3:
            between = float(np.average(
                (own_mu[S:][good] - mu_pop_out) ** 2, weights=oc[good]))
        else:
            between = 0.25 * var_pop_out
        pop_mu = node_mu.copy()
        pop_var = node_var.copy()
        pop_mu[S:] = mu_pop_out
        pop_var[S:] = var_pop_out + between
        w = c / (c + tau)
        mu_sh = w * own_mu + (1 - w) * pop_mu
        var_sh = np.where(c > 1, w * own_var + (1 - w) * pop_var, pop_var)
        c_eff = c + tau
        # fleet error null (node plane pools every span once)
        p_fleet = float(plane[:S, :B, F_ERR].sum()
                        / max(float(cnt[:S, :B].sum()), 1.0))
        own_e = plane[S:3 * S, :B, F_ERR].sum(axis=1)
        p_null = np.clip((own_e + 2 * tau * p_fleet) / (c + 2 * tau)
                         * 2.0 + 0.005, 0.005, 0.5)
        return dict(edge_mu=mu_sh, edge_var=var_sh, edge_c_eff=c_eff,
                    edge_p_null=p_null)

    def _score_through(self, through: int) -> List[Alert]:
        """Score closed ABSOLUTE windows (scored_through, through]."""
        rng = self.scoring_window_range(through)
        if rng is None:
            return []
        start, through = rng
        plane = self.replay.agg_plane()
        b = self.ensure_baseline(plane)
        S, K = self._n_svc, self._K
        cnt = plane[..., F_COUNT]
        off = self.replay.window_offset
        # fleet activity per column (node rows see every span once): a
        # window nobody reported in is feed silence, never evidence
        fleet = cnt[:S].sum(axis=0) > 0
        out: List[Alert] = []
        for w in range(start, through + 1):
            col = w - off
            if col < 0 or not fleet[col]:
                # evicted before it could be scored, or feed silence: a
                # gap breaks hysteresis and the CUSUM run
                self._streak[:] = 0
                self._cusum[:] = 0.0
                self._cusum_k[:] = 0
                continue
            z = window_span_z(plane[:, col], b, self._cusum,
                              self._cusum_k, self.min_count,
                              self.drop_memory)
            self._cusum = z["cusum"]
            self._cusum_k = z["cusum_k"]
            zl, ze, zd, zdc = z["zl"], z["ze"], z["zd"], z["zdc"]
            # alerts fire on the raw z (sensitivity); the ranking score
            # weights the drop signals by their deficit FRACTION
            # (specificity); modality planes (a subclass's log / metric /
            # api z) join both at full weight, zero on edge rows
            extras = self._modality_z(w)
            if K > S:
                extras = {k: np.concatenate([v, np.zeros(K - S)])
                          for k, v in extras.items()}
            det_parts = dict(latency=zl, error=ze, drop=zd, cusum=zdc,
                             **extras)
            rank_parts = dict(latency=zl, error=ze, drop=zd * z["frac_w"],
                              cusum=zdc * z["frac_t"], **extras)
            detect_z = np.stack(list(det_parts.values())).max(axis=0)
            rank_stack = np.stack(list(rank_parts.values()))
            score = rank_stack.max(axis=0)
            ev_names = list(rank_parts)
            ev_idx = rank_stack.argmax(axis=0)
            hot = detect_z >= self.z_threshold
            if K > S:
                # Edge rows alert on span latency/error only, over a
                # mass-pooled VARIABLE-width window: walk back from the
                # current window until enough spans accumulate, capped at
                # ``edge_pool`` windows of reach, at two scales (narrow:
                # ``edge_mass`` spans; wide: one baseline block's worth)
                P = self.edge_pool
                plo = max(col - P + 1, 0)
                seg = plane[S:, plo:col + 1]
                rev_cnt = seg[..., F_COUNT][:, ::-1]
                cumc = rev_cnt.cumsum(axis=1)
                reach = cumc.shape[1]
                cuml = seg[..., F_LOGLAT][:, ::-1].cumsum(axis=1)
                cume = seg[..., F_ERR][:, ::-1].cumsum(axis=1)
                zl_p = np.zeros(2 * S)
                ze_p = np.zeros(2 * S)
                scales = (np.full(2 * S, self.edge_mass),
                          np.maximum(b["C0"][S:], self.edge_mass))
                n_p_wide = np.zeros(2 * S)  # wide-scale pooled counts
                for mass in scales:
                    m = mass[:, None]
                    has = cumc[:, -1:] >= m
                    kidx = np.where(
                        has, np.argmax(cumc >= m, axis=1, keepdims=True),
                        reach - 1)
                    n_p = np.take_along_axis(cumc, kidx, axis=1)[:, 0]
                    suml = np.take_along_axis(cuml, kidx, axis=1)[:, 0]
                    sume = np.take_along_axis(cume, kidx, axis=1)[:, 0]
                    safe_p = np.maximum(n_p, 1.0)
                    ok_p = n_p >= min(3.0, self.edge_mass)
                    zl_p = np.maximum(zl_p, np.where(
                        ok_p,
                        (suml / safe_p - b["edge_mu"])
                        / np.sqrt(b["edge_var"] / safe_p
                                  + b["edge_var"] / b["edge_c_eff"]
                                  + b["var_bl_pool"][S:]),
                        0.0))
                    # error channel: exact binomial tail against the fleet
                    # null, only rows with >= 2 pooled errors
                    for ei in np.nonzero(ok_p & (sume >= 2.0))[0]:
                        ze_p[ei] = max(ze_p[ei], _binom_tail_z(
                            int(sume[ei]), int(n_p[ei]),
                            float(b["edge_p_null"][ei])))
                    if mass is scales[1]:
                        n_p_wide = n_p
                # SELF-edge rows keep the conservative gates (own baseline
                # AND evidence mass >= min_count): they are the
                # node-vs-link locus discriminator
                self_ok = (b["C0"][S:2 * S] >= self.min_count) & \
                    (n_p_wide[:S] >= self.min_count)
                zl_p[:S] = np.where(self_ok, zl_p[:S], 0.0)
                ze_p[:S] = np.where(self_ok, ze_p[:S], 0.0)
                span_z = np.concatenate(
                    [np.maximum(zl, ze)[:S], np.maximum(zl_p, ze_p)])
                # out-edge alerting is two-tier: a halved-sigma threshold,
                # and below it a row that UNIQUELY dominates the out-edge
                # plane on a structurally thin baseline
                hot[S:] = span_z[S:] >= self.z_threshold
                out_z = span_z[2 * S:]
                if os.environ.get("ANOMOD_EDGE_DEBUG"):
                    # the out-edge plane's leader a scored window
                    _t = int(out_z.argmax())
                    print(f"[edge] w{w} top={self.services[_t]} "
                          f"z={out_z[_t]:.2f} "
                          f"2nd={float(np.partition(out_z, -2)[-2]):.2f}")
                hot_hi = out_z >= self.z_threshold - 0.5
                if out_z.size >= 2:
                    top = int(out_z.argmax())
                    second = float(np.partition(out_z, -2)[-2])
                    if (out_z[top] >= self.z_threshold - 1.5
                            and out_z[top] >= 1.2 * max(second, 1e-9)
                            and b["C0"][2 * S + top]
                            < 4.0 * self.min_count):
                        hot_hi[top] = True
                hot[2 * S:] |= hot_hi
            self._streak = np.where(hot, self._streak + 1, 0)
            for s in np.nonzero(self._streak[:S] >= self.consecutive)[0]:
                out.append(Alert(window=w, service=int(s),
                                 service_name=self.services[s],
                                 score=float(score[s]),
                                 z_latency=float(zl[s]),
                                 z_error=float(ze[s]),
                                 z_drop=float(zd[s]),
                                 z_drop_cum=float(zdc[s]),
                                 evidence=ev_names[int(ev_idx[s])]))
            if K > S:
                # a NODE fault heats the culprit's self-edge; a LINK fault
                # leaves every self-edge cool and only the culprit's
                # out-edge slot hot
                self._self_hot |= span_z[S:2 * S] >= self.z_threshold
                for pi in np.nonzero(
                        self._streak[2 * S:] >= self.consecutive)[0]:
                    p = int(pi)
                    # a callee with a hot SELF-edge owns the blame: the
                    # out-edge heat is its reflection
                    callees = self._callees_of(p)
                    if callees and bool(
                            (span_z[S + np.fromiter(callees, np.int64)]
                             >= self.z_threshold).any()):
                        continue
                    slot = 2 * S + p
                    sc = float(span_z[slot])
                    self._edge_hot[p] = self._edge_hot.get(p, 0.0) + sc
                    out.append(Alert(window=w, service=p,
                                     service_name=self.services[p],
                                     score=sc,
                                     z_latency=float(zl_p[slot - S]),
                                     z_error=float(ze_p[slot - S]),
                                     z_drop=0.0, z_drop_cum=0.0,
                                     evidence="edge"))
        self._scored_through = through
        self._after_score(through)
        self.alerts.extend(out)
        return out

    def _after_score(self, through: int) -> None:
        """Hook after scoring advances (the multimodal detector prunes its
        per-window host state here)."""

    def _modality_z(self, w: int) -> dict:
        """Hook for extra per-window, per-service z planes (the
        multimodal detector's log / api / metric)."""
        return {}

    # -- stream-mode quality metrics --------------------------------------

    def ranked_services(self) -> List[str]:
        """Culprit ranking: deepest anomalous dependency first.

        SUMMED alert scores per service, but a service with an anomalous
        service transitively downstream of it ranks after services with
        none (:func:`_explained_by_downstream`).  Edge-explained callees —
        hot incoming cross edges, self-edge never hot, no sustained
        modality evidence — are blast victims of the edge's CALLER; an
        edge-dominant caller yields only to node-borne anomalies
        downstream.  On a multimodal run, the per-pair concentration
        verdicts refine "node-borne", and each edge-dominant caller lifts
        above adjacent single-plane services that no span evidence
        corroborates."""
        peak: dict = {}
        total: dict = {}
        windows: dict = {}
        for a in self.alerts:
            peak[a.service] = max(peak.get(a.service, 0.0), a.score)
            total[a.service] = total.get(a.service, 0.0) + a.score
            windows.setdefault(a.service, set()).add(a.window)
        edge_explained: set = set()
        edge_dom: set = set()
        direct_node_ev: set = set()
        if self.edge_attribution and self._edge_hot:
            # node-borne modality evidence must SUSTAIN (>= 2 distinct
            # windows): one 4-sigma log/metric window is multiple-testing
            # noise
            mod_windows: dict = {}
            plane_groups: dict = {}   # log / metric / api / span, shared
            # with the corroboration tier below
            for a in self.alerts:
                g = a.evidence if a.evidence in ("log", "metric", "api") \
                    else "span"
                plane_groups.setdefault(a.service, set()).add(g)
                if g != "span":
                    mod_windows.setdefault(a.service, set()).add(a.window)
            direct_node_ev = {s for s, ws in mod_windows.items()
                              if len(ws) >= 2}
            hot_children = {c for p in self._edge_hot
                            for c in self._callees_of(p)}
            for c in hot_children:
                if c in peak and not self._self_hot[c] \
                        and c not in direct_node_ev:
                    edge_explained.add(c)
            #: callers whose evidence is mostly edge-borne
            edge_dom = {p for p, eh in self._edge_hot.items()
                        if p in total and eh >= 0.5 * total[p]}
            if edge_dom:
                # upstream blast: a service neither node-borne nor
                # edge-dominant from which an edge-dominant caller is
                # reachable is that caller's blast radius
                direct = {}
                for a, c in self.call_edges:
                    direct.setdefault(a, set()).add(c)

                def _reaches_edge_dom(q):
                    seen, frontier = {q}, [q]
                    while frontier:
                        nxt = direct.get(frontier.pop(), ())
                        for r in nxt:
                            if r in edge_dom:
                                return True
                            if r not in seen:
                                seen.add(r)
                                frontier.append(r)
                    return False

                for q in set(peak) - edge_dom - edge_explained:
                    if not self._self_hot[q] and q not in direct_node_ev \
                            and _reaches_edge_dom(q):
                        edge_explained.add(q)
        anomalous = set(peak) - edge_explained
        explained = _explained_by_downstream(self.call_edges, anomalous,
                                             peaks=peak, windows=windows)
        if edge_dom:
            # an edge-dominant caller yields only to NODE-borne anomalies
            # downstream: a hot self-edge, or sustained modality evidence
            # that its callers' pair heat does not refute as spread
            verdicts = {p: self._pair_verdict(p) for p in edge_dom}

            def _node_borne(s):
                if self._self_hot[s]:
                    return True
                if s not in direct_node_ev:
                    return False
                calling = [verdicts[p] for p in edge_dom
                           if verdicts[p] is not None
                           and s in self._callees_of(p)]
                # concentration on s wins over a spread refutation from
                # another caller
                if any(v == ("concentrated", s) for v in calling):
                    return True
                return not any(v == ("spread", -1) for v in calling)
            node_borne = {s for s in anomalous if _node_borne(s)}
            strict = _explained_by_downstream(
                self.call_edges, node_borne | edge_dom,
                peaks=peak, windows=windows)
            explained = (explained - edge_dom) | (strict & edge_dom)

        # Plane-corroboration tier: with an edge-dominant candidate on a
        # genuinely multimodal run (>= 2 evidence plane groups fired), a
        # service whose only evidence is one log / metric / api plane —
        # no span evidence, no hot self-edge, not the callee its caller's
        # pair heat concentrates on, and sustained only under a spread
        # refutation — is "uncorroborated"; each edge-dominant candidate
        # is bubbled above adjacent uncorroborated services below.
        # ``ANOMOD_RANK_TIER=0`` turns the reorder off.
        uncorroborated: set = set()
        if (edge_dom and os.environ.get("ANOMOD_RANK_TIER", "1") != "0"
                and len(set().union(*plane_groups.values())) >= 2):
            conc_exempt = {v[1] for v in verdicts.values()
                           if v is not None and v[0] == "concentrated"}
            spread_callees: set = set()
            for p, v in verdicts.items():
                if v == ("spread", -1):
                    spread_callees |= self._callees_of(p)
            uncorroborated = {
                s for s in total
                if s not in edge_dom and not self._self_hot[s]
                and s not in conc_exempt
                and (s not in direct_node_ev or s in spread_callees)
                and len(plane_groups.get(s, ())) < 2
                and "span" not in plane_groups.get(s, ())}

        def key(s):
            return (s in explained or s in edge_explained, -total[s])

        order = sorted(total, key=key)
        if uncorroborated:
            # pairwise, within one explained tier: exactly the pairs the
            # corroboration argument covers move
            changed = True
            while changed:
                changed = False
                for i in range(len(order) - 1):
                    a, b = order[i], order[i + 1]
                    if a in uncorroborated and b in edge_dom \
                            and key(a)[0] == key(b)[0]:
                        order[i], order[i + 1] = b, a
                        changed = True
        return [self.services[s] for s in order]

    def first_alert_window(self, service_name: Optional[str] = None):
        ws = [a.window for a in self.alerts
              if service_name is None or a.service_name == service_name]
        return min(ws) if ws else None


def score_closed_windows_batched(work, gather_cols) -> int:
    """Score many detectors' newly closed windows in ONE vectorized pass.

    ``work`` is a list of ``(det, start, through)`` for ``batch_scorable``
    detectors whose :meth:`OnlineDetector.scoring_window_range` returned
    ``(start, through)``; ``gather_cols(items)`` maps ``(work_index,
    col)`` pairs to a float32 ``[len(items), K, F]`` stack of plane
    columns.  Alerts, streaks, CUSUM state and ``_scored_through`` advance
    byte-identically to ``det._score_through(through)`` per detector.
    Returns the number of alerts raised.
    """
    if not work:
        return 0
    dets = [d for d, _, _ in work]
    K = dets[0]._K
    if any(d._K != K for d in dets):
        raise ValueError("batched scoring needs a uniform service table")
    for det in dets:
        if det._baseline is None:
            det.ensure_baseline(det.replay.agg_plane())
    bkeys = ("mu_l", "var_span", "var_bl", "p_err", "err_var", "var_be",
             "active", "cum_active", "calibrated", "rate0", "sd_cnt")
    b_all = {k: np.stack([d._baseline[k] for d in dets]) for k in bkeys}
    streak = np.stack([d._streak for d in dets])
    cusum = np.stack([d._cusum for d in dets])
    cusum_k = np.stack([d._cusum_k for d in dets])
    min_count = np.asarray([d.min_count for d in dets])[:, None]
    drop_memory = np.asarray([d.drop_memory for d in dets])[:, None]
    consecutive = np.asarray([d.consecutive for d in dets])[:, None]
    thr = np.asarray([d.z_threshold for d in dets])[:, None]
    offs = np.asarray([d.replay.window_offset for d in dets])
    new_alerts: dict = {t: [] for t in range(len(dets))}
    lo = min(s for _, s, _ in work)
    hi = max(t for _, _, t in work)
    for w in range(lo, hi + 1):
        act = np.asarray([s <= w <= t for _, s, t in work], bool)
        if not act.any():
            continue
        idx = np.nonzero(act)[0]
        cols = w - offs[idx]
        gathered = gather_cols(
            [(int(i), int(max(c, 0))) for i, c in zip(idx, cols)])
        # a window nobody reported in (or evicted) breaks hysteresis and
        # the CUSUM run, exactly as in the sequential scorer
        fleet = gathered[..., F_COUNT].sum(axis=1) > 0
        skip = (cols < 0) | ~fleet
        if skip.any():
            reset = idx[skip]
            streak[reset] = 0
            cusum[reset] = 0.0
            cusum_k[reset] = 0
        live = idx[~skip]
        if live.size == 0:
            continue
        z = window_span_z(gathered[~skip],
                          {k: v[live] for k, v in b_all.items()},
                          cusum[live], cusum_k[live],
                          min_count[live], drop_memory[live])
        cusum[live] = z["cusum"]
        cusum_k[live] = z["cusum_k"]
        det_stack = np.stack([z["zl"], z["ze"], z["zd"], z["zdc"]])
        rank_stack = np.stack([z["zl"], z["ze"], z["zd"] * z["frac_w"],
                               z["zdc"] * z["frac_t"]])
        detect_z = det_stack.max(axis=0)
        score = rank_stack.max(axis=0)
        ev_idx = rank_stack.argmax(axis=0)
        hot = detect_z >= thr[live]
        streak[live] = np.where(hot, streak[live] + 1, 0)
        firing = streak[live] >= consecutive[live]
        for j, s in np.argwhere(firing):
            t = int(live[j])
            det = dets[t]
            new_alerts[t].append(Alert(
                window=w, service=int(s),
                service_name=det.services[s],
                score=float(score[j, s]),
                z_latency=float(z["zl"][j, s]),
                z_error=float(z["ze"][j, s]),
                z_drop=float(z["zd"][j, s]),
                z_drop_cum=float(z["zdc"][j, s]),
                evidence=SPAN_EV_NAMES[int(ev_idx[j, s])]))
    n_alerts = 0
    for t, (det, _, through) in enumerate(work):
        det._streak = streak[t].copy()
        det._cusum = cusum[t].copy()
        det._cusum_k = cusum_k[t].copy()
        det._scored_through = through
        det._after_score(through)
        det.alerts.extend(new_alerts[t])
        n_alerts += len(new_alerts[t])
    return n_alerts


class MultimodalDetector(OnlineDetector):
    """Online detector fusing all the time-resolved modalities.

    Logs, metrics and API responses accumulate into per-(service,
    absolute-window) host planes and contribute three per-service z
    signals to every closed window, fused with the span statistics:

    - ``log``: Laplace-smoothed binomial z on the window's log-error rate;
    - ``metric``: per-SERIES |z| of the window mean vs its own frozen
      baseline (counters detected by monotone baseline means and
      rate-ified by window diffs), the sustained two-window minimum, max
      over the service's series;
    - ``api``: binomial z on per-owner-service probe error rates
      (endpoint -> owner via the gateway route tables).

    Coverage is not time-resolved and stays offline-only.  Modalities must
    be pushed before the span push that closes their windows
    (:func:`stream_experiment_multimodal` slices all four on one clock).
    """

    #: minimum lines/records in a window for its rate to be scored
    MIN_EVENTS = 3.0

    def __init__(self, batch_services: Sequence[str], cfg: ReplayConfig,
                 t0_us: int, testbed: Optional[str] = None, **kw):
        super().__init__(batch_services, cfg, t0_us, **kw)
        self.testbed = testbed
        self._t0_s = t0_us / 1e6
        self._win_s = cfg.window_us / 1e6
        self._svc_index = {s: i for i, s in enumerate(batch_services)}
        S = len(batch_services)
        self._S = S
        self._log_tot: dict = {}     # abs window -> [S] float
        self._log_err: dict = {}
        self._api_tot: dict = {}
        self._api_err: dict = {}
        # metric series: canonical key -> {"svc": id, "win": {w: [sum, n]}}
        self._met: dict = {}
        self._mm_base: Optional[dict] = None
        self._owner_cache: dict = {}
        # frozen grid anchor for the pair accumulators' phase split (the
        # replay's own t0 ROLLS with the ring)
        self._t0_us = int(t0_us)
        self._window_us = int(cfg.window_us)

    def replay_batch(self, batch: SpanBatch,
                     parent_service: Optional[np.ndarray] = None
                     ) -> SpanBatch:
        """The base class's replay batch, after folding the batch's cross
        edges into the per-pair accumulators the ranking's concentration
        verdicts read."""
        if self.edge_attribution and batch.n_spans \
                and parent_service is not None:
            self._accumulate_pairs(batch, batch.service.astype(np.int32),
                                   np.asarray(parent_service, np.int32))
        return super().replay_batch(batch, parent_service)

    def _accumulate_pairs(self, batch: SpanBatch, svc: np.ndarray,
                          psvc: np.ndarray) -> None:
        """Fold a micro-batch's cross edges into the per-pair phase
        accumulators (vectorized per unique pair; O(pairs) dict work)."""
        cross = (psvc >= 0) & (psvc != svc)
        if not cross.any():
            return
        wi = (batch.start_us[cross] - self._t0_us) // self._window_us
        keys = psvc[cross].astype(np.int64) * self._n_svc + svc[cross]
        dur = np.log1p(batch.duration_us[cross].astype(np.float64))
        err = batch.is_error[cross].astype(np.float64)
        in_base = wi < self.baseline_windows
        for phase, m in ((self._pair_base, in_base),
                         (self._pair_anom, ~in_base)):
            if not m.any():
                continue
            uk, inv = np.unique(keys[m], return_inverse=True)
            ns = np.bincount(inv).astype(np.float64)
            ds = np.bincount(inv, weights=dur[m])
            es = np.bincount(inv, weights=err[m])
            for k_, n_, d_, e_ in zip(uk.tolist(), ns, ds, es):
                acc = phase.setdefault(k_, [0.0, 0.0, 0.0])
                acc[0] += n_
                acc[1] += d_
                acc[2] += e_

    def _windows_of(self, t_s: np.ndarray) -> np.ndarray:
        return ((t_s - self._t0_s) // self._win_s).astype(np.int64)

    def push_logs(self, lb) -> None:
        if lb is None or lb.n_lines == 0:
            return
        t0 = time.perf_counter()
        smap = np.array([self._svc_index.get(n, -1) for n in lb.services],
                        np.int32)
        svc = smap[lb.service]
        w = self._windows_of(lb.t_s)
        keep = (svc >= 0) & (w >= 0)
        err = keep & (lb.level == LOG_ERROR)
        for wv in np.unique(w[keep]):
            m = keep & (w == wv)
            tot = self._log_tot.setdefault(int(wv), np.zeros(self._S))
            np.add.at(tot, svc[m], 1.0)
            ev = self._log_err.setdefault(int(wv), np.zeros(self._S))
            me = err & (w == wv)
            np.add.at(ev, svc[me], 1.0)
        self.push_wall_s += time.perf_counter() - t0

    def push_metrics(self, mb) -> None:
        if mb is None or mb.n_samples == 0:
            return
        t0 = time.perf_counter()
        smap = np.array([self._svc_index.get(n, -1) for n in mb.services],
                        np.int32)
        w = self._windows_of(mb.t_s)
        finite = np.isfinite(mb.value)
        # one accumulator per (metric, label-set) PAIR: a producer may
        # reuse one series id across metrics
        nm = len(mb.metric_names)
        combo = mb.series.astype(np.int64) * nm + mb.metric
        ok = finite & (w >= 0)
        for cv in np.unique(combo[ok]):
            si, mi = int(cv) // nm, int(cv) % nm
            sv = mb.series_service[si]
            svc = int(smap[sv]) if sv >= 0 else -1
            if svc < 0:
                continue
            sel = ok & (combo == cv)
            key = f"{mb.metric_names[mi]}|{mb.series_keys[si]}"
            rec = self._met.setdefault(key, {"svc": svc, "win": {}})
            for wv, val in zip(w[sel], mb.value[sel]):
                acc = rec["win"].setdefault(int(wv), [0.0, 0])
                acc[0] += float(val)
                acc[1] += 1
        self.push_wall_s += time.perf_counter() - t0

    def push_api(self, ab) -> None:
        if ab is None or ab.n_records == 0:
            return
        t0 = time.perf_counter()
        owner = np.empty(len(ab.endpoints), np.int32)
        for i, e in enumerate(ab.endpoints):
            if e not in self._owner_cache:
                self._owner_cache[e] = self._svc_index.get(
                    endpoint_owner(e, self.testbed or "TT"), -1)
            owner[i] = self._owner_cache[e]
        svc = owner[ab.endpoint]
        w = self._windows_of(ab.t_s)
        keep = (svc >= 0) & (w >= 0)
        err = keep & (ab.status >= 500)
        for wv in np.unique(w[keep]):
            m = keep & (w == wv)
            tot = self._api_tot.setdefault(int(wv), np.zeros(self._S))
            np.add.at(tot, svc[m], 1.0)
            ev = self._api_err.setdefault(int(wv), np.zeros(self._S))
            me = err & (w == wv)
            np.add.at(ev, svc[me], 1.0)
        self.push_wall_s += time.perf_counter() - t0

    # -- modality baselines + per-window z --------------------------------

    def _rate_baseline(self, tot: dict, err: dict) -> dict:
        B = self.baseline_windows
        T0 = np.zeros(self._S)
        E0 = np.zeros(self._S)
        rates = []
        for wv in range(B):
            t = tot.get(wv)
            if t is None:
                continue
            e = err.get(wv, np.zeros(self._S))
            T0 += t
            E0 += e
            with np.errstate(invalid="ignore", divide="ignore"):
                rates.append(np.where(t >= self.MIN_EVENTS, e / np.maximum(
                    t, 1.0), np.nan))
        p = (E0 + 1.0) / (T0 + 2.0)
        var = np.maximum(p * (1.0 - p), 1e-6)
        if rates:
            stack = np.stack(rates)           # [B_present, S], NaN = too few
            mask = np.isfinite(stack)
            n = np.maximum(mask.sum(axis=0), 1)
            mean = np.where(mask, stack, 0.0).sum(axis=0) / n
            var_b = np.where(mask, (stack - mean) ** 2, 0.0).sum(axis=0) / n
        else:
            var_b = np.zeros(self._S)
        return dict(p=p, var=var, var_b=var_b)

    def _metric_baseline(self) -> dict:
        B = self.baseline_windows
        out = {}
        for key, rec in self._met.items():
            means = {wv: s / n for wv, (s, n) in rec["win"].items() if n}
            base = [means[wv] for wv in range(B) if wv in means]
            if len(base) < 3:
                continue
            arr = np.asarray(base)
            counter = bool(np.all(np.diff(arr) >= -1e-12) and arr[-1] > arr[0])
            if counter:
                arr = np.diff(arr)
            mu = float(arr.mean())
            # relative sd floor: B windows underestimate a series' spread
            sd = float(max(arr.std(), 0.1 * (abs(mu) + 1.0)))
            out[key] = dict(svc=rec["svc"], mu=mu, sd=sd, counter=counter)
        return out

    def _series_z(self, key: str, b: dict, w: int) -> float:
        rec = self._met.get(key)
        if rec is None:
            return 0.0
        acc = rec["win"].get(w)
        if not acc or not acc[1]:
            return 0.0
        v = acc[0] / acc[1]
        if b["counter"]:
            prev = rec["win"].get(w - 1)
            if not prev or not prev[1]:
                return 0.0
            v = v - prev[0] / prev[1]
        return abs(v - b["mu"]) / b["sd"]

    def _mm_calibrate(self) -> None:
        self._mm_base = dict(
            log=self._rate_baseline(self._log_tot, self._log_err),
            api=self._rate_baseline(self._api_tot, self._api_err),
            met=self._metric_baseline())

    def _rate_z(self, w: int, tot: dict, err: dict, base: dict) -> np.ndarray:
        t = tot.get(w)
        if t is None:
            return np.zeros(self._S)
        e = err.get(w, np.zeros(self._S))
        ok = t >= self.MIN_EVENTS
        safe = np.maximum(t, 1.0)
        return np.where(ok, (e / safe - base["p"])
                        / np.sqrt(base["var"] / safe + base["var_b"]), 0.0)

    def _metric_z(self, w: int) -> np.ndarray:
        """Per-service metric z: max over the service's series of the
        SUSTAINED two-window z (min of this and the previous window's)."""
        z = np.zeros(self._S)
        for key, b in self._mm_base["met"].items():
            zi = min(self._series_z(key, b, w),
                     self._series_z(key, b, w - 1))
            s = b["svc"]
            if zi > z[s]:
                z[s] = zi
        return z

    def _modality_z(self, w: int) -> dict:
        if self._mm_base is None:
            self._mm_calibrate()
        out = {}
        if self._log_tot:
            out["log"] = self._rate_z(w, self._log_tot, self._log_err,
                                      self._mm_base["log"])
        if self._api_tot:
            out["api"] = self._rate_z(w, self._api_tot, self._api_err,
                                      self._mm_base["api"])
        if self._mm_base["met"]:
            out["metric"] = self._metric_z(w)
        return out

    def _after_score(self, through: int) -> None:
        """Bound the per-window host planes: once calibrated, windows
        older than ``through - 1`` are never read again (counter diffs
        need one lookback), so evict them."""
        if self._mm_base is None:
            return
        cut = through - 1
        for d in (self._log_tot, self._log_err, self._api_tot,
                  self._api_err):
            for wv in [k for k in d if k < cut]:
                del d[wv]
        for rec in self._met.values():
            win = rec["win"]
            for wv in [k for k in win if k < cut]:
                del win[wv]


#: per-batch-type row fields (explicit: a side table whose length equals
#: the sample count must not be sliced)
_ROW_FIELDS = {
    "LogBatch": ("service", "t_s", "level"),
    "MetricBatch": ("metric", "series", "t_s", "value"),
    "ApiBatch": ("endpoint", "t_s", "status", "latency_ms",
                 "content_length"),
}


def _take_nt(nt, mask):
    """Row-subset of a NamedTuple batch: sample-axis fields masked, side
    tables kept whole."""
    fields = _ROW_FIELDS[type(nt).__name__]
    return nt._replace(**{f: getattr(nt, f)[mask] for f in fields})


def stream_experiment_multimodal(exp, cfg: Optional[ReplayConfig] = None,
                                 slice_s: float = 60.0, **detector_kw):
    """Replay a full experiment bundle — spans, logs, metrics, API — in
    arrival order through the multimodal online detector.  One clock
    slices all four modalities; within each slice the low-volume
    modalities are pushed first so their windows are populated before the
    span push closes them.  Returns the finished detector."""
    batch = exp.spans
    cfg = cfg or ReplayConfig(n_services=batch.n_services, chunk_size=4096)
    edges = set()
    if batch.n_spans:
        has_parent = batch.parent >= 0
        edges = set(zip(batch.service[batch.parent[has_parent]].tolist(),
                        batch.service[has_parent].tolist()))
    psvc = resolve_parent_services(batch)
    order = np.argsort(batch.start_us, kind="stable")
    batch = take_spans(batch, order)
    psvc = psvc[order]
    t0 = int(batch.start_us.min()) if batch.n_spans else 0
    det = MultimodalDetector(batch.services, cfg, t0, testbed=exp.testbed,
                             call_edges=edges, **detector_kw)
    if not batch.n_spans:
        det.finish()
        return det
    t0_s = t0 / 1e6
    end_s = float(batch.start_us.max()) / 1e6
    lo_s = t0_s
    while lo_s <= end_s:
        hi_s = lo_s + slice_s
        if exp.logs is not None and exp.logs.n_lines:
            det.push_logs(_take_nt(exp.logs, (exp.logs.t_s >= lo_s)
                                   & (exp.logs.t_s < hi_s)))
        if exp.metrics is not None and exp.metrics.n_samples:
            det.push_metrics(_take_nt(exp.metrics, (exp.metrics.t_s >= lo_s)
                                      & (exp.metrics.t_s < hi_s)))
        if exp.api is not None and exp.api.n_records:
            det.push_api(_take_nt(exp.api, (exp.api.t_s >= lo_s)
                                  & (exp.api.t_s < hi_s)))
        m = (batch.start_us >= lo_s * 1e6) & (batch.start_us < hi_s * 1e6)
        if m.any():
            det.push(take_spans(batch, m), parent_service=psvc[m])
        lo_s = hi_s
    det.finish()
    return det


def _explained_by_downstream(call_edges: set, anomalous: set,
                             peaks: Optional[dict] = None,
                             windows: Optional[dict] = None,
                             rho: float = 0.5) -> set:
    """Anomalous nodes explained by an anomalous node strictly downstream.

    Condense the call graph into strongly-connected components (iterative
    Tarjan), then mark an anomalous node "explained" iff some OTHER SCC
    reachable from its own holds an anomalous node that passes the
    magnitude guard (its peak >= ``rho`` x the caller's), the onset guard
    (its first alert lags the caller's by at most 2 windows) and the
    concentration guard (its alerts mostly fall inside the caller's
    anomalous interval, or cover at least half of it)."""
    nodes = {n for e in call_edges for n in e} | set(anomalous)
    adj = {n: [] for n in nodes}
    for a, b in call_edges:
        adj[a].append(b)
    # iterative Tarjan SCC
    index = {}
    low = {}
    comp = {}
    stack, on_stack = [], set()
    counter = [0]
    n_comp = [0]
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for u in it:
                if u not in index:
                    index[u] = low[u] = counter[0]
                    counter[0] += 1
                    stack.append(u)
                    on_stack.add(u)
                    work.append((u, iter(adj[u])))
                    advanced = True
                    break
                if u in on_stack:
                    low[v] = min(low[v], index[u])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                while True:
                    u = stack.pop()
                    on_stack.discard(u)
                    comp[u] = n_comp[0]
                    if u == v:
                        break
                n_comp[0] += 1
    # condensation adjacency + anomalous members per SCC
    canom = {}
    for n in anomalous:
        canom.setdefault(comp[n], set()).add(n)
    cadj = {}
    for a, b in call_edges:
        if comp[a] != comp[b]:
            cadj.setdefault(comp[a], set()).add(comp[b])
    # Tarjan emits SCCs in REVERSE topological order, so one pass over
    # component ids visits children before parents
    memo = {}
    for c in range(n_comp[0]):
        acc = set()
        for d in cadj.get(c, ()):
            acc |= canom.get(d, set())
            acc |= memo.get(d, set())
        memo[c] = acc

    def guards_pass(n, b):
        if peaks is not None and peaks.get(b, 0.0) < rho * peaks.get(n, 0.0):
            return False
        if windows is not None:
            wn, wb = windows.get(n, set()), windows.get(b, set())
            if not wn or not wb:
                return False
            first_n, last_n = min(wn), max(wn)
            if min(wb) > first_n + 2:          # consequence, not cause
                return False
            inside = sum(1 for y in wb
                         if first_n - 1 <= y <= last_n + 1)
            span_n = last_n - first_n + 1
            if inside < 0.5 * len(wb) and inside < 0.5 * span_n:
                return False                   # scattered blips
        return True

    return {n for n in anomalous
            if any(guards_pass(n, b) for b in memo[comp[n]])}


def stream_experiment(batch: SpanBatch, cfg: Optional[ReplayConfig] = None,
                      slice_s: float = 60.0, **detector_kw):
    """Replay a corpus in arrival order through the online detector: sort
    spans by start time, slice the timeline into ``slice_s``-second
    micro-batches, push each.  Returns the finished
    :class:`OnlineDetector`."""
    cfg = cfg or ReplayConfig(n_services=batch.n_services, chunk_size=4096)
    # observed call graph and parent services resolve on the FULL batch
    # (time slices cut parent/child pairs across micro-batches)
    if batch.n_spans and "call_edges" not in detector_kw:
        has_parent = batch.parent >= 0
        callers = batch.service[batch.parent[has_parent]]
        callees = batch.service[has_parent]
        detector_kw = dict(detector_kw, call_edges=set(
            zip(callers.tolist(), callees.tolist())))
    psvc = resolve_parent_services(batch)
    order = np.argsort(batch.start_us, kind="stable")
    batch = take_spans(batch, order)
    psvc = psvc[order]
    t0 = int(batch.start_us.min()) if batch.n_spans else 0
    det = OnlineDetector(batch.services, cfg, t0, **detector_kw)
    if batch.n_spans:
        rel_s = (batch.start_us - t0) / 1e6
        bounds = np.searchsorted(
            rel_s, np.arange(slice_s, float(rel_s[-1]) + slice_s, slice_s))
        for lo, hi in zip(np.concatenate([[0], bounds]),
                          np.concatenate([bounds, [batch.n_spans]])):
            if hi > lo:
                sl = slice(int(lo), int(hi))
                det.push(take_spans(batch, sl), parent_service=psvc[sl])
    det.finish()
    return det


def stream_quality(testbed: str = "TT", n_traces: int = 400, seed: int = 0,
                   experiments: Optional[Sequence[str]] = None,
                   multimodal: bool = False, severity: float = 1.0,
                   noise: float = 0.0, n_confounders: int = 0,
                   shift: str = "in-dist", **detector_kw) -> List[dict]:
    """Streaming-mode quality over the fault taxonomy: one row per
    experiment with its alert timeline (``alerts``), ranked culprits,
    top-1/top-3 hits and signed detection latency in windows (fault onset
    = 600 s).  The corpus is ``rca.experiment_plan``'s, the offline
    quality sweep's: ``severity`` / ``noise`` de-saturate the generator
    (``synth.HardMode``), ``n_confounders`` plants decoy services and
    ``shift`` names one of the sweep's shifted generators
    (``quality.SHIFTS``: effect shape, fault timing, fault locus).
    ``multimodal`` generates each experiment's logs, metrics and API
    records and runs :func:`stream_experiment_multimodal`; otherwise only
    the spans are generated and :func:`stream_experiment` runs.  The
    remaining ``detector_kw`` (``mesh`` among them) reach every
    detector."""
    from anomod_torch import synth
    from anomod_torch.quality import SHIFTS
    from anomod_torch.rca import experiment_plan
    cfg = detector_kw.get("cfg")
    win_us = cfg.window_us if cfg is not None else 60_000_000
    onset_w = int(600_000_000 // win_us)
    hard = synth.HardMode(severity=severity, noise=noise, **SHIFTS[shift])
    rows = []
    for label, mode, gen_seed in experiment_plan(
            testbed, seed, hard=hard, n_confounders=n_confounders,
            experiments=experiments):
        if multimodal:
            det = stream_experiment_multimodal(
                synth.generate_experiment(label, n_traces=n_traces,
                                          seed=gen_seed, hard=mode),
                **detector_kw)
        else:
            det = stream_experiment(
                synth.generate_spans(label, n_traces=n_traces,
                                     seed=gen_seed, hard=mode),
                **detector_kw)
        ranked = det.ranked_services()
        row = dict(experiment=label.experiment, testbed=testbed,
                   target_service=label.target_service,
                   n_alerts=len(det.alerts), ranked=ranked,
                   first_alert_window=det.first_alert_window(),
                   alerts=list(det.alerts))
        if label.is_anomaly and label.target_service:
            fw = det.first_alert_window(label.target_service)
            row.update(
                top1_hit=bool(ranked) and ranked[0] == label.target_service,
                top3_hit=label.target_service in ranked[:3],
                first_culprit_alert_window=fw,
                detection_latency_windows=(None if fw is None
                                           else fw - onset_w))
        rows.append(row)
    return rows
