"""Process-wide metrics registry: Counter / Gauge / Histogram
(counterpart of ``anomod/obs/registry.py``).

The port's runtime emits the three shapes every monitoring stack does,
with two twists that keep them the repo's own:

- **Histograms are t-digest sketches** built on the HOST
  (``anomod_torch.ops.tdigest.tdigest_build`` / ``tdigest_merge_many`` /
  ``tdigest_quantile`` on numpy), never the tensor build: recording a
  metric launches nothing on the card.  ``Histogram.merge_digest`` folds
  a foreign host digest (a serve tenant's SLO sketch) in, weight-
  preserving, without replaying raw samples.
- **The registry is a time series**: :meth:`Registry.scrape` appends
  every metric's samples to a bounded journal on a caller-supplied clock
  (the serve engine scrapes on its deterministic VIRTUAL clock), and the
  journal exports to the port's ``MetricBatch`` / TT-CSV shapes
  (``anomod_torch.obs.export``), so a run's telemetry loads back through
  ``load_tt_metric_csv`` and scores through the detector stack.

Hot-path cost: one dict ``get`` at handle lookup (call sites cache
handles) and one small-lock update per record.  With
``ANOMOD_OBS_ENABLED=0`` every constructor returns the shared
:data:`NULL` no-op handle, so instrumented code never branches.

Metric names follow ``anomod_<subsystem>_<what>[_unit][_total]``, the
JAX package's names: the subsystem token is the self-scrape scorer's
"service" (``anomod_torch.obs.selfscrape``).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch.ops.tdigest import (TDigest, tdigest_build,
                                      tdigest_merge_many, tdigest_quantile)

#: digest capacity for histogram sketches (same accuracy class as the
#: serving plane's _TenantSLO digests)
_DIGEST_K = 32
#: samples buffered per histogram before folding into the digest
_FOLD_EVERY = 256


def render_labels(labels: Dict[str, str]) -> str:
    """Canonical label rendering — the io.metrics series-key shape
    (``k="v"`` sorted, comma-joined), so exported series keys read the
    same as every loaded corpus's."""
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


def subsystem_of(name: str) -> str:
    """The subsystem token of a metric name (``anomod_serve_...`` ->
    ``serve``) — the self-scrape scorer's service identity."""
    parts = name.split("_")
    if len(parts) >= 2 and parts[0] == "anomod":
        return parts[1]
    return parts[0] or "anomod"


class _NullMetric:
    """Shared no-op handle for a disabled registry: every recording
    method exists and does nothing, so instrumented hot paths never
    branch on enablement."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def merge_digest(self, digest) -> None:
        pass

    def quantile(self, q: float):
        return None

    def samples(self):
        return []


NULL = _NullMetric()


class Counter:
    """Monotone accumulator; ``samples()`` exports the running total."""

    kind = "counter"
    __slots__ = ("name", "labels", "rendered", "rev", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        #: rendered-labels cache: computed once at registration, read by
        #: every scrape/fold instead of re-sorting the label dict per
        #: metric per barrier (the dense-fold hot spot's fixed half)
        self.rendered = render_labels(self.labels)
        #: mutation generation — bumped under the metric lock on every
        #: write, so a barrier fold can skip families untouched since
        #: its last visit (Registry.delta_snapshot's dirty check)
        self.rev = 0
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n
            self.rev += 1

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self._value)]


class Gauge:
    """Last-value metric with inc/dec convenience."""

    kind = "gauge"
    __slots__ = ("name", "labels", "rendered", "rev", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.rendered = render_labels(self.labels)
        self.rev = 0
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self.rev += 1

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self.rev += 1

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n
            self.rev += 1

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self._value)]


class Histogram:
    """t-digest-backed distribution sketch.

    ``observe`` appends to a small buffer and folds into the digest every
    ``_FOLD_EVERY`` samples (the _TenantSLO cadence) — the hot path is a
    list append, the sketch work is amortized.  ``merge_digest`` folds a
    foreign :class:`TDigest` (e.g. a serve tenant's SLO sketch) into this
    histogram's, weight-preserving, so pre-sketched telemetry joins the
    registry without replaying raw samples.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "rendered", "rev", "_lock", "_buf",
                 "_digest", "count", "sum", "_max", "_n_folds", "_q_cache")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.rendered = render_labels(self.labels)
        self.rev = 0
        self._lock = threading.Lock()
        self._buf: List[float] = []
        self._digest: Optional[TDigest] = None
        self.count = 0
        self.sum = 0.0
        self._max = 0.0
        self._n_folds = 0
        # (fold generation, p50, p99) — the scrape path recomputes
        # quantiles only when the DIGEST changed, so a per-tick scrape
        # costs dict lookups, not a tdigest build
        self._q_cache: Optional[Tuple[int, float, float]] = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._buf.append(v)
            self.count += 1
            self.sum += v
            self._max = max(self._max, v)
            self.rev += 1
            if len(self._buf) >= _FOLD_EVERY:
                self._fold_locked()

    def merge_digest(self, digest: TDigest) -> None:
        """Fold a pre-built digest in (count/sum book via its weights)."""
        w = float(np.asarray(digest.weight).sum())
        if w <= 0:
            return
        with self._lock:
            self.count += int(round(w))
            self.sum += float((np.asarray(digest.mean)
                               * np.asarray(digest.weight)).sum())
            self._max = max(self._max,
                            float(np.asarray(digest.mean)[
                                np.asarray(digest.weight) > 0].max()))
            self._digest = digest if self._digest is None else \
                tdigest_merge_many([self._digest, digest])
            self._n_folds += 1
            self.rev += 1

    def _fold_locked(self) -> None:
        if not self._buf:
            return
        d = tdigest_build(np.asarray(self._buf, np.float32), k=_DIGEST_K)
        self._digest = d if self._digest is None else \
            tdigest_merge_many([self._digest, d])
        self._buf = []
        self._n_folds += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            self._fold_locked()
            if self._digest is None or \
                    float(self._digest.weight.sum()) <= 0:
                return None
            return float(tdigest_quantile(self._digest, q))

    def _quantiles_cached_locked(self) -> Optional[Tuple[float, float]]:
        """(p50, p99) from the digest alone, recomputed only when the
        digest changed.  The scrape path's cheap read: pending buffer
        samples fold in early only once enough of them pile up (64), so
        scrape-time quantiles may lag the newest few observations — the
        price of a per-tick scrape that costs microseconds.  Caller
        holds ``self._lock``."""
        if self._digest is None or len(self._buf) >= 64:
            self._fold_locked()
        if self._digest is None:
            return None
        cached = self._q_cache
        if cached is not None and cached[0] == self._n_folds:
            return cached[1], cached[2]
        if float(self._digest.weight.sum()) <= 0:
            return None
        p50 = float(tdigest_quantile(self._digest, 0.5))
        p99 = float(tdigest_quantile(self._digest, 0.99))
        self._q_cache = (self._n_folds, p50, p99)
        return p50, p99

    def drain_digest(self) -> Optional[TDigest]:
        """Fold pending samples, hand the digest out, and RESET this
        histogram — the move-semantics half of :meth:`merge_digest`, so
        a worker registry's histogram can fold into the process
        registry repeatedly without double counting (Registry.fold_from
        at ``final=True``).  Returns None when nothing was observed."""
        with self._lock:
            self._fold_locked()
            digest, self._digest = self._digest, None
            self.count = 0
            self.sum = 0.0
            self._max = 0.0
            self._n_folds += 1
            self._q_cache = None
            self.rev += 1
            return digest

    def samples(self) -> List[Tuple[str, float]]:
        # ONE locked snapshot: count, sum, max and the quantiles come
        # from the same instant, so a scrape racing a concurrent
        # observe() never journals a count that disagrees with its sum
        with self._lock:
            out = [(f"{self.name}_count", float(self.count)),
                   (f"{self.name}_sum", self.sum)]
            qs = self._quantiles_cached_locked()
            if qs is not None:
                out.append((f"{self.name}_p50", qs[0]))
                out.append((f"{self.name}_p99", qs[1]))
                out.append((f"{self.name}_max", self._max))
            return out


#: one journal row: (t_s, sample_name, series_labels_rendered, value)
Sample = Tuple[float, str, str, float]


class Registry:
    """Thread-safe metric registry + bounded scrape journal.

    ``enabled``/``max_samples`` default from the validated Config env
    contract (``ANOMOD_OBS_ENABLED`` / ``ANOMOD_OBS_MAX_SAMPLES``).
    """

    def __init__(self, enabled: Optional[bool] = None,
                 max_samples: Optional[int] = None):
        if enabled is None or max_samples is None:
            from anomod_torch.config import get_config
            cfg = get_config()
            enabled = cfg.obs_enabled if enabled is None else enabled
            max_samples = (cfg.obs_max_samples if max_samples is None
                           else max_samples)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str], object] = {}
        self._journal: "collections.deque[Sample]" = collections.deque(
            maxlen=int(max_samples))

    # -- handle construction (memoized by name + rendered labels) ---------

    def _get(self, cls, name: str, labels: Dict[str, str]):
        if not self.enabled:
            return NULL
        key = (name, render_labels(labels))
        got = self._metrics.get(key)
        if got is None:
            with self._lock:
                got = self._metrics.get(key)
                if got is None:
                    got = cls(name, labels)
                    self._metrics[key] = got
        if not isinstance(got, cls):
            raise ValueError(
                f"metric {name!r} already registered as {got.kind}, "
                f"not {cls.kind}")
        return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    # -- time series -------------------------------------------------------

    def scrape(self, now_s: Optional[float] = None) -> int:
        """Append every metric's current samples to the journal.

        ``now_s`` is the caller's clock — wall time by default, the
        VIRTUAL clock for the serving plane, so a seeded serve run's
        self-scrape timeline is deterministic and windows bin cleanly.
        Returns the number of samples appended (0 when disabled)."""
        if not self.enabled:
            return 0
        if now_s is None:
            import time
            now_s = time.time()
        rows = []
        for m in self.metrics():
            series = m.rendered
            for sname, val in m.samples():
                rows.append((float(now_s), sname, series, float(val)))
        # rows are built first (each m.samples() takes its own metric
        # lock, never nested with ours), then one locked extend, so two
        # concurrent scrapes never interleave their rows
        with self._lock:
            self._journal.extend(rows)
        return len(rows)

    @property
    def n_samples(self) -> int:
        return len(self._journal)

    def journal(self) -> List[Sample]:
        return list(self._journal)

    def snapshot(self) -> dict:
        """Point-in-time JSON-able view of every metric (no journal)."""
        out: Dict[str, dict] = {}
        for m in self.metrics():
            key = m.name if not m.labels else \
                f"{m.name}{{{render_labels(m.labels)}}}"
            if m.kind == "histogram":
                out[key] = {"kind": m.kind, "count": m.count,
                            "sum": round(m.sum, 6)}
                p50 = m.quantile(0.5)
                if p50 is not None:
                    out[key].update(p50=round(p50, 6),
                                    p99=round(m.quantile(0.99), 6))
            else:
                out[key] = {"kind": m.kind, "value": m.value}
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._journal.clear()

    # -- worker-registry fold (the sharded serving plane's seam: the
    # engine's tick barrier folds each shard registry through it) --------
    #
    # The barrier merge is split into a picklable DELTA snapshot
    # (delta_snapshot, taken where the metrics live — a worker thread's
    # registry in-process, a worker PROCESS's registry across a pipe)
    # and a coordinator-side APPLY (apply_delta).  fold_from composes
    # the two, so the thread engine's fold and the process engine's
    # barrier payload are ONE code path and can never drift.

    def delta_snapshot(self, state: Dict[tuple, float],
                       mode: str = "sparse", final: bool = False) -> dict:
        """Serialize this registry's change since ``state`` as a
        picklable delta — the tick barrier's wire shape.

        ``sparse`` visits every family but SKIPS the ones whose ``rev``
        generation matches the high-water in ``state`` (untouched since
        the previous snapshot): the dirty check is two dict probes, so
        barrier cost follows touched families — O(active tenants'
        metrics) under Zipf traffic, not registered fleet size.
        ``dense`` serializes every family every time (the payload
        oracle the sparse win is measured against): all counters (zero
        deltas included), all gauges, and every histogram's full
        current digest snapshot.  Applying either produces the same
        registry bytes — dense just ships more to say it.

        Histogram entries carry ``(mean, weight)`` centroid arrays.  At
        ``final=True`` they are DRAINED from the source (move
        semantics, exactly :meth:`Histogram.drain_digest`) and meant to
        merge; dense non-final entries are non-draining snapshots that
        :meth:`apply_delta` deliberately ignores.

        ``state`` is owned by the caller (one dict per source registry)
        and carries both the counter high-waters — keyed ``(name,
        rendered_labels)``, the historic fold_from shape — and the rev
        marks, keyed ``("rev", name, rendered_labels)``.
        """
        if mode not in ("sparse", "dense"):
            raise ValueError(f"unknown fold mode {mode!r} (dense|sparse)")
        sparse = mode == "sparse"
        counters: list = []
        gauges: list = []
        hists: list = []
        for m in self.metrics():
            rkey = ("rev", m.name, m.rendered)
            if m.kind == "counter":
                if sparse and state.get(rkey) == m.rev:
                    continue
                state[rkey] = m.rev
                key = (m.name, m.rendered)
                prev = state.get(key, 0.0)
                cur = m.value
                if cur > prev:
                    state[key] = cur
                    counters.append((m.name, tuple(sorted(m.labels.items())),
                                     cur - prev))
                elif not sparse:
                    counters.append((m.name, tuple(sorted(m.labels.items())),
                                     0.0))
            elif m.kind == "gauge":
                if sparse and state.get(rkey) == m.rev:
                    continue
                state[rkey] = m.rev
                gauges.append((m.name, tuple(sorted(m.labels.items())),
                               m.value))
            elif m.kind == "histogram":
                if final:
                    digest = m.drain_digest()
                    if digest is not None:
                        hists.append((m.name,
                                      tuple(sorted(m.labels.items())),
                                      np.asarray(digest.mean, np.float32),
                                      np.asarray(digest.weight,
                                                 np.float32)))
                elif not sparse:
                    with m._lock:
                        m._fold_locked()
                        digest = m._digest
                        if digest is not None:
                            hists.append((
                                m.name, tuple(sorted(m.labels.items())),
                                np.asarray(digest.mean, np.float32).copy(),
                                np.asarray(digest.weight,
                                           np.float32).copy()))
        return {"mode": mode, "final": bool(final), "counters": counters,
                "gauges": gauges, "hists": hists}

    def apply_delta(self, delta: Optional[dict],
                    shard: Optional[str] = None) -> None:
        """Fold one :meth:`delta_snapshot` into this registry — the
        coordinator half of the barrier merge.  Counter entries
        increment (zero deltas skipped), gauge entries set a
        ``shard``-labeled twin when ``shard`` is given (a gauge is a
        per-shard fact), histogram entries merge their centroid sets
        through :meth:`Histogram.merge_digest` ONLY on a final delta
        (non-final dense snapshots are informational payload, not
        mergeable state)."""
        if delta is None or not self.enabled:
            return
        for name, litems, d in delta["counters"]:
            if d > 0:
                self.counter(name, **dict(litems)).inc(d)
        for name, litems, v in delta["gauges"]:
            labels = dict(litems)
            if shard is not None:
                labels["shard"] = shard
            self.gauge(name, **labels).set(v)
        if delta["final"]:
            for name, litems, mean, weight in delta["hists"]:
                self.histogram(name, **dict(litems)).merge_digest(
                    TDigest(mean=np.asarray(mean, np.float32),
                            weight=np.asarray(weight, np.float32)))

    def fold_from(self, src: "Registry", state: Dict[tuple, float],
                  shard: Optional[str] = None, final: bool = False,
                  mode: str = "sparse") -> Optional[dict]:
        """Fold a worker registry into this one at the tick barrier.

        Each serve shard records its runner's hot-path metrics into its
        OWN registry (zero cross-thread contention per dispatch); the
        coordinator folds the shards in at the barrier:

        - **Counters** increment by the delta since the previous fold
          (``state`` carries the per-metric high-water marks), so the
          process-registry counter stays the summable fleet total.
        - **Gauges** set a ``shard``-labeled twin (a gauge is a
          per-shard fact — pad-waste on shard 2 is not a fleet sum).
        - **Histograms** DRAIN at ``final=True`` (run end): the source
          digest folds through :meth:`Histogram.merge_digest` — exactly
          how the per-tenant SLO digests already join the registry —
          and is then cleared on the source, so repeated final folds
          (an engine run() twice) neither double-count nor drop data.

        ``mode`` selects the snapshot discipline: ``sparse`` (default)
        skips families untouched since the previous fold via the
        per-metric ``rev`` dirty marks — scrape output is pinned byte-identical to a dense
        walk, the walk is just cheaper.  Returns the applied delta so
        barrier callers can account payload bytes (None when either
        side is disabled).

        The caller owns the quiescence contract: fold at a barrier,
        with the worker that records into ``src`` idle.
        """
        if not (self.enabled and src.enabled):
            return None
        delta = src.delta_snapshot(state, mode=mode, final=final)
        self.apply_delta(delta, shard=shard)
        return delta


def delta_nbytes(delta: Optional[dict]) -> int:
    """Structural payload size of one :meth:`Registry.delta_snapshot`
    in bytes — key strings at utf-8 length, 8 bytes per float scalar,
    8 bytes per digest centroid component.  A deterministic accounting
    (identical on every box and in both worker modes), NOT a pickle
    length: the sparse-vs-dense win criterion needs exact,
    box-independent byte counts."""
    if delta is None:
        return 0
    n = 0
    for name, litems, _ in delta["counters"]:
        n += len(name.encode()) + 8
        n += sum(len(k.encode()) + len(str(v).encode()) for k, v in litems)
    for name, litems, _ in delta["gauges"]:
        n += len(name.encode()) + 8
        n += sum(len(k.encode()) + len(str(v).encode()) for k, v in litems)
    for name, litems, mean, weight in delta["hists"]:
        n += len(name.encode()) + 8 * (len(mean) + len(weight))
        n += sum(len(k.encode()) + len(str(v).encode()) for k, v in litems)
    return n


_DEFAULT: Optional[Registry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> Registry:
    """The process-wide registry (constructed lazily from the env
    contract so import order never races config)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Registry()
    return _DEFAULT


def set_registry(registry: Registry) -> Registry:
    """Swap the process-wide registry (tests, the bench's off/on pair);
    returns the previous one so callers can restore it."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, registry
    return prev if prev is not None else registry
