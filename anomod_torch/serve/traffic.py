"""Seeded multi-tenant traffic (counterpart of ``anomod/serve/traffic.py``).

Per-tenant offered rates follow a power law (the r-th busiest tenant's
rate is proportional to (r+1)^-alpha), normalized so the fleet offers
exactly the asked total.  Priorities cycle through the rate ranking, so
every class spans busy and quiet tenants.  Arrival counts per (tenant,
tick) are Poisson draws from per-tenant ``np.random.default_rng((seed,
tenant_id))`` streams, so arrivals are byte-identical to the JAX
package's for a seed and tick schedule.  Span payloads are lognormal
latencies over a shared service table with a small error floor, plus an
optional per-tenant fault (latency inflation or an error burst on one
culprit service after an onset).  No clock is read: callers drive
``arrivals(t_lo_s, t_hi_s)`` from the engine's virtual clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch.schemas import SpanBatch, take_spans
from anomod_torch.serve.queues import TenantSpec


@dataclasses.dataclass(frozen=True)
class TenantFault:
    """A scripted per-tenant anomaly."""
    kind: str                  # "latency" | "error"
    service: int               # culprit service id
    onset_s: float             # virtual time the effect activates
    factor: float = 8.0        # latency multiplier / error-rate boost


class PowerLawTraffic:
    """Seeded power-law tenant fleet emitting span micro-batches."""

    def __init__(self, n_tenants: int, total_rate_spans_per_s: float,
                 alpha: float = 1.2, seed: int = 0, n_services: int = 8,
                 n_priorities: int = 3,
                 faults: Optional[Dict[int, TenantFault]] = None,
                 t0_us: int = 0, batch_cap: int = 512):
        if n_tenants < 1:
            raise ValueError("need >= 1 tenant")
        if total_rate_spans_per_s <= 0:
            raise ValueError("total rate must be positive")
        if batch_cap < 1:
            raise ValueError("batch_cap must be >= 1 span")
        # a feed arrives as bounded collector flushes: a busy tenant sheds
        # its excess, not its whole tick
        self.batch_cap = int(batch_cap)
        self.n_services = int(n_services)
        self.services: Tuple[str, ...] = tuple(
            f"svc{i:02d}" for i in range(self.n_services))
        self.t0_us = int(t0_us)
        self.seed = int(seed)
        self.faults = dict(faults or {})
        shares = (1.0 + np.arange(n_tenants)) ** -float(alpha)
        shares /= shares.sum()
        self.specs: List[TenantSpec] = [
            TenantSpec(tenant_id=t, name=f"tenant{t:04d}",
                       priority=t % n_priorities,
                       rate_spans_per_s=float(total_rate_spans_per_s
                                              * shares[t]))
            for t in range(n_tenants)]
        self._rngs = {t.tenant_id: np.random.default_rng(
            (self.seed, t.tenant_id)) for t in self.specs}
        # per-tenant service mix and latency scale: from the tenant id,
        # never from the arrival stream
        self._svc_p: Dict[int, np.ndarray] = {}
        self._lat_scale: Dict[int, np.ndarray] = {}
        for t in self.specs:
            mix_rng = np.random.default_rng((self.seed, t.tenant_id, 7))
            self._svc_p[t.tenant_id] = mix_rng.dirichlet(
                np.full(self.n_services, 2.0))
            self._lat_scale[t.tenant_id] = mix_rng.uniform(
                800.0, 6000.0, self.n_services)

    def arrivals(self, t_lo_s: float,
                 t_hi_s: float) -> List[Tuple[int, SpanBatch]]:
        """Per-tenant micro-batches arriving in [t_lo_s, t_hi_s)."""
        out: List[Tuple[int, SpanBatch]] = []
        dt = t_hi_s - t_lo_s
        for spec in self.specs:
            rng = self._rngs[spec.tenant_id]
            n = int(rng.poisson(spec.rate_spans_per_s * dt))
            if n == 0:
                continue
            batch = self._make_spans(spec, rng, n, t_lo_s, t_hi_s)
            for lo in range(0, n, self.batch_cap):
                out.append((spec.tenant_id,
                            take_spans(batch,
                                       slice(lo, min(lo + self.batch_cap,
                                                     n)))))
        return out

    def _make_spans(self, spec: TenantSpec, rng: np.random.Generator,
                    n: int, t_lo_s: float, t_hi_s: float) -> SpanBatch:
        svc = rng.choice(self.n_services, size=n,
                         p=self._svc_p[spec.tenant_id]).astype(np.int32)
        start = self.t0_us + np.sort(rng.integers(
            int(t_lo_s * 1e6), int(t_hi_s * 1e6), n)).astype(np.int64)
        scale = self._lat_scale[spec.tenant_id][svc]
        dur = (scale * rng.lognormal(0.0, 0.35, n)).astype(np.int64)
        err = rng.random(n) < 0.01
        fault = self.faults.get(spec.tenant_id)
        if fault is not None and t_lo_s >= fault.onset_s:
            hit = svc == fault.service
            if fault.kind == "latency":
                dur = np.where(hit, (dur * fault.factor).astype(np.int64),
                               dur)
            elif fault.kind == "error":
                err = err | (hit & (rng.random(n)
                                    < min(0.95, 0.1 * fault.factor)))
            else:
                raise ValueError(f"unknown fault kind {fault.kind!r}")
        return SpanBatch(
            trace=(rng.integers(0, 64, n)).astype(np.int32),
            parent=np.full(n, -1, np.int32),
            service=svc,
            endpoint=np.zeros(n, np.int32),
            start_us=start,
            duration_us=np.maximum(dur, 1),
            is_error=err.astype(np.bool_),
            status=np.where(err, 500, 200).astype(np.int16),
            kind=np.zeros(n, np.int8),
            services=self.services,
            endpoints=("ep",),
            trace_ids=tuple(f"t{i:02d}" for i in range(64)),
        ).validate()


class ScriptedTraffic:
    """Replay pre-built per-tenant SpanBatches on the virtual clock: the
    parity harness's traffic source.  ``streams`` maps tenant_id to an
    arrival-ordered SpanBatch; each ``arrivals`` call slices every stream
    to [t_lo_s, t_hi_s) relative to ``t0_us``.  ``experiments``
    (optional, tenant_id -> Experiment) also feeds the tenants' log,
    metric and API planes through ``modality_arrivals``: the multimodal
    sidecar's counterpart of ``stream_experiment_multimodal``'s
    one-clock slicing."""

    def __init__(self, streams: Dict[int, SpanBatch],
                 specs: Sequence[TenantSpec], t0_us: int,
                 experiments: Optional[Dict[int, object]] = None):
        self.specs = list(specs)
        self.t0_us = int(t0_us)
        ids = {s.tenant_id for s in self.specs}
        if set(streams) - ids:
            raise ValueError("streams for unknown tenant ids: "
                             f"{sorted(set(streams) - ids)}")
        self.streams = {
            t: take_spans(b, np.argsort(b.start_us, kind="stable"))
            for t, b in streams.items()}
        self.experiments = dict(experiments or {})

    def end_s(self) -> float:
        """Last span's arrival, in virtual seconds past t0."""
        ends = [float(b.start_us.max()) for b in self.streams.values()
                if b.n_spans]
        return (max(ends) - self.t0_us) / 1e6 if ends else 0.0

    def arrivals(self, t_lo_s: float,
                 t_hi_s: float) -> List[Tuple[int, SpanBatch]]:
        lo = self.t0_us + int(t_lo_s * 1e6)
        hi = self.t0_us + int(t_hi_s * 1e6)
        out = []
        for tid in sorted(self.streams):
            b = self.streams[tid]
            m = (b.start_us >= lo) & (b.start_us < hi)
            if m.any():
                out.append((tid, take_spans(b, m)))
        return out

    def modality_arrivals(self, t_lo_s: float, t_hi_s: float) -> List[tuple]:
        """The tick's ``(tenant_id, kind, batch)`` log / metric / API
        slices, on the serving clock."""
        from anomod_torch.stream import _take_nt
        lo = self.t0_us / 1e6 + t_lo_s
        hi = self.t0_us / 1e6 + t_hi_s
        out: List[tuple] = []
        for tid in sorted(self.experiments):
            exp = self.experiments[tid]
            for kind, b, n in (("logs", exp.logs,
                                getattr(exp.logs, "n_lines", 0)),
                               ("metrics", exp.metrics,
                                getattr(exp.metrics, "n_samples", 0)),
                               ("api", exp.api,
                                getattr(exp.api, "n_records", 0))):
                if b is None or not n:
                    continue
                m = (b.t_s >= lo) & (b.t_s < hi)
                if m.any():
                    out.append((tid, kind, _take_nt(b, m)))
        return out
