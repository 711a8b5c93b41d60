"""Deterministic synthetic data generator (counterpart of
``anomod/synth.py``).

Seeded per experiment label, it emits fault-conditioned corpora of all
five modalities: TT / SN spans (and their SkyWalking and Jaeger JSON
artifacts), metric samples over the reference catalogs, log lines and
summaries, API records and per-file coverage.  Faults inflate latency for
performance/database faults and inject errors for service/code faults,
inside the shared anomaly window [600, 1200) s.  Given the same label and
arguments every generator returns output byte-identical to the JAX
package's (pinned in tests/test_torch_synth.py and
tests/test_torch_data.py), so the two packages replay the same corpus.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch import labels as labels_mod
from anomod_torch.labels import FaultLabel
from anomod_torch.schemas import (
    KIND_ENTRY, KIND_EXIT, KIND_LOCAL, KIND_NAMES,
    LOG_ERROR, LOG_INFO, LOG_WARN,
    ApiBatch, CoverageBatch, Experiment, FileCoverage, LogBatch, LogSummary,
    MetricBatch, SpanBatch, coverage_batch_from_files, empty_span_batch,
)

#: Ingest-cache key component (anomod_torch.io.cache) for synth-fallback
#: entries: the JAX package's generator version, whose output this module
#: reproduces byte for byte (bump both together).
SYNTH_VERSION = 1

# ---------------------------------------------------------------------------
# Service topologies.
# SN: the 12 core services of DeathStarBench SocialNetwork
# (collect_log.sh:31-44); edges reflect the compose/read call paths
# (mixed-workload.lua:111-125 drives home-timeline/user-timeline/compose).
# ---------------------------------------------------------------------------

SN_SERVICES: Tuple[str, ...] = (
    "nginx-web-server", "compose-post-service", "post-storage-service",
    "user-service", "user-mention-service", "unique-id-service",
    "media-service", "social-graph-service", "user-timeline-service",
    "url-shorten-service", "home-timeline-service", "text-service",
)

SN_EDGES: Tuple[Tuple[str, str], ...] = (
    ("nginx-web-server", "compose-post-service"),
    ("nginx-web-server", "home-timeline-service"),
    ("nginx-web-server", "user-timeline-service"),
    ("nginx-web-server", "user-service"),
    ("nginx-web-server", "social-graph-service"),
    ("compose-post-service", "unique-id-service"),
    ("compose-post-service", "user-service"),
    ("compose-post-service", "media-service"),
    ("compose-post-service", "text-service"),
    ("compose-post-service", "post-storage-service"),
    ("compose-post-service", "user-timeline-service"),
    ("compose-post-service", "home-timeline-service"),
    ("text-service", "url-shorten-service"),
    ("text-service", "user-mention-service"),
    ("home-timeline-service", "post-storage-service"),
    ("home-timeline-service", "social-graph-service"),
    ("user-timeline-service", "post-storage-service"),
)

# TT: the Train-Ticket ts-* services observed in TT_data pod logs
# (TT_data/log_data/<exp>/ listing) and gen-mysql-secret.sh:2; edges follow
# the booking flow exercised by test_all_services.py:127-196.
TT_SERVICES: Tuple[str, ...] = (
    "ts-gateway-service", "ts-auth-service", "ts-user-service", "ts-verification-code-service",
    "ts-travel-service", "ts-travel2-service", "ts-travel-plan-service", "ts-route-plan-service",
    "ts-route-service", "ts-train-service", "ts-station-service", "ts-basic-service",
    "ts-seat-service", "ts-config-service", "ts-price-service", "ts-ticketinfo-service",
    "ts-preserve-service", "ts-preserve-other-service", "ts-security-service",
    "ts-contacts-service", "ts-assurance-service", "ts-food-service",
    "ts-station-food-service", "ts-train-food-service", "ts-food-delivery-service",
    "ts-consign-service", "ts-consign-price-service", "ts-order-service",
    "ts-order-other-service", "ts-inside-payment-service", "ts-payment-service",
    "ts-cancel-service", "ts-execute-service", "ts-rebook-service", "ts-delivery-service",
    "ts-notification-service", "ts-news-service", "ts-voucher-service",
    "ts-wait-order-service", "ts-admin-order-service", "ts-admin-route-service",
    "ts-admin-travel-service", "ts-admin-user-service", "ts-admin-basic-info-service",
    "ts-avatar-service",
)

TT_EDGES: Tuple[Tuple[str, str], ...] = (
    ("ts-gateway-service", "ts-auth-service"),
    ("ts-gateway-service", "ts-user-service"),
    ("ts-gateway-service", "ts-travel-service"),
    ("ts-gateway-service", "ts-travel2-service"),
    ("ts-gateway-service", "ts-travel-plan-service"),
    ("ts-gateway-service", "ts-preserve-service"),
    ("ts-gateway-service", "ts-preserve-other-service"),
    ("ts-gateway-service", "ts-order-service"),
    ("ts-gateway-service", "ts-order-other-service"),
    ("ts-gateway-service", "ts-cancel-service"),
    ("ts-gateway-service", "ts-execute-service"),
    ("ts-gateway-service", "ts-rebook-service"),
    ("ts-gateway-service", "ts-consign-service"),
    ("ts-gateway-service", "ts-food-service"),
    ("ts-gateway-service", "ts-contacts-service"),
    ("ts-gateway-service", "ts-admin-order-service"),
    ("ts-gateway-service", "ts-admin-route-service"),
    ("ts-gateway-service", "ts-admin-travel-service"),
    ("ts-gateway-service", "ts-admin-user-service"),
    ("ts-gateway-service", "ts-admin-basic-info-service"),
    ("ts-auth-service", "ts-verification-code-service"),
    ("ts-user-service", "ts-auth-service"),
    ("ts-user-service", "ts-avatar-service"),
    ("ts-travel-service", "ts-basic-service"),
    ("ts-travel-service", "ts-train-service"),
    ("ts-travel-service", "ts-route-service"),
    ("ts-travel-service", "ts-seat-service"),
    ("ts-travel-service", "ts-ticketinfo-service"),
    ("ts-travel2-service", "ts-basic-service"),
    ("ts-travel2-service", "ts-route-service"),
    ("ts-travel-plan-service", "ts-route-plan-service"),
    ("ts-travel-plan-service", "ts-travel-service"),
    ("ts-route-plan-service", "ts-route-service"),
    ("ts-route-plan-service", "ts-travel-service"),
    ("ts-basic-service", "ts-station-service"),
    ("ts-basic-service", "ts-train-service"),
    ("ts-basic-service", "ts-route-service"),
    ("ts-basic-service", "ts-price-service"),
    ("ts-ticketinfo-service", "ts-basic-service"),
    ("ts-seat-service", "ts-config-service"),
    ("ts-seat-service", "ts-order-service"),
    ("ts-preserve-service", "ts-seat-service"),
    ("ts-preserve-service", "ts-security-service"),
    ("ts-preserve-service", "ts-contacts-service"),
    ("ts-preserve-service", "ts-assurance-service"),
    ("ts-preserve-service", "ts-food-service"),
    ("ts-preserve-service", "ts-consign-service"),
    ("ts-preserve-service", "ts-order-service"),
    ("ts-preserve-service", "ts-user-service"),
    ("ts-preserve-service", "ts-travel-service"),
    ("ts-preserve-service", "ts-station-service"),
    ("ts-preserve-other-service", "ts-seat-service"),
    ("ts-preserve-other-service", "ts-security-service"),
    ("ts-preserve-other-service", "ts-order-other-service"),
    ("ts-security-service", "ts-order-service"),
    ("ts-security-service", "ts-order-other-service"),
    ("ts-food-service", "ts-station-food-service"),
    ("ts-food-service", "ts-train-food-service"),
    ("ts-food-service", "ts-food-delivery-service"),
    ("ts-consign-service", "ts-consign-price-service"),
    ("ts-consign-service", "ts-order-service"),
    ("ts-order-service", "ts-station-service"),
    ("ts-inside-payment-service", "ts-order-service"),
    ("ts-inside-payment-service", "ts-payment-service"),
    ("ts-cancel-service", "ts-order-service"),
    ("ts-cancel-service", "ts-order-other-service"),
    ("ts-cancel-service", "ts-inside-payment-service"),
    ("ts-cancel-service", "ts-notification-service"),
    ("ts-execute-service", "ts-order-service"),
    ("ts-rebook-service", "ts-travel-service"),
    ("ts-rebook-service", "ts-order-service"),
    ("ts-rebook-service", "ts-seat-service"),
    ("ts-rebook-service", "ts-inside-payment-service"),
    ("ts-delivery-service", "ts-food-service"),
    ("ts-wait-order-service", "ts-order-service"),
    ("ts-admin-order-service", "ts-order-service"),
    ("ts-admin-order-service", "ts-order-other-service"),
    ("ts-admin-route-service", "ts-route-service"),
    ("ts-admin-travel-service", "ts-travel-service"),
    ("ts-admin-user-service", "ts-user-service"),
    ("ts-admin-basic-info-service", "ts-basic-service"),
)

SN_API_ENDPOINTS: Tuple[str, ...] = tuple(
    f"http://localhost:8080/wrk2-api/{p}" for p in (
        "user/register", "user/follow", "user/unfollow", "user/login",
        "post/compose", "home-timeline/read", "user-timeline/read",
        "user/profile", "media/upload", "text/upload", "url/shorten",
        "user-mention/upload",
    )
)  # enhanced_openapi_monitor.py:36-49


def _seed_for(name: str, salt: int = 0) -> int:
    h = hashlib.sha256(f"{name}:{salt}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2**63)


def _topology(testbed: str):
    if testbed == "SN":
        return SN_SERVICES, SN_EDGES, "nginx-web-server"
    return TT_SERVICES, TT_EDGES, "ts-gateway-service"


# ---------------------------------------------------------------------------
# Trace templates: deterministic random walks over the topology.  Each
# template is a list of (service_idx, parent_pos, kind) triples; traces are
# instantiated per-template in vectorized batches.
# ---------------------------------------------------------------------------

def build_templates(testbed: str, n_templates: int = 24, max_depth: int = 5,
                    seed: int = 1) -> List[List[Tuple[int, int, int]]]:
    services, edges, root = _topology(testbed)
    svc_idx = {s: i for i, s in enumerate(services)}
    children: Dict[int, List[int]] = {}
    for a, b in edges:
        children.setdefault(svc_idx[a], []).append(svc_idx[b])
    rng = np.random.default_rng(seed)
    templates = []
    for _ in range(n_templates):
        tpl: List[Tuple[int, int, int]] = [(svc_idx[root], -1, KIND_ENTRY)]
        frontier = [(svc_idx[root], 0, 0)]  # (svc, pos in tpl, depth)
        while frontier:
            svc, pos, depth = frontier.pop()
            kids = children.get(svc, [])
            if not kids or depth >= max_depth:
                continue
            n_kids = int(rng.integers(1, min(len(kids), 3) + 1))
            picked = rng.choice(len(kids), size=n_kids, replace=False)
            for k in picked:
                child_svc = kids[int(k)]
                # Exit span on caller, Entry span on callee (SkyWalking style).
                tpl.append((svc, pos, KIND_EXIT))
                exit_pos = len(tpl) - 1
                tpl.append((child_svc, exit_pos, KIND_ENTRY))
                entry_pos = len(tpl) - 1
                frontier.append((child_svc, entry_pos, depth + 1))
        templates.append(tpl)
    return templates


@dataclasses.dataclass(frozen=True)
class HardMode:
    """Difficulty knobs for de-saturated evaluation corpora.

    The full-strength fault effects (6-20x latency, 0.5-0.7 error rates) make
    every detector score 1.0; these knobs produce the regimes where models
    actually separate:

    - ``severity`` interpolates every fault effect toward baseline
      (0.05 => ~1.25x latency / ~2.5% error on a service fault — the
      1.2-2x / 2-5% operating band).
    - ``noise`` widens the baseline distributions (log-latency sigma scales
      by 1+noise, baseline error jitter grows), shrinking the fault SNR.
    - ``confounders`` names decoy services that also degrade (fixed mild
      1.5x latency / 2% errors in the same anomaly window, independent of
      severity) — the ranking must still put the labeled culprit first.

    The three ``*_shape/profile/locus`` knobs are the DISTRIBUTION-SHIFT
    axes (round-2 weak #4: generator and evaluator shared one effect
    model, so quality rankings could be statements about the generator).
    Train on the default effect model, evaluate under shift:

    - ``effect_shape``: how fault latency manifests on affected spans —
      "mult" (lognormal location shift, the training shape), "add" (a
      constant offset — spread does not scale with the effect), "tail"
      (only ~12% of affected spans inflate, 3x harder — p99 moves, the
      median barely does).
    - ``fault_profile``: when the fault is active inside the anomaly
      window — "sustained" (the whole [600, 1200) s window), "bursty"
      (alternating 60 s on/off bursts), "partial" (first half only).
      Applied consistently across ALL modality generators via
      :func:`anomaly_window_mask` so the corpus stays time-synchronized.
    - ``fault_locus``: where the fault manifests — "node" (the culprit
      service's own spans) or "edge" (the callee side of the culprit's
      outgoing calls, like a link fault: node-scoped metrics/logs stay
      healthy, coverage does not shift, API routes degrade only when the
      target actually has outgoing calls, and attribution must come from
      trace structure; a target with NO outgoing calls faults no edge, so
      its corpus carries no localizing signal at all — the honest floor
      for every detector).
    """
    severity: float = 1.0
    noise: float = 0.0
    confounders: Tuple[str, ...] = ()
    effect_shape: str = "mult"        # "mult" | "add" | "tail"
    fault_profile: str = "sustained"  # "sustained" | "bursty" | "partial"
    fault_locus: str = "node"         # "node" | "edge"


_EASY = HardMode()

# Fixed confounder effect (NOT scaled by severity: decoys stay at this level
# while the true fault shrinks, so low severity is genuinely confusable).
_CONFOUND_LAT, _CONFOUND_ERR = 1.5, 0.02


def scale_mult(mult: float, severity: float) -> float:
    """Interpolate a fault multiplier toward 1.0 (works for <1 drops too)."""
    return 1.0 + (mult - 1.0) * severity


def anomaly_window_mask(rel_s, profile: str = "sustained"):
    """Fault-active mask from experiment-relative times in SECONDS — the one
    definition of the anomaly window every modality generator uses, so a
    fault_profile shift stays time-synchronized across spans, metrics,
    logs, and API records.

    "sustained" = the whole middle third [600, 1200); "bursty" = alternating
    60 s on/off bursts inside it (5 bursts); "partial" = its first half
    [600, 900) only.
    """
    rel_s = np.asarray(rel_s)
    base = (rel_s >= 600) & (rel_s < 1200)
    if profile == "sustained":
        return base
    if profile == "bursty":
        return base & (((rel_s - 600) // 60).astype(np.int64) % 2 == 0)
    if profile == "partial":
        return base & (rel_s < 900)
    raise ValueError(f"unknown fault_profile {profile!r}")


# Per-(level,type) effect multipliers applied to the target service.
def _fault_effects(label: FaultLabel,
                   severity: float = 1.0) -> Tuple[float, float]:
    """Return (latency_multiplier, error_probability) for the culprit
    service, interpolated toward baseline by ``severity``."""
    if not label.is_anomaly:
        return 1.0, 0.002
    lvl, typ = label.anomaly_level, label.anomaly_type
    if lvl == "performance":
        lat, err = {"cpu_contention": 6.0, "disk_io_stress": 4.0,
                    "network_loss": 8.0}.get(typ, 5.0), 0.02
    elif lvl == "service":
        lat, err = ({"kill_service_instance": 2.0, "http_abort": 1.5,
                     "dns_failure": 3.0}.get(typ, 2.0),
                    {"http_abort": 0.7, "kill_service_instance": 0.5,
                     "dns_failure": 0.6}.get(typ, 0.5))
    elif lvl == "database":
        lat, err = {"transaction_timeout": 20.0,
                    "connection_pool_exhaustion": 12.0,
                    "cache_limit": 5.0}.get(typ, 8.0), 0.10
    else:  # code-level: immediate failure responses / exceptions
        lat, err = 1.2, 0.6
    return scale_mult(lat, severity), 0.002 + (err - 0.002) * severity


def generate_spans(label: FaultLabel, n_traces: int = 200,
                   seed: Optional[int] = None,
                   base_time_us: int = 1_762_180_000_000_000,
                   hard: HardMode = _EASY) -> SpanBatch:
    """Generate a fault-conditioned SpanBatch for one experiment."""
    services, _, _ = _topology(label.testbed)
    if n_traces <= 0:
        return empty_span_batch()._replace(services=tuple(services))
    if seed is None:
        seed = _seed_for(label.experiment)
    # Templates are seeded per-TESTBED, not per-experiment: the reference
    # replays the same EvoMaster suite in every experiment, so every
    # experiment sees the same call-path mix (collect_all_modalities.sh:152-171)
    templates = build_templates(label.testbed, seed=_seed_for(label.testbed, 11))
    rng = np.random.default_rng(seed)

    lat_mult, err_p = _fault_effects(label, hard.severity)
    sigma = 0.4 * (1.0 + hard.noise)
    decoy_set = frozenset(hard.confounders)
    target = label.target_service
    target_idx = services.index(target) if target in services else -1
    # SN host-level performance faults hit every service.
    host_level = label.is_anomaly and target_idx < 0

    # Deterministic proportional template assignment: every call path shows
    # up in every experiment (the reference replays its complete suite each
    # iteration — random sampling would leave rare paths out of the normal
    # baseline and fabricate latency-inflation artifacts), with SN templates
    # weighted by the wrk2 request mix (mixed-workload.lua:113-115).
    weights = np.ones(len(templates))
    if label.testbed == "SN":
        from anomod_torch.workload import SN_REQUEST_MIX
        svc_of_root_child = [services[tpl[2][0]] if len(tpl) > 2 else ""
                             for tpl in templates]
        for i, svc in enumerate(svc_of_root_child):
            weights[i] = SN_REQUEST_MIX.get(svc, 0.05) * 10
    alloc = np.maximum((weights / weights.sum() * n_traces).astype(int), 1)
    # trim/pad to exactly n_traces while keeping every template present
    tpl_ids = np.repeat(np.arange(len(templates)), alloc)[:n_traces]
    if tpl_ids.shape[0] < n_traces:
        tpl_ids = np.concatenate([
            tpl_ids, np.arange(n_traces - tpl_ids.shape[0]) % len(templates)])
    rng.shuffle(tpl_ids)
    # Per-service baseline latency (ms, lognormal median), deterministic per testbed.
    svc_rng = np.random.default_rng(_seed_for(label.testbed, 7))
    base_ms = svc_rng.uniform(2.0, 30.0, size=len(services))

    cols = {k: [] for k in ("trace", "parent", "service", "endpoint",
                            "start_us", "duration_us", "is_error", "status", "kind")}
    endpoints: Dict[str, int] = {}
    offset = 0
    # Traces span the full 1800 s experiment; the fault is active in the middle
    # third [600, 1200) s — the same anomaly window generate_metrics and
    # generate_api use, so the five modalities stay time-synchronized.
    trace_start = base_time_us + np.sort(rng.integers(0, 1_800_000_000, size=n_traces))
    trace_in_window = anomaly_window_mask(
        (trace_start - base_time_us) / 1e6, hard.fault_profile)

    for t_id in range(len(templates)):
        mask = tpl_ids == t_id
        m = int(mask.sum())
        if m == 0:
            continue
        tpl = templates[t_id]
        L = len(tpl)
        svc = np.array([s for s, _, _ in tpl], np.int32)
        par_local = np.array([p for _, p, _ in tpl], np.int32)
        kind = np.array([k for _, _, k in tpl], np.int8)
        ep_names = [f"{services[s]}/{'entry' if k == KIND_ENTRY else 'exit'}/{i % 4}"
                    for i, (s, _, k) in enumerate(tpl)]
        ep_ids = np.array([endpoints.setdefault(e, len(endpoints)) for e in ep_names],
                          np.int32)

        # durations: lognormal around per-service base, inflated on the
        # culprit service only while the trace falls in the anomaly window
        tw = trace_in_window[mask]  # (m,)
        if hard.fault_locus == "edge" and not host_level:
            # link fault: the callee side of the culprit's outgoing calls
            # degrades; the culprit's own spans (including its entry->exit
            # self-edges) stay healthy, so node-level attribution has no
            # direct signal and the ranking must come from trace structure
            par_svc = np.where(par_local >= 0,
                               svc[np.clip(par_local, 0, None)], -1)
            culprit = (par_svc == target_idx) & (svc != target_idx)  # (L,)
        else:
            culprit = (np.full(L, True) if host_level
                       else (svc == target_idx))  # (L,)
        active = label.is_anomaly & (tw[:, None] & culprit[None, :])  # (m, L)
        mult = np.where(active, lat_mult, 1.0)
        err_prob = np.where(active, err_p, 0.005 if label.is_anomaly else 0.002)
        if decoy_set:
            # confounders degrade mildly in the same window (HardMode)
            decoy = np.array([services[s] in decoy_set for s in svc])  # (L,)
            decoy_active = (tw[:, None] & decoy[None, :]) & ~active
            mult = np.where(decoy_active, _CONFOUND_LAT, mult)
            err_prob = np.where(decoy_active, _CONFOUND_ERR, err_prob)
        if hard.effect_shape == "mult":
            dur_ms = rng.lognormal(mean=np.log(base_ms[svc][None, :] * mult),
                                   sigma=sigma, size=(m, L))
        elif hard.effect_shape == "add":
            # constant offset: location moves, spread does not scale
            dur_ms = rng.lognormal(mean=np.log(base_ms[svc][None, :]),
                                   sigma=sigma, size=(m, L)) \
                + (mult - 1.0) * base_ms[svc][None, :]
        elif hard.effect_shape == "tail":
            # only ~12% of affected spans inflate, 3x harder: the p99 moves,
            # the median barely does (mean-based detectors see ~1/3 of the
            # "mult" signal)
            tail_sel = rng.random((m, L)) < 0.12
            eff = np.where(tail_sel, 1.0 + (mult - 1.0) * 3.0, 1.0)
            dur_ms = rng.lognormal(mean=np.log(base_ms[svc][None, :] * eff),
                                   sigma=sigma, size=(m, L))
        else:
            raise ValueError(f"unknown effect_shape {hard.effect_shape!r}")
        errors = rng.random((m, L)) < err_prob
        # Entry spans of parents of failed spans also error (propagation).
        prop = errors.copy()
        for i in range(L - 1, 0, -1):
            p = par_local[i]
            if p >= 0:
                prop[:, p] |= prop[:, i] & (rng.random(m) < 0.6)

        start = (trace_start[mask][:, None]
                 + np.cumsum(rng.integers(50, 2000, size=(m, L)), axis=1))
        dur_us = (dur_ms * 1000.0).astype(np.int64)
        status = np.where(prop, 500, 200).astype(np.int16)

        glob_idx = offset + np.arange(m * L, dtype=np.int64).reshape(m, L)
        parent = np.where(par_local[None, :] >= 0,
                          glob_idx[:, np.clip(par_local, 0, None)],
                          -1).astype(np.int32)
        trace_idx = np.repeat(np.flatnonzero(mask).astype(np.int32), L)

        cols["trace"].append(trace_idx)
        cols["parent"].append(parent.reshape(-1))
        cols["service"].append(np.tile(svc, m))
        cols["endpoint"].append(np.tile(ep_ids, m))
        cols["start_us"].append(start.astype(np.int64).reshape(-1))
        cols["duration_us"].append(dur_us.reshape(-1))
        cols["is_error"].append(prop.reshape(-1))
        cols["status"].append(status.reshape(-1))
        cols["kind"].append(np.tile(kind, m))
        offset += m * L

    trace_ids = tuple(f"{label.experiment}.{i:08x}" for i in range(n_traces))
    batch = SpanBatch(
        trace=np.concatenate(cols["trace"]),
        parent=np.concatenate(cols["parent"]),
        service=np.concatenate(cols["service"]),
        endpoint=np.concatenate(cols["endpoint"]),
        start_us=np.concatenate(cols["start_us"]),
        duration_us=np.concatenate(cols["duration_us"]),
        is_error=np.concatenate(cols["is_error"]),
        status=np.concatenate(cols["status"]),
        kind=np.concatenate(cols["kind"]),
        services=tuple(services),
        endpoints=tuple(endpoints),
        trace_ids=trace_ids,
    )
    # Sort spans by start time (stable), preserving parent links via permutation.
    order = np.argsort(batch.start_us, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    parent_sorted = batch.parent[order]
    parent_sorted = np.where(parent_sorted >= 0, inv[np.clip(parent_sorted, 0, None)], -1)
    batch = batch._replace(
        trace=batch.trace[order], parent=parent_sorted.astype(np.int32),
        service=batch.service[order], endpoint=batch.endpoint[order],
        start_us=batch.start_us[order], duration_us=batch.duration_us[order],
        is_error=batch.is_error[order], status=batch.status[order],
        kind=batch.kind[order],
    )
    return batch.validate()


# ---------------------------------------------------------------------------
# JSON emitters matching the raw reference artifacts (used for loader tests
# and for materializing a synthetic dataset tree).
# ---------------------------------------------------------------------------

def spans_to_skywalking_json(batch: SpanBatch, experiment: str) -> dict:
    """Emit the TT SkyWalking collector JSON (trace_collector.py:552-584)."""
    traces: List[dict] = []
    by_trace: Dict[int, List[int]] = {}
    for i in range(batch.n_spans):
        by_trace.setdefault(int(batch.trace[i]), []).append(i)
    for t, rows in by_trace.items():
        # segment per service within the trace (simplified: one segment/service)
        pos = {row: j for j, row in enumerate(rows)}
        seg_of_svc: Dict[int, str] = {}
        node_ids = {}
        for i in rows:
            svc = int(batch.service[i])
            seg = seg_of_svc.setdefault(svc, f"seg-{batch.trace_ids[t]}-{svc}")
            node_ids[i] = f"{seg}:{pos[i]}"
        spans = []
        roots = []
        for i in rows:
            svc = int(batch.service[i])
            seg = seg_of_svc[svc]
            par = int(batch.parent[i])
            parent_node = node_ids.get(par) if par >= 0 else None
            same_segment = par >= 0 and int(batch.service[par]) == svc
            start_ms = int(batch.start_us[i] // 1000)
            end_ms = int((batch.start_us[i] + batch.duration_us[i]) // 1000)
            refs = []
            if par >= 0 and not same_segment:
                par_svc = int(batch.service[par])
                refs.append({
                    "traceId": batch.trace_ids[t],
                    "parentSegmentId": seg_of_svc[par_svc],
                    "parentSpanId": pos[par],
                    "type": "CROSS_PROCESS",
                })
            if par < 0:
                roots.append(node_ids[i])
            spans.append({
                "node_id": node_ids[i],
                "trace_id": batch.trace_ids[t],
                "segment_id": seg,
                "span_id": pos[i],
                "parent_span_id": pos[par] if same_segment else -1,
                "parent_node_id": parent_node,
                "depth": 0,
                "children_node_ids": [],
                "service_code": batch.services[svc],
                "service_instance": f"{batch.services[svc]}-instance",
                "start_timestamp_ms": start_ms,
                "end_timestamp_ms": end_ms,
                "duration_ms": max(0, end_ms - start_ms),
                "endpoint_name": batch.endpoints[int(batch.endpoint[i])],
                "type": KIND_NAMES[int(batch.kind[i])] if int(batch.kind[i]) < 3 else "Local",
                "peer": None,
                "component": "SpringMVC",
                "layer": "Http",
                "is_error": bool(batch.is_error[i]),
                "tags": [{"key": "http.status_code", "value": str(int(batch.status[i]))}],
                "tags_map": {"http.status_code": str(int(batch.status[i]))},
                "logs": [],
                "refs": refs,
            })
        svcs = sorted({s["service_code"] for s in spans})
        traces.append({
            "summary": {"trace_ids": [batch.trace_ids[t]],
                        "duration": max(s["duration_ms"] for s in spans),
                        "is_error": any(s["is_error"] for s in spans)},
            "trace_id": batch.trace_ids[t],
            "span_count": len(spans),
            "services_involved": svcs,
            "root_span_node_ids": roots,
            "spans": spans,
        })
    return {
        "metadata": {
            "experiment": experiment,
            "collection_hours": 24,
            "trace_count": len(traces),
            "span_count": batch.n_spans,
            "services": sorted(set(batch.services)),
            # the reference generator's name: the artifact is byte-identical
            # to the one it writes
            "generator": "anomod.synth",
        },
        "traces": traces,
    }


_KIND_TO_JAEGER = {KIND_ENTRY: "server", KIND_EXIT: "client", KIND_LOCAL: "internal"}


def spans_to_jaeger_json(batch: SpanBatch) -> dict:
    """Emit Jaeger API JSON (consumed by jaeger_to_csv.py:20-74)."""
    data = []
    by_trace: Dict[int, List[int]] = {}
    for i in range(batch.n_spans):
        by_trace.setdefault(int(batch.trace[i]), []).append(i)
    for t, rows in by_trace.items():
        processes = {f"p{int(batch.service[i])}":
                     {"serviceName": batch.services[int(batch.service[i])]}
                     for i in rows}
        spans = []
        for i in rows:
            refs = []
            par = int(batch.parent[i])
            if par >= 0:
                refs.append({"refType": "CHILD_OF",
                             "traceID": batch.trace_ids[t],
                             "spanID": f"s{par:08x}"})
            spans.append({
                "traceID": batch.trace_ids[t],
                "spanID": f"s{i:08x}",
                "processID": f"p{int(batch.service[i])}",
                "operationName": batch.endpoints[int(batch.endpoint[i])],
                "startTime": int(batch.start_us[i]),
                "duration": int(batch.duration_us[i]),
                "references": refs,
                "tags": [
                    {"key": "http.status_code", "value": int(batch.status[i])},
                    {"key": "span.kind",
                     "value": _KIND_TO_JAEGER[int(batch.kind[i])]},
                    {"key": "component", "value": "thrift"},
                ] + ([{"key": "error", "value": True}]
                     if bool(batch.is_error[i]) else []),
                "logs": [],
            })
        data.append({"traceID": batch.trace_ids[t],
                     "processes": processes, "spans": spans})
    return {"data": data}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

# Complete reference catalogs live in anomod_torch.metrics_catalog
# (level-keyed); re-exported here because the generator is where they
# become data.
from anomod_torch.metrics_catalog import (  # noqa: E402
    SN_METRIC_FILES, SN_PER_SERVICE_FILES, TT_ALL_METRIC_NAMES,
    TT_METRIC_NAMES, TT_PER_SERVICE_METRICS)


def _host_family_values(name: str, label: FaultLabel, rng, t, in_window,
                        lat_mult: float, sev: float = 1.0) -> np.ndarray:
    """One host-scoped series for an SN/TT metric family, fault-conditioned.

    Shapes follow the reference's sanity thresholds where it states them
    (SN README.md:106: CPU fault ⇒ system_cpu_usage > 90%, Redis cache fault
    ⇒ reduced redis_memory_used plateau); otherwise: performance faults
    inflate their matching resource family inside the anomaly window,
    database faults move storage/fd families, everything else is stationary
    noise around a per-family operating point.
    """
    nt = t.shape[0]
    anomaly = label.is_anomaly
    typ = label.anomaly_type
    lvl = label.anomaly_level

    def gauge(base: float, noise: float) -> np.ndarray:
        return base + rng.normal(0, noise, nt)

    if name in ("system_cpu_usage",):
        base = gauge(rng.uniform(15, 35), 3)
        if anomaly and typ == "cpu_contention":
            spike = rng.uniform(91, 99, nt)
            base = np.where(in_window, base + (spike - base) * sev, base)
        return np.clip(base, 0, 100)
    if name == "node_cpu_seconds_total":
        # counter: cumulative busy seconds; slope rises under CPU faults
        rate = np.clip(gauge(rng.uniform(2, 6), 0.5), 0.1, None)
        if anomaly and typ == "cpu_contention":
            rate = np.where(in_window, rate * lat_mult, rate)
        return np.cumsum(rate)
    if name in ("system_load1", "node_load5"):
        base = np.abs(gauge(rng.uniform(0.5, 2.0), 0.3))
        if anomaly and typ == "cpu_contention":
            base = np.where(in_window, base * scale_mult(5.0, sev), base)
        return base
    if name == "system_memory_usage_percent":
        return np.clip(gauge(rng.uniform(35, 60), 2), 0, 100)
    if name == "node_memory_MemTotal_bytes":
        return np.full(nt, 16.0e9)
    if name in ("node_memory_MemAvailable_bytes", "node_memory_MemFree_bytes"):
        base = gauge(rng.uniform(6e9, 9e9), 2e8)
        if anomaly and typ == "cache_limit":  # memory stress on the DB host
            base = np.where(in_window, base * scale_mult(0.4, sev), base)
        return np.clip(base, 1e8, None)
    if name in ("system_disk_io_time", "node_disk_io_time_seconds_total",
                "system_disk_read_bytes", "system_disk_write_bytes",
                "node_disk_read_bytes_total", "node_disk_written_bytes_total"):
        base = np.abs(gauge(rng.uniform(5, 50), 5))
        if anomaly and typ == "disk_io_stress":
            base = np.where(in_window, base * lat_mult, base)
        return base
    if name == "system_disk_usage_percent":
        return np.clip(gauge(rng.uniform(40, 70), 0.5), 0, 100)
    if name in ("node_filesystem_size_bytes",):
        return np.full(nt, 200.0e9)
    if name == "node_filesystem_avail_bytes":
        drain = 1e5 if not (anomaly and lvl == "database") else 1e5 + 4.9e6 * sev
        return 80.0e9 - np.cumsum(np.full(nt, drain)) + rng.normal(0, 1e6, nt)
    if name == "volume_manager_total_volumes":
        return np.full(nt, float(rng.integers(20, 40)))
    if name in ("system_network_receive_bytes", "system_network_transmit_bytes",
                "node_network_receive_bytes_total",
                "node_network_transmit_bytes_total"):
        base = np.abs(gauge(rng.uniform(1e6, 5e6), 2e5))
        if anomaly and typ == "network_loss":
            # lost throughput
            base = np.where(in_window, base * scale_mult(0.3, sev), base)
        return base
    if name in ("system_network_errors", "node_network_receive_drop_total",
                "node_network_transmit_drop_total",
                "node_network_receive_errs_total",
                "node_network_transmit_errs_total"):
        base = np.abs(gauge(1.0, 0.5))
        if anomaly and typ in ("network_loss", "dns_failure"):
            base = np.where(in_window, base + rng.uniform(50, 200, nt) * sev,
                            base)
        return base
    if name == "jaeger_spans_rate":
        base = np.abs(gauge(rng.uniform(100, 300), 20))
        if anomaly and lvl == "performance":
            base = np.where(in_window, base / max(lat_mult / 2, 1.0), base)
        return base
    if name == "jaeger_sampling_rate":
        return np.clip(gauge(1.0, 0.01), 0, 1)
    if name in ("post_creation_rate", "timeline_read_rate"):
        from anomod_torch.workload import SN_REQUEST_MIX
        mix = (SN_REQUEST_MIX["compose-post-service"]
               if name == "post_creation_rate"
               else SN_REQUEST_MIX["home-timeline-service"]
               + SN_REQUEST_MIX["user-timeline-service"])
        base = np.abs(gauge(150.0 * mix, 15.0 * mix))
        if anomaly and lvl == "performance":  # host fault slows the workload
            base = np.where(in_window, base / max(lat_mult / 2, 1.0), base)
        return base
    # stationary default for families without a fault hook
    return np.abs(gauge(rng.uniform(1, 100), 5))


# SN store topology: the gcov compose stack runs one Redis/Mongo instance
# per owning service (docker-compose-gcov.yml:227-322), and the ChaosBlade
# cache-limit fault targets ONE service's Redis — so the store-family
# PromQL (redis_memory_used_bytes etc., no grouping) returns one series per
# exporter instance, attributed here to the owning service.
SN_REDIS_OWNERS: Tuple[str, ...] = (
    "home-timeline-service", "user-timeline-service", "social-graph-service")
SN_MONGO_OWNERS: Tuple[str, ...] = (
    "post-storage-service", "user-timeline-service", "social-graph-service",
    "user-service", "media-service", "url-shorten-service")
SN_STORE_FILES: Dict[str, Tuple[str, ...]] = {
    "mongodb_latency_p95": SN_MONGO_OWNERS,
    "redis_memory_used": SN_REDIS_OWNERS,
    "redis_command_rate": SN_REDIS_OWNERS,
}


def _store_family_values(name: str, label: FaultLabel, rng, t, in_window,
                         lat_mult: float, is_target: bool,
                         sev: float = 1.0) -> np.ndarray:
    """One per-store-instance series (owner-service attributed)."""
    nt = t.shape[0]
    anomaly = label.is_anomaly and is_target
    lvl = label.anomaly_level
    typ = label.anomaly_type
    if name == "mongodb_latency_p95":
        base = np.abs(rng.uniform(0.005, 0.02) + rng.normal(0, 0.002, nt))
        if anomaly and lvl == "database":
            # cache limit pushes misses onto the backing store
            base = np.where(in_window, base * lat_mult, base)
        return base
    if name == "redis_memory_used":
        base = rng.uniform(4e7, 6e7) + rng.normal(0, 1e6, nt)
        if anomaly and typ == "cache_limit":
            # README.md:106 plateau drop
            base = np.where(in_window, base * scale_mult(0.3, sev), base)
        return base
    # redis_command_rate
    base = np.abs(rng.uniform(200, 500) + rng.normal(0, 30, nt))
    if anomaly and typ == "cache_limit":
        base = np.where(in_window, base * scale_mult(0.5, sev), base)
    return base


def _service_family_values(name: str, label: FaultLabel, rng, t, in_window,
                           lat_mult: float, err_p: float,
                           is_target: bool, sev: float = 1.0) -> np.ndarray:
    """One per-service series, fault-conditioned on the culprit service."""
    nt = t.shape[0]
    anomaly = label.is_anomaly and is_target
    typ = label.anomaly_type

    def gauge(base: float, noise: float) -> np.ndarray:
        return base + rng.normal(0, noise, nt)

    if name == "up":
        v = np.ones(nt)
        if anomaly and typ == "kill_service_instance":
            v = np.where(in_window & (rng.random(nt) < 0.5 * sev), 0.0, v)
        return v
    if name == "kube_pod_status_phase":
        v = np.ones(nt)  # 1 == Running
        if anomaly and typ == "kill_service_instance":
            v = np.where(in_window & (rng.random(nt) < 0.5 * sev), 0.0, v)
        return v
    if name == "kube_pod_container_status_restarts_total":
        if anomaly and typ == "kill_service_instance":
            # Schedule+PodChaos kills every 3 s (Lv_S_KILLPOD_*.yaml:15-22)
            return np.cumsum(in_window * rng.poisson(2.0 * sev, nt)).astype(float)
        return np.zeros(nt)
    if name in ("microservice_request_rate", "http_requests_total"):
        rate = np.abs(gauge(rng.uniform(20, 80), 5))
        if anomaly and typ in ("kill_service_instance", "dns_failure"):
            # requests not arriving
            rate = np.where(in_window, rate * scale_mult(0.2, sev), rate)
        if name == "http_requests_total":
            return np.cumsum(rate)  # counter
        return rate
    if name == "microservice_error_rate":
        base = np.clip(gauge(0.002, 0.001), 0, 1)
        if anomaly:
            base = np.where(in_window, np.clip(err_p + rng.normal(0, 0.02, nt),
                                               0, 1), base)
        return base
    if name == "microservice_latency_p95":
        base = np.abs(gauge(rng.uniform(0.01, 0.06), 0.005))
        if anomaly:
            base = np.where(in_window, base * lat_mult, base)
        return base
    if name in ("socialnet_container_cpu", "container_cpu_usage_seconds_total",
                "process_cpu_seconds_total"):
        base = np.abs(gauge(rng.uniform(5, 20), 2))
        if anomaly and label.anomaly_level in ("performance", "database"):
            base = np.where(in_window, base * lat_mult, base)
        return base
    if name == "container_cpu_cfs_throttled_periods_total":
        rate = np.zeros(nt)
        if anomaly and typ == "cpu_contention":
            rate = in_window * rng.poisson(5.0 * sev, nt).astype(float)
        return np.cumsum(rate)
    if name in ("socialnet_container_memory", "container_memory_usage_bytes",
                "container_memory_working_set_bytes",
                "process_resident_memory_bytes"):
        base = np.abs(gauge(rng.uniform(2e8, 8e8), 2e7))
        if anomaly and typ == "cache_limit":
            base = np.where(in_window, base * scale_mult(1.8, sev), base)
        return base
    if name == "container_spec_memory_limit_bytes":
        return np.full(nt, 2.0e9)
    if name == "container_memory_failcnt":
        if anomaly and typ == "cache_limit":
            return np.cumsum(in_window * rng.poisson(1.0 * sev, nt)).astype(float)
        return np.zeros(nt)
    if name in ("socialnet_container_network_receive",
                "socialnet_container_network_transmit",
                "container_network_receive_bytes_total",
                "container_network_transmit_bytes_total"):
        base = np.abs(gauge(rng.uniform(1e5, 1e6), 5e4))
        if anomaly and typ in ("network_loss", "http_abort"):
            base = np.where(in_window, base * scale_mult(0.3, sev), base)
        return base
    if name in ("container_network_receive_errors_total",
                "container_network_transmit_errors_total"):
        base = np.abs(gauge(0.5, 0.3))
        if anomaly and typ in ("network_loss", "dns_failure"):
            base = np.where(in_window, base + rng.uniform(20, 80, nt) * sev,
                            base)
        return base
    if name == "process_open_fds":
        base = np.abs(gauge(rng.uniform(50, 150), 10))
        if anomaly and typ == "connection_pool_exhaustion":
            base = np.where(in_window, base * scale_mult(8.0, sev), base)
        return base
    if name == "process_max_fds":
        return np.full(nt, 1024.0)
    if name == "container_processes":
        return np.abs(gauge(rng.uniform(10, 40), 1))
    if name == "kubelet_volume_stats_used_bytes":
        drain = 5e4 if not (anomaly and label.anomaly_level == "database") \
            else 5e4 + (5e6 - 5e4) * sev
        return 1.0e9 + np.cumsum(np.full(nt, drain)) + rng.normal(0, 1e5, nt)
    # generic per-service level with target inflation
    base = np.abs(gauge(10 * rng.uniform(0.5, 2.0), 2))
    if anomaly:
        base = np.where(in_window, base * lat_mult, base)
    return base


def generate_metrics(label: FaultLabel, duration_s: int = 1800, step_s: int = 15,
                     seed: Optional[int] = None,
                     base_time_s: float = 1.7621800e9,
                     hard: HardMode = _EASY) -> MetricBatch:
    """Fault-conditioned metric samples at the reference's 15 s step
    (collect_metric.sh:4-5), over the COMPLETE reference catalogs: all 24 SN
    per-query families (collect_metric.sh:20-125) and all TT level-group +
    kube-state families (metric_collector.py:37-104,283-303) — see
    anomod_torch.metrics_catalog."""
    if seed is None:
        seed = _seed_for(label.experiment, 2)
    rng = np.random.default_rng(seed)
    services, _, _ = _topology(label.testbed)
    if label.testbed == "SN":
        names: Tuple[str, ...] = SN_METRIC_FILES
        per_service = frozenset(SN_PER_SERVICE_FILES)
    else:
        names = TT_ALL_METRIC_NAMES
        per_service = frozenset(TT_PER_SERVICE_METRICS)
    t = np.arange(0, duration_s, step_s, dtype=np.float64) + base_time_s
    nt = t.shape[0]
    sev = hard.severity
    lat_mult, err_p = _fault_effects(label, sev)

    metric_col, series_col, t_col, v_col = [], [], [], []
    series_keys: List[str] = []
    series_service: List[int] = []

    def add_series(m_idx: int, key: str, svc: int, values: np.ndarray):
        s_idx = len(series_keys)
        series_keys.append(key)
        series_service.append(svc)
        metric_col.append(np.full(nt, m_idx, np.int32))
        series_col.append(np.full(nt, s_idx, np.int32))
        t_col.append(t)
        v_col.append(values)

    # anomaly window: middle third of the experiment (same [600, 1200) s
    # window generate_spans / generate_logs / generate_api use; rescaled to
    # the canonical 1800 s so non-default durations keep proportional
    # boundaries under every fault_profile)
    in_window = anomaly_window_mask((t - t[0]) * (1800.0 / duration_s),
                                    hard.fault_profile)
    # SN host-level performance faults (ChaosBlade on the Docker host) hit
    # every service's containers; named-target faults hit one service.
    host_level = label.is_anomaly and label.target_service not in services
    # an edge-locus fault is a link fault: node-scoped series stay healthy
    # (the trace plane carries the only attribution evidence); is_anomaly
    # derives from anomaly_level, so neutralize the level
    if hard.fault_locus == "edge" and not host_level:
        label = dataclasses.replace(label, anomaly_level="normal")
    for m_idx, name in enumerate(names):
        if label.testbed == "SN" and name in SN_STORE_FILES:
            store = name.split("_")[0]  # "mongodb" | "redis"
            for svc_name in SN_STORE_FILES[name]:
                s = services.index(svc_name)
                is_target = label.is_anomaly and (
                    host_level or svc_name == label.target_service)
                add_series(m_idx, f'instance="{svc_name}-{store}"', s,
                           _store_family_values(name, label, rng, t,
                                                in_window, lat_mult,
                                                is_target, sev))
        elif name in per_service:
            for s, svc_name in enumerate(services):
                is_target = label.is_anomaly and (
                    host_level or svc_name == label.target_service)
                key = (f'name="{svc_name}"' if label.testbed == "SN"
                       else f'pod="{svc_name}-0",service="{svc_name}"')
                add_series(m_idx, key, s,
                           _service_family_values(name, label, rng, t,
                                                  in_window, lat_mult, err_p,
                                                  is_target, sev))
        else:
            add_series(m_idx, 'instance="host"', -1,
                       _host_family_values(name, label, rng, t, in_window,
                                           lat_mult, sev))

    return MetricBatch(
        metric=np.concatenate(metric_col),
        series=np.concatenate(series_col),
        t_s=np.concatenate(t_col),
        value=np.concatenate(v_col),
        metric_names=tuple(names),
        series_keys=tuple(series_keys),
        series_service=np.array(series_service, np.int32),
        services=tuple(services),
    )


# ---------------------------------------------------------------------------
# Logs, API responses, coverage
# ---------------------------------------------------------------------------

def generate_logs(label: FaultLabel, lines_per_service: int = 400,
                  seed: Optional[int] = None,
                  base_time_s: float = 1.7621800e9,
                  hard: HardMode = _EASY) -> Tuple[LogBatch, List[LogSummary]]:
    if seed is None:
        seed = _seed_for(label.experiment, 3)
    rng = np.random.default_rng(seed)
    services, _, _ = _topology(label.testbed)
    svc_col, t_col, lvl_col = [], [], []
    summaries = []
    host_level = label.is_anomaly and label.target_service not in services
    sev = hard.severity
    p_culprit = 0.01 + ((0.35 if not host_level else 0.12) - 0.01) * sev
    for s, svc in enumerate(services):
        n = int(lines_per_service * rng.uniform(0.5, 2.0))
        tt = base_time_s + np.sort(rng.uniform(0, 1800, n))
        # edge-locus faults leave node-scoped logs healthy (link fault)
        culprit = label.is_anomaly and (host_level or label.target_service == svc) \
            and not (hard.fault_locus == "edge" and not host_level)
        # elevated error rate only inside the shared anomaly window [600,1200)s
        in_window = anomaly_window_mask(tt - base_time_s, hard.fault_profile)
        p_err = np.where(culprit & in_window, p_culprit, 0.01)
        if svc in hard.confounders and not culprit:
            p_err = np.where(in_window, 0.03, p_err)
        r = rng.random(n)
        lvl = np.where(r < p_err, LOG_ERROR,
                       np.where(r < p_err + 0.05, LOG_WARN, LOG_INFO)).astype(np.int8)
        svc_col.append(np.full(n, s, np.int32))
        t_col.append(tt)
        lvl_col.append(lvl)
        summaries.append(LogSummary(
            service=svc, n_lines=n,
            n_error=int((lvl == LOG_ERROR).sum()),
            n_warn=int((lvl == LOG_WARN).sum()),
            n_info=int((lvl == LOG_INFO).sum()),
            size_bytes=n * 120))
    return LogBatch(
        service=np.concatenate(svc_col), t_s=np.concatenate(t_col),
        level=np.concatenate(lvl_col), services=tuple(services),
    ), summaries


def generate_api(label: FaultLabel, n_records: int = 600,
                 seed: Optional[int] = None,
                 base_time_s: float = 1.7621800e9,
                 hard: HardMode = _EASY) -> ApiBatch:
    if seed is None:
        seed = _seed_for(label.experiment, 4)
    rng = np.random.default_rng(seed)
    if label.testbed == "SN":
        eps = SN_API_ENDPOINTS
    else:
        eps = tuple(f"/api/v1/{s.replace('ts-', '').replace('-service', '')}service"
                    for s in TT_SERVICES[:20])
    lat_mult, err_p = _fault_effects(label, hard.severity)
    ep = rng.integers(0, len(eps), n_records).astype(np.int32)
    t = base_time_s + np.sort(rng.uniform(0, 1800, n_records))
    lat = rng.lognormal(np.log(40.0), 0.5 * (1.0 + hard.noise),
                        n_records).astype(np.float32)
    status = np.full(n_records, 200, np.int16)
    # An edge-locus fault lives on the target's OUTGOING links.  End-to-end
    # API routes through the target still slow down (the route waits on the
    # slow downstream call) — but ONLY if the target has outgoing calls: a
    # leaf target faults no edge, so the whole API surface stays healthy.
    # Without this gate the api artifact named the culprit for corpora
    # that carry zero fault signal anywhere else (a target-identity leak
    # the learned models exploited to fake 1.00 on edge-locus leaf kills).
    edge_inert = (hard.fault_locus == "edge" and label.target_service
                  and not any(a == label.target_service
                              for a, _c in _topology(label.testbed)[1]))
    if label.is_anomaly and not edge_inert:
        # endpoints routed through the culprit service bear the brunt; a
        # host-level fault (no target) hits the whole surface (matches how
        # the reference's monitor sees chaos: per-endpoint p95/p99 spikes on
        # affected routes, enhanced_openapi_monitor.py:318-397)
        from anomod_torch.suite import endpoint_owner  # suite imports synth
        owners = np.array([endpoint_owner(e, label.testbed) for e in eps])
        on_target = (owners == label.target_service)[ep] \
            if label.target_service else np.ones(n_records, bool)
        hit_p = np.where(on_target, min(err_p + 0.05, 0.6),
                         min(err_p * 0.1 + 0.01, 0.1))
        affected = rng.random(n_records) < hit_p
        # API records see end-to-end latency, so they stay fault-conditioned
        # under an edge locus (a slow outgoing call still slows the route);
        # only the active-window profile shifts
        in_window = anomaly_window_mask(t - t[0], hard.fault_profile)
        affected &= in_window
        lat = np.where(affected, lat * lat_mult, lat).astype(np.float32)
        status = np.where(affected & (rng.random(n_records) < err_p), 500, status)
    clen = rng.integers(64, 4096, n_records).astype(np.int32)
    if label.testbed == "SN":
        # compose-post records carry the wrk2 content model's body-length
        # distribution (mixed-workload.lua:33-83) instead of the generic
        # response-size draw.
        from anomod_torch.workload import sample_compose_lengths
        compose = np.array(["post/compose" in e for e in eps])[ep]
        if compose.any():
            clen[compose] = sample_compose_lengths(rng, int(compose.sum()))
    return ApiBatch(endpoint=ep, t_s=t, status=status.astype(np.int16),
                    latency_ms=lat, content_length=clen, endpoints=eps)


@functools.lru_cache(maxsize=4096)
def _file_coverage_base(svc: str, i: int) -> Tuple[int, float]:
    """Line count + base coverage ratio of one source file.  These belong to
    the *codebase*, not the experiment: seeded per (service, file) so coverage
    is stable across experiments and only fault-conditioned shifts move it
    (the reference's per-run reports differ mainly on the culprit, e.g.
    ts-order-service under Lv_C_exception_injection)."""
    frng = np.random.default_rng(_seed_for(f"{svc}/file_{i}", 5))
    return int(frng.integers(50, 800)), float(frng.uniform(0.3, 0.7))


def generate_coverage(label: FaultLabel, files_per_service: int = 6,
                      seed: Optional[int] = None,
                      hard: HardMode = _EASY) -> CoverageBatch:
    if seed is None:
        seed = _seed_for(label.experiment, 5)
    rng = np.random.default_rng(seed)
    services, _, _ = _topology(label.testbed)
    files: List[FileCoverage] = []
    for svc in services:
        for i in range(files_per_service):
            total, base_ratio = _file_coverage_base(svc, i)
            ratio = base_ratio + float(rng.uniform(-0.02, 0.02))  # run jitter
            if label.is_anomaly and label.target_service == svc \
                    and hard.fault_locus != "edge":
                # injected faults shift executed paths on the culprit — but
                # only NODE faults: a link fault is in the network between
                # services, the culprit's own code runs the same paths
                # (leaving this ungated leaked the target's identity into
                # edge-locus corpora through an artifact no real link
                # fault would move)
                ratio = max(0.05, ratio - 0.15 * hard.severity)
            ext = "cpp" if label.testbed == "SN" else "java"
            files.append(FileCoverage(
                service=svc, path=f"src/{svc}/file_{i}.{ext}",
                lines_total=total, lines_covered=int(total * min(ratio, 1.0))))
    return coverage_batch_from_files(files)


def generate_experiment(label_or_name, n_traces: int = 200,
                        seed: Optional[int] = None,
                        hard: HardMode = _EASY) -> Experiment:
    """Generate a full five-modality experiment bundle.

    ``hard`` tunes corpus difficulty (severity / noise / confounders) for
    de-saturated evaluation — see :class:`HardMode`.  Confounders degrade
    spans and logs only: a decoy slowdown plausibly moves latency and log
    errors but not kube-state counters, so the metric modality is the
    disambiguating evidence, as it would be for a real operator.
    """
    if isinstance(label_or_name, str):
        label = labels_mod.label_for(label_or_name)
        if label is None:
            raise KeyError(f"unknown experiment: {label_or_name}")
    else:
        label = label_or_name
    logs, summaries = generate_logs(label, seed=seed, hard=hard)
    return Experiment(
        name=label.experiment, testbed=label.testbed,
        spans=generate_spans(label, n_traces=n_traces, seed=seed, hard=hard),
        metrics=generate_metrics(label, seed=seed, hard=hard),
        logs=logs, log_summaries=summaries,
        api=generate_api(label, seed=seed, hard=hard),
        coverage=generate_coverage(label, seed=seed, hard=hard),
        synthetic=True,
    )


def generate_corpus(testbed: str, n_traces: int = 200) -> List[Experiment]:
    """All 13 experiments (12 faults + normal) for one testbed — the synthetic
    mirror of the shipped SN_data/TT_data trees."""
    return [generate_experiment(l, n_traces=n_traces)
            for l in labels_mod.labels_for_testbed(testbed)]
