"""Deterministic span generator (the span half of ``anomod/synth.py``).

Seeded per experiment label, it emits the fault-conditioned TT / SN span
corpora the replay and the online detector consume: latency inflation for
performance/database faults, error injection for service/code faults, all
inside the shared anomaly window [600, 1200) s.  Given the same
``(label, n_traces, seed, hard)`` it produces a ``SpanBatch`` byte-identical
to the JAX package's generator (pinned in tests/test_torch_synth.py), so
the two packages replay the same corpus.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch.labels import FaultLabel
from anomod_torch.schemas import (KIND_ENTRY, KIND_EXIT, SpanBatch,
                                  empty_span_batch)

#: the wrk2 workload distribution (mixed-workload.lua:113-115 — 60%
#: home-timeline read, 30% user-timeline read, 10% compose), used by the
#: SN template weighting
SN_REQUEST_MIX = {
    "home-timeline-service": 0.60,
    "user-timeline-service": 0.30,
    "compose-post-service": 0.10,
}

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
