"""Service-dependency graph construction from span batches (counterpart
of ``anomod/graph.py``; host numpy, byte-identical output).

By the time spans reach this module they are a SpanBatch with resolved
``parent`` row indices (the loaders handle both trace conventions), so
everything here is O(n) numpy on fixed-dtype columns.

Outputs:
  - ``ServiceGraph``: dense service x service edge matrix + padded CSR
    (fixed shapes for the GNNs' message passing).
  - per-service / per-edge aggregates (count, error rate, latency stats).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from anomod_torch.schemas import SpanBatch


class ServiceGraph(NamedTuple):
    """Service DAG with padded-CSR adjacency (static shapes)."""

    services: Tuple[str, ...]
    # dense [S, S] call-count matrix: A[i, j] = #spans where i calls j
    adj_counts: np.ndarray          # int64
    # per-edge latency/error aggregates aligned with edge list
    edge_src: np.ndarray            # int32 [E]
    edge_dst: np.ndarray            # int32 [E]
    edge_count: np.ndarray          # int64 [E]
    edge_err: np.ndarray            # int64 [E]
    edge_lat_sum_us: np.ndarray     # float64 [E]
    # padded CSR over the fixed service set: neighbors[i, k] = k-th callee
    neighbors: np.ndarray           # int32 [S, Dmax] (padded with -1)
    neighbor_mask: np.ndarray       # bool  [S, Dmax]

    @property
    def n_services(self) -> int:
        return len(self.services)

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


def depths(batch: SpanBatch) -> np.ndarray:
    """Span depth in its trace (root=0), replacing the reference's BFS
    (trace_collector.py:461-481) with pointer-jumping over the parent column —
    O(n log d) and fully vectorized."""
    n = batch.n_spans
    d = np.zeros(n, np.int32)
    cur = batch.parent.copy()
    while (cur >= 0).any():
        live = cur >= 0
        d[live] += 1
        cur = np.where(live, batch.parent[np.clip(cur, 0, None)], -1)
    return d


def service_edges(batch: SpanBatch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src_service, dst_service, span_row) for every cross-service call.

    A call edge exists where a span's parent lives in a different service
    (covers both SkyWalking Exit→Entry pairs and Jaeger CHILD_OF chains).
    """
    has_parent = batch.parent >= 0
    child = np.flatnonzero(has_parent)
    par = batch.parent[child]
    src = batch.service[par]
    dst = batch.service[child]
    cross = src != dst
    return src[cross], dst[cross], child[cross]


def build_service_graph(batch: SpanBatch,
                        services: Optional[Tuple[str, ...]] = None,
                        max_degree: Optional[int] = None) -> ServiceGraph:
    """Build the service DAG.  ``services`` pins the node set (and ordering) so
    graphs from different experiments share shapes; defaults to batch table."""
    if services is None:
        services = batch.services
    S = len(services)
    # remap batch-local service ids into the pinned table
    remap = np.full(len(batch.services), -1, np.int32)
    svc_index = {s: i for i, s in enumerate(services)}
    for i, s in enumerate(batch.services):
        remap[i] = svc_index.get(s, -1)

    src_l, dst_l, child_rows = service_edges(batch)
    src = remap[src_l]
    dst = remap[dst_l]
    keep = (src >= 0) & (dst >= 0)
    src, dst, child_rows = src[keep], dst[keep], child_rows[keep]

    flat = src.astype(np.int64) * S + dst
    adj = np.zeros(S * S, np.int64)
    np.add.at(adj, flat, 1)
    err = np.zeros(S * S, np.int64)
    np.add.at(err, flat, batch.is_error[child_rows].astype(np.int64))
    lat = np.zeros(S * S, np.float64)
    np.add.at(lat, flat, batch.duration_us[child_rows].astype(np.float64))

    eflat = np.flatnonzero(adj)
    edge_src = (eflat // S).astype(np.int32)
    edge_dst = (eflat % S).astype(np.int32)

    # padded CSR
    deg = np.zeros(S, np.int64)
    np.add.at(deg, edge_src, 1)
    dmax = int(max_degree or max(int(deg.max(initial=0)), 1))
    neighbors = np.full((S, dmax), -1, np.int32)
    mask = np.zeros((S, dmax), np.bool_)
    slot = np.zeros(S, np.int64)
    for e in range(eflat.shape[0]):
        s = edge_src[e]
        k = slot[s]
        if k < dmax:
            neighbors[s, k] = edge_dst[e]
            mask[s, k] = True
            slot[s] += 1

    return ServiceGraph(
        services=tuple(services),
        adj_counts=adj.reshape(S, S),
        edge_src=edge_src, edge_dst=edge_dst,
        edge_count=adj[eflat], edge_err=err[eflat],
        edge_lat_sum_us=lat[eflat],
        neighbors=neighbors, neighbor_mask=mask,
    )


# ---------------------------------------------------------------------------
# Per-service span aggregates — the feature vector the detectors consume.
# ---------------------------------------------------------------------------

class ServiceStats(NamedTuple):
    services: Tuple[str, ...]
    count: np.ndarray        # int64 [S]
    err_count: np.ndarray    # int64 [S]
    err_rate: np.ndarray     # float64 [S]
    lat_mean_us: np.ndarray  # float64 [S]
    lat_p50_us: np.ndarray   # float64 [S]
    lat_p95_us: np.ndarray   # float64 [S]
    lat_p99_us: np.ndarray   # float64 [S]


def service_stats(batch: SpanBatch,
                  services: Optional[Tuple[str, ...]] = None) -> ServiceStats:
    """Count / error-rate / latency percentiles per service.

    Percentiles are computed with one global sort + per-service segment
    indexing, not a Python loop over services.
    """
    if services is None:
        services = batch.services
    S = len(services)
    svc_index = {s: i for i, s in enumerate(services)}
    remap = np.array([svc_index.get(s, -1) for s in batch.services] or [-1],
                     np.int32)
    svc = remap[batch.service] if batch.n_spans else np.zeros(0, np.int32)
    keep = svc >= 0
    svc = svc[keep]
    dur = batch.duration_us[keep].astype(np.float64)
    err = batch.is_error[keep]

    count = np.zeros(S, np.int64)
    np.add.at(count, svc, 1)
    err_count = np.zeros(S, np.int64)
    np.add.at(err_count, svc, err.astype(np.int64))
    lat_sum = np.zeros(S, np.float64)
    np.add.at(lat_sum, svc, dur)

    # segment-sorted percentiles
    p50 = np.zeros(S); p95 = np.zeros(S); p99 = np.zeros(S)
    if svc.shape[0]:
        order = np.lexsort((dur, svc))
        svc_s, dur_s = svc[order], dur[order]
        starts = np.searchsorted(svc_s, np.arange(S))
        ends = np.searchsorted(svc_s, np.arange(S) + 1)
        seg_len = ends - starts
        for q, out in ((0.50, p50), (0.95, p95), (0.99, p99)):
            idx = starts + np.clip((seg_len * q).astype(np.int64),
                                   0, np.maximum(seg_len - 1, 0))
            vals = dur_s[np.clip(idx, 0, max(dur_s.shape[0] - 1, 0))] \
                if dur_s.shape[0] else np.zeros(S)
            out[:] = np.where(seg_len > 0, vals, 0.0)

    with np.errstate(invalid="ignore", divide="ignore"):
        err_rate = np.where(count > 0, err_count / np.maximum(count, 1), 0.0)
        lat_mean = np.where(count > 0, lat_sum / np.maximum(count, 1), 0.0)

    return ServiceStats(services=tuple(services), count=count,
                        err_count=err_count, err_rate=err_rate,
                        lat_mean_us=lat_mean, lat_p50_us=p50,
                        lat_p95_us=p95, lat_p99_us=p99)
