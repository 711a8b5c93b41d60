"""Windowed RCA node/edge features (counterpart of
``anomod/rca_features.py``): ONE definition, shared by the offline
dataset builder (:mod:`anomod_torch.rca`) and any online extractor.

Pure host numpy over a SpanBatch + ReplayConfig, through the host replay
fold (``replay.replay_numpy`` over ``replay.stage_columns``), never the
card's kernel: the block must equal the JAX package's bit for bit, and an
f32 fold on the card adds in arrival order.

- :func:`agg_feature_block` — [S, W, 4] windowed aggregates (count,
  err rate, mean log-latency, 5xx rate) via the replay plane.
- :func:`windowed_features` — node features, optionally doubled with the
  per-service OUT-EDGE block (the link-fault evidence channel).
- :func:`edge_feature_block` — [E, W, 4] per-call-graph-edge aggregates.
- :func:`pad_edge_arrays` — the fixed-shape edge padding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from anomod_torch.replay import (F_ERR, F_LOGLAT, F_STATUS5XX, ReplayConfig,
                                 replay_numpy, stage_columns)
from anomod_torch.schemas import take_spans


def agg_feature_block(batch, services, cfg: ReplayConfig,
                      t0_us=None) -> np.ndarray:
    """[S, W, 4]: count, err_rate, mean log-latency, 5xx rate per window."""
    chunks, _ = stage_columns(batch, cfg, t0_us=t0_us)
    st = replay_numpy(chunks, cfg)
    agg = st.agg.reshape(len(services), cfg.n_windows, -1)
    count = agg[..., 0]
    safe = np.maximum(count, 1.0)
    return np.stack([
        np.log1p(count), agg[..., F_ERR] / safe, agg[..., F_LOGLAT] / safe,
        agg[..., F_STATUS5XX] / safe,
    ], axis=-1).astype(np.float32)


def windowed_features(batch, services, cfg: ReplayConfig,
                      edge_features: bool = False) -> np.ndarray:
    """[S, W, 4] node features — or [S, W, 8] with ``edge_features``: the
    same four aggregates computed a second time over each service's
    OUT-EDGE spans (spans whose parent belongs to that service, i.e. the
    callee side of its outgoing calls).  The out-edge block is the
    offline counterpart of the streaming detector's caller-keyed
    out-edge plane: a link fault (synth fault_locus="edge") is invisible
    in every node aggregate but lands exactly in the culprit's out-edge
    block — without it the models have no evidence channel for edge
    faults at all."""
    svc_index = {s: i for i, s in enumerate(services)}
    remap = np.array([svc_index.get(s, 0) for s in batch.services] or [0],
                     np.int32)
    batch = batch._replace(service=remap[batch.service],
                           services=tuple(services))
    # one time origin for BOTH blocks: the edge subset excludes root
    # spans, so letting stage_columns re-derive t0 from it would slide
    # the edge block's window grid relative to the node block's
    t0_us = int(batch.start_us.min()) if batch.n_spans else 0
    node = agg_feature_block(batch, services, cfg, t0_us=t0_us)
    if not edge_features:
        return node
    psvc = np.full(batch.n_spans, -1, np.int32)
    has = batch.parent >= 0
    psvc[has] = batch.service[batch.parent[has]]
    cross = (psvc >= 0) & (psvc != batch.service)
    if not cross.any():
        return np.concatenate([node, np.zeros_like(node)], axis=-1)
    edge_batch = take_spans(batch, cross)._replace(service=psvc[cross])
    edge = agg_feature_block(edge_batch, services, cfg, t0_us=t0_us)
    return np.concatenate([node, edge], axis=-1)


def edge_feature_block(batch, services, g, cfg: ReplayConfig) -> np.ndarray:
    """[E, W, 4] windowed aggregates PER call-graph edge of ``g`` —
    count/err/log-lat/5xx of the spans riding each (caller, callee) edge
    (child spans keyed by their parent's service, the
    ``replay.edge_keyed_batch`` convention).  The line-graph model's
    token features: a link fault lands in exactly one row here, where the
    per-caller out-edge BLOCK (windowed_features) sums it with every
    other callee of the same caller."""
    svc_index = {s: i for i, s in enumerate(services)}
    remap = np.array([svc_index.get(s, 0) for s in batch.services] or [0],
                     np.int32)
    svc = remap[batch.service]
    psvc = np.full(batch.n_spans, -1, np.int32)
    has = batch.parent >= 0
    psvc[has] = svc[batch.parent[has]]
    S = len(services)
    eid_of_pair = {int(a) * S + int(b): i
                   for i, (a, b) in enumerate(zip(g.edge_src, g.edge_dst))}
    E = len(eid_of_pair)
    pair = psvc.astype(np.int64) * S + svc
    eid = np.array([eid_of_pair.get(int(p), -1) for p in pair], np.int32)
    keep = (psvc >= 0) & (eid >= 0)
    if not keep.any() or E == 0:
        return np.zeros((E, cfg.n_windows, 4), np.float32)
    eb = take_spans(batch, keep)._replace(
        service=eid[keep],
        services=tuple(f"e{i}" for i in range(E)))
    cfg_e = dataclasses.replace(cfg, n_services=E)
    t0_us = int(batch.start_us.min()) if batch.n_spans else 0
    return agg_feature_block(eb, eb.services, cfg_e, t0_us=t0_us)


def pad_edge_arrays(g, e_max: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """(edge_src, edge_dst, edge_mask) of one ServiceGraph padded to the
    fixed ``e_max`` shape — the ONE edge-padding definition shared by
    the offline dataset builder and fixed-shape online consumers."""
    if g.n_edges > e_max:
        raise ValueError(f"graph has {g.n_edges} edges > e_max={e_max}")
    src = np.zeros(e_max, np.int32)
    dst = np.zeros(e_max, np.int32)
    mask = np.zeros(e_max, np.bool_)
    src[:g.n_edges] = g.edge_src
    dst[:g.n_edges] = g.edge_dst
    mask[:g.n_edges] = True
    return src, dst, mask
