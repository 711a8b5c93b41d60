"""The rank body of ``tests/test_torch_parallel.py``'s 2-rank ``gloo``
launch.

It imports only ``torch``, ``numpy`` and ``anomod_torch``, so a spawned
rank never imports JAX.  :func:`library_checks` runs every library check
of the parallel planes in one group (the collectives, the sharded replay,
the sharded streaming plane under the detector, the serve mesh plane) and
returns the rank's results as numpy arrays and lists; the parent compares
them with the JAX package on ``make_mesh(2)``.  The inputs are made here
from seeds, by the same recipes the parent uses for the JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

from anomod_torch import labels, synth
from anomod_torch.parallel import collectives as coll
from anomod_torch.parallel import make_mesh, make_sharded_replay_fn
from anomod_torch.parallel import stage_sharded
from anomod_torch.parallel.stream import ShardedStreamReplay
from anomod_torch.replay import ReplayConfig
from anomod_torch.schemas import concat_span_batches, take_spans
from anomod_torch.stream import OnlineDetector, resolve_parent_services

#: (kernel, merge) of the sharded replay runs, each with the HLL plane
REPLAY_RUNS = (("cuda", "replicated"), ("matmul", "replicated"),
               ("cuda", "scattered"))
#: micro-batch cuts of the span-only and the edge streams (the span-only
#: corpus has 1,928 spans: every push below is non-empty, one a single
#: span)
SPAN_CUTS_AT = (500, 501, 1200)
EDGE_CUTS_AT = (4000, 11000)


def collective_inputs(rank: int) -> dict:
    """One rank's collective inputs (the parent stacks both ranks')."""
    rng = np.random.default_rng(100 + rank)
    mean = np.sort(rng.normal(3.0, 1.0, (3, 16)), axis=-1)
    return {"x": rng.normal(0, 1, (8, 5)).astype(np.float32),
            "scatter": rng.integers(0, 50, (6, 4)).astype(np.float32),
            "hll": rng.integers(0, 20, (4, 64)).astype(np.int32),
            "td_mean": mean.astype(np.float32),
            "td_weight": rng.integers(0, 6, (3, 16)).astype(np.float32)}


def replay_corpus():
    """``tests/test_parallel.py``'s corpus: 13 TT labels x 30 traces."""
    return concat_span_batches([synth.generate_spans(l, n_traces=30)
                                for l in labels.labels_for_testbed("TT")])


def span_stream():
    """``tests/test_stream.py``'s sharded-stream input, in arrival order."""
    exp = synth.generate_experiment(labels.label_for("Svc_Kill_UserTimeline"),
                                    n_traces=200, seed=0)
    batch = exp.spans
    return take_spans(batch, np.argsort(batch.start_us, kind="stable"))


def edge_stream():
    """``tests/test_stream.py``'s edge-locus input: ``(label, batch,
    parent services, call edges)`` in arrival order."""
    label = labels.label_for("Lv_C_travel_detail_failure")
    hard = synth.HardMode(severity=1.0, noise=0.0, fault_locus="edge")
    exp = synth.generate_spans(label, n_traces=300, seed=0, hard=hard)
    psvc = resolve_parent_services(exp)
    order = np.argsort(exp.start_us, kind="stable")
    batch, psvc = take_spans(exp, order), psvc[order]
    has = batch.parent >= 0
    edges = set(zip(batch.service[batch.parent[has]].tolist(),
                    batch.service[has].tolist()))
    return label, batch, psvc, edges


def serve_traffic(traffic_mod):
    """``tests/test_serve.py``'s mesh deployment, from either package's
    traffic module: ``(traffic, engine kw, replay cfg kw, duration)``.
    The JAX test's ``max_tenant_backlog=100_000`` is the JAX engine's
    knob alone; at 600 spans/s against 10,000 of capacity no tenant ever
    queues past a tick, so it decides nothing here."""
    traffic = traffic_mod.PowerLawTraffic(
        n_tenants=2, total_rate_spans_per_s=600, alpha=0.0, seed=2,
        n_services=4, batch_cap=256,
        faults={0: traffic_mod.TenantFault("latency", service=1,
                                           onset_s=30.0, factor=12.0)})
    kw = dict(capacity_spans_per_s=10_000, tick_s=1.0, buckets=(256,),
              max_backlog=100_000, baseline_windows=4)
    cfg_kw = dict(n_services=4, n_windows=16, window_us=5_000_000,
                  chunk_size=512)
    return traffic, kw, cfg_kw, 50.0


def alert_keys(alerts, evidence=False) -> list:
    return [(a.window, a.service) + ((a.evidence,) if evidence else ())
            for a in alerts]


def _cuts(n, at):
    return [0, *at, n]


def _collectives(mesh) -> dict:
    inp = {k: torch.from_numpy(v) for k, v in
           collective_inputs(mesh.rank).items()}
    mean, weight = coll.allgather_merge_tdigests(inp["td_mean"],
                                                 inp["td_weight"], mesh)
    return {"psum": coll.psum(inp["x"], mesh).numpy(),
            "ring": coll.ring_allreduce(inp["x"], mesh).numpy(),
            "scatter": coll.reduce_scatter_state(inp["scatter"],
                                                 mesh).numpy(),
            "hll": coll.pmax_merge_hll(inp["hll"], mesh).numpy(),
            "td_mean": mean.numpy(), "td_weight": weight.numpy()}


def _replay(mesh) -> dict:
    batch = replay_corpus()
    cfg = ReplayConfig(n_services=batch.n_services, chunk_size=512)
    shard, n = stage_sharded(batch, mesh, cfg)
    out = {"n": n}
    for kernel, merge in REPLAY_RUNS:
        st = make_sharded_replay_fn(cfg, mesh, kernel=kernel, with_hll=True,
                                    merge=merge)(shard)
        out[f"{kernel}-{merge}"] = {"agg": st.agg.numpy(),
                                    "hist": st.hist.numpy(),
                                    "hll": st.hll.numpy()}
    return out


def _stream(mesh) -> dict:
    batch = span_stream()
    cfg = ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    t0 = int(batch.start_us.min())
    cuts = _cuts(batch.n_spans, SPAN_CUTS_AT)
    plane = ShardedStreamReplay(cfg, t0, mesh)
    windows = [plane.push(take_spans(batch, slice(lo, hi)))
               for lo, hi in zip(cuts, cuts[1:])]
    det = OnlineDetector(batch.services, cfg, t0,
                         replay=ShardedStreamReplay(cfg, t0, mesh))
    for lo, hi in zip(cuts, cuts[1:]):
        det.push(take_spans(batch, slice(lo, hi)))
    det.finish()
    # edge attribution over the mesh: the detector builds its own plane
    # on the combined id space
    _, eb, psvc, edges = edge_stream()
    ecfg = ReplayConfig(n_services=eb.n_services, chunk_size=1024)
    edet = OnlineDetector(eb.services, ecfg, int(eb.start_us.min()),
                          call_edges=edges, mesh=mesh)
    ecuts = _cuts(eb.n_spans, EDGE_CUTS_AT)
    for lo, hi in zip(ecuts, ecuts[1:]):
        sl = slice(lo, hi)
        edet.push(take_spans(eb, sl), parent_service=psvc[sl])
    edet.finish()
    return {"windows": windows, "n_spans": plane.n_spans,
            "agg": plane.state.agg.numpy(), "hist": plane.state.hist.numpy(),
            "alerts": alert_keys(det.alerts),
            "edge_alerts": alert_keys(edet.alerts, evidence=True),
            "edge_ranked": edet.ranked_services(),
            "edge_replay": type(edet.replay).__name__,
            "edge_cfg_services": edet.replay.cfg.n_services}


def _serve(mesh) -> dict:
    from anomod_torch.serve import traffic as ttraffic
    from anomod_torch.serve.engine import ServeEngine
    traffic, kw, cfg_kw, duration = serve_traffic(ttraffic)
    eng = ServeEngine(traffic.specs, traffic.services,
                      ReplayConfig(**cfg_kw), mesh=mesh, **kw)
    rep = eng.run(traffic, duration_s=duration)
    return {"alerts": {t: alert_keys(eng.alerts_for(t)) for t in (0, 1)},
            "fused": rep.to_dict().get("fused"),
            "replay": type(eng._replay_for(0)).__name__,
            "ckpt_every": eng.ckpt_every, "state": eng.serve_state}


def library_checks() -> dict:
    """Every library check of the parallel planes on this rank of a
    2-rank ``gloo`` group."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, device="cpu")
    return {"rank": mesh.rank, "world": mesh.world_size,
            "backend": mesh.backend, "devices": int(mesh.devices.size),
            "collectives": _collectives(mesh), "replay": _replay(mesh),
            "stream": _stream(mesh), "serve": _serve(mesh)}
