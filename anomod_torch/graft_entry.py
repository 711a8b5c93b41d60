"""Entry points of the port: a one-card forward step and the multi-device
dry run (counterpart of ``__graft_entry__.py``).

``entry()`` returns the forward step of the flagship pipeline (span
replay featurization, then a detector-style score) with its example
arguments on the card.

``dryrun_multichip(n)`` runs every parallel plane once over an n-rank
group (``parallel.launch``), each step with its assertion, at the JAX dry
run's shapes: (1) the sharded replay with the dense kernel and the HLL
plane a rank, against the one-hot route; (1b) the sharded streaming plane
against the batch replay; (2) the GCN dp x tp train step on
``make_mesh2d(n)``; (3) ring and Ulysses attention against full
attention; (4) the MoE expert-parallel step; (4b) the line-graph step;
(5) the GPipe pipeline step.  On ``cuda`` (the default: ``nccl``, a card a
rank) unless ``cpu`` (``gloo``) is asked for.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from anomod_torch.device import DeviceLike, resolve_device


def _example_batch(n_traces: int = 20):
    from anomod_torch import labels, synth
    return synth.generate_spans(labels.label_for("Lv_P_CPU_preserve"),
                                n_traces=n_traces)


def entry(device: DeviceLike = None):
    """``(forward, example_args)``: ``forward(chunks) -> [S]`` scores of
    the example corpus's staged chunks (on ``device``, the card unless
    ``cpu`` is asked for)."""
    from anomod_torch.io.prefetch import device_put_columns
    from anomod_torch.replay import (F_COUNT, F_ERR, F_LOGLAT, ReplayConfig,
                                     make_replay_fn, stage_columns)

    dev = resolve_device(device)
    batch = _example_batch()
    cfg = ReplayConfig(n_services=batch.n_services, chunk_size=1024)
    chunks, _ = stage_columns(batch, cfg)
    replay = make_replay_fn(cfg, device=dev)

    def forward(chunks):
        agg = replay(chunks).agg.reshape(cfg.n_services, cfg.n_windows, -1)
        # detector-style score: windowed error rate + log-latency inflation
        count = agg[..., F_COUNT].sum(dim=1).clamp(min=1.0)
        return agg[..., F_ERR].sum(dim=1) / count * 4.0 \
            + agg[..., F_LOGLAT].sum(dim=1) / count * 0.1

    return forward, (device_put_columns(chunks, dev),)


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _finite(name: str, loss: torch.Tensor) -> float:
    value = float(loss)
    _check(math.isfinite(value), f"non-finite {name} loss {value}")
    return value


def _dryrun_rank(n: int, device_type: str) -> dict:
    """One rank's dry run inside an n-rank group; returns the summary (the
    same on every rank)."""
    from anomod_torch.parallel import (make_mesh, make_ring_attention,
                                       make_sharded_replay_fn,
                                       make_ulysses_attention, stage_sharded)
    from anomod_torch.parallel.pipeline import (PipelineConfig,
                                                make_pipe_mesh,
                                                make_pipeline_train_step)
    from anomod_torch.parallel.ring_attention import full_attention
    from anomod_torch.parallel.stream import ShardedStreamReplay
    from anomod_torch.parallel.train import (make_distributed_train_step,
                                             make_mesh2d)
    from anomod_torch.rca import _stack, build_dataset
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.schemas import take_spans

    dev = torch.device(device_type)
    # (1) the sharded replay, the dense kernel and the HLL plane a rank,
    # held to the one-hot route (the JAX xla shard body) within the JAX
    # dry run's bounds
    mesh1d = make_mesh(n, device=dev)
    batch = _example_batch(n_traces=8 * n)
    # 8 windows x 240 s cover the 1800 s experiment: the batch replay
    # clamps spans past the grid where the stream rolls, so their parity
    # below needs the corpus inside the grid
    cfg = ReplayConfig(n_services=batch.n_services, chunk_size=256,
                       n_windows=8, n_hist_buckets=8, window_us=240_000_000)
    shard, n_spans = stage_sharded(batch, mesh1d, cfg)
    _check(n_spans == batch.n_spans, f"staged {n_spans} of {batch.n_spans}")
    kern = make_sharded_replay_fn(cfg, mesh1d, kernel="cuda",
                                  with_hll=True)(shard)
    onehot = make_sharded_replay_fn(cfg, mesh1d, kernel="matmul",
                                    with_hll=True)(shard)
    agg = kern.agg.cpu().numpy()
    np.testing.assert_allclose(agg, onehot.agg.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(kern.hist.cpu().numpy(),
                               onehot.hist.cpu().numpy(), rtol=1e-6)
    # the max-merged distinct-trace registers: equal across the two
    # routes, and not empty
    _check(torch.equal(kern.hll.cpu(), onehot.hll.cpu()),
           "HLL registers differ between the routes")
    _check(int(kern.hll.max()) > 0, "the HLL plane is empty")
    # the merged span count is the staged corpus's
    _check(abs(float(agg[:, 0].sum()) - n_spans) <= 8.0,
           f"span count {agg[:, 0].sum()} != {n_spans}")

    # (1b) the streaming plane over the same mesh: two pushes, the
    # cumulative plane equal to the batch replay of the same spans
    _check(int(batch.start_us.max() - batch.start_us.min())
           < cfg.n_windows * cfg.window_us,
           "parity precondition: the corpus must fit the grid")
    sstream = ShardedStreamReplay(cfg, int(batch.start_us.min()), mesh1d)
    ordered = take_spans(batch, np.argsort(batch.start_us, kind="stable"))
    half = ordered.n_spans // 2
    sstream.push(take_spans(ordered, slice(0, half)))
    sstream.push(take_spans(ordered, slice(half, ordered.n_spans)))
    _check(sstream.n_spans == n_spans, "streamed span count")
    np.testing.assert_allclose(sstream.state.agg.cpu().numpy(), agg,
                               rtol=1e-3, atol=1e-3)

    # (2) the GCN dp x tp train step on a (data, model) mesh
    mesh2d = make_mesh2d(n, device=dev)
    data_size = mesh2d.shape["data"]
    samples, _ = build_dataset("TT", seeds=[0], n_traces=10, n_windows=4)
    # the batch must split over the dp axis: tile the 13 experiments up
    n_batch = math.ceil(len(samples) / data_size) * data_size
    stacked = _stack((samples * data_size)[:n_batch])
    _, _, step, put_batch = make_distributed_train_step("gcn", stacked,
                                                        mesh2d)
    gcn_loss = _finite("GCN", step(put_batch(stacked)))

    # (3) sequence parallelism over the 1-D mesh, both planes, each exact
    # against full attention
    rng = np.random.default_rng(0)
    L, H, D = 8 * n, n, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(L, H, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    ref = full_attention(q, k, v).cpu().numpy()
    for plane in (make_ring_attention, make_ulysses_attention):
        np.testing.assert_allclose(plane(mesh1d)(q, k, v).cpu().numpy(),
                                   ref, rtol=2e-4, atol=2e-5,
                                   err_msg=plane.__name__)

    # (4) expert parallelism: the MoE expert tensors over the model axis
    _, _, step, put_batch = make_distributed_train_step("moe", stacked,
                                                        mesh2d)
    moe_loss = _finite("MoE", step(put_batch(stacked)))

    # (4b) the line graph on the same mesh (its own batch: it needs the
    # per-edge features)
    e_samples, _ = build_dataset("TT", seeds=[0], n_traces=10, n_windows=4,
                                 edge_features=True)
    e_stacked = _stack((e_samples * data_size)[:n_batch])
    _, _, step, put_batch = make_distributed_train_step(
        "linegraph", e_stacked, mesh2d)
    lg_loss = _finite("linegraph", step(put_batch(e_stacked)))

    # (5) pipeline parallelism: the stage-split transformer, GPipe
    # microbatches
    pipe_mesh = make_pipe_mesh(n, device=dev)
    n_micro = max(2, n // 2)
    pp_batch = _stack((samples * math.ceil(2 * n_micro / len(samples)))
                      [:2 * n_micro])
    cfg_pp = PipelineConfig(n_microbatches=n_micro, layers_per_stage=1,
                            d_model=16, n_heads=2, mlp_hidden=32)
    _, _, step, put_batch = make_pipeline_train_step(pipe_mesh, cfg_pp,
                                                     pp_batch)
    pp_loss = _finite("pipeline", step(put_batch(pp_batch)))
    return {"n_devices": n, "device": device_type, "n_spans": n_spans,
            "sw": cfg.sw,
            "mesh2d": mesh2d.shape, "gcn_loss": gcn_loss,
            "attention_L": L, "moe_loss": moe_loss,
            "linegraph_loss": lg_loss, "pipeline_loss": pp_loss,
            "n_microbatches": n_micro}


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Every parallel plane once over ``n_devices`` ranks (module
    docstring).  Called outside a process group it launches the ranks
    (``parallel.launch``; one card a rank on ``cuda``, and a group past
    the attached cards is refused); called by every rank of an
    ``n_devices`` group it runs in that group.  Returns the summary
    (losses, span count, meshes) and prints it once."""
    from anomod_torch.parallel import launch
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a group "
                             f"of {dist.get_world_size()} ranks")
        out = _dryrun_rank(n_devices, dev.type)
        lead = dist.get_rank() == 0
    else:
        out = launch(_dryrun_rank, n_devices, dev,
                     args=(n_devices, dev.type))[0]
        lead = True
    if lead:
        print(f"dryrun_multichip({n_devices}) on {dev.type}: "
              f"{out['n_spans']} spans replayed on a 1-D mesh (the dense "
              f"kernel and the HLL plane a rank == the one-hot route; "
              f"sharded streaming pushes == the batch replay); GCN step on "
              f"{out['mesh2d']} loss={out['gcn_loss']:.4f}; ring + ulysses "
              f"attention L={out['attention_L']} == full attention; MoE ep "
              f"step loss={out['moe_loss']:.4f}; linegraph step "
              f"loss={out['linegraph_loss']:.4f}; pipeline step "
              f"({n_devices} stages, {out['n_microbatches']} microbatches) "
              f"loss={out['pipeline_loss']:.4f} - OK", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m anomod_torch.graft_entry",
                                 description="the one-card forward step, "
                                             "then the multi-device dry run")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print("entry:", tuple(fn(*example).shape))
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
