"""The sorted replay kernel's roofline probe (counterpart of
``scripts/bench_kernel_roofline.py``).

On the TT bench corpus (13 labels x ``n_traces`` traces), staged the sorted
way (``stage_columns`` -> ``stage_planes`` -> ``stage_sorted_planes`` at
``k``, ``block``), it times three versions of the sorted kernel, each
folding the staged corpus ``replicate`` times in one launch:

- ``full``: the replay kernel itself (``replay_sorted``);
- ``onehot_only``: the ``counts`` ablation, one payload row a span;
- ``no_hist``: the ``no_hist`` ablation, the exact planes and the moments'
  hi and lo rows without the histogram.

All three share the grid, block, staging and shared-memory atomics, so
their rates split the full kernel's time between what every payload pays
(reading the staging, the same-address atomic on the count row) and the
payload's own work.  ``full / onehot_only`` is the probe's ceiling ratio.

On the card the ablations do not isolate what they isolated on the TPU:
there they cut the rows of one one-hot matrix product, here each cuts the
shared-memory atomics a span issues (up to 7 for ``full``, 1 for
``counts``, up to 9 for ``no_hist``, whose hi and lo rows stay separate as
in the TPU ablation's output).  The TPU probe's fourth version,
``full_bf16oh`` (the bf16 iota one-hot), has no counterpart: the port has
no one-hot.  ``best`` is therefore ``full``.

At ``replicate = 4096`` every pass after the first reads the 13.7 MB of
staged inputs from L2, so the rates are the kernels' atomic and compute
ceilings, not their HBM-facing times.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from anomod_torch.device import DeviceLike, device_name, resolve_device
from anomod_torch.ops.replay_kernels import (replay_sorted,
                                             replay_sorted_ablation,
                                             stage_sorted_planes)

#: ablation name in the verdict -> ``rows_mode`` of replay_sorted_ablation
ABLATIONS = {"onehot_only": "counts", "no_hist": "no_hist"}
N_HIST = 16


def _timed(run, n_real: int, replicate: int):
    """One warm call, then three timed ones: the median wall of launch,
    synchronize and copy to the host.  Returns (rate, wall, output)."""
    out = run().cpu()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run().cpu()
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[1]
    return n_real * replicate / wall, wall, out


def _check_count(name: str, counts: torch.Tensor, want: int) -> None:
    # f32 per-segment counts are exact only below 2^24 spans a segment,
    # hence the small relative slack
    got = float(counts.double().sum())
    if abs(got - want) > max(8.0, 1e-6 * want):
        raise RuntimeError(f"{name}: span count {got} != {want}")


def kernel_roofline(n_traces: int = 2000, replicate: int = 4096,
                    k: int = 128, block: int = 4096,
                    device: DeviceLike = None,
                    outdir: Optional[str] = None) -> dict:
    """Time ``full``, ``onehot_only`` and ``no_hist`` on the TT bench
    corpus and write one ``replay_kernel_roofline`` capture (the record's
    ``device`` names the card).  Returns the verdict: ``metric``,
    ``value`` (the best rate, spans/s), ``unit``, ``rates``,
    ``onehot_ceiling_ratio``, ``within_2x_of_formulation_ceiling``,
    ``params`` and ``capture_file``.  The rate of a version is ``n_real x
    replicate / wall``."""
    from anomod_torch.io.dataset import load_bench_corpus
    from anomod_torch.provenance import capture_record, write_capture
    from anomod_torch.replay import ReplayConfig, stage_columns, stage_planes
    if replicate < 1:
        raise ValueError("replicate must be >= 1")
    dev = resolve_device(device)
    dev_name = device_name(dev)
    batch = load_bench_corpus("TT", n_traces)
    cfg = ReplayConfig(n_services=batch.n_services)
    chunks, n = stage_columns(batch, cfg)
    sid_np, planes_np = stage_planes(chunks)
    staged = [torch.from_numpy(a).to(dev) for a in stage_sorted_planes(
        sid_np, planes_np, cfg.sw, k=k, block=block)]
    SW = cfg.sw

    results, walls = {}, {}
    results["full"], walls["full"], out = _timed(
        lambda: replay_sorted(*staged, SW, N_HIST, k=k, block=block,
                              inner_repeats=replicate), n, replicate)
    _check_count("full", out[:, 0], n * replicate)
    for name, mode in ABLATIONS.items():
        results[name], walls[name], out = _timed(
            lambda: replay_sorted_ablation(*staged, SW, mode, k=k,
                                           block=block,
                                           inner_repeats=replicate),
            n, replicate)
        _check_count(name, out[0], n * replicate)

    ceiling = results["onehot_only"]
    best = results["full"]
    verdict = {
        "metric": "replay_kernel_roofline",
        "value": round(best, 1),
        "unit": "spans/sec/chip",
        "rates": {m: round(v, 1) for m, v in results.items()},
        "onehot_ceiling_ratio": round(ceiling / max(best, 1.0), 3),
        "within_2x_of_formulation_ceiling": bool(ceiling / best <= 2.0),
        "params": dict(k=k, block=block, replicate=replicate, n_spans=n,
                       walls_s={m: round(w, 6) for m, w in walls.items()},
                       device=dev_name),
    }
    rec = capture_record(verdict["metric"], verdict["value"], verdict["unit"],
                         device=dev_name,
                         **{kk: vv for kk, vv in verdict.items()
                            if kk not in ("metric", "value", "unit")})
    path = write_capture(rec, outdir=outdir)
    verdict["capture_file"] = None if path is None else str(path)
    return verdict
