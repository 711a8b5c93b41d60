#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``anomod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``anomod_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the main path at the TT deployment's full width (45 services x 32
windows x 16 buckets): the bench corpus replay (13 labels x 2000 traces)
through both kernels, and the online detector over all 13 TT labels
(400 traces each, 3S = 135-row edge id space) through the dense kernel,
checked against the same detector run with the plain version on the card.

Prints progress, the card's name and power limit, one ``{"kernels": ...}``
JSON line and, last, ``{"ok": true, "device": ...}``.  Any failed phase
exits non-zero without the last line; so does a host without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 CUDA-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations per span per fold in the kernels' payload: 6+H
# accumulating adds, 9 bf16 roundings and subtractions for the hi/lo
# split, 3 for the bucket
OPS_PER_SPAN_EXTRA = 12
H = 16
# on the card at bench scale a hot segment sums ~2e4 moment terms in f32,
# in arrival order on one side and index order on the other: relative
# differences reach ~sqrt(n) * 2^-24 ~ 1e-5, hence 1e-4 here (the CPU
# tests, at small sizes, hold 1e-5)
RTOL_CARD, ATOL = 1e-4, 1e-3
# against the un-rounded numpy oracle: the bf16 hi/lo split's envelope
RTOL_ORACLE = 2e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def compare(name, got, want, rtol):
    """Exact planes (count, err, 5xx, histogram) equal, moments within
    ``rtol``; returns the max absolute error over all planes."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != "
          f"{want.shape}")
    check(np.isfinite(got).all(), f"{name}: non-finite output")
    check((got[:, :3] == want[:, :3]).all(),
          f"{name}: count/err/5xx planes differ")
    check((got[:, 6:] == want[:, 6:]).all(), f"{name}: histogram differs")
    bad = ~np.isclose(got[:, 3:6], want[:, 3:6], rtol=rtol, atol=ATOL)
    check(not bad.any(), f"{name}: {int(bad.sum())} moment entries outside "
          f"rtol={rtol}, atol={ATOL}")
    diff = np.abs(got.astype(np.float64) - want)
    rel = float((diff / np.maximum(np.abs(want), 1.0)).max()) if diff.size \
        else 0.0
    err = float(diff.max()) if diff.size else 0.0
    log(f"    {name}: max_abs_err={err:.6g} max_rel_err={rel:.3g}")
    return err


_FLUSH = []


def cuda_ms(fn, iters=20):
    """Mean device time of ``fn`` in ms, by CUDA events around each of
    ``iters`` calls after two warm-up calls.  Before each timed call a
    write of four times the L2 size evicts the inputs, so every call
    reads them from HBM, as a replay of fresh trace data would."""
    import torch
    if not _FLUSH:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                     0) or 50 << 20
        _FLUSH.append(torch.empty(4 * l2, dtype=torch.uint8, device="cuda"))
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(n_spans, n_out):
    """(bound_ms, bound_by) of one fold of ``n_spans`` real spans: each
    input byte read once (sid + 6 planes, 28 B a span), each output byte
    written once, against the f32 operations.  Padding that a kernel's
    staging adds is not part of the function, so it is not counted."""
    t_bytes = (n_spans * 28 + n_out * 4) / PEAK_BYTES_PER_S
    t_ops = n_spans * (6 + H + OPS_PER_SPAN_EXTRA) / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_busy_ms(prof):
    """Union of the device-side event intervals (kernels, copies, sets)
    in a ``torch.profiler`` trace, in ms; None when the trace holds no
    device events."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    if not spans:
        return None
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    # the port under test is the checkout this script sits in, never an
    # installed copy elsewhere
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import anomod_torch
    check(Path(anomod_torch.__file__).resolve().parent.parent == here,
          f"anomod_torch imported from {anomod_torch.__file__}, not from "
          f"the checkout at {here}")
    from anomod_torch.io.dataset import load_bench_corpus
    from anomod_torch.ops import _build
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.replay import (ReplayConfig, measure_throughput,
                                     segment_ids, stage_columns,
                                     stage_planes)
    from anomod_torch.stream import (OnlineDetector, StreamReplay,
                                     edge_combined_cfg,
                                     resolve_parent_services,
                                     stream_quality)

    class PlainFoldReplay(StreamReplay):
        """The stream plane with the dense kernel's plain version as its
        chunk fold, on the card: the reference the kernel's stream is held
        against."""

        def __init__(self, cfg, t0_us, device=None):
            super().__init__(cfg, t0_us, device=device)
            SW, H = cfg.sw, cfg.n_hist_buckets

            def step(state, chunk):
                sid, planes = stage_planes(chunk, xp=torch)
                out = rk.replay_dense_plain(sid, planes, SW, H)
                return state._replace(agg=state.agg + out[:, :6],
                                      hist=state.hist + out[:, 6:])
            self._step = step

    # the plain versions and the matmul path run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = card[0] if card else "nvidia-smi gave no answer"
    t_all = time.perf_counter()

    # -- phase 1: build -------------------------------------------------
    log(f"[1] card: {card}")
    t0 = time.perf_counter()
    _build.build(["replay"])
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1] ptxas {name}: {line.strip()}")

    # -- phase 2: dense kernel vs plain on the card ------------------------
    batch = load_bench_corpus("TT", 2000)
    cfg = ReplayConfig(n_services=batch.n_services)
    SW = cfg.sw
    chunks, n_real = stage_columns(batch, cfg)
    sid_np, planes_np = stage_planes(chunks)
    sid = torch.from_numpy(sid_np).to(dev)
    planes = torch.from_numpy(planes_np).to(dev)
    N = sid.shape[0]
    log(f"[2] TT bench corpus: {n_real} spans ({N} staged), SW={SW}")
    got = rk.replay_dense(sid, planes, SW, H)
    torch.cuda.synchronize()
    plain = rk.replay_dense_plain(sid, planes, SW, H)
    dense_err = compare("dense SW=1440", got.cpu(), plain.cpu(), RTOL_CARD)
    compare("dense SW=1440 vs oracle", got.cpu(),
            rk.replay_planes_numpy(sid_np, planes_np, SW, H), RTOL_ORACLE)
    check(float(got[:, 0].double().sum()) == n_real, "dense: span count")
    dense_ms = cuda_ms(lambda: rk.replay_dense(sid, planes, SW, H))
    dense_plain_ms = cuda_ms(
        lambda: rk.replay_dense_plain(sid, planes, SW, H), iters=5)
    payload = rk.replay_payload(planes, H)
    acc = torch.zeros((SW + 1, 6 + H), device=dev)
    idx = sid.long()
    dense_lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, payload))
    # both kernels compute the same fold of the same real spans: one bound
    fold_bound, fold_by = bound(n_real, SW * (6 + H))
    log(f"[2] dense SW=1440: max_abs_err={dense_err:.3g} "
        f"kernel {dense_ms:.4f} ms, plain {dense_plain_ms:.4f} ms, "
        f"index_add_ {dense_lib_ms:.4f} ms, bound {fold_bound:.6f} ms "
        f"({fold_by}; {n_real} real spans)")

    # the stream's 3S id space: every span twice (node id + edge slot)
    scfg = ReplayConfig(n_services=batch.n_services, chunk_size=4096)
    det = OnlineDetector(batch.services, scfg, int(batch.start_us.min()),
                         device=dev)
    doubled = det.replay_batch(batch, resolve_parent_services(batch))
    ecfg = edge_combined_cfg(scfg, batch.n_services)
    e_chunks, _ = stage_columns(doubled, ecfg)
    e_sid_np, e_planes_np = stage_planes(e_chunks)
    e_sid = torch.from_numpy(e_sid_np).to(dev)
    e_planes = torch.from_numpy(e_planes_np).to(dev)
    got = rk.replay_dense(e_sid, e_planes, ecfg.sw, H)
    err_4320 = compare(
        "dense SW=4320", got.cpu(),
        rk.replay_dense_plain(e_sid, e_planes, ecfg.sw, H).cpu(), RTOL_CARD)
    one = slice(0, ecfg.chunk_size)               # the stream's chunk shape
    chunk_ms = cuda_ms(lambda: rk.replay_dense(
        e_sid[one], e_planes[:, one].contiguous(), ecfg.sw, H))
    log(f"[2] dense SW={ecfg.sw}: max_abs_err={err_4320:.3g}; one "
        f"{ecfg.chunk_size}-span stream chunk {chunk_ms:.4f} ms")

    z32 = torch.zeros(0, dtype=torch.int32, device=dev)
    zp = torch.zeros((6, 0), dtype=torch.float32, device=dev)
    for name, out in (("dense", rk.replay_dense(z32, zp, SW, H)),
                      ("sorted", rk.replay_sorted(z32, zp, z32, SW, H))):
        check(out.shape == (SW, 6 + H) and bool((out == 0).all()),
              f"{name}: empty corpus is not all zeros")
    log("[2] empty corpus: zeros from both kernels")

    # -- phase 3: sorted kernel vs plain, inner_repeats = 2 ----------------
    block = 4096
    sid_l, planes_s, wids = rk.stage_sorted_planes(sid_np, planes_np, SW,
                                                   block=block)
    s_args = [torch.from_numpy(a).to(dev) for a in (sid_l, planes_s, wids)]
    got = rk.replay_sorted(*s_args, SW, H, block=block, inner_repeats=2)
    sorted_err = compare(
        "sorted", got.cpu(),
        rk.replay_sorted_plain(*s_args, SW, H, block=block,
                               inner_repeats=2).cpu(), RTOL_CARD)
    compare("sorted vs oracle", got.cpu(),
            rk.replay_planes_numpy(sid_np, planes_np, SW, H) * 2,
            RTOL_ORACLE)
    sorted_ms = cuda_ms(lambda: rk.replay_sorted(*s_args, SW, H,
                                                 block=block))
    sorted_plain_ms = cuda_ms(lambda: rk.replay_sorted_plain(
        *s_args, SW, H, block=block), iters=5)
    g_idx = rk.sorted_global_ids(s_args[0], s_args[2], 128, block)
    s_payload = rk.replay_payload(s_args[1], H)
    s_acc = torch.zeros(((SW + 128) // 128 * 128, 6 + H), device=dev)
    sorted_lib_ms = cuda_ms(lambda: s_acc.index_add_(0, g_idx, s_payload))
    log(f"[3] sorted: T={sid_l.shape[0]} staged, max_abs_err="
        f"{sorted_err:.3g} kernel {sorted_ms:.4f} ms, plain "
        f"{sorted_plain_ms:.4f} ms, index_add_ {sorted_lib_ms:.4f} ms, "
        f"bound {fold_bound:.6f} ms")

    # -- the main path: phases 4 and 5, launches counted -------------------
    rk.reset_launches()
    # f32 counts are exact to 2^24 spans per segment: clamp the replicate
    # to the hottest segment (as the JAX bench does)
    hottest = int(np.bincount(segment_ids(batch, cfg), minlength=SW).max())
    replicate = max(1, min(64, (1 << 24) // max(hottest, 1)))
    rates = {}
    for kernel in ("cuda", "cuda-sorted", "matmul"):
        r = measure_throughput(batch, cfg, repeats=3, replicate=replicate,
                               kernel=kernel, device=dev)
        rates[kernel] = r.spans_per_sec
        log(f"[4] replay kernel={kernel}: {r.spans_per_sec:.6g} spans/s "
            f"({r.n_spans} spans x {len(r.raw_wall_s)} runs, median wall "
            f"{r.wall_s:.6f} s, first run {r.compile_s:.3f} s) on {card}")
    replay_launches = dict(rk.launches)

    t0 = time.perf_counter()
    rows = stream_quality("TT", n_traces=400, seed=0, device=dev)
    stream_s = time.perf_counter() - t0
    launches = dict(rk.launches)
    plain_rows = stream_quality("TT", n_traces=400, seed=0, device=dev,
                                replay_factory=PlainFoldReplay)
    check(len(rows) == 13, f"stream: {len(rows)} labels, expected 13")
    hits = []
    for r, p in zip(rows, plain_rows):
        check(r["ranked"] == p["ranked"],
              f"stream {r['experiment']}: ranked lists differ")
        check(r["first_alert_window"] == p["first_alert_window"],
              f"stream {r['experiment']}: first alert windows differ")
        same = [(a.window, a.service, a.evidence) for a in r["alerts"]] == \
            [(a.window, a.service, a.evidence) for a in p["alerts"]]
        if "top1_hit" in r:
            hits.append(r["top1_hit"])
        log(f"[5] {r['experiment']}: top1={r['ranked'][:1]} target="
            f"{r['target_service'] or '-'} hit={r.get('top1_hit')} "
            f"alerts={r['n_alerts']} first_alert={r['first_alert_window']} "
            f"alerts_equal_plain={same}")
    stream_launches = launches["replay_dense"] - replay_launches["replay_dense"]
    log(f"[5] stream top-1 {sum(hits)}/{len(hits)} in {stream_s:.3f} s "
        f"(kernel run, corpus generation included); launches: replay "
        f"{replay_launches}, main path total {launches}; estimated "
        f"dense-kernel share of the stream wall: {stream_launches} x "
        f"{chunk_ms:.4f} ms / {stream_s:.3f} s = "
        f"{stream_launches * chunk_ms / 1e3 / stream_s:.3g}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    # the stream once more under the profiler: the device's busy time,
    # read from the trace, against the un-profiled wall above
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stream_quality("TT", n_traces=400, seed=0, device=dev)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    busy_share = None if busy is None else busy / 1e3 / stream_s
    log(f"[5] stream trace: device busy "
        f"{'not measured (no device events)' if busy is None else f'{busy:.3f} ms'}"
        f" in a {prof_s:.3f} s profiled wall; busy share of the un-profiled "
        f"wall {busy_share if busy_share is None else f'{busy_share:.4g}'}")

    # -- report -----------------------------------------------------------
    kernels = [
        {"name": "replay_dense", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:85",
         "launches": launches["replay_dense"],
         "max_abs_err": max(dense_err, err_4320),
         "ms": dense_ms, "plain_ms": dense_plain_ms, "bound_ms": fold_bound,
         "bound_by": fold_by, "library_ms": dense_lib_ms},
        {"name": "replay_sorted", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:257",
         "launches": launches["replay_sorted"], "max_abs_err": sorted_err,
         "ms": sorted_ms, "plain_ms": sorted_plain_ms,
         "bound_ms": fold_bound, "bound_by": fold_by,
         "library_ms": sorted_lib_ms},
    ]
    log(json.dumps({"replay_spans_per_sec": rates, "replicate": replicate,
                    "stream_top1": sum(hits) / len(hits),
                    "stream_chunk_ms": chunk_ms, "stream_wall_s": stream_s,
                    "stream_device_busy_ms": busy,
                    "stream_device_busy_share": busy_share,
                    "wall_s": time.perf_counter() - t_all}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
