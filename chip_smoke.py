#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``anomod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``anomod_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives three paths:

- replay (phases 2-5), at the TT deployment's full width (45 services x
  32 windows x 16 buckets): the bench corpus replay (13 labels x 2000
  traces) through both replay kernels, the dense kernel at both of its
  path shapes (the corpus pass and one 4096-span stream chunk at SW =
  4320) and at its ends (every span in one segment, every span dead, two
  shared-memory tiles), with the fold / reduce split of each call read
  from a profiler trace (phase 3 also holds the sorted kernel and its
  ablations at both ends of run length: every staged block one segment,
  and run length 1), and the online detector over all 13 TT labels (400
  traces each, 3S = 135-row edge id space) through the dense kernel,
  checked against the same detector run with the plain version on the
  card, its trace giving the dense kernel's device time a chunk;
- serve (phases 6-8), at the serve bench's deployment (200 tenants, 12
  services x 32 windows of 5 s, 25,000 spans/s capacity at 2x overload,
  60 virtual seconds in 0.5 s ticks, seed 7): the lane-delta kernel
  bit for bit against the host's plain version at every bucket width,
  L = 1, 7, 32 and on adversarial lanes (one hot segment, two
  alternating, all dead), the window-gather kernel against its plain
  version, then the serve
  tick (admission, fused lane dispatch, device state pool, batched
  scoring), checked against the decision pins of the JAX package's
  captures (p99 22.998135 s, shed 0.437567, 158 alerts), against the
  same coalesced batches pushed through one-lane dispatches and against
  its depth-1, host-state and CPU twins, byte for byte; the unfused run
  is held to its CPU twin byte for byte and to the fused run's admission
  and SLO fields; a profiled run gives each serve kernel's device time;
- sketches (phases 9-11), on the replay's bench corpus at its full width
  (45 services x 32 windows, K = 64 centroids, HLL p = 8 per edge and
  p = 10 for the single sketch): the t-digest reduction and HLL update
  kernels against their plain versions and a numpy HLL oracle at the
  service- and edge-plane shapes (the t-digest also on edge-plane rows
  shuffled out of bucket order), then ``replay_percentiles`` and
  ``replay_edge_features`` with the launches counted, held against the
  same path run with the plain versions on the card, and the CLI's
  ``replay --percentiles --edge-percentiles``;
- the sorted replay kernel's roofline probe (phase 12), on the replay's
  bench corpus staged the sorted way (k = 128, block = 4096): the
  ``counts`` and ``no_hist`` ablation kernels against their plain
  versions and the full sorted kernel, then ``kernel_roofline()`` at its
  full size (replicate = 4096) with the launches counted, its capture
  written to a temporary directory and read back.

Phase 1 also prints how each kernel's shared atomics compiled (from
``cuobjdump -sass``), and phase 2 what the L2 eviction before each timed
call costs inside the timed window.  Prints progress, the card's name
and power limit, one ``{"kernels": ...}`` JSON line and, last, ``{"ok":
true, "device": ...}``.  Every time in the kernels line (``ms``,
``library_ms``) is taken with the card spinning before each call, so the
host's launch work opens no gap in the timed window; the reading without
the spin stands beside it (``ms_unspun``, ``library_ms_unspun``; see
``cuda_ms``).  Any failed phase exits non-zero without the last line; so
does a host without CUDA.
"""

from __future__ import annotations

import contextlib
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
# int32 ALU rate: Hopper has half as many INT32 as FP32 lanes per SM
# (NVIDIA's Hopper white paper), so half the f32 CUDA-core rate
PEAK_INT32_OPS_PER_S = PEAK_F32_OPS_PER_S / 2
# t-digest means: each centroid sums ~L/K = 46 f32 terms, in the kernel's
# fixed scan-and-tail order and in no fixed order in the card's
# index_add_, so relative differences stay near 46 * 2^-24 ~ 3e-6
RTOL_DIGEST = 1e-5
# percentiles (µs) of the path with the kernels against the path with the
# plain versions: the means' 1e-5 passes through the CDF interpolation
# and expm1 of log1p-µs values near 10
RTOL_PCT, ATOL_PCT = 1e-4, 1e-2
K_DIGEST = 64
# HLL ops a item: two fmix32 rounds (8 each), the bucket, the clz and
# rank, the lane test, the address and the max
HLL_OPS_PER_ITEM = 26


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
#: clock cycles the card spins before each timed call (about 1 ms at the
#: H100's 1.98 GHz boost clock)
SPIN_CYCLES = 2_000_000
#: the dense replay kernels of every design the kernels line has read,
#: as the profiler names them (a name absent from a trace reads 0)
DENSE_KERNELS = ("dense_fold", "reduce_parts", "dense_slice_fold",
                 "dense_cluster_fold", "dense_reduce")


def _evict(flush):
    """Evict L2 before a timed call: ``write`` zeroes four times the L2
    size (its dirty lines are written back while the next call runs),
    ``read`` sums it (the lines it leaves are clean)."""
    import torch
    if not _FLUSH:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                     0) or 50 << 20
        _FLUSH.append(torch.empty(4 * l2, dtype=torch.uint8, device="cuda"))
    if flush == "write":
        _FLUSH[0].zero_()
    else:
        _FLUSH[0].sum()


def cuda_ms(fn, iters=20, spin=True, flush="write"):
    """Mean device time of ``fn`` in ms, by CUDA events around each of
    ``iters`` calls after two warm-up calls.  Before each timed call L2 is
    evicted (``_evict``: by default a write of four times its size), so
    every call reads its inputs from HBM, as a replay of fresh trace data
    would.  With ``spin`` (the kernels line's reading) the card then
    spins about 1 ms (``torch.cuda._sleep``) while the host queues the
    start event and ``fn``'s launches, so the host's launch work (tens of
    microseconds in a wrapper) opens no idle gap inside the timed window;
    without it (``*_unspun``) such gaps count."""
    import torch
    _evict(flush)
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        _evict(flush)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def timed(kernel, library) -> dict:
    """The kernels line's times of ``kernel`` and its library call: spun
    (``ms``, ``library_ms``) and unspun beside them."""
    return {"ms": cuda_ms(kernel), "library_ms": cuda_ms(library),
            "ms_unspun": cuda_ms(kernel, spin=False),
            "library_ms_unspun": cuda_ms(library, spin=False)}


_PROFILER_READY = []


def traced_ms(fn, names, iters=20):
    """Per kernel name: the mean device time (ms) and launches a call of
    ``fn`` gives in a ``torch.profiler`` trace of ``iters`` spun calls,
    each after the L2 write: the split of a wrapper's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not _PROFILER_READY:
        # the profiler's first start in a process sets its tracing up for
        # seconds: pay that on a throw-away trace
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        _PROFILER_READY.append(True)
    for _ in range(2):
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            _evict("write")
            torch.cuda._sleep(SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
    return {n: [t / iters, c / iters]
            for n, (t, c) in kernel_device_ms(prof, names).items() if c}


def sass_atomics(lib_path):
    """Per kernel of a built library: its shared and global atomic
    opcodes (``cuobjdump -sass``), counted; None without cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([exe, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except OSError:
        return None
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)",
                      line)
        if fn and m:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return out


def bound(n_spans, n_out, n_dead=0):
    """(bound_ms, bound_by) of one fold of ``n_spans`` real spans: each
    input byte read once (sid + 6 planes, 28 B a span), each output byte
    written once, against the f32 operations.  Padding that a kernel's
    staging adds is not part of the function, so it is not counted.
    ``n_dead`` dead rows that are part of the function's input (a lane's
    dead tail) cost their 4 B sid alone: it is what tells them dead."""
    t_bytes = (n_spans * 28 + n_dead * 4 + n_out * 4) / PEAK_BYTES_PER_S
    t_ops = n_spans * (6 + H + OPS_PER_SPAN_EXTRA) / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_device_ms(prof, names):
    """Per name: the summed device time (ms) and the count of the
    ``torch.profiler`` trace's kernels whose name holds it."""
    from torch.autograd import DeviceType
    out = {n: [0.0, 0] for n in names}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                out[n][0] += (e.time_range.end - e.time_range.start) / 1e3
                out[n][1] += 1
    return out


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


#: the serve bench's deployment (bench.py --mode serve)
SERVE_KW = dict(n_tenants=200, n_services=12, capacity_spans_per_s=25_000.0,
                overload=2.0, duration_s=60.0, tick_s=0.5, seed=7,
                window_s=5.0, baseline_windows=4, fault_tenants=2,
                max_backlog=200_000)
#: decision pins of every committed JAX serve capture at the bench seed
SERVE_PINS = {"p99_latency_s": 22.998135, "shed_fraction": 0.437567,
              "n_alerts": 158}
#: report fields set by admission and the tick clock alone
ADMISSION_FIELDS = ("offered_spans", "admitted_spans", "served_spans",
                    "shed_spans", "shed_fraction", "served_batches",
                    "peak_backlog_spans", "latency", "per_priority")


def serve_fingerprint(eng):
    """Per tenant: its alert stream and its replay state's bytes."""
    import dataclasses

    import numpy as np
    out = {}
    for tid in sorted(eng._tenant_replay):
        st = eng._tenant_replay[tid].state
        out[tid] = ([dataclasses.asdict(a) for a in eng.alerts_for(tid)],
                    np.asarray(st.agg).tobytes(),
                    np.asarray(st.hist).tobytes())
    return out


def serve_phases(dev, card) -> dict:
    """Phases 6-8: the serve kernels against their plain versions, then
    the serve path at the bench deployment with its launches counted.
    Returns the summary fields and the two kernels' report entries."""
    import dataclasses

    import numpy as np
    import torch
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.replay import stage_columns_fused
    from anomod_torch.schemas import concat_span_batches
    from anomod_torch.serve.engine import (VARIANT_REPORT_FIELDS,
                                           ServeEngine, power_law_traffic,
                                           replay_served_sequentially,
                                           run_power_law, serve_plane_cfg)
    from anomod_torch.serve.traffic import PowerLawTraffic

    cfg = serve_plane_cfg(SERVE_KW["n_services"])
    SW = cfg.sw
    # -- phase 6: lane_delta vs plain -------------------------------------
    # serve traffic spread over all 32 windows: a 0.1 s slice of arrivals
    # at the start of every window, staged as the serve plane stages them
    traffic = PowerLawTraffic(
        n_tenants=SERVE_KW["n_tenants"],
        total_rate_spans_per_s=SERVE_KW["capacity_spans_per_s"]
        * SERVE_KW["overload"], seed=SERVE_KW["seed"],
        n_services=SERVE_KW["n_services"])
    win_s = SERVE_KW["window_s"]
    spans = concat_span_batches([
        b for w in range(cfg.n_windows)
        for _, b in traffic.arrivals(w * win_s, w * win_s + 0.1)])
    _, cols = stage_columns_fused(spans, cfg, 0)
    n = spans.n_spans
    keys = ("valid", "err", "s5", "dur_raw", "dur")

    def lanes(L, W):
        """[L, W] lanes of staged rows with ragged dead tails; the last
        lane of a multi-lane stack is all dead."""
        sid = np.full((L, W), SW, np.int32)
        planes = np.zeros((L, 6, W), np.float32)
        for i in range(L - 1 if L > 1 else L):
            m = W - (i % 4) * (W // 8)
            lo = (i * W) % (n - W)
            sid[i, :m] = cols["sid"][lo:lo + m]
            for p, k in enumerate(keys):
                planes[i, p, :m] = cols[k][lo:lo + m]
            planes[i, 5, :m] = planes[i, 4, :m] * planes[i, 4, :m]
        return (torch.from_numpy(sid).to(dev),
                torch.from_numpy(planes).to(dev))

    log(f"[6] serve traffic: {n} spans over {cfg.n_windows} windows, "
        f"SW={SW}, H={H}")

    def held(what, s, p):
        """lane_delta on (s, p): two runs equal, equal to the host's
        row-ordered plain version bit for bit, each lane equal to its
        one-lane dispatch, and within tolerance of the card's plain
        version.  Returns the max absolute error against the latter."""
        L = s.shape[0]
        got = sk.lane_delta(s, p, SW, H)
        again = sk.lane_delta(s, p, SW, H)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"lane_delta {what}: two runs differ")
        check(torch.equal(got.cpu(), sk.lane_delta_plain(
            s.cpu(), p.cpu(), SW, H)),
            f"lane_delta {what}: not bit-identical to the row-ordered "
            "plain version on the host")
        if L > 1:
            for i in range(L):
                one = sk.lane_delta(s[i:i + 1].contiguous(),
                                    p[i:i + 1].contiguous(), SW, H)
                check(torch.equal(one[0], got[i]),
                      f"lane_delta {what}: lane {i} of {L} differs from its "
                      "one-lane dispatch")
        return got, compare(
            f"lane_delta {what}", got.reshape(-1, 6 + H).cpu(),
            sk.lane_delta_plain(s, p, SW, H).reshape(-1, 6 + H).cpu(),
            RTOL_CARD)

    lane_err = 0.0
    for W in (64, 256, 1024, 4096, 16384):
        for L in (1, 7, 32):
            s, p = lanes(L, W)
            got, err = held(f"W={W} L={L}", s, p)
            lane_err = max(lane_err, err)
            if L > 1:
                check(bool((got[L - 1] == 0).all()),
                      f"lane_delta W={W}: dead lane not zero")
    log("[6] lane_delta: deterministic, L-invariant, equal to the host's "
        "row-ordered plain version at every width and L = 1, 7, 32")

    def adversarial(kind, L, W):
        """Serve lanes with their live rows all in one segment (``hot``),
        alternating between two (``alternating``) or none (``dead``)."""
        s, p = lanes(L, W)
        live = s < SW
        if kind == "hot":
            s[live] = SW // 3
        elif kind == "alternating":
            alt = torch.where(torch.arange(W, device=dev) % 2 == 0, 5,
                              SW - 2).to(torch.int32)
            s = torch.where(live, alt[None], s)
        else:
            s[:] = SW
            p[:] = 0.0
        return s.contiguous(), p

    for kind in ("hot", "alternating", "dead"):
        for W in (4096, 16384):
            for L in (1, 7, 32):
                s, p = adversarial(kind, L, W)
                got, err = held(f"{kind} W={W} L={L}", s, p)
                lane_err = max(lane_err, err)
                if kind == "dead":
                    check(not bool(got.any()), f"lane_delta {kind} W={W} "
                          f"L={L}: not all zero")
    # [kernel, index_add_] ms on hot lanes and a spread one
    adv_ms = {}
    for kind, L, W in (("hot", 1, 16384), ("spread", 1, 16384),
                       ("hot", 32, 4096)):
        s, p = adversarial(kind, L, W) if kind != "spread" else lanes(L, W)
        pay = sk.lane_payload(p, H).reshape(L * W, -1)
        idx = (torch.arange(L, device=dev)[:, None] * (SW + 1)
               + s.long()).reshape(-1)
        acc = torch.zeros((L * (SW + 1), pay.shape[1]), device=dev)
        adv_ms[f"{kind} W={W} L={L}"] = [
            cuda_ms(lambda: sk.lane_delta(s, p, SW, H)),
            cuda_ms(lambda: acc.index_add_(0, idx, pay))]
    log(f"[6] lane_delta adversarial lanes (hot, alternating, dead at "
        f"W = 4096, 16384 and L = 1, 7, 32): bit-identical to the host's "
        f"plain version, across runs and per lane; [kernel, index_add_] ms "
        f"{adv_ms} on {card}")
    s, p = lanes(32, 4096)
    lane_plain_ms = cuda_ms(lambda: sk.lane_delta_plain(s, p, SW, H),
                            iters=5)
    pay = sk.lane_payload(p, H).reshape(32 * 4096, -1)
    idx = (torch.arange(32, device=dev)[:, None] * (SW + 1)
           + s.long()).reshape(-1)
    acc = torch.zeros((32 * (SW + 1), pay.shape[1]), device=dev)
    lane_t = timed(lambda: sk.lane_delta(s, p, SW, H),
                   lambda: acc.index_add_(0, idx, pay))
    live = int((s < SW).sum())
    lane_bound, lane_by = bound(live, 32 * SW * (6 + H),
                                n_dead=s.numel() - live)
    log(f"[6] lane_delta W=4096 L=32: kernel {lane_t['ms']:.4f} ms, plain "
        f"{lane_plain_ms:.4f} ms, index_add_ {lane_t['library_ms']:.4f} ms, "
        f"bound {lane_bound:.6f} ms ({lane_by}; {live} live rows of "
        f"{s.numel()}) on {card}; unspun: {lane_t['ms_unspun']:.4f}, "
        f"{lane_t['library_ms_unspun']:.4f}")

    # -- phase 7: window_gather vs advanced indexing ----------------------
    P, S, Wn = SERVE_KW["n_tenants"], cfg.n_services, cfg.n_windows
    rng = np.random.default_rng(7)
    pool = torch.from_numpy(rng.normal(size=(P + 1, SW, 6)).astype(
        np.float32) * 1e3).to(dev)
    for T in (1, 64, 256):
        slots = torch.from_numpy(rng.integers(1, P + 1, T).astype(
            np.int32)).to(dev)
        wcols = torch.from_numpy(rng.integers(0, Wn, T).astype(
            np.int32)).to(dev)
        got = sk.window_gather(pool, slots, wcols, S, Wn)
        torch.cuda.synchronize()
        check(torch.equal(got, sk.window_gather_plain(pool, slots, wcols,
                                                      S, Wn)),
              f"window_gather T={T}: differs from advanced indexing")
    log("[7] window_gather: bit-identical at T = 1, 64, 256")
    gather_plain_ms = cuda_ms(lambda: sk.window_gather_plain(
        pool, slots, wcols, S, Wn))
    rows = pool.view(P + 1, S, Wn, 6)
    si, sv, ci = (slots.long()[:, None], torch.arange(S, device=dev)[None],
                  wcols.long()[:, None])
    gather_t = timed(lambda: sk.window_gather(pool, slots, wcols, S, Wn),
                     lambda: rows[si, sv, ci])
    # a pure copy: T*S*F f32 read and written, plus the two index arrays
    gather_bound = (2 * 256 * S * 6 * 4 + 256 * 8) / PEAK_BYTES_PER_S * 1e3
    log(f"[7] window_gather T=256: kernel {gather_t['ms']:.4f} ms, plain "
        f"{gather_plain_ms:.4f} ms, indexing {gather_t['library_ms']:.4f} "
        f"ms, bound {gather_bound:.6f} ms (bytes) on {card}; unspun: "
        f"{gather_t['ms_unspun']:.4f}, {gather_t['library_ms_unspun']:.4f}")

    # -- phase 8: the serve path at the bench deployment ------------------
    sk.reset_launches()
    rk.reset_launches()
    t0 = time.perf_counter()
    eng, rep = run_power_law(device=dev, **SERVE_KW)
    run_s = time.perf_counter() - t0
    launches = dict(sk.launches)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the serve path")
    got = {"p99_latency_s": rep.latency["p99_latency_s"],
           "shed_fraction": rep.shed_fraction, "n_alerts": rep.n_alerts}
    check(got == SERVE_PINS, f"serve pins: {got} != {SERVE_PINS}")
    spans_per_s = rep.served_spans / rep.serve_wall_s
    log(f"[8] serve: p99 {got['p99_latency_s']} s, shed "
        f"{got['shed_fraction']}, alerts {got['n_alerts']} (pins held); "
        f"{rep.served_spans} spans served in {rep.serve_wall_s:.4f} s of "
        f"serve wall = {spans_per_s:.6g} spans/s on {card}; "
        f"{sum(rep.dispatches_by_width.values())} staged chunks by width "
        f"{rep.dispatches_by_width}; {rep.fused_dispatches} fused "
        f"dispatches, lanes {rep.lanes_by_bucket}; stage "
        f"{rep.stage_wall_s} s, dispatch "
        f"{rep.dispatch_wall_s} s, fold {rep.fold_wall_s} s, score "
        f"{rep.score_wall_s} s; launches {launches}; whole call "
        f"{run_s:.3f} s")

    def decisions(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS and k != "device"}
    want = serve_fingerprint(eng)

    # fused == sequential: the same run tick by tick, its served batches
    # logged, then pushed per tenant (coalesced per tick, as the fused
    # tick coalesces them) through one-lane dispatches of the kernel
    t0 = time.perf_counter()
    traffic = power_law_traffic(
        SERVE_KW["n_tenants"], SERVE_KW["n_services"],
        SERVE_KW["capacity_spans_per_s"], SERVE_KW["overload"],
        SERVE_KW["duration_s"], SERVE_KW["seed"], 1.2,
        SERVE_KW["window_s"], SERVE_KW["baseline_windows"],
        SERVE_KW["fault_tenants"])
    e_log = ServeEngine(traffic.specs, traffic.services, cfg,
                        capacity_spans_per_s=SERVE_KW["capacity_spans_per_s"],
                        tick_s=SERVE_KW["tick_s"],
                        max_backlog=SERVE_KW["max_backlog"],
                        baseline_windows=SERVE_KW["baseline_windows"],
                        device=dev)
    served_log = []
    for _ in range(int(round(SERVE_KW["duration_s"] / SERVE_KW["tick_s"]))):
        lo = e_log.clock.now_s
        served_log.append(e_log.tick(traffic.arrivals(
            lo, lo + e_log.clock.tick_s)))
    for det in e_log._tenant_det.values():
        det.finish()
    check(serve_fingerprint(e_log) == want,
          "serve tick by tick: states or alert streams differ")
    seq = replay_served_sequentially(e_log, served_log)
    check(sorted(seq) == sorted(eng._tenant_det), "sequential: tenants")
    for tid, det in seq.items():
        st = det.replay.state
        check(([dataclasses.asdict(a) for a in det.alerts],
               np.asarray(st.agg).tobytes(),
               np.asarray(st.hist).tobytes()) == want[tid],
              f"sequential: tenant {tid} differs from the fused engine")
    log(f"[8] fused == sequential one-lane dispatch of the same coalesced "
        f"batches: byte-identical states and alerts for {len(seq)} tenants "
        f"({time.perf_counter() - t0:.3f} s)")

    twins = {}
    unfused = None
    for name, variant in (("pipeline=1", dict(pipeline=1)),
                          ("host state", dict(state="host")),
                          ("cpu plain", dict(device="cpu")),
                          ("unfused", dict(fuse=False)),
                          ("unfused cpu plain", dict(fuse=False,
                                                     device="cpu"))):
        t0 = time.perf_counter()
        e2, r2 = run_power_law(**dict(dict(SERVE_KW, device=dev),
                                      **variant))
        # unfused runs push each batch alone, where the fused tick
        # coalesces a tenant's batches of one tick: staging plans and f32
        # sums regroup, as in the JAX package, so unfused is held to the
        # fused run's admission and SLO fields and to its own CPU twin
        fields = ADMISSION_FIELDS if name.startswith("unfused") \
            else decisions(rep)
        diff = [k for k in fields
                if getattr(r2, k) != getattr(rep, k)]
        check(not diff, f"serve {name}: report fields {diff} differ")
        fp = serve_fingerprint(e2)
        if name == "unfused":
            unfused = fp
            same = sum(fp[t] == want[t] for t in want)
            what = (f"{same} of {len(want)} tenants byte-identical to the "
                    "fused run (coalescing regroups the rest)")
        else:
            ref = unfused if name.startswith("unfused") else want
            check(fp == ref, f"serve {name}: states or alert streams differ")
            what = ("byte-identical states and alerts to the "
                    + ("unfused" if ref is unfused else "fused")
                    + " card run")
        twins[name] = r2.serve_wall_s
        log(f"[8] serve {name}: {what}, equal "
            f"{'admission and SLO fields' if fields is ADMISSION_FIELDS else 'decisions'}"
            f"; serve wall {r2.serve_wall_s:.4f} s "
            f"(call {time.perf_counter() - t0:.3f} s)")

    from torch.profiler import ProfilerActivity, profile
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, rep_prof = run_power_law(device=dev, **SERVE_KW)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    per_kernel = kernel_device_ms(prof, ("lane_delta_kernel",
                                         "window_gather_kernel"))
    log(f"[8] serve trace by kernel (device ms, kernels in the trace): "
        f"{per_kernel}; wrapper launches in the profiled run "
        f"{dict(sk.launches)}; fused dispatches by lane bucket "
        f"{rep_prof.lanes_by_bucket}")
    # the share is of the profiled run's own serve wall: walls of separate
    # runs differ by tens of percent on a shared host
    busy_share = (None if busy is None
                  else busy / 1e3 / rep_prof.serve_wall_s)
    log(f"[8] serve trace: device busy "
        f"{'not measured (no device events)' if busy is None else f'{busy:.3f} ms'}"
        f" in a {rep_prof.serve_wall_s:.4f} s profiled serve wall (the "
        f"un-profiled run's {rep.serve_wall_s:.4f} s); busy share "
        f"{busy_share if busy_share is None else f'{busy_share:.4g}'}")

    kernels = [
        {"name": "lane_delta", "route": "cuda",
         "source": "anomod_torch/csrc/serve.cu",
         "replaces": "anomod/ops/pallas_replay.py:150", "redesigned": "PR 5",
         "launches": launches["lane_delta"], "max_abs_err": lane_err,
         "plain_ms": lane_plain_ms, "bound_ms": lane_bound,
         "bound_by": lane_by, **lane_t},
        {"name": "window_gather", "route": "cuda",
         "source": "anomod_torch/csrc/serve.cu",
         "replaces": "anomod/ops/pallas_replay.py:354",
         "launches": launches["window_gather"], "max_abs_err": 0.0,
         "plain_ms": gather_plain_ms, "bound_ms": gather_bound,
         "bound_by": "bytes", **gather_t},
    ]
    return {"kernels": kernels, "serve_spans_per_sec": spans_per_s,
            "serve_wall_s": rep.serve_wall_s,
            "serve_twin_walls_s": twins,
            "serve_fused_dispatches": rep.fused_dispatches,
            "serve_chunks_by_width": rep.dispatches_by_width,
            "serve_split_s": {"stage": rep.stage_wall_s,
                              "dispatch": rep.dispatch_wall_s,
                              "fold": rep.fold_wall_s,
                              "score": rep.score_wall_s},
            "serve_pins": got, "serve_device_busy_ms": busy,
            "serve_kernel_device_ms": per_kernel,
            "serve_lanes_by_bucket": rep_prof.lanes_by_bucket,
            "lane_delta_adversarial_ms": adv_ms,
            "serve_profiled_wall_s": rep_prof.serve_wall_s,
            "serve_device_busy_share": busy_share}


def sorted_ends(dev, card, SW, block) -> dict:
    """Phase 3's two ends of the run-length distribution in sorted
    staging: every staged block one segment, and every span of a warp
    step a different segment of its window (run length 1).  The full
    kernel and both ablations against their plain versions; returns their
    times."""
    import numpy as np
    import torch
    from anomod_torch.ops import replay_kernels as rk

    end_ms = {}
    rng = np.random.default_rng(3)
    e_wids = np.repeat(np.array([0, 2, 5, 10], np.int32), 3)
    T = e_wids.size * block
    live = rng.random(T) < 0.95                   # padding rows: all zero
    dur_us = rng.lognormal(8.0, 1.0, T).astype(np.float32)
    e_planes = np.stack([np.ones(T), rng.random(T) < 0.2,
                         rng.random(T) < 0.1, dur_us, np.log1p(dur_us),
                         np.log1p(dur_us) ** 2]).astype(np.float32) * live
    n_live = int(live.sum())
    for what, e_sid in (
            ("one segment a block",
             np.repeat(rng.integers(0, 128, e_wids.size), block)),
            ("run length 1", np.arange(T) % 128)):
        e_args = [torch.from_numpy(a).to(dev) for a in (
            e_sid.astype(np.int32), e_planes, e_wids)]
        for reps in (1, 2):
            full = rk.replay_sorted(*e_args, SW, H, block=block,
                                    inner_repeats=reps)
            compare(f"sorted {what} x{reps}", full.cpu(),
                    rk.replay_sorted_plain(*e_args, SW, H, block=block,
                                           inner_repeats=reps).cpu(),
                    RTOL_CARD)
            full = full.cpu().numpy()
            check(float(full[:, 0].astype(np.float64).sum()) == n_live * reps,
                  f"sorted {what}: count column != live spans x {reps}")
            for mode, rows in rk.ABLATION_ROWS.items():
                got = rk.replay_sorted_ablation(
                    *e_args, SW, mode, block=block,
                    inner_repeats=reps).cpu().numpy()
                want = rk.replay_sorted_ablation_plain(
                    *e_args, SW, mode, block=block,
                    inner_repeats=reps).cpu().numpy()
                check((got[:3] == want[:3]).all() and np.isclose(
                    got[3:], want[3:], rtol=RTOL_CARD, atol=ATOL).all(),
                    f"{mode} {what} x{reps}: differs from the plain version")
                check(float(got[0].astype(np.float64).sum()) == n_live * reps,
                      f"{mode} {what}: count row != live spans x {reps}")
                if mode == "no_hist":
                    check(np.isclose(got[3:6, :SW].T + got[6:9, :SW].T,
                                     full[:, 3:6], rtol=RTOL_CARD,
                                     atol=ATOL).all(),
                          f"no_hist {what}: hi + lo != the sorted moments")
        end_ms[what] = {
            "full": cuda_ms(lambda: rk.replay_sorted(*e_args, SW, H,
                                                     block=block)),
            **{mode: cuda_ms(lambda: rk.replay_sorted_ablation(
                *e_args, SW, mode, block=block))
               for mode in rk.ABLATION_ROWS}}
    log(f"[3] sorted staging's two ends ({T} staged rows, {n_live} live, "
        f"windows {sorted(set(e_wids.tolist()))}): full, counts and no_hist "
        f"equal to the plain versions (exact rows equal, moments within "
        f"rtol={RTOL_CARD}), count rows = live x repeats; times {end_ms} "
        f"ms on {card}")
    return end_ms


def dense_ends(dev, card) -> dict:
    """Phase 2's ends of the dense kernel: every span in one segment
    (every atomic on one row), every span on the dead lane (with nonzero
    planes: dropped all the same), at the stream chunk's 4096 spans and
    the corpus pass's 491,520, SW 1440 and 4320 (more than one
    shared-memory tile).  Each against the plain version at
    inner_repeats 1 and 2, the count column = live spans x repeats;
    returns [kernel, index_add_] ms of each."""
    import numpy as np
    import torch
    from anomod_torch.ops import replay_kernels as rk

    rng = np.random.default_rng(11)
    out = {}
    for n, sw in ((4096, 4320), (491_520, 1440), (491_520, 4320)):
        dur_us = rng.lognormal(8.0, 1.0, n).astype(np.float32)
        planes = torch.from_numpy(np.stack([
            np.ones(n), rng.random(n) < 0.2, rng.random(n) < 0.1, dur_us,
            np.log1p(dur_us), np.log1p(dur_us) ** 2]).astype(
                np.float32)).to(dev)
        for kind, seg, live in (("one segment", sw // 3, n),
                                ("all dead", sw, 0)):
            sid = torch.full((n,), seg, dtype=torch.int32, device=dev)
            what = f"dense {kind} N={n} SW={sw}"
            for reps in (1, 2):
                got = rk.replay_dense(sid, planes, sw, H, inner_repeats=reps)
                compare(f"{what} x{reps}", got.cpu(), rk.replay_dense_plain(
                    sid, planes, sw, H, inner_repeats=reps).cpu(), RTOL_CARD)
                check(float(got[:, 0].double().sum()) == live * reps,
                      f"{what}: count column != {live} x {reps}")
                if not live:
                    check(not bool(got.any()), f"{what}: not all zero")
            payload = rk.replay_payload(planes, H)
            acc = torch.zeros((sw + 1, 6 + H), device=dev)
            idx = sid.long()
            out[f"{kind} N={n} SW={sw}"] = [
                cuda_ms(lambda: rk.replay_dense(sid, planes, sw, H)),
                cuda_ms(lambda: acc.index_add_(0, idx, payload))]
    log(f"[2] dense ends (one segment, all dead; N 4096 and 491,520; SW "
        f"1440 and 4320): equal to the plain version at inner_repeats 1, "
        f"2, count column = live x repeats, dead lane dropped; [kernel, "
        f"index_add_] ms {out} on {card}")
    return out


def hll_numpy(items, p, lane=None, n_lanes=1):
    """numpy HLL oracle, independent of the port: uint32 fmix32, clz in
    float64 (exact for uint32), ``np.maximum.at`` into ``[n_lanes, 2^p]``
    registers; items whose lane is outside ``[0, n_lanes)`` are dropped."""
    import numpy as np

    def fmix(v):
        v = v ^ (v >> np.uint32(16))
        v = v * np.uint32(0x85EBCA6B)
        v = v ^ (v >> np.uint32(13))
        v = v * np.uint32(0xC2B2AE35)
        return v ^ (v >> np.uint32(16))
    h = fmix(np.asarray(items).astype(np.uint32))
    bucket = (h >> np.uint32(32 - p)).astype(np.int64)
    h2 = fmix(h ^ np.uint32(0x9E3779B9))
    msb = np.floor(np.log2(np.maximum(h2, 1).astype(np.float64)))
    clz = np.where(h2 > 0, 31 - msb.astype(np.int32), 32)
    rank = np.minimum(clz + 1, 32).astype(np.int32)
    lane = np.zeros(len(h), np.int64) if lane is None \
        else np.asarray(lane).astype(np.int64)
    keep = (lane >= 0) & (lane < n_lanes)
    regs = np.zeros(n_lanes << p, np.int32)
    np.maximum.at(regs, (lane[keep] << p) + bucket[keep], rank[keep])
    return regs.reshape(n_lanes, 1 << p)


def sketch_bound(n_bytes, n_ops, peak_ops):
    """(bound_ms, bound_by): the larger of the bytes at the HBM rate and
    the operations at ``peak_ops``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def plain_sketch_kernels():
    """Run the sketch path with the kernels' plain versions in place of
    their wrappers (the path calls ``sketch_kernels.tdigest_reduce`` and
    ``.hll_update`` by module attribute): the reference on the card."""
    from anomod_torch.ops import sketch_kernels as sk
    saved = sk.tdigest_reduce, sk.hll_update
    sk.tdigest_reduce, sk.hll_update = (sk.tdigest_reduce_plain,
                                        sk.hll_update_plain)
    try:
        yield
    finally:
        sk.tdigest_reduce, sk.hll_update = saved


def sketch_phases(dev, card, batch, cfg) -> dict:
    """Phases 9-11: the t-digest reduction and HLL update kernels against
    their plain versions at the bench shapes, then the sketch path with
    its launches counted.  Returns the summary fields and the two
    kernels' report entries."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from anomod_torch import cli
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import sketch_kernels as sk
    from anomod_torch.ops.tdigest import SEGMENT_PAD_TO, scale_pass, segment_pad
    from anomod_torch.replay import (edge_keyed_batch, replay_edge_features,
                                     replay_percentiles, segment_ids,
                                     stage_columns)

    t_phases = time.perf_counter()
    K = K_DIGEST
    eb, table = edge_keyed_batch(batch)
    ecfg = dataclasses.replace(cfg, n_services=len(table))
    planes = {}
    for name, c, b in (("service", cfg, batch), ("edge", ecfg, eb)):
        ch, _ = stage_columns(b, c)
        sid, dur = ch["sid"].reshape(-1), ch["dur"].reshape(-1)
        real = sid < c.sw
        padded, weights = segment_pad(dur[real], sid[real], c.sw,
                                      pad_to=SEGMENT_PAD_TO)
        planes[name] = (c, ch, padded, weights, int(real.sum()))

    # -- phase 9: tdigest_reduce vs plain ----------------------------------
    digest_err = 0.0
    digest_times = {}

    def digest_case(name, bucket, ws, wv, n_weight, note):
        """tdigest_reduce on one plane: two launches bit-identical,
        weights equal to the plain version's and summing to
        ``n_weight``, means within tolerance; then its times."""
        nonlocal digest_err
        got = sk.tdigest_reduce(bucket, ws, wv, K)
        again = sk.tdigest_reduce(bucket, ws, wv, K)
        plain = sk.tdigest_reduce_plain(bucket, ws, wv, K)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"tdigest_reduce {name}: two launches differ")
        check(torch.equal(got[1], plain[1]),
              f"tdigest_reduce {name}: weights differ from the plain version")
        check(float(got[1].double().sum()) == n_weight,
              f"tdigest_reduce {name}: weight total != {n_weight}")
        gm, pm = got[0].cpu().numpy(), plain[0].cpu().numpy()
        check(np.isfinite(gm).all(), f"tdigest_reduce {name}: non-finite")
        bad = ~np.isclose(gm, pm, rtol=RTOL_DIGEST, atol=0.0)
        check(not bad.any(), f"tdigest_reduce {name}: {int(bad.sum())} means "
              f"outside rtol={RTOL_DIGEST}")
        err = float(np.abs(gm.astype(np.float64) - pm).max())
        rel = float((np.abs(gm.astype(np.float64) - pm)
                     / np.maximum(np.abs(pm), 1e-30)).max())
        digest_err = max(digest_err, err)
        R, L = bucket.shape
        plain_ms = cuda_ms(lambda: sk.tdigest_reduce_plain(bucket, ws, wv, K),
                           iters=5)
        keep = (bucket >= 0) & (bucket < K)
        idx = (torch.arange(R, device=dev)[:, None] * K
               + bucket.long())[keep]
        pay = torch.stack([ws[keep], wv[keep]], dim=1)
        acc = torch.zeros((R * K, 2), device=dev)
        bnd, by = sketch_bound(R * L * 12 + R * K * 8,
                               2 * R * L + R * K * 17, PEAK_F32_OPS_PER_S)
        digest_times[name] = dict(
            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            **timed(lambda: sk.tdigest_reduce(bucket, ws, wv, K),
                    lambda: acc.index_add_(0, idx, pay)))
        t = digest_times[name]
        log(f"[9] tdigest_reduce {name} R={R} L={L} K={K} ({note}): "
            f"launches bit-identical, weights equal, means "
            f"max_abs_err={err:.3g} max_rel_err={rel:.3g}; kernel "
            f"{t['ms']:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
            f"{t['library_ms']:.4f} ms, bound {bnd:.6f} ms ({by}) on {card}; "
            f"unspun: {t['ms_unspun']:.4f}, {t['library_ms_unspun']:.4f}")

    for name, (c, _, padded, weights, n_real) in planes.items():
        v = torch.from_numpy(padded).to(dev)
        w = torch.from_numpy(weights).to(dev)
        bucket, ws, wv = edge = scale_pass(v, w, K)
        flips = (bucket.cpu() != scale_pass(v.cpu(), w.cpu(), K)[0])
        digest_case(name, bucket, ws, wv, n_real,
                    f"{n_real} real spans; scale_pass bucket rows card vs "
                    f"host differ in {int(flips.any(1).sum())} rows, "
                    f"{int(flips.sum())} slots")
    # the edge plane (the loop's last) with each row's slots shuffled
    # (rows no longer sorted by bucket) and some buckets moved outside
    # [0, K)
    g = torch.Generator(device=dev).manual_seed(9)
    perm = torch.rand(edge[0].shape, generator=g, device=dev).argsort(dim=1)
    ub, uw, uwv = (torch.gather(x, 1, perm) for x in edge)
    ub[:, ::97] = -1
    ub[:, 1::89] = K
    n_in = float(uw[(ub >= 0) & (ub < K)].double().sum())
    digest_case("edge unsorted", ub, uw, uwv, n_in,
                "rows shuffled, every 97th slot at -1 and every 89th at K")
    # a weighted merge: the service plane's even windows' digests with the
    # odd windows', one weighted rebuild per pair
    c, _, padded, weights, n_real = planes["service"]
    bucket, ws, wv = scale_pass(torch.from_numpy(padded).to(dev),
                                torch.from_numpy(weights).to(dev), K)
    mean, weight = sk.tdigest_reduce(bucket, ws, wv, K)
    m2 = mean.reshape(-1, 2 * K)
    w2 = weight.reshape(-1, 2 * K)
    mb, mw, mwv = scale_pass(m2, w2, K)
    got = sk.tdigest_reduce(mb, mw, mwv, K)
    plain = sk.tdigest_reduce_plain(mb, mw, mwv, K)
    torch.cuda.synchronize()
    check(torch.equal(got[1], plain[1]), "weighted merge: weights differ")
    check(float(got[1].double().sum()) == n_real, "weighted merge: total")
    check(np.allclose(got[0].cpu().numpy(), plain[0].cpu().numpy(),
                      rtol=RTOL_DIGEST, atol=0.0),
          "weighted merge: means outside rtol")
    merge_flips = int((mb.cpu() != scale_pass(m2.cpu(), w2.cpu(), K)[0])
                      .any(1).sum())
    log(f"[9] weighted merge of {m2.shape[0]} digest pairs: weights equal, "
        f"means within rtol={RTOL_DIGEST}; scale_pass rows card vs host "
        f"differ in {merge_flips}")

    # -- phase 10: hll_update vs plain and the numpy oracle ----------------
    items = torch.from_numpy(batch.trace.astype(np.int32)).to(dev)
    n_items = items.shape[0]
    single = hll_numpy(batch.trace, 10)[0]
    got = sk.hll_update(torch.zeros(1 << 10, dtype=torch.int32, device=dev),
                        items, p=10)
    plain = sk.hll_update_plain(torch.zeros(1 << 10, dtype=torch.int32,
                                            device=dev), items, p=10)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), "hll_update p=10: differs from plain")
    check(np.array_equal(got.cpu().numpy(), single),
          "hll_update p=10: differs from the numpy oracle")
    _, ech, _, _, _ = planes["edge"]
    esid = ech["sid"].reshape(-1)
    etid = ech["tid"].reshape(-1)
    E = ecfg.n_services
    elane = np.where(esid < ecfg.sw, np.clip(esid // ecfg.n_windows, 0,
                                             E - 1), E).astype(np.int32)
    e_items = torch.from_numpy(etid).to(dev)
    e_lane = torch.from_numpy(elane).to(dev)
    got_e = sk.hll_update(torch.zeros((E, 1 << 8), dtype=torch.int32,
                                      device=dev), e_items, e_lane, p=8)
    plain_e = sk.hll_update_plain(torch.zeros((E, 1 << 8), dtype=torch.int32,
                                              device=dev), e_items, e_lane,
                                  p=8)
    torch.cuda.synchronize()
    check(torch.equal(got_e, plain_e), "hll_update edge plane: differs from "
          "plain")
    check(np.array_equal(got_e.cpu().numpy(), hll_numpy(etid, 8, elane, E)),
          "hll_update edge plane: differs from the numpy oracle")
    log(f"[10] hll_update: single sketch p=10 over {n_items} trace ids and "
        f"the edge plane p=8 over {E}+1 lanes ({etid.size} staged rows, "
        f"{int((elane == E).sum())} on the dead lane): registers equal to "
        "the plain version and the numpy oracle")
    hll_times = {}
    for name, regs, it, ln, p in (
            ("single p=10", torch.zeros(1 << 10, dtype=torch.int32,
                                        device=dev), items, None, 10),
            ("edge p=8", torch.zeros((E, 1 << 8), dtype=torch.int32,
                                     device=dev), e_items, e_lane, 8)):
        plain_ms = cuda_ms(lambda: sk.hll_update_plain(regs, it, ln, p),
                           iters=5)
        bucket, rank = sk.hll_hash(it, p)
        # what the kernel must move: the item of each row it keeps (and
        # that row's lane), only the lane of each dead-lane row, and the
        # registers read and written; only the kept rows are hashed
        n_live, n_dead = it.shape[0], 0
        if ln is not None:
            keep = ln < E
            n_live = int(keep.sum())
            n_dead = it.shape[0] - n_live
            bucket = (ln.long() << p)[keep] + bucket[keep]
            rank = rank[keep]
        rank = rank.to(torch.int32)
        flat = regs.view(-1)
        bnd, by = sketch_bound(n_live * (4 if ln is None else 8)
                               + n_dead * 4 + 2 * regs.numel() * 4,
                               n_live * HLL_OPS_PER_ITEM, PEAK_INT32_OPS_PER_S)
        t = hll_times[name] = dict(
            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            **timed(lambda: sk.hll_update(regs, it, ln, p),
                    lambda: flat.scatter_reduce_(0, bucket, rank,
                                                 reduce="amax")))
        log(f"[10] hll_update {name}: kernel {t['ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scatter_reduce_ {t['library_ms']:.4f} ms, "
            f"bound {bnd:.6f} ms ({by}) on {card}; unspun: "
            f"{t['ms_unspun']:.4f}, {t['library_ms_unspun']:.4f}")

    # -- phase 11: the sketch path, launches counted -----------------------
    sk.reset_launches()
    rk.reset_launches()
    t0 = time.perf_counter()
    pct = replay_percentiles(batch, cfg, device=dev)
    epct, counts, etable = replay_edge_features(batch, cfg, device=dev)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(sk.launches)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the sketch path")
    check(pct.shape == (cfg.sw, 3) and np.isfinite(pct).all(),
          "replay_percentiles: shape or non-finite")
    check(etable == table and epct.shape == (E * cfg.n_windows, 3)
          and np.isfinite(epct).all() and counts.shape == (E,),
          "replay_edge_features: shapes")
    with plain_sketch_kernels():
        t0 = time.perf_counter()
        pct_p = replay_percentiles(batch, cfg, device=dev)
        epct_p, counts_p, table_p = replay_edge_features(batch, cfg,
                                                         device=dev)
        torch.cuda.synchronize()
        plain_path_s = time.perf_counter() - t0
    check(table_p == etable, "sketch path: edge tables differ from plain")
    check(np.array_equal(counts, counts_p),
          "sketch path: distinct counts differ from plain")
    for what, a, b in (("service", pct, pct_p), ("edge", epct, epct_p)):
        bad = ~np.isclose(a, b, rtol=RTOL_PCT, atol=ATOL_PCT)
        check(not bad.any(), f"sketch path {what} percentiles: "
              f"{int(bad.sum())} outside rtol={RTOL_PCT}, atol={ATOL_PCT}")
    pct_err = float(max(np.abs(pct.astype(np.float64) - pct_p).max(),
                        np.abs(epct.astype(np.float64) - epct_p).max()))
    # against exact quantiles of the five busiest service segments, at
    # the JAX package's own accuracy bar (tests/test_replay.py)
    sid = segment_ids(batch, cfg)
    busiest = np.argsort(np.bincount(sid, minlength=cfg.sw))[-5:]
    worst = {}
    for j, q, bar in ((0, 0.5, 0.08), (2, 0.99, 0.20)):
        worst[q] = max(
            abs(float(pct[seg, j]) - exact) / exact for seg in busiest
            for exact in [float(np.quantile(batch.duration_us[sid == seg],
                                            q))])
        check(worst[q] <= bar, f"sketch path: q={q} of the busiest segments "
              f"{worst[q]:.3g} off the exact quantile (bar {bar})")
    exact_d = np.array([len(np.unique(batch.trace[eb.service == i]))
                        for i in range(E)], np.float64)
    d_rel = np.abs(counts - exact_d) / exact_d
    check(float(np.median(d_rel)) < 0.1, "sketch path: distinct counts "
          f"median relative error {float(np.median(d_rel)):.3g}")
    log(f"[11] sketch path: replay_percentiles [{cfg.sw}, 3] + "
        f"replay_edge_features ({E} edges, [{E * cfg.n_windows}, 3]) in "
        f"{path_s:.3f} s on {card} (plain versions on the card "
        f"{plain_path_s:.3f} s); launches {launches}; edge table and "
        f"distinct counts equal to the plain run, percentiles within "
        f"rtol={RTOL_PCT} (max abs {pct_err:.3g} us); busiest segments' "
        f"p50 within {worst[0.5]:.3g}, p99 within {worst[0.99]:.3g} of "
        f"exact; distinct counts vs exact: "
        f"median {float(np.median(d_rel)):.3g}, max {float(d_rel.max()):.3g}")
    # the path once more under the profiler: the device's busy time
    # against that profiled run's own wall (the profiler was started once
    # already, in phase 2)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay_percentiles(batch, cfg, device=dev)
        replay_edge_features(batch, cfg, device=dev)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    busy_share = None if busy is None else busy / 1e3 / prof_s
    log(f"[11] sketch path trace: device busy "
        f"{'not measured (no device events)' if busy is None else f'{busy:.3f} ms'}"
        f" in a {prof_s:.3f} s profiled wall; busy share "
        f"{busy_share if busy_share is None else f'{busy_share:.4g}'}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["replay", "--percentiles", "--edge-percentiles",
                       "--repeats", "1"])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"cli replay exited {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(out["latency_us"]) == {"p50", "p95", "p99"}
          and len(out["edge_p99_us_top"]) == 5, f"cli replay output {out}")
    log(f"[11] python -m anomod_torch replay --percentiles "
        f"--edge-percentiles ({cli_s:.3f} s): latency_us "
        f"{out['latency_us']}")
    for row in out["edge_p99_us_top"]:
        log(f"[11]   {row['edge']}: p99 {row['p99_us']} us, "
            f"{row['distinct_traces']} distinct traces")
    total = dict(sk.launches)

    def entry(name, replaces, times, err):
        return {"name": name, "route": "cuda",
                "source": "anomod_torch/csrc/sketch.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, **times}
    kernels = [
        entry("tdigest_reduce", "anomod/ops/pallas_tdigest.py:34",
              dict(digest_times["edge"], planes=digest_times,
                   redesigned="PR 6"), digest_err),
        entry("hll_update", "anomod/ops/pallas_hll.py:19",
              hll_times["edge p=8"], 0.0)]
    return {"kernels": kernels, "sketch_path_wall_s": path_s,
            "sketch_device_busy_ms": busy,
            "sketch_profiled_wall_s": prof_s,
            "sketch_device_busy_share": busy_share,
            "sketch_phases_wall_s": time.perf_counter() - t_phases,
            "sketch_plain_path_wall_s": plain_path_s,
            "sketch_cli_wall_s": cli_s, "sketch_launches_with_cli": total,
            "sketch_latency_us": out["latency_us"],
            "tdigest_times": digest_times, "hll_times": hll_times}


def roofline_phases(dev, card, kind, sid_np, planes_np, n_real, SW) -> dict:
    """Phase 12: the sorted kernel's ablations against their plain
    versions and the full kernel, then the roofline probe at full size
    with its launches counted and its capture read back.  Returns the
    summary fields and the two kernels' report entries."""
    import os
    import tempfile

    import numpy as np
    import torch
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.roofline import kernel_roofline

    block, k = 4096, 128
    args = [torch.from_numpy(a).to(dev) for a in rk.stage_sorted_planes(
        sid_np, planes_np, SW, k=k, block=block)]
    nwk = rk.n_window_cols(SW, k)
    n_dead = int((sid_np == SW).sum())
    errs = {mode: 0.0 for mode in rk.ABLATION_ROWS}
    for reps in (1, 2):
        full = rk.replay_sorted(*args, SW, H, k=k, block=block,
                                inner_repeats=reps).cpu().numpy()
        for mode, rows in rk.ABLATION_ROWS.items():
            got = rk.replay_sorted_ablation(*args, SW, mode, k=k, block=block,
                                            inner_repeats=reps)
            torch.cuda.synchronize()
            want = rk.replay_sorted_ablation_plain(
                *args, SW, mode, k=k, block=block,
                inner_repeats=reps).cpu().numpy()
            got = got.cpu().numpy()
            what = f"{mode} inner_repeats={reps}"
            check(got.shape == (rows, nwk), f"{what}: shape {got.shape}")
            check(np.isfinite(got).all(), f"{what}: non-finite output")
            check((got[:3] == want[:3]).all(),
                  f"{what}: count/exact rows differ from the plain version")
            bad = ~np.isclose(got[3:], want[3:], rtol=RTOL_CARD, atol=ATOL)
            check(not bad.any(), f"{what}: {int(bad.sum())} hi/lo entries "
                  f"outside rtol={RTOL_CARD}, atol={ATOL}")
            errs[mode] = max(errs[mode], float(np.abs(
                got.astype(np.float64) - want).max()))
            check((got[0, :SW] == full[:, 0]).all(),
                  f"{what}: row 0 differs from the sorted kernel's counts")
            check((got[:, SW:] == 0).all(),
                  f"{what}: dead lane or padding columns not zero")
            if mode == "counts":
                check(float(got[0].astype(np.float64).sum())
                      == n_real * reps, f"{what}: count row sums to "
                      f"{float(got[0].astype(np.float64).sum())}, not "
                      f"{n_real * reps}")
            else:
                check((got[:3, :SW].T == full[:, :3]).all(),
                      f"{what}: exact rows differ from the sorted kernel")
                bad = ~np.isclose(got[3:6, :SW].T + got[6:9, :SW].T,
                                  full[:, 3:6], rtol=RTOL_CARD, atol=ATOL)
                check(not bad.any(), f"{what}: hi + lo rows differ from the "
                      f"sorted kernel's moments in {int(bad.sum())} entries")
    log(f"[12] ablations counts, no_hist at inner_repeats 1, 2: count and "
        f"exact rows equal to the plain versions and the sorted kernel, "
        f"count row = {n_real} x repeats, dead lane and padding columns "
        f"zero; max_abs_err {errs}")

    times = {}
    g_idx = rk.sorted_global_ids(args[0], args[2], k, block)
    for mode, rows in rk.ABLATION_ROWS.items():
        plain_ms = cuda_ms(lambda: rk.replay_sorted_ablation_plain(
            *args, SW, mode, k=k, block=block), iters=5)
        pay = rk.ablation_payload(args[1], mode)
        acc = torch.zeros((nwk, rows), device=dev)
        # bytes: sid + the planes it reads (valid only for counts) a real
        # span, the sid of each dead row, the [ROWS, NWK] output; ops: a
        # bf16 rounding and an add a row, two more roundings and a
        # subtraction a moment
        in_bytes, ops = (8, 2) if mode == "counts" else (28, 9 + 9 + 3 * 3)
        bnd, by = sketch_bound(n_real * in_bytes + n_dead * 4
                               + rows * nwk * 4, n_real * ops,
                               PEAK_F32_OPS_PER_S)
        t = times[mode] = dict(
            plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            **timed(lambda: rk.replay_sorted_ablation(
                *args, SW, mode, k=k, block=block),
                lambda: acc.index_add_(0, g_idx, pay)))
        log(f"[12] {mode}: kernel {t['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_add_ {t['library_ms']:.4f} ms, bound {bnd:.6f} ms ({by}; "
            f"{n_real} real + {n_dead} dead rows) on {card}; unspun: "
            f"{t['ms_unspun']:.4f}, {t['library_ms_unspun']:.4f}")

    # -- the probe path, launches counted ---------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        rk.reset_launches()
        t0 = time.perf_counter()
        verdict = kernel_roofline(device=dev, outdir=tmp)
        probe_s = time.perf_counter() - t0
        launches = dict(rk.launches)
        for name in ("replay_sorted", "replay_sorted_counts",
                     "replay_sorted_no_hist"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the probe path")
        path = verdict["capture_file"]
        check(path is not None and os.path.dirname(path) == tmp
              and path.endswith("_replay_kernel_roofline_gpu.json"),
              f"roofline capture at {path}")
        with open(path) as f:
            rec = json.load(f)
    check(rec["device"] == kind and rec["params"]["device"] == kind,
          f"capture device {rec['device']!r} != {kind!r}")
    check(rec["torch_version"] == torch.__version__
          and rec["cuda_version"] == torch.version.cuda,
          "capture torch/cuda versions")
    sha = rec["git_sha"]
    check(isinstance(sha, str) and (
        len(sha.split("-")[0]) == 40
        or not (Path(__file__).resolve().parent / ".git").exists()),
        f"capture git_sha {sha!r}")
    rates = rec["rates"]
    check(set(rates) == {"full", "onehot_only", "no_hist"}
          and all(v > 0 for v in rates.values()) and rates == verdict["rates"],
          f"capture rates {rates}")
    check(rec["params"]["replicate"] == 4096
          and rec["params"]["n_spans"] == n_real, f"capture params "
          f"{rec['params']}")
    log(f"[12] roofline probe ({probe_s:.3f} s, replicate 4096, L2-resident "
        f"after the first pass): full {rates['full']:.6g}, onehot_only "
        f"{rates['onehot_only']:.6g}, no_hist {rates['no_hist']:.6g} "
        f"spans/s; onehot_ceiling_ratio {verdict['onehot_ceiling_ratio']}; "
        f"walls {rec['params']['walls_s']} s; launches {launches}; capture "
        f"read back (git_sha {sha!r}) on {card}")

    kernels = [
        {"name": f"replay_sorted_{mode}", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "scripts/bench_kernel_roofline.py:73",
         "redesigned": "PR 5",
         "launches": launches[f"replay_sorted_{mode}"],
         "max_abs_err": errs[mode], **times[mode]}
        for mode in rk.ABLATION_ROWS]
    return {"kernels": kernels, "roofline_rates": rates,
            "roofline_onehot_ceiling_ratio": verdict["onehot_ceiling_ratio"],
            "roofline_walls_s": rec["params"]["walls_s"],
            "roofline_probe_wall_s": probe_s, "roofline_times": times}


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
    from anomod_torch.ops import serve_kernels as sk
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

        def __init__(self, cfg, t0_us, device=None, with_hll=False):
            super().__init__(cfg, t0_us, device=device, with_hll=with_hll)
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
    _build.build(["replay", "serve", "sketch"])
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1] ptxas {name}: {line.strip()}")
    # how the shared f32 atomicAdd lowers on this target: a native shared
    # add or a compare-and-swap loop (ATOMS.CAST.SPIN)
    for name in ("replay", "sketch"):
        atomics = sass_atomics(_build._target(name))
        log(f"[1] sass {name} atomics by kernel: "
            f"{'not measured (no cuobjdump)' if atomics is None else atomics}")

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
    again = rk.replay_dense(sid, planes, SW, H)
    dense_bits = bool(torch.equal(got, again))
    log(f"[2] dense: two launches bit-identical: {dense_bits} (not "
        f"required: shared-memory atomics add in arrival order)")
    dense_plain_ms = cuda_ms(
        lambda: rk.replay_dense_plain(sid, planes, SW, H), iters=5)
    payload = rk.replay_payload(planes, H)
    acc = torch.zeros((SW + 1, 6 + H), device=dev)
    idx = sid.long()
    dense_t = timed(lambda: rk.replay_dense(sid, planes, SW, H),
                    lambda: acc.index_add_(0, idx, payload))
    dense_split = traced_ms(lambda: rk.replay_dense(sid, planes, SW, H),
                            DENSE_KERNELS)
    # both kernels compute the same fold of the same real spans: one bound
    fold_bound, fold_by = bound(n_real, SW * (6 + H))
    log(f"[2] dense SW=1440: max_abs_err={dense_err:.3g} "
        f"kernel {dense_t['ms']:.4f} ms, plain {dense_plain_ms:.4f} ms, "
        f"index_add_ {dense_t['library_ms']:.4f} ms, bound "
        f"{fold_bound:.6f} ms ({fold_by}; {n_real} real spans); unspun: "
        f"{dense_t['ms_unspun']:.4f}, {dense_t['library_ms_unspun']:.4f}; "
        f"traced device ms and launches a call by kernel {dense_split}")

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
    ESW = ecfg.sw
    got = rk.replay_dense(e_sid, e_planes, ESW, H)
    err_4320 = compare(
        f"dense SW={ESW}", got.cpu(),
        rk.replay_dense_plain(e_sid, e_planes, ESW, H).cpu(), RTOL_CARD)
    # the stream's chunk shape: one 4096-span chunk of that id space
    one = slice(0, ecfg.chunk_size)
    c_sid, c_planes = e_sid[one], e_planes[:, one].contiguous()
    got = rk.replay_dense(c_sid, c_planes, ESW, H)
    err_4320 = max(err_4320, compare(
        f"dense chunk SW={ESW}", got.cpu(),
        rk.replay_dense_plain(c_sid, c_planes, ESW, H).cpu(), RTOL_CARD))
    chunk_bits = bool(torch.equal(got, rk.replay_dense(c_sid, c_planes, ESW,
                                                       H)))
    chunk_plain_ms = cuda_ms(
        lambda: rk.replay_dense_plain(c_sid, c_planes, ESW, H), iters=5)
    c_payload = rk.replay_payload(c_planes, H)
    c_acc = torch.zeros((ESW + 1, 6 + H), device=dev)
    c_idx = c_sid.long()
    chunk_t = timed(lambda: rk.replay_dense(c_sid, c_planes, ESW, H),
                    lambda: c_acc.index_add_(0, c_idx, c_payload))
    chunk_split = traced_ms(lambda: rk.replay_dense(c_sid, c_planes, ESW, H),
                            DENSE_KERNELS)
    c_live = int((c_sid < ESW).sum())
    chunk_bound, chunk_by = bound(c_live, ESW * (6 + H),
                                  n_dead=ecfg.chunk_size - c_live)
    log(f"[2] dense SW={ESW}: max_abs_err={err_4320:.3g}; one "
        f"{ecfg.chunk_size}-span stream chunk ({c_live} live): kernel "
        f"{chunk_t['ms']:.4f} ms, plain {chunk_plain_ms:.4f} ms, index_add_ "
        f"{chunk_t['library_ms']:.4f} ms, bound {chunk_bound:.6f} ms "
        f"({chunk_by}); unspun: {chunk_t['ms_unspun']:.4f}, "
        f"{chunk_t['library_ms_unspun']:.4f}; traced device ms and launches "
        f"a call by kernel {chunk_split}; two launches bit-identical: "
        f"{chunk_bits}")

    z32 = torch.zeros(0, dtype=torch.int32, device=dev)
    zp = torch.zeros((6, 0), dtype=torch.float32, device=dev)
    for name, out in (("dense", rk.replay_dense(z32, zp, SW, H)),
                      ("dense SW=4320", rk.replay_dense(z32, zp, ESW, H)),
                      ("sorted", rk.replay_sorted(z32, zp, z32, SW, H))):
        check(out.shape[1] == 6 + H and bool((out == 0).all()),
              f"{name}: empty corpus is not all zeros")
    log("[2] empty corpus: zeros from both kernels")
    dense_end_ms = dense_ends(dev, card)

    # the L2 write's price inside a timed window: an empty window after
    # it, and each replay kernel after the write (dirty lines written back
    # while the kernel runs) and after a read of the same size (clean)
    flush = {"empty_ms": cuda_ms(lambda: None)}
    for name, fn in (("dense", lambda: rk.replay_dense(sid, planes, SW, H)),
                     ("chunk", lambda: rk.replay_dense(c_sid, c_planes, ESW,
                                                       H))):
        flush[name] = [cuda_ms(fn), cuda_ms(fn, flush="read")]
    log(f"[2] L2 eviction: empty window after the write {flush['empty_ms']:.4f}"
        f" ms; [after the write, after a read] ms {flush} on {card}")

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
    sorted_plain_ms = cuda_ms(lambda: rk.replay_sorted_plain(
        *s_args, SW, H, block=block), iters=5)
    g_idx = rk.sorted_global_ids(s_args[0], s_args[2], 128, block)
    s_payload = rk.replay_payload(s_args[1], H)
    s_acc = torch.zeros(((SW + 128) // 128 * 128, 6 + H), device=dev)
    def sorted_fn():
        return rk.replay_sorted(*s_args, SW, H, block=block)
    sorted_t = timed(sorted_fn,
                     lambda: s_acc.index_add_(0, g_idx, s_payload))
    flush["sorted"] = [sorted_t["ms"], cuda_ms(sorted_fn, flush="read")]
    log(f"[3] sorted: T={sid_l.shape[0]} staged, max_abs_err="
        f"{sorted_err:.3g} kernel {sorted_t['ms']:.4f} ms (after a clean "
        f"read {flush['sorted'][1]:.4f}), plain {sorted_plain_ms:.4f} ms, "
        f"index_add_ {sorted_t['library_ms']:.4f} ms, bound "
        f"{fold_bound:.6f} ms; unspun: {sorted_t['ms_unspun']:.4f}, "
        f"{sorted_t['library_ms_unspun']:.4f}")
    again = rk.replay_sorted(*s_args, SW, H, block=block, inner_repeats=2)
    log(f"[3] sorted: two launches bit-identical: "
        f"{bool(torch.equal(got, again))} (not required: run sums meet in "
        f"shared-memory atomics)")

    end_ms = sorted_ends(dev, card, SW, block)

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
        f"{replay_launches}, main path total {launches}; the stream's "
        f"{stream_launches} at the chunk shape")
    for k in ("replay_dense", "replay_sorted"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")

    # the stream once more under the profiler: the device's busy time and
    # the dense kernels' device time, read from the trace, against the
    # un-profiled wall above (the profiler was started in phase 2)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_quality("TT", n_traces=400, seed=0, device=dev)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    # the share is of the profiled run's own wall, as in phase 8
    busy_share = None if busy is None else busy / 1e3 / prof_s
    log(f"[5] stream trace: device busy "
        f"{'not measured (no device events)' if busy is None else f'{busy:.3f} ms'}"
        f" in a {prof_s:.3f} s profiled wall (the un-profiled run's "
        f"{stream_s:.3f} s); busy share "
        f"{busy_share if busy_share is None else f'{busy_share:.4g}'}")
    stream_kernels = {n: v for n, v in kernel_device_ms(
        prof, DENSE_KERNELS).items() if v[1]}
    chunk_trace_ms = sum(v[0] for v in stream_kernels.values()) \
        / stream_launches
    log(f"[5] stream trace by kernel (device ms, kernels in the trace): "
        f"{stream_kernels}; {chunk_trace_ms:.6f} ms of dense-kernel device "
        f"time a chunk over {stream_launches} chunks")

    serve = serve_phases(dev, card)
    sketch = sketch_phases(dev, card, batch, cfg)
    roof = roofline_phases(dev, card, kind, sid_np, planes_np, n_real, SW)

    # -- report -----------------------------------------------------------
    # the dense kernel's top-level times are the corpus pass's; each path
    # shape has its own entry, launches counted on the main path
    corpus = dict(launches=launches["replay_dense"] - stream_launches,
                  plain_ms=dense_plain_ms, bound_ms=fold_bound,
                  bound_by=fold_by, traced=dense_split, **dense_t)
    chunk = dict(launches=stream_launches, plain_ms=chunk_plain_ms,
                 bound_ms=chunk_bound, bound_by=chunk_by,
                 traced=chunk_split, stream_trace_ms=chunk_trace_ms,
                 **chunk_t)
    kernels = [
        {"name": "replay_dense", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:85", "redesigned": "PR 6",
         "launches": launches["replay_dense"],
         "max_abs_err": max(dense_err, err_4320),
         **{k: corpus[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "ms_unspun",
                                   "library_ms_unspun")},
         "bit_identical_launches": {"corpus": dense_bits,
                                    "stream_chunk": chunk_bits},
         "shapes": {"corpus": corpus, "stream_chunk": chunk}},
        {"name": "replay_sorted", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:257", "redesigned": "PR 5",
         "launches": launches["replay_sorted"], "max_abs_err": sorted_err,
         "plain_ms": sorted_plain_ms, "bound_ms": fold_bound,
         "bound_by": fold_by, **sorted_t},
    ] + serve.pop("kernels") + sketch.pop("kernels") + roof.pop("kernels")
    log(json.dumps({"replay_spans_per_sec": rates, "replicate": replicate,
                    "stream_top1": sum(hits) / len(hits),
                    "stream_wall_s": stream_s,
                    "stream_dense_trace_ms": stream_kernels,
                    "stream_device_busy_ms": busy,
                    "stream_profiled_wall_s": prof_s,
                    "stream_device_busy_share": busy_share,
                    "sorted_ends_ms": end_ms, "dense_ends_ms": dense_end_ms,
                    "l2_eviction_ms": flush, **serve,
                    **sketch, **roof,
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
