#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``anomod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``anomod_torch/csrc/`` with nvcc and
its host entries (``csrc/native.cpp``) with the host's C++ compiler,
holds each kernel against its plain PyTorch version on the card, then
drives the data layer and every ported path:

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
- the data layer (phase 5b): ``load_corpus`` of both testbeds at 50
  traces, all five modalities, through a temporary ingest cache, cold
  then warm, warm held to cold byte for byte and the traces to
  ``synth.generate_spans``;
- serve (phases 6-8), at the serve bench's deployment (200 tenants, 12
  services x 32 windows of 5 s, 25,000 spans/s capacity at 2x overload,
  60 virtual seconds in 0.5 s ticks, seed 7): the lane-delta kernel
  bit for bit against the host's plain version at every bucket width,
  L = 1, 7, 32 and on adversarial lanes (one hot segment, two
  alternating, all dead), the window-gather kernel against its plain
  version at T = 1, 64, 256 and 1200 (above one launch's parameter
  capacity) with host indices, then the serve
  tick (admission, fused lane dispatch, device state pool, batched
  scoring), checked against the decision pins of the JAX package's
  captures (p99 22.998135 s, shed 0.437567, 158 alerts), against the
  same coalesced batches pushed through one-lane dispatches and against
  its depth-1, host-state, CPU, interpreter-fill and heap / numpy drain
  twins, byte for byte; the unfused run is held to its CPU twin byte for
  byte and to the fused run's admission and SLO fields; the host legs
  are split (bucket plan, scratch fill, admission offer and drain) for
  the native default and the interpreter / heap twin; a profiled run
  gives each serve kernel's device time;
- sketches (phases 9-11), on the replay's bench corpus at its full width
  (45 services x 32 windows, K = 64 centroids, HLL p = 8 per edge and
  p = 10 for the single sketch): the t-digest reduction and HLL update
  kernels against their plain versions and a numpy HLL oracle at the
  service- and edge-plane shapes (the t-digest also on edge-plane rows
  shuffled out of bucket order; the HLL update also at its ends: every
  row dead, every row on one register, p = 16 on the direct path, 100
  rows, and its C entry alone by both paths), then ``replay_percentiles`` and
  ``replay_edge_features`` with the launches counted, held against the
  same path run with the plain versions on the card, and the CLI's
  ``replay --percentiles --edge-percentiles``;
- the sorted replay kernel's roofline probe (phase 12), on the replay's
  bench corpus staged the sorted way (k = 128, block = 4096): the
  ``counts`` and ``no_hist`` ablation kernels against their plain
  versions and the full sorted kernel, then ``kernel_roofline()`` at its
  full size (replicate = 4096) with the launches counted, its capture
  written to a temporary directory and read back;
- detect (phase 13): ``detect.evaluate_corpus`` of both testbeds at the
  CLI's 100 traces, the scores on the card against the numpy oracle
  (the CPU runs in a spawned process beside the card's);
- RCA training (phase 14) at full width on TT (45 services; GCN 2 x 64,
  GraphSAGE 2 x 64, GAT 2 x 32 x 4 heads; the CLI's 300 epochs, 6 train
  and 2 eval seeds, 80 traces; the dataset built once on the host): each
  model trained on the card and on the CPU from one generator draw, a
  slice of epochs traced, and a GCN run resumed from a checkpoint held to
  the straight run;
- the multimodal stream (phase 15): ``stream_quality("TT", 400,
  multimodal=True)`` through the dense kernel, its launches counted,
  held to the same run with the plain fold on the card;
- online RCA in the serve tick (phase 16) at the serve bench deployment,
  nothing cut: RCA off, then on, on the card; the on-run holds the
  decision pins, equals the off-run's states and alerts byte for byte,
  holds the JAX captures' RCA pins (58 runs, one eligible fault tenant,
  top-1/3/5 hits 1/1/1) and one first launch per RCA bucket, and its
  verdict stream equals the CPU twin's; one RCA run is traced for its
  device events;
- telemetry (phase 17) at the same deployment: the registry off, then on
  (once each), decisions identical, the overhead and the journal's size
  printed; the on-run's journal exported to TT-CSV, loaded
  back through ``load_tt_metric_csv`` and scored by ``score_self_scrape``
  on the card (the dense kernel, launches counted) against the same
  scoring through the plain fold on the card (the scorings' own chunks,
  1024 spans at SW = subsystems x 64, also through the kernel and its
  plain version alone; the alert scores of 20 kernel scorings within
  ``RTOL_SELFSCRAPE_CARD``), and the injected-stall registry through
  the same round trip, alerting on ``serve`` alone;
- the quality sweep (phase 18): ``severity_sweep("TT")`` at full width
  and the CLI's defaults (60 traces, 120 epochs, noise 0.5, two
  confounders) but 3 train and 2 eval seeds, over nine rows (the z-score
  and stream baselines, GCN, GAT, GraphSAGE, the temporal GRU, the LRU, the
  TraceTransformer, the MoE) at severities 1.0 and 0.12, its stream
  row's ``dense_slice_fold`` launches counted, the training-free rows
  held to the CPU twin's (run in a spawned process meanwhile), each
  learned family's first 20 losses on the card held to the CPU's from
  one draw, and each family's ms an epoch, device events and busy share
  from one profiled epoch;
- the edge-aware shift sweep (phase 19): ``shift_sweep("TT",
  edge_aware=True)`` for the line graph and the transformer, in
  distribution and under the edge-locus shift, with each family's
  figures an epoch;
- the flight recorder and thread shards (phase 20) at the serve bench
  deployment, RCA on: flight off and on in two alternating turns, the
  decision and RCA pins on every run, decisions equal off / on, the
  card's canonical journal byte-identical to the CPU twin's (phase 16's),
  no ring drop, the overhead fraction with the state digest's and the
  tick record's own walls; 2 and 4 shards on the card equal to the
  1-shard run (states, alerts, verdicts, decisions, canonical journal,
  staged chunks per width), ``lane_delta`` launched from the shard
  runners' own streams only, serve wall and launches per shard count, a
  profiled busy share at 1 and 2 shards; ``audit record``, ``audit
  replay --shards 2``
  and ``audit diff`` (exit 0) through the CLI on the card, and a journal
  with one tick's admission digest edited, which ``diff`` names (exit
  1);
- supervision, chaos and process shard workers (phase 21) at the same
  deployment, RCA and flight on: the supervised default (4 checkpoints)
  held to supervision off and the CPU twin's journal, its checkpoint
  wall; the JAX bench's chaos leg at 1 shard (3 crashes, 55 restored
  ticks, no score gap), its recovery wall; 2 shard threads, then process
  workers at 2 shards (sparse fold), 1, 2 (dense) and 4, each equal to
  the threads on every decision and the canonical journal, the lane
  kernels launched in the children only, serve wall, the children's
  start wall and the 2-shard sparse run's busy share (its children
  profile their own device work); and a 2-shard process run whose child
  is killed at tick 40, respawned and restored with no score gap; each
  run's wall split into serve wall, children's start and the rest;
- the deferred-commit tick, the elastic policy and state tiering (phase
  22): the serve bench deployment, RCA on, at pipeline 2 and 1, each
  synchronous and deferred, and 2 thread shards deferred, every run
  holding the pins, the synchronous run's states, alerts, verdicts and
  decisions and the CPU twin's journal, with ``commit_defer_wall_s`` > 0,
  lane dispatches still in flight at the depth-2 barriers (each
  barrier's in-flight, finished and drain wall printed) and the lane
  kernel launched from the shard streams only; the JAX
  bench's elastic legs (0.6x load, ``surge@30:factor=4:ticks=15``)
  static and ``auto`` on 1-2 thread shards and 1-2 process children,
  each elastic run scaling up and down, equal to the static run and
  scaling on the CPU twin's schedule; the JAX bench's tiering pair (48
  tenants, hot 12) off, on and on again, every counter non-zero and the
  CPU twin's, states, alerts and SLO the off run's, the rerun's journal
  the first's (both CPU twins in a spawned process beside the card's
  work);
- the live feed and the multimodal sidecar (phase 23): the JAX bench's
  live-feed leg (the dogfood loop: the port's own ``/metrics`` scraped
  into the tick, 4 tenants, 10 s) live and recorded, replayed on the
  card and by a CPU twin in a spawned process, equal on the canonical
  journal, states, alerts, latency and shed; the feed at the TT
  deployment's full width (a Jaeger stub serving one TT fault experiment
  at 400 traces, 45 tenants and services, 60 s windows, the anchor pinned
  to the corpus start) live, card replay and CPU-twin replay, equal
  gap counts too; the sidecar (the 13 TT labels one tenant each, logs,
  metrics and API, 60 s ticks) held to the port's sequential
  ``MultimodalDetector`` on the card and to the CPU twin, supervision
  and the policy off; each run's serve wall, the traffic's own wall,
  polls / samples / spans / gaps, launches, and a profiled busy share;
- the perf and census observatories (phase 24) at the serve bench
  deployment, RCA on: perf off and on in two alternating turns, the
  pins and the CPU twin's journal on every run, decisions equal off /
  on, events recorded and none dropped, the timeline's dispatch and fold
  stamps summing to the report's legs, the wait, the headroom and the
  bubble fractions printed with the overhead's median; the same at 2
  thread shards (shard tags, a Chrome trace written and parsed back, one
  lane a shard and scratch slot) and with the deferred commit
  (``deferred`` stamps); the census every 8 ticks, its pool reconciled,
  its stream byte-equal to a rerun's and to a CPU twin's (a spawned
  process), its hot-set document the twin's and its eleven gauges in
  the scrape journal; the registered-fleet sweep (1e3, 1e4 and 1e5
  registered, 1e3 hot, 8 ticks) and the tiered one (plus 1e6, hot 1000,
  demotion after 2 idle ticks), each row's bytes the twin's, beside the
  JAX engine's committed CPU capture of the sweep;
- the parallel planes (phase 25) at world size 1 over NCCL (one card;
  NCCL puts no two ranks on one GPU): a mesh or launch past the attached
  cards refused before any spawn; each collective on card tensors
  returning its input; the sharded replay of the bench corpus (the dense
  kernel's cluster fold and the HLL kernel, replicated and scattered)
  equal to ``make_replay_fn``'s, its spans/s beside the single card's and
  the NCCL merge's device time; the detector on the sharded plane over
  phase 5's 13 labels equal to phase 5; the serve mesh plane at the serve
  bench deployment (RCA off) holding the admission pins, every tenant's
  alerts equal to phase 8's unfused run's; no plain version called on any
  of them; ``replay`` and ``stream --devices 1`` through the CLI and
  ``replay --devices 2`` refused;
- the rest of the parallel planes (phase 26) at world size 1 over NCCL:
  ``graft_entry.dryrun_multichip(1)`` (every plane of the JAX dry run at
  its shapes) with the dense fold's and the HLL kernel's launches counted
  and no plain version called; at full width on phase 14's TT batch, the
  dp x tp train step of ``gcn``, ``moe`` and ``linegraph`` on a ``(1,
  1)`` mesh against ``train_loop``, the pipeline step at
  ``PipelineConfig()`` against ``reference_forward``'s, the
  sequence-parallel transformer (ring, Ulysses) against the one-card
  forward, the sequence-parallel scan over one day of 15 s windows, and
  the hybrid mesh's checks under ``torchrun --standalone``;
- the device decisions (phase 27): the bounded probe of the card;
  ``with_cpu_failover`` re-raising a loss without
  ``allow``, retrying it once on the CPU with it, and leaving a real out
  of memory, an illegal-address error and a real ``nvcc`` failure
  alone; ``train_rca_resilient(failover=True)`` clean and after a loss
  injected past its first save (equal to the CPU run resumed from that
  checkpoint); a small ``severity_sweep(failover=True)`` clean and with
  a loss at ``gcn``; both engine knobs (the card's values launch the
  kernels with the unset run's results, the JAX formulations' values
  are refused before any launch); ``rca --cpu-failover`` and
  ``ANOMOD_PLATFORM=cpu detect`` through the CLI, the same ``rca``
  call timed with the probe and without it.  The earlier phases' CLI
  calls run with ``ANOMOD_SKIP_PROBE=1`` (:func:`probe_skipped`);
- the fault and workload planes (phase 28), host only: ``chaos`` for
  all 26 labels in YAML and JSON, ``deploy`` (TT and its flags, the
  secrets, SN up and down), ``scenario`` bare, under a TT Chaos Mesh and
  a TT ChaosBlade fault and refused for an SN one, ``monitor`` active
  (with wrk2 traffic, into a temporary artifact tree) and passive, all
  through the CLI in this process with no probe skipped, then
  ``run_with_recovery``, a TT suite under an injected fault and a spec's
  endpoint pool: each output's sha256 equal to the JAX package's
  (:data:`FAULT_PLANE_DIGESTS`), with ``yaml`` blocked, no probe, no
  launch and no device memory taken.

The serve runs of phases 8 and 16-23 run with the flight recorder on and
supervised (a checkpoint every 32 ticks), the engine's defaults.

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
# f32 operations per span per fold beside its accumulating adds (9+H in
# the dense fold, hi and lo apart; 6+H in the sorted one): 9 bf16
# roundings and subtractions for the hi/lo split, 3 for the bucket
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


@contextlib.contextmanager
def probe_skipped():
    """``ANOMOD_SKIP_PROBE=1`` around an earlier phase's CLI call: each
    probe is a subprocess importing torch (7.8-9.3 s each on an H100
    host, 42.6 s for the five calls of phases 11, 20 and 25), and the
    script runs near its time limit; phase 27 times the probe inside a
    CLI call."""
    import os
    prev = os.environ.get("ANOMOD_SKIP_PROBE")
    os.environ["ANOMOD_SKIP_PROBE"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("ANOMOD_SKIP_PROBE", None)
        else:
            os.environ["ANOMOD_SKIP_PROBE"] = prev


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


def bound(n_spans, n_out, n_dead=0, n_cols=6 + H):
    """(bound_ms, bound_by) of one fold of ``n_spans`` real spans: each
    input byte read once (sid + 6 planes, 28 B a span), each output byte
    written once, against the f32 operations (``n_cols`` accumulating
    adds a span).  Padding that a kernel's staging adds is not part of the
    function, so it is not counted.  ``n_dead`` dead rows that are part
    of the function's input (a lane's dead tail) cost their 4 B sid
    alone: it is what tells them dead."""
    t_bytes = (n_spans * 28 + n_dead * 4 + n_out * 4) / PEAK_BYTES_PER_S
    t_ops = n_spans * (n_cols + OPS_PER_SPAN_EXTRA) / PEAK_F32_OPS_PER_S
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
#: the online-RCA pins of every committed JAX serve capture at the bench
#: seed (RCA on)
RCA_PINS = {"n_rca_runs": 58, "rca_eligible": 1,
            "rca_topk_hits": {1: 1, 3: 1, 5: 1}}
#: RCA verdict scores on the card against the CPU twin's: the scorer adds
#: in one written-out order on both, so only the 6-decimal rounding of a
#: last-bit difference could show
ATOL_RCA_SCORE = 2e-6
#: self-scrape alert scores, the kernel's scoring against the plain
#: fold's on the card (``report_gap``): both sum each moment's hi and lo
#: halves apart, the kernel in its atomics' order, and a near-constant
#: series' variance lifts the last-bit differences of those sums into z.
#: Read on an H100 (20 kernel scorings of the stall registry): 0 in all
#: twenty with the halves apart (0.0030-0.0231 when each row added
#: ``hi + lo``); none on the serve journal, which raises no alert
RTOL_SELFSCRAPE_CARD = 0.04
#: kernel scorings of each self-scrape capture held to the plain fold's
#: (the kernel's atomics add in another order each launch)
SELFSCRAPE_REPEATS = 20
#: the quality sweep on the card (phase 18): every row the CLI trains by
#: default, the stream row and the z-score baseline, at full strength and
#: at the hard point (severity 0.12 with the CLI's noise 0.5 and two
#: confounders); every other argument at the CLI's defaults but the seeds:
#: at its 6 train and 3 eval seeds the script ran 464-471 s, past its
#: 420 s aim, so 3 train seeds (one a severity third) and 2 eval seeds
SWEEP_MODELS = ("zscore", "stream", "gcn", "gat", "sage", "temporal", "lru",
                "transformer", "moe")
SWEEP_SEVERITIES = (1.0, 0.12)
SWEEP_SEEDS = dict(train_seeds=range(3), eval_seeds=range(100, 102))
#: the edge-aware shift sweep (phase 19)
SHIFT_MODELS = ("linegraph", "transformer")
SHIFT_SHIFTS = ("in-dist", "edge-locus")
#: epochs of each learned family trained from one draw on the card and on
#: the CPU, every loss within RTOL_SWEEP_LOSS of the first loss's
#: magnitude: f32 on both (TF32 off), sums in each device's reduction
#: order, and the rounding of those sums scales with their terms, which
#: stay at the first epoch's scale while the loss itself falls toward 0
#: as a model fits the batch (at 3 train seeds the transformer's reached
#: 6e-4 by epoch 20, where the two devices' 1.5e-7 apart read 2.5e-4 of
#: that epoch's own loss).  Read on an H100: the transformer's twenty at
#: most 1.5e-6 of its first loss
SWEEP_LOSS_EPOCHS = 20
RTOL_SWEEP_LOSS = 1e-5


@contextlib.contextmanager
def host_walls(cls, name):
    """Record the host wall (s) of every call of method ``cls.name`` made
    inside the block, in a list the block receives."""
    orig = getattr(cls, name)
    walls = []

    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            walls.append(time.perf_counter() - t0)
    setattr(cls, name, wrapper)
    try:
        yield walls
    finally:
        setattr(cls, name, orig)


def serve_split():
    """Record the serve tick's host legs inside the block: the bucket
    plan (``BucketRunner.stage_plan``), the slot fill with its waits for
    the slot's last dispatch (``_fill_slot``), the fill proper (native
    ``StagePlan.stage`` or the interpreter's ``_fill_slot_py``) and the
    admission offer and drain.  The block receives name -> walls."""
    from anomod_torch.io.native import StagePlan
    from anomod_torch.serve.batcher import BucketRunner
    from anomod_torch.serve.queues import AdmissionController
    legs = (("plan", BucketRunner, "stage_plan"),
            ("slot", BucketRunner, "_fill_slot"),
            ("fill_native", StagePlan, "stage"),
            ("fill_py", BucketRunner, "_fill_slot_py"),
            ("offer", AdmissionController, "offer"),
            ("drain", AdmissionController, "drain"))
    stack = contextlib.ExitStack()
    walls = {name: stack.enter_context(host_walls(cls, meth))
             for name, cls, meth in legs}
    return stack, walls


def split_sums(walls, rep) -> dict:
    """Calls and summed host wall (s) of each leg, beside the run's serve
    wall and stage leg."""
    out = {k: {"calls": len(v), "sum_s": sum(v)} for k, v in walls.items()}
    out["serve_wall_s"] = rep.serve_wall_s
    out["stage_wall_s"] = rep.stage_wall_s
    return out


def field_diff(a: dict, b: dict) -> dict:
    """``{key: (a's value, b's value)}`` of every key the two differ on."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)}


def recovery_events(eng) -> list:
    """The supervisor's recovery events in an engine's flight journal."""
    if eng.flight_recorder is None:
        return []
    return [ev for t in eng.flight_recorder.records()
            for ev in t.get("recovery", ())]


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


def same_value(a, b) -> bool:
    """Equal modal batches (arrays by dtype, shape and bytes), tuples,
    lists and plain values."""
    import dataclasses

    import numpy as np
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    if hasattr(a, "_fields"):
        return type(a) is type(b) and all(
            same_value(getattr(a, f), getattr(b, f)) for f in a._fields)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_value, a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def data_phase(card) -> dict:
    """Phase 5b: the data layer.  ``load_corpus`` of both testbeds, all
    five modalities at 50 traces, through a temporary ingest cache (the
    ``ANOMOD_CACHE_DIR`` the settings read), cold then warm; warm must
    equal cold byte for byte and the traces ``synth.generate_spans``."""
    import os
    import tempfile

    from anomod_torch import labels as labels_mod
    from anomod_torch import synth
    from anomod_torch.config import Config
    from anomod_torch.io import cache, dataset

    fields = ("spans", "metrics", "logs", "log_summaries", "api", "coverage")
    out = {}
    prev = os.environ.get("ANOMOD_CACHE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ANOMOD_CACHE_DIR"] = tmp
        try:
            cfg = Config()
            check(cfg.cache_dir == Path(tmp) and cfg.ingest_workers == 0,
                  f"data: settings {cfg}")
            for testbed in ("TT", "SN"):
                walls, runs = [], []
                for leg in ("cold", "warm"):
                    cache.reset_stats()
                    t0 = time.perf_counter()
                    runs.append(dataset.load_corpus(testbed, cfg=cfg,
                                                    n_synth_traces=50))
                    walls.append(time.perf_counter() - t0)
                    st = cache.stats()
                    want = (0, 65, 65) if leg == "cold" else (65, 0, 0)
                    check((st.hits, st.misses, st.stores) == want,
                          f"data {testbed} {leg}: cache {st}")
                cold, warm = runs
                check(len(cold) == 13 and all(e.synthetic for e in cold),
                      f"data {testbed}: {len(cold)} experiments")
                for a, b, label in zip(cold, warm,
                                       labels_mod.labels_for_testbed(testbed)):
                    for f in fields:
                        check(same_value(getattr(a, f), getattr(b, f)),
                              f"data {testbed} {a.name}: warm {f} != cold")
                    check(same_value(a.spans, synth.generate_spans(
                        label, n_traces=50)),
                          f"data {testbed} {a.name}: traces != generate_spans")
                n_spans = sum(e.spans.n_spans for e in cold)
                log(f"[5b] data load_corpus({testbed!r}), 13 experiments x 5 "
                    f"modalities at 50 traces ({n_spans} spans): cold "
                    f"{walls[0]:.4f} s, warm {walls[1]:.4f} s (host walls, "
                    f"the card idle; on {card}); warm == cold byte for byte, "
                    f"traces == synth.generate_spans")
                out[testbed] = {"cold_s": walls[0], "warm_s": walls[1],
                                "n_spans": n_spans}
        finally:
            if prev is None:
                os.environ.pop("ANOMOD_CACHE_DIR", None)
            else:
                os.environ["ANOMOD_CACHE_DIR"] = prev
    return {"data_load_corpus_s": out}


#: phase 8's variants on the host's plain versions: they run in a spawned
#: process beside the card's variants (:func:`serve_cpu_twins`)
SERVE_CPU_VARIANTS = (("cpu plain", dict(device="cpu")),
                      ("unfused cpu plain", dict(fuse=False, device="cpu")))


def serve_cpu_twins() -> dict:
    """Phase 8's CPU variants, run in a spawned process: for each its
    report, fingerprint, drain engine and call wall.  One torch thread
    (:func:`census_cpu_twin` says why)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    torch.set_num_threads(1)
    from anomod_torch.serve.engine import run_power_law
    out = {}
    for name, variant in SERVE_CPU_VARIANTS:
        t0 = time.perf_counter()
        e2, r2 = run_power_law(**dict(SERVE_KW, **variant))
        out[name] = (r2, serve_fingerprint(e2), e2.admission.drain_engine,
                     time.perf_counter() - t0)
    return out


def serve_phases(dev, card) -> dict:
    """Phases 6-8: the serve kernels against their plain versions, then
    the serve path at the bench deployment with its launches counted.
    Returns the summary fields and the two kernels' report entries.  The
    CPU variants of phase 8 run in a spawned process from the start."""
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return _serve_phases(dev, card, pool.apply_async(serve_cpu_twins))


def _serve_phases(dev, card, twin_job) -> dict:
    """:func:`serve_phases`, with ``twin_job`` the CPU variants' result
    (:func:`serve_cpu_twins`)."""
    import dataclasses

    import numpy as np
    import torch
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.replay import TenantStatePool, stage_columns_fused
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
        pay = rk.replay_payload(p, H).reshape(L * W, -1)
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
    pay = rk.replay_payload(p, H).reshape(32 * 4096, -1)
    idx = (torch.arange(32, device=dev)[:, None] * (SW + 1)
           + s.long()).reshape(-1)
    acc = torch.zeros((32 * (SW + 1), pay.shape[1]), device=dev)
    lane_t = timed(lambda: sk.lane_delta(s, p, SW, H),
                   lambda: acc.index_add_(0, idx, pay))
    live = int((s < SW).sum())
    lane_bound, lane_by = bound(live, 32 * SW * (6 + H), n_cols=9 + H,
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
    # the wrapper takes host indices by value; T = 1200 is above one launch's parameter capacity (GATHER_PAIRS)
    gather_in, gather_launches = {}, {}
    for T in (1, 64, 256, 1200):
        s_np = rng.integers(0, P + 1, T).astype(np.int32)
        c_np = rng.integers(0, Wn, T).astype(np.int32)
        s_np[0], c_np[-1] = 0, Wn - 1       # the dead slot, the last column
        s_np[T // 2] = s_np[min(1, T - 1)]  # a duplicated slot
        gather_in[T] = torch.from_numpy(s_np), torch.from_numpy(c_np)
        before = sk.launches["window_gather"]
        got = sk.window_gather(pool, *gather_in[T], S, Wn)
        torch.cuda.synchronize()
        gather_launches[T] = sk.launches["window_gather"] - before
        check(torch.equal(got, sk.window_gather_plain(
            pool, torch.from_numpy(s_np).to(dev),
            torch.from_numpy(c_np).to(dev), S, Wn)),
            f"window_gather T={T}: differs from advanced indexing")
    log(f"[7] window_gather: bit-identical at T = 1, 64, 256, 1200 (slot 0, "
        f"a duplicated slot, column {Wn - 1}; host indices); launches a "
        f"call "
        f"{gather_launches}")
    slots, wcols = gather_in[256]
    dslots, dcols = slots.to(dev), wcols.to(dev)
    gather_plain_ms = cuda_ms(lambda: sk.window_gather_plain(
        pool, dslots, dcols, S, Wn))
    rows = pool.view(P + 1, S, Wn, 6)
    si, sv, ci = (dslots.long()[:, None], torch.arange(S, device=dev)[None],
                  dcols.long()[:, None])
    gather_t = timed(lambda: sk.window_gather(pool, slots, wcols, S, Wn),
                     lambda: rows[si, sv, ci])
    gather_ms = {T: cuda_ms(lambda: sk.window_gather(pool, *a, S, Wn))
                 for T, a in gather_in.items()}
    # a pure copy: T*S*F f32 read and written, plus the two index arrays
    gather_bound = (2 * 256 * S * 6 * 4 + 256 * 8) / PEAK_BYTES_PER_S * 1e3
    log(f"[7] window_gather T=256: kernel {gather_t['ms']:.4f} ms, plain "
        f"{gather_plain_ms:.4f} ms, indexing {gather_t['library_ms']:.4f} "
        f"ms, bound {gather_bound:.6f} ms (bytes), "
        f"{gather_launches[256]} launch a call, on {card}; unspun: "
        f"{gather_t['ms_unspun']:.4f}, {gather_t['library_ms_unspun']:.4f}; "
        f"kernel ms by T {gather_ms}, launches by T {gather_launches}")

    # -- phase 8: the serve path at the bench deployment ------------------
    sk.reset_launches()
    rk.reset_launches()
    t0 = time.perf_counter()
    stack, walls = serve_split()
    with stack, host_walls(TenantStatePool, "gather_window") as gather_walls:
        eng, rep = run_power_law(device=dev, **SERVE_KW)
    run_s = time.perf_counter() - t0
    check(rep.native_staging and eng.admission.drain_engine == "native"
          and rep.native_staged_dispatches == rep.fused_dispatches,
          "serve: the default run did not stage and drain natively")
    split = {"native": split_sums(walls, rep)}
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
    gather_host = {"calls": len(gather_walls),
                   "sum_s": sum(gather_walls),
                   "first_s": gather_walls[0] if gather_walls else None}
    log(f"[8] TenantStatePool.gather_window host wall: {gather_host['calls']}"
        f" calls, {gather_host['sum_s']:.6f} s summed (the first, the "
        f"pool's warm-up outside the serve wall, {gather_host['first_s']})")

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
    cpu_twins = {}
    cpu_variants = dict(SERVE_CPU_VARIANTS)
    for name, variant in (("pipeline=1", dict(pipeline=1)),
                          ("host state", dict(state="host")),
                          ("cpu plain", cpu_variants["cpu plain"]),
                          ("interpreter fill", dict(native_stage=False)),
                          ("heap drain", dict(drain_engine="heap")),
                          ("numpy drain", dict(drain_engine="numpy")),
                          ("interpreter/heap", dict(native_stage=False,
                                                    drain_engine="heap")),
                          ("native again", {}),
                          ("unfused", dict(fuse=False)),
                          ("unfused cpu plain",
                           cpu_variants["unfused cpu plain"])):
        t0 = time.perf_counter()
        if name in cpu_variants:
            # run in the spawned process since phase 6 began
            cpu_twins = cpu_twins or twin_job.get(timeout=900)
            r2, fp, drain, call_s = cpu_twins[name]
            where = (f"in its own process: call {call_s:.3f} s, waited "
                     f"{time.perf_counter() - t0:.3f} s")
        else:
            stack, walls = serve_split()
            with stack:
                e2, r2 = run_power_law(**dict(dict(SERVE_KW, device=dev),
                                              **variant))
            fp, drain = serve_fingerprint(e2), e2.admission.drain_engine
            where = f"call {time.perf_counter() - t0:.3f} s"
        if name in ("interpreter/heap", "native again"):
            split[name] = split_sums(walls, r2)
        # unfused runs push each batch alone, where the fused tick
        # coalesces a tenant's batches of one tick: staging plans and f32
        # sums regroup, as in the JAX package, so unfused is held to the
        # fused run's admission and SLO fields and to its own CPU twin
        fields = ADMISSION_FIELDS if name.startswith("unfused") \
            else decisions(rep)
        diff = [k for k in fields
                if getattr(r2, k) != getattr(rep, k)]
        check(not diff, f"serve {name}: report fields {diff} differ")
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
        check(drain == variant.get("drain_engine", "native")
              and r2.native_staging == variant.get("native_stage", True),
              f"serve {name}: engines {drain}, "
              f"native staging {r2.native_staging}")
        log(f"[8] serve {name}: {what}, equal "
            f"{'admission and SLO fields' if fields is ADMISSION_FIELDS else 'decisions'}"
            f"; serve wall {r2.serve_wall_s:.4f} s ({where})")

    for name, legs in split.items():
        log(f"[8] serve host split, {name} (s summed over calls, warm-up "
            f"fills included; slot = fill + waits for the slot's last "
            f"dispatch): " + ", ".join(
                f"{k} {v['sum_s']:.6f} ({v['calls']})" if isinstance(v, dict)
                else f"{k} {v}" for k, v in legs.items())
            + f" on {card}")

    from torch.profiler import ProfilerActivity, profile
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, rep_prof = run_power_law(device=dev, **SERVE_KW)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    per_kernel = kernel_device_ms(prof, ("lane_delta_kernel",
                                         "window_gather_kernel"))
    g_ms, g_n = per_kernel["window_gather_kernel"]
    gather_trace_ms = g_ms / g_n if g_n else None
    log(f"[8] serve trace by kernel (device ms, kernels in the trace): "
        f"{per_kernel}; window_gather {gather_trace_ms} ms a launch; "
        f"wrapper launches in the profiled run {dict(sk.launches)}; fused "
        f"dispatches by lane bucket {rep_prof.lanes_by_bucket}")
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
         "bound_by": "bytes", "launches_per_call": gather_launches,
         "ms_by_t": gather_ms, "serve_trace_ms_per_launch": gather_trace_ms,
         "serve_gather_window_host": gather_host, **gather_t},
    ]
    return {"kernels": kernels, "serve_spans_per_sec": spans_per_s,
            "serve_wall_s": rep.serve_wall_s,
            "serve_twin_walls_s": twins,
            "serve_host_split": split,
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
            "serve_device_busy_share": busy_share,
            # phase 25's oracle for the serve mesh plane (popped by main)
            "serve_unfused_alerts": {tid: fp_t[0]
                                     for tid, fp_t in unfused.items()}}


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
            acc = torch.zeros((sw + 1, rk.N_PAYLOAD + H), device=dev)
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
    import functools
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
    def hll_held(what, n_regs, it, ln, p, n_lanes, it_np, ln_np):
        """hll_update from zeroed registers: two launches identical, equal
        to the plain version and to the numpy oracle."""
        shape = (n_regs,) if ln is None else (n_lanes, n_regs)
        zero = torch.zeros(shape, dtype=torch.int32, device=dev)
        got = sk.hll_update(zero.clone(), it, ln, p)
        again = sk.hll_update(zero.clone(), it, ln, p)
        plain = sk.hll_update_plain(zero.clone(), it, ln, p)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"hll_update {what}: two launches "
              "differ")
        check(torch.equal(got, plain), f"hll_update {what}: differs from "
              "plain")
        check(np.array_equal(got.cpu().numpy().reshape(-1, n_regs),
                             hll_numpy(it_np, p, ln_np, n_lanes)),
              f"hll_update {what}: differs from the numpy oracle")

    items = torch.from_numpy(batch.trace.astype(np.int32)).to(dev)
    n_items = items.shape[0]
    hll_held("single p=10", 1 << 10, items, None, 10, 1, batch.trace, None)
    _, ech, _, _, _ = planes["edge"]
    esid = ech["sid"].reshape(-1)
    etid = ech["tid"].reshape(-1)
    E = ecfg.n_services
    elane = np.where(esid < ecfg.sw, np.clip(esid // ecfg.n_windows, 0,
                                             E - 1), E).astype(np.int32)
    e_items = torch.from_numpy(etid).to(dev)
    e_lane = torch.from_numpy(elane).to(dev)
    hll_held("edge plane p=8", 1 << 8, e_items, e_lane, 8, E, etid, elane)
    log(f"[10] hll_update: single sketch p=10 over {n_items} trace ids and "
        f"the edge plane p=8 over {E}+1 lanes ({etid.size} staged rows, "
        f"{int((elane == E).sum())} on the dead lane): registers equal to "
        "the plain version and the numpy oracle, two launches identical")
    # the ends: every row on the dead lane, every row on one register,
    # p = 16 (5.9 M registers), fewer rows than one block takes
    one_np = np.full_like(etid, etid[0])
    zero_lane = np.zeros_like(elane)
    dead_np = np.full_like(elane, E)
    hll_ends = {}
    for name, it_np, ln_np, p in (
            ("all dead p=8", etid, dead_np, 8),
            ("one register p=8", one_np, zero_lane, 8),
            ("edge plane p=16", etid, elane, 16),
            ("100 rows p=8", etid[:100], elane[:100], 8)):
        it = torch.from_numpy(np.ascontiguousarray(it_np)).to(dev)
        ln = torch.from_numpy(np.ascontiguousarray(ln_np)).to(dev)
        hll_held(name, 1 << p, it, ln, p, E, it_np, ln_np)
        regs = torch.zeros((E, 1 << p), dtype=torch.int32, device=dev)
        hll_ends[name] = cuda_ms(lambda: sk.hll_update(regs, it, ln, p))
    # the C entry alone, on the edge plane: by its direct path, by its
    # cluster copy as the wrapper plans it, and with every row dead
    entry = sk._lib().anomod_hll_update
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    regs_c = torch.zeros((E, 1 << 8), dtype=torch.int32, device=dev)
    dead = torch.from_numpy(dead_np).to(dev)

    def c_entry(ln, mid):
        args = (rk._ptr(e_items), rk._ptr(ln), e_items.shape[0], 8, E,
                rk._ptr(regs_c), *mid, n_sm, rk._stream(dev))
        check(entry(*args) == 0, "anomod_hll_update returned an error")
        return lambda: entry(*args)
    plan = sk.hll_plan(e_items.shape[0], E << 8, n_sm, functools.partial(
        sk._hll_cluster_capacity, torch.cuda.current_device()))
    hll_grid = plan._asdict()
    readings = {"direct": c_entry(e_lane, (0, 0)),
                "cluster copy": c_entry(e_lane, tuple(plan)),
                "all dead, cluster copy": c_entry(dead, tuple(plan))}
    hll_c_entry = {k: cuda_ms(f) for k, f in readings.items()}
    log(f"[10] hll_update ends (two launches identical, equal to plain and "
        f"the oracle), kernel ms: {hll_ends}; the C entry on the "
        f"edge plane, ms: {hll_c_entry} on {card}; edge-plane grid "
        f"{hll_grid}")
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
    sketch_trace = kernel_device_ms(prof, ("tdigest_reduce_kernel",
                                           "hll_update_kernel"))
    log(f"[11] sketch path trace: device busy "
        f"{'not measured (no device events)' if busy is None else f'{busy:.3f} ms'}"
        f" in a {prof_s:.3f} s profiled wall; busy share "
        f"{busy_share if busy_share is None else f'{busy_share:.4g}'}; by "
        f"kernel (device ms, kernels in the trace) {sketch_trace}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), probe_skipped():
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
              dict(hll_times["edge p=8"], ends=hll_ends,
                   sketch_trace_ms=sketch_trace["hll_update_kernel"][0],
                   c_entry_ms=hll_c_entry,
                   grid=hll_grid), 0.0)]
    return {"kernels": kernels, "sketch_path_wall_s": path_s,
            "sketch_device_busy_ms": busy,
            "sketch_profiled_wall_s": prof_s,
            "sketch_device_busy_share": busy_share,
            "sketch_kernel_device_ms": sketch_trace,
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


#: detect scores: the same f32 expression on the card and in numpy; an
#: expm1 or a division may round in another last bit
RTOL_DETECT = 1e-5
#: the first epoch's loss, card against CPU from one generator draw
RTOL_LOSS = 1e-5
RCA_EPOCHS = 300


def detect_cpu_twin() -> dict:
    """Phase 13's CPU runs of ``evaluate_corpus`` (both testbeds, 100
    traces), one torch thread: for each testbed the result and its wall.
    They run in the spawned process started before phase 5b, ahead of
    :func:`rca_cpu_twins` (a process of their own would start slower
    than the 0.1 s they take)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    torch.set_num_threads(1)
    from anomod_torch import detect, labels, synth
    out = {}
    for testbed in ("TT", "SN"):
        corpus = [synth.generate_experiment(l, n_traces=100)
                  for l in labels.labels_for_testbed(testbed)]
        t0 = time.perf_counter()
        want = detect.evaluate_corpus(corpus, device="cpu")
        out[testbed] = (want, time.perf_counter() - t0)
    return out


def detect_phase(dev, card, twin_job) -> dict:
    """Phase 13: ``evaluate_corpus`` of both testbeds at the CLI's 100
    traces, the scores on the card and by the numpy oracle: summary rows
    equal, scores within ``RTOL_DETECT``, each ranking equal to the
    oracle's but for services whose oracle scores differ by less than
    that.  ``twin_job`` is the CPU runs' result (:func:`detect_cpu_twin`,
    in a spawned process)."""
    import numpy as np
    import torch
    from anomod_torch import detect, labels, synth

    out = {}
    twins = None
    for testbed in ("TT", "SN"):
        t0 = time.perf_counter()
        corpus = [synth.generate_experiment(l, n_traces=100)
                  for l in labels.labels_for_testbed(testbed)]
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = detect.evaluate_corpus(corpus, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if twins is None:
            twins = twin_job.get()
        wait_s = time.perf_counter() - t0
        want, oracle_s = twins[testbed]
        rows = ("top1", "top3", "top5", "detection_accuracy", "n_rca_cases")
        check([getattr(got, k) for k in rows]
              == [getattr(want, k) for k in rows],
              f"detect {testbed}: summary rows differ")
        check(detect.per_level_breakdown(got)
              == detect.per_level_breakdown(want),
              f"detect {testbed}: per-level rows differ")
        # the pinned service table and the baseline of evaluate_corpus
        services = tuple(dict.fromkeys(
            s for e in corpus if e.spans is not None
            for s in e.spans.services))
        normal = next(e for e in corpus if not
                      labels.label_for(e.name).is_anomaly)
        base = detect.extract_features(normal, services).x
        swapped, err = 0, 0.0
        for exp, g, w in zip(corpus, got.results, want.results):
            check((g.experiment, g.target_service, g.is_anomaly_true)
                  == (w.experiment, w.target_service, w.is_anomaly_true),
                  f"detect {testbed}: result rows out of step")
            feat = detect.extract_features(exp, services).x
            oracle = detect.service_scores_numpy(feat, base)
            on_card = detect.service_scores(feat, base, dev).cpu().numpy()
            check(np.allclose(on_card, oracle, rtol=RTOL_DETECT, atol=1e-6),
                  f"detect {testbed} {exp.name}: scores outside rtol "
                  f"{RTOL_DETECT}")
            err = max(err, float(np.abs(on_card - oracle).max()))
            check(abs(g.score - w.score) <= RTOL_DETECT * abs(w.score),
                  f"detect {testbed} {exp.name}: experiment score")
            if g.ranked_services != w.ranked_services:
                # only near-ties may trade places: the card's order must
                # be a descending order of the oracle's scores within rtol
                by = dict(zip(services, oracle))
                seq = [by[s] for s in g.ranked_services]
                check(all(b <= a + RTOL_DETECT * max(abs(a), abs(b))
                          for a, b in zip(seq, seq[1:])),
                      f"detect {testbed} {exp.name}: ranking differs "
                      f"beyond near-ties")
                swapped += 1
        out[testbed] = dict(top1=got.top1, top3=got.top3, top5=got.top5,
                            detection_accuracy=got.detection_accuracy,
                            n_rca_cases=got.n_rca_cases,
                            card_wall_s=card_s, oracle_wall_s=oracle_s,
                            oracle_wait_s=wait_s,
                            corpus_gen_s=gen_s, max_abs_err=err,
                            rankings_with_near_tie_swaps=swapped)
        log(f"[13] detect {testbed} (100 traces): top1 {got.top1:.4f} top3 "
            f"{got.top3:.4f} top5 {got.top5:.4f} detection accuracy "
            f"{got.detection_accuracy:.4f} over {got.n_rca_cases} cases; "
            f"rows equal to the numpy oracle (scores max_abs_err "
            f"{err:.3g}, {swapped} rankings with near-tie swaps); "
            f"evaluate_corpus wall {card_s:.3f} s on the "
            f"card, {oracle_s:.3f} s numpy in a spawned process (waited "
            f"{wait_s:.3f} s; corpus generation {gen_s:.3f} s) on {card}")
    return {"detect": out}


#: phase 14's learned families, each trained on the card and on the CPU
RCA_FAMILIES = ("gcn", "sage", "gat")


def rca_cpu_twins() -> dict:
    """Phases 14's and 16's CPU runs, in a spawned process started before
    phase 5b: phase 14's three trainings from the same dataset and draws
    (two torch threads), then phase 16's serve run with RCA on (one
    thread: :func:`census_cpu_twin` says why).  Each with its wall."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    from anomod_torch import rca
    from anomod_torch.serve.engine import run_power_law
    torch.set_num_threads(2)
    train, evalb = rca.prepare_data("TT", range(6), range(100, 102), 80)
    out = {}
    for name in RCA_FAMILIES:
        model = rca.init_model(name, train["x"].shape[-1], seed=0,
                               device=torch.device("cpu"))
        t0 = time.perf_counter()
        r = rca.fit(name, train, evalb, model, epochs=RCA_EPOCHS,
                    meta={"model": name, "testbed": "TT"})
        r.wall_s, r.params = time.perf_counter() - t0, None
        out[name] = r
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    e_cpu, r_cpu = run_power_law(device="cpu", rca=True, **SERVE_KW)
    out["serve"] = ([v.to_dict() for v in e_cpu.rca_verdicts],
                    e_cpu.flight_recorder.canonical_bytes(),
                    r_cpu.serve_wall_s, time.perf_counter() - t0)
    return out


def rca_phase(dev, card, twins) -> dict:
    """Phase 14: RCA training at full width on TT (the CLI's 300 epochs, 6
    train seeds, 2 eval seeds, 80 traces), ``gcn``, ``sage`` and ``gat``,
    each from one ``torch.Generator`` draw on the card and on the CPU: the
    first epoch's loss within ``RTOL_LOSS``, the card's held-out top-1
    within one eval case of the CPU's; a slice of epochs traced for the
    device-busy share; and a GCN run resumed from a checkpoint written
    here equal to the straight run, bit for bit.  The CPU trainings come
    from ``twins`` (:func:`rca_cpu_twins`)."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch import rca

    check(not torch.backends.cuda.matmul.allow_tf32,
          "rca: TF32 matmuls are on")
    t0 = time.perf_counter()
    train, evalb = rca.prepare_data("TT", range(6), range(100, 102), 80)
    build_s = time.perf_counter() - t0
    F = train["x"].shape[-1]
    log(f"[14] TT dataset: train {tuple(train['x'].shape)}, eval "
        f"{tuple(evalb['x'].shape)}, edges {train['edge_src'].shape[1]}, "
        f"built in {build_s:.3f} s on the host")
    out = {"dataset_build_s": build_s}
    meta = {"model": None, "testbed": "TT"}
    straight_gcn = None
    for name in RCA_FAMILIES:
        meta["model"] = name
        model = rca.init_model(name, F, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rca.fit(name, train, evalb, model, epochs=RCA_EPOCHS,
                      meta=meta)
        torch.cuda.synchronize()
        got.wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = twins.get(timeout=900)[name]
        wait_s = time.perf_counter() - t0
        check(abs(got.losses[0] - want.losses[0])
              <= RTOL_LOSS * abs(want.losses[0]),
              f"rca {name}: first-epoch loss {got.losses[0]} on the card "
              f"vs {want.losses[0]} on the CPU")
        check(abs(got.top1 - want.top1) * want.n_eval <= 1 + 1e-9,
              f"rca {name}: top-1 {got.top1} on the card vs {want.top1}")
        # a slice of epochs under the profiler: device busy / wall
        model = rca.init_model(name, F, seed=0, device=dev)
        opt = rca.make_optimizer(model)
        batch = rca.to_device(train, dev)
        rca.train_loop(name, model, opt, batch, 0, 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rca.train_loop(name, model, opt, batch, 0, 50)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        busy = device_busy_ms(prof)
        n_kernels = sum(1 for e in prof.events()
                        if getattr(e, "device_type", None)
                        == DeviceType.CUDA)
        share = None if busy is None else busy / 1e3 / prof_s
        every = {ep: (got.losses[ep], want.losses[ep])
                 for ep in range(0, RCA_EPOCHS, 50)}
        out[name] = dict(
            first_loss=[got.losses[0], want.losses[0]],
            loss_every_50=every,
            final_loss=[got.losses[-1], want.losses[-1]],
            top1=[got.top1, want.top1], top3=[got.top3, want.top3],
            auc=[got.detection_auc, want.detection_auc],
            n_eval=got.n_eval, train_wall_s=[got.wall_s, want.wall_s],
            ms_per_epoch=[got.wall_s / RCA_EPOCHS * 1e3,
                          want.wall_s / RCA_EPOCHS * 1e3],
            profiled_ms_per_epoch=prof_s / 50 * 1e3,
            device_busy_ms_50_epochs=busy, device_events_50_epochs=n_kernels,
            device_busy_share=share)
        log(f"[14] rca {name}: loss [card, cpu] every 50 epochs {every}; "
            f"top1 {got.top1:.4f} / {want.top1:.4f}, top3 {got.top3:.4f} / "
            f"{want.top3:.4f}, AUC {got.detection_auc:.4f} / "
            f"{want.detection_auc:.4f} over {got.n_eval} cases; train wall "
            f"(fit: copy, {RCA_EPOCHS} epochs, eval) {got.wall_s:.3f} s on "
            f"the card ({got.wall_s / RCA_EPOCHS * 1e3:.3f} ms an epoch), "
            f"{want.wall_s:.3f} s on the CPU (its own process, two "
            f"threads, {wait_s:.3f} s waited); 50 traced epochs "
            f"{prof_s / 50 * 1e3:.3f} ms each, device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'} over "
            f"{n_kernels} device events, busy share "
            f"{share if share is None else f'{share:.4g}'} on {card}")
        if name == "gcn":
            straight_gcn = got
    # --resume: half the epochs with a checkpoint, then resumed to the end
    meta["model"] = "gcn"
    with tempfile.TemporaryDirectory() as tmp:
        half = rca.fit("gcn", train, evalb,
                       rca.init_model("gcn", F, seed=0, device=dev),
                       epochs=RCA_EPOCHS // 2, checkpoint_dir=tmp,
                       meta=meta)
        resumed = rca.fit("gcn", train, evalb,
                          rca.init_model("gcn", F, seed=1, device=dev),
                          epochs=RCA_EPOCHS, checkpoint_dir=tmp,
                          resume=True, meta=meta)
    same_params = all(torch.equal(v, resumed.params[k])
                      for k, v in straight_gcn.params.items())
    check(half.losses + resumed.losses == straight_gcn.losses
          and same_params
          and (resumed.top1, resumed.top3, resumed.detection_auc)
          == (straight_gcn.top1, straight_gcn.top3,
              straight_gcn.detection_auc),
          "rca gcn: the resumed run differs from the straight run")
    log(f"[14] rca gcn --resume at epoch {RCA_EPOCHS // 2}: losses, "
        f"parameters and held-out metrics equal to the straight run, bit "
        f"for bit")
    out["resume_equals_straight"] = True
    # phase 26's full-width batch (popped by main)
    return {"rca": out, "rca_train_batch": train}


def multimodal_phase(dev, card, plain_factory) -> dict:
    """Phase 15: ``stream_quality("TT", 400, multimodal=True)`` on the
    card, its ``dense_slice_fold`` launches counted, held to the same run
    with the plain fold on the card (ranked lists, first-alert windows,
    alert lists); then traced for the device-busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.stream import stream_quality

    rk.reset_launches()
    t0 = time.perf_counter()
    rows = stream_quality("TT", n_traces=400, seed=0, multimodal=True,
                          device=dev)
    wall_s = time.perf_counter() - t0
    launches = dict(rk.launches)
    plain_rows = stream_quality("TT", n_traces=400, seed=0, multimodal=True,
                                device=dev, replay_factory=plain_factory)
    check(len(rows) == 13, f"multimodal: {len(rows)} labels, expected 13")
    hits = []
    for r, p in zip(rows, plain_rows):
        check(r["ranked"] == p["ranked"],
              f"multimodal {r['experiment']}: ranked lists differ")
        check(r["first_alert_window"] == p["first_alert_window"],
              f"multimodal {r['experiment']}: first alert windows differ")
        check([(a.window, a.service, a.evidence) for a in r["alerts"]]
              == [(a.window, a.service, a.evidence) for a in p["alerts"]],
              f"multimodal {r['experiment']}: alert lists differ")
        if "top1_hit" in r:
            hits.append(r["top1_hit"])
        log(f"[15] {r['experiment']}: top1={r['ranked'][:1]} target="
            f"{r['target_service'] or '-'} hit={r.get('top1_hit')} "
            f"alerts={r['n_alerts']} (evidence "
            f"{sorted({a.evidence for a in r['alerts']})})")
    check(launches["replay_dense"] > 0,
          "multimodal: dense_slice_fold was not launched")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_quality("TT", n_traces=400, seed=0, multimodal=True,
                       device=dev)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    share = None if busy is None else busy / 1e3 / prof_s
    dense = {n: v for n, v in kernel_device_ms(prof, DENSE_KERNELS).items()
             if v[1]}
    log(f"[15] multimodal stream trace by kernel (device ms, kernels in "
        f"the trace): {dense}")
    log(f"[15] multimodal stream top-1 {sum(hits)}/{len(hits)} in "
        f"{wall_s:.3f} s (corpus generation included); dense_slice_fold "
        f"launches {launches['replay_dense']} (all launches {launches}); "
        f"equal to the plain fold on the card; traced: device busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms'} in "
        f"{prof_s:.3f} s, share {share if share is None else f'{share:.4g}'}"
        f" on {card}")
    return {"multimodal_stream": dict(
        top1=sum(hits) / len(hits), wall_s=wall_s,
        dense_launches=launches["replay_dense"], dense_trace_ms=dense,
        device_busy_ms=busy,
        profiled_wall_s=prof_s, device_busy_share=share)}


def rca_serve_phase(dev, card, twins) -> dict:
    """Phase 16: online RCA at the serve bench deployment (phase 8's,
    nothing cut).  RCA off, then on, on the card: the on-run holds the
    decision pins, equals the off-run's states and alerts byte for byte
    and holds the JAX captures' RCA pins; its verdict stream equals the
    CPU twin's; one RCA run is traced for its device events."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch.obs.registry import (Registry, get_registry,
                                           set_registry)
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve.engine import (RCA_REPORT_FIELDS,
                                           VARIANT_REPORT_FIELDS,
                                           run_power_law)

    def decisions(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS + RCA_REPORT_FIELDS
                and k != "device"}
    e_off, r_off = run_power_law(device=dev, rca=False, **SERVE_KW)
    reg = Registry(enabled=True)
    prev = get_registry()
    set_registry(reg)
    try:
        sk.reset_launches()
        e_on, r_on = run_power_law(device=dev, rca=True, **SERVE_KW)
        launches = dict(sk.launches)
    finally:
        set_registry(prev)
    for k, v in launches.items():
        check(v > 0, f"rca serve: kernel {k} was not launched")
    got = {"p99_latency_s": r_on.latency["p99_latency_s"],
           "shed_fraction": r_on.shed_fraction, "n_alerts": r_on.n_alerts}
    check(got == SERVE_PINS, f"rca serve pins: {got} != {SERVE_PINS}")
    check(serve_fingerprint(e_on) == serve_fingerprint(e_off),
          "rca serve: states or alert streams differ from the RCA-off run")
    check(decisions(r_on) == decisions(r_off),
          "rca serve: decision fields differ from the RCA-off run")
    rca_got = {"n_rca_runs": r_on.n_rca_runs,
               "rca_eligible": r_on.rca_eligible,
               "rca_topk_hits": r_on.rca_topk_hits}
    check(rca_got == RCA_PINS, f"rca pins: {rca_got} != {RCA_PINS}")
    runner = e_on._rca_plane.runner
    compiles = reg.counter("anomod_serve_rca_compile_total").value
    runs = reg.counter("anomod_serve_rca_runs_total").value
    check(compiles == len(runner.buckets),
          f"rca: {compiles} first launches for {len(runner.buckets)} "
          "buckets")
    check(runs == r_on.n_rca_runs, f"rca: {runs} runs counted, report "
          f"{r_on.n_rca_runs}")
    log(f"[16] serve with RCA on {card}: pins held (p99 "
        f"{got['p99_latency_s']} s, shed {got['shed_fraction']}, "
        f"{got['n_alerts']} alerts), states and alerts byte-identical to "
        f"RCA off; {r_on.n_rca_runs} RCA runs, eligible "
        f"{r_on.rca_eligible}, top-k hits {r_on.rca_topk_hits} (the JAX "
        f"captures' pins); first launches {compiles:.0f} for buckets "
        f"{runner.buckets}, runs by bucket {runner.runs_by_bucket}; "
        f"launches {launches}")
    log(f"[16] rca_wall_s {r_on.rca_wall_s} s, rca_latency "
        f"{r_on.rca_latency}, alert-to-culprit (virtual) "
        f"{r_on.rca_alert_to_culprit_s}; serve wall RCA on "
        f"{r_on.serve_wall_s:.4f} s against off {r_off.serve_wall_s:.4f} s")

    # the CPU twin: the same run through the plain versions on the host,
    # in its own process since phase 5b (rca_cpu_twins)
    t0 = time.perf_counter()
    want, cpu_journal, cpu_wall_s, cpu_s = twins.get(timeout=900)["serve"]
    wait_s = time.perf_counter() - t0
    have = [v.to_dict() for v in e_on.rca_verdicts]
    check(len(want) == len(have), f"rca: {len(have)} verdicts on the card, "
          f"{len(want)} on the CPU")
    err = 0.0
    for a, b in zip(have, want):
        check({k: v for k, v in a.items() if k != "scores"}
              == {k: v for k, v in b.items() if k != "scores"},
              f"rca: verdict of tenant {a['tenant_id']} window "
              f"{a['alert_window']} differs from the CPU twin's")
        err = max([err] + [abs(x - y) for x, y in zip(a["scores"],
                                                     b["scores"])])
    check(err <= ATOL_RCA_SCORE, f"rca: scores {err} from the CPU twin's "
          f"(limit {ATOL_RCA_SCORE})")
    log(f"[16] verdict stream equal to the CPU twin's ({len(have)} "
        f"verdicts; services, windows, n_spans, n_edges, buckets exact; "
        f"scores within {err:.3g} <= {ATOL_RCA_SCORE}); CPU twin "
        f"{cpu_s:.3f} s in its own process ({wait_s:.3f} s waited), its "
        f"serve wall {cpu_wall_s:.4f} s")

    # one RCA run traced: the newest verdict, whose evidence the buffer
    # still holds, run again on the card under the profiler
    v = max(e_on.rca_verdicts, key=lambda v: (v.alert_window, v.tenant_id))
    plane = e_on._rca_plane
    alerts = e_on._tenant_det[v.tenant_id].alerts
    plane.run(v.tenant_id, v.alert_window, alerts, v.enqueued_s, v.scored_s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again, wall = plane.run(v.tenant_id, v.alert_window, alerts,
                                v.enqueued_s, v.scored_s)
        torch.cuda.synchronize()
    check(again == v, "rca: a traced re-run of the newest verdict differs")
    from torch.autograd import DeviceType
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    kinds = {}
    for e in events:
        kinds[e.name] = kinds.get(e.name, 0) + 1
    busy = device_busy_ms(prof)
    log(f"[16] one RCA run traced (tenant {v.tenant_id}, window "
        f"{v.alert_window}, bucket {v.bucket}): {len(events)} device "
        f"events, device busy "
        f"{'not measured' if busy is None else f'{busy:.4f} ms'} in a "
        f"{wall * 1e3:.3f} ms run wall; events by name {kinds}")
    check(e_on.flight_recorder is not None
          and e_on.flight_recorder.canonical_bytes() == cpu_journal,
          "rca serve: the card's canonical flight journal differs from the "
          "CPU twin's")
    log(f"[16] flight recorder on (the default): canonical journal of "
        f"{r_on.flight_recorded_ticks} records byte-identical to the CPU "
        f"twin's, {r_on.flight_dropped_ticks} dropped")
    return {"cpu_journal": cpu_journal,
            "rca_serve": dict(
                pins=got, rca=rca_got, rca_wall_s=r_on.rca_wall_s,
                rca_latency=r_on.rca_latency,
                rca_alert_to_culprit_s=r_on.rca_alert_to_culprit_s,
                serve_wall_on_s=r_on.serve_wall_s,
                serve_wall_off_s=r_off.serve_wall_s,
                cpu_twin_max_score_err=err, launches=launches,
                one_run_device_events=len(events), one_run_busy_ms=busy,
                one_run_wall_ms=wall * 1e3,
                one_run_events_by_name=kinds)}


def telemetry_phase(dev, card, plain_factory) -> dict:
    """Phase 17: the serve bench deployment with the registry off, then
    on (once each): identical decisions, the overhead; the
    on-run's journal through TT-CSV, ``load_tt_metric_csv`` and
    ``score_self_scrape`` on the card, against the same scoring through
    the plain fold on the card; the injected-stall registry through the
    same round trip, alerting on ``serve`` alone at or after window 14;
    the ``dense_slice_fold`` launches of every scoring counted.  Each
    scoring's chunks also go through the kernel and its plain version
    alone, and the alert scores of several kernel scorings are held to
    the plain fold's within :data:`RTOL_SELFSCRAPE_CARD`."""
    import dataclasses
    import tempfile

    import torch

    from anomod_torch.io.metrics import load_tt_metric_csv
    from anomod_torch.obs import export
    from anomod_torch.obs.registry import (Registry, get_registry,
                                           set_registry)
    from anomod_torch.obs.selfscrape import (report_gap, score_self_scrape,
                                             stalled_registry)
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.replay import stage_planes
    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
    from anomod_torch.stream import StreamReplay

    def decisions(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS and k != "device"}
    prev = get_registry()
    walls = {"off": [], "on": []}
    runs = {}
    try:
        for leg in ("off", "on"):
            reg = Registry(enabled=leg == "on")
            set_registry(reg)
            eng, rep = run_power_law(device=dev, **SERVE_KW)
            walls[leg].append(rep.serve_wall_s)
            if leg not in runs:
                runs[leg] = (eng, rep, reg)
    finally:
        set_registry(prev)
    (e_off, r_off, reg_off), (e_on, r_on, reg_on) = runs["off"], runs["on"]
    check(reg_off.n_samples == 0 and e_off.tracer is None,
          "telemetry off: the registry or the tracer recorded")
    check(serve_fingerprint(e_on) == serve_fingerprint(e_off)
          and decisions(r_on) == decisions(r_off),
          "telemetry: decisions differ between registry off and on")
    served = reg_on.counter("anomod_serve_served_spans_total").value
    check(served == r_on.served_spans, f"telemetry: served counter {served}"
          f" != report {r_on.served_spans}")
    overhead = [on / off - 1.0 for on, off in zip(walls["on"], walls["off"])]
    log(f"[17] telemetry on {card}: decisions identical off / on; serve "
        f"wall off {walls['off']} s, on {walls['on']} s (alternating), "
        f"overhead fraction {overhead}; journal {reg_on.n_samples} samples "
        f"over {len(reg_on.metrics())} series, tracer "
        f"{e_on.tracer.n_spans} spans")

    chunks = []

    class RecordingReplay(StreamReplay):
        """The kernel's stream plane, keeping each chunk it folds."""

        def __init__(self, cfg, t0_us, device=None, with_hll=False):
            super().__init__(cfg, t0_us, device=device, with_hll=with_hll)
            fold = self._step

            def step(state, chunk):
                sid, planes = stage_planes(chunk, xp=torch)
                chunks.append((sid.clone(), planes.clone(), cfg.sw))
                return fold(state, chunk)
            self._step = step

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, reg, kw in (
                ("serve", reg_on, {}),
                ("stall", stalled_registry(),
                 dict(window_s=10.0, baseline_windows=4, z_threshold=4.0))):
            path = Path(tmp) / f"{name}.csv"
            n = export.export_tt_csv(reg, path)
            check(load_tt_metric_csv(path).n_samples == n == reg.n_samples,
                  f"self-scrape {name}: the CSV does not load back whole")
            rk.reset_launches()
            t0 = time.perf_counter()
            report = score_self_scrape(path, device=dev, **kw)
            wall = time.perf_counter() - t0
            n_dense = rk.launches["replay_dense"]
            check(n_dense > 0, f"self-scrape {name}: dense_slice_fold was "
                  "not launched")
            # the kernel at the self-scrape's own shapes, chunk by chunk
            chunks.clear()
            again = score_self_scrape(path, device=dev,
                                      replay_factory=RecordingReplay, **kw)
            sw = chunks[0][2]
            widths = sorted({int(c[0].numel()) for c in chunks})
            err = compare(
                f"self-scrape {name}: its {len(chunks)} chunks (N "
                f"{widths[0]}-{widths[-1]}, SW {sw})",
                torch.cat([rk.replay_dense(*c, H) for c in chunks]).cpu(),
                torch.cat([rk.replay_dense_plain(*c, H)
                           for c in chunks]).cpu(), RTOL_CARD)
            plain = score_self_scrape(path, device=dev,
                                      replay_factory=plain_factory, **kw)
            reports = [report, again] + [
                score_self_scrape(path, device=dev, **kw)
                for _ in range(SELFSCRAPE_REPEATS - 2)]
            gaps = [report_gap(r, plain) for r in reports]
            log(f"[17] self-scrape {name}: alert score / z gaps of "
                f"{len(reports)} kernel scorings to the plain fold's "
                f"{gaps} (limit {RTOL_SELFSCRAPE_CARD}; "
                f"{report['n_alerts']} alerts a scoring)")
            check(None not in gaps and max(gaps) <= RTOL_SELFSCRAPE_CARD,
                  f"self-scrape {name}: a report differs from the plain "
                  f"fold's: {reports} != {plain}")
            if name == "stall":
                check(report["alerted_subsystems"] == ["serve"]
                      and report["n_alerts"] > 0
                      and all(a["window"] >= 14 for a in report["alerts"]),
                      f"self-scrape stall: {report}")
            out[name] = dict(samples=n, n_alerts=report["n_alerts"],
                             alerted=report["alerted_subsystems"],
                             dense_launches=n_dense, wall_s=wall,
                             chunks=len(chunks), chunk_max_abs_err=err,
                             score_gaps=gaps)
            log(f"[17] self-scrape {name}: {n} samples through TT-CSV, "
                f"{report['n_alerts']} alerts on "
                f"{report['alerted_subsystems']} (windows "
                f"{sorted({a['window'] for a in report['alerts']})}), "
                f"equal to the plain fold's on the card; dense_slice_fold "
                f"launches {n_dense}; scored in {wall:.3f} s")
    return {"telemetry": dict(
        serve_wall_off_s=walls["off"], serve_wall_on_s=walls["on"],
        overhead_fraction=overhead, journal_samples=reg_on.n_samples,
        selfscrape=out,
        selfscrape_dense_launches=sum(v["dense_launches"]
                                      for v in out.values()))}


def epoch_profile(name, train, dev, epochs=10) -> dict:
    """One family's training on ``train`` at the sweep's setup (its draw
    of seed 0, full-batch AdamW): ms an epoch over ``epochs`` un-profiled
    epochs after a warm one, then one epoch under the profiler for its
    device events and busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch import rca
    model = rca.init_model(name, train, seed=0, device=dev)
    opt = rca.make_optimizer(model)
    batch = rca.to_device(train, dev)
    rca.train_loop(name, model, opt, batch, 0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rca.train_loop(name, model, opt, batch, 0, epochs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / epochs * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rca.train_loop(name, model, opt, batch, 0, 1)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    events = sum(1 for e in prof.events()
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
    return dict(ms_per_epoch=ms, profiled_epoch_ms=prof_s * 1e3,
                device_busy_ms=busy, device_events=events,
                device_busy_share=None if busy is None
                else busy / 1e3 / prof_s)


def sweep_cpu_twin() -> tuple:
    """The training-free rows of phase 18's sweep on the CPU, as dicts,
    and their wall: run in a spawned process beside the card's sweep (it
    needs no card, and on the host it takes about as long as the card's
    whole sweep)."""
    import dataclasses
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from anomod_torch import quality
    t0 = time.perf_counter()
    twin = quality.severity_sweep("TT", model_names=quality.TRAINING_FREE,
                                  severities=SWEEP_SEVERITIES, device="cpu",
                                  **SWEEP_SEEDS)
    return [dataclasses.asdict(p) for p in twin], time.perf_counter() - t0


def quality_phase(dev, card) -> dict:
    """Phase 18: ``severity_sweep("TT")`` on the card at full width, every
    learned family the CLI trains plus the stream row and the z-score
    baseline, at severities 1.0 and 0.12 (the hard point), every other
    argument at the CLI's defaults but the seeds (:data:`SWEEP_SEEDS`):
    the table; the stream row's
    ``dense_slice_fold`` launches counted; the training-free rows equal
    to the same sweep's CPU twin (run in a spawned process meanwhile);
    each learned family trained from one draw on the card and on the CPU
    for :data:`SWEEP_LOSS_EPOCHS` epochs, the losses within
    :data:`RTOL_SWEEP_LOSS` of the first, and trained twice on the card
    with losses equal bit for bit (the GNN segment sums add in a fixed
    order on the card); and each family's ms an
    epoch, device events and busy share from one profiled epoch."""
    import dataclasses
    import multiprocessing

    import numpy as np
    import torch

    from anomod_torch import quality, rca, synth
    from anomod_torch.ops import replay_kernels as rk

    check(not torch.backends.cuda.matmul.allow_tf32,
          "quality: TF32 matmuls are on")
    check(quality.HARD_POINT == {"severity": SWEEP_SEVERITIES[1],
                                 "noise": 0.5, "n_confounders": 2},
          f"quality: HARD_POINT {quality.HARD_POINT}")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        twin_job = pool.apply_async(sweep_cpu_twin)
        rk.reset_launches()
        t0 = time.perf_counter()
        pts = quality.severity_sweep("TT", model_names=SWEEP_MODELS,
                                     severities=SWEEP_SEVERITIES, device=dev,
                                     **SWEEP_SEEDS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = rk.launches["replay_dense"]
        t0 = time.perf_counter()
        twin, twin_s = twin_job.get(timeout=900)
        twin_wait_s = time.perf_counter() - t0
    check(launches > 0, "quality: the stream row launched no "
          "dense_slice_fold")
    check(len(pts) == len(SWEEP_MODELS) * len(SWEEP_SEVERITIES),
          f"quality: {len(pts)} points")
    for p in pts:
        check(0.0 <= p.top1 <= 1.0 and p.n_eval > 0,
              f"quality: point {p}")
    table = quality.render_markdown(pts)
    for line in table.splitlines():
        log(f"[18] {line}")
    free = [dataclasses.asdict(p) for p in pts
            if p.model in quality.TRAINING_FREE]
    check(free == twin, f"quality: the training-free rows on the card "
          f"{free} differ from the CPU twin's {twin}")
    log(f"[18] severity sweep TT, {len(SWEEP_MODELS)} rows x "
        f"{len(SWEEP_SEVERITIES)} severities in {wall_s:.3f} s on the card "
        f"(corpora, training and scoring; the CPU twin running beside it); "
        f"dense_slice_fold launches {launches} (the stream row); zscore "
        f"and stream rows equal to the CPU twin's ({twin_s:.3f} s in its "
        f"own process, {twin_wait_s:.3f} s waited for) on {card}")

    eval_modes = {sev: synth.HardMode(severity=sev, noise=0.5)
                  for sev in SWEEP_SEVERITIES}
    t0 = time.perf_counter()
    train, _ = quality._grid_batches(
        "TT", eval_modes, SWEEP_SEEDS["train_seeds"],
        SWEEP_SEEDS["eval_seeds"], 60, 0.5, 2)
    build_s = time.perf_counter() - t0
    log(f"[18] training batch {tuple(train['x'].shape)} x_t "
        f"{tuple(train['x_t'].shape)}, edges {train['edge_src'].shape[1]}, "
        f"rebuilt in {build_s:.3f} s on the host")
    families = {}
    for name in SWEEP_MODELS:
        if name in quality.TRAINING_FREE:
            continue
        runs = {}
        for key, where in (("cuda", dev), ("cuda_again", dev),
                           ("cpu", torch.device("cpu"))):
            model = rca.init_model(name, train, seed=0, device=where)
            t0 = time.perf_counter()
            runs[key] = rca.train_loop(
                name, model, rca.make_optimizer(model),
                rca.to_device(train, where), 0, SWEEP_LOSS_EPOCHS)
            runs[key + "_s"] = time.perf_counter() - t0
        got, want = np.asarray(runs["cuda"]), np.asarray(runs["cpu"])
        check(np.array_equal(got, np.asarray(runs["cuda_again"])),
              f"quality {name}: two trainings on the card from one draw "
              f"differ: {got.tolist()} vs {runs['cuda_again']}")
        err = float(np.max(np.abs(got - want)) / abs(want[0]))
        check(err <= RTOL_SWEEP_LOSS,
              f"quality {name}: {SWEEP_LOSS_EPOCHS} losses on the card "
              f"{got.tolist()} vs the CPU {want.tolist()} (max difference "
              f"{err:.3g} of the first loss)")
        prof = epoch_profile(name, train, dev)
        families[name] = dict(
            losses_max_rel_err=err,
            first_loss=[float(got[0]), float(want[0])],
            last_loss=[float(got[-1]), float(want[-1])],
            cpu_s_for_loss_epochs=runs["cpu_s"], **prof)
        log(f"[18] {name}: {SWEEP_LOSS_EPOCHS} losses card vs CPU, max "
            f"difference {err:.3g} of the first loss, two card runs equal "
            f"bit for bit (first "
            f"{got[0]:.6f} / {want[0]:.6f}, last "
            f"{got[-1]:.6f} / {want[-1]:.6f}; CPU {runs['cpu_s']:.3f} s); "
            f"{prof['ms_per_epoch']:.3f} ms an epoch on the card; one "
            f"profiled epoch {prof['profiled_epoch_ms']:.3f} ms, "
            f"{prof['device_events']} device events, busy "
            f"{prof['device_busy_ms']} ms, share "
            f"{prof['device_busy_share']} on {card}")
    return {"quality": dict(
        points=[dataclasses.asdict(p) for p in pts], table=table,
        wall_s=wall_s, cpu_twin_wall_s=twin_s, cpu_twin_wait_s=twin_wait_s,
        dense_launches=launches,
        batch_build_s=build_s, families=families)}


def shift_phase(dev, card) -> dict:
    """Phase 19: the edge-aware ``shift_sweep("TT")`` on the card
    (out-edge blocks, per-edge features, node + edge training loci) for
    the line graph and the transformer, in distribution and under the
    edge-locus shift, every other argument at the CLI's defaults but the
    seeds (:data:`SWEEP_SEEDS`): the table, and each family's ms an
    epoch, device events and busy share from one profiled epoch on the
    sweep's training batch."""
    import dataclasses

    import torch

    from anomod_torch import quality, synth

    t0 = time.perf_counter()
    pts = quality.shift_sweep("TT", model_names=SHIFT_MODELS,
                              shifts=SHIFT_SHIFTS, edge_aware=True,
                              device=dev, **SWEEP_SEEDS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(len(pts) == len(SHIFT_MODELS) * len(SHIFT_SHIFTS),
          f"shift: {len(pts)} points")
    for p in pts:
        check(0.0 <= p.top1 <= 1.0 and p.n_eval > 0, f"shift: point {p}")
    table = quality.render_shift_markdown(pts)
    for line in table.splitlines():
        log(f"[19] {line}")
    modes = {name: synth.HardMode(severity=0.3, noise=0.5,
                                  **quality.SHIFTS[name])
             for name in SHIFT_SHIFTS}
    train, _ = quality._grid_batches(
        "TT", modes, SWEEP_SEEDS["train_seeds"], SWEEP_SEEDS["eval_seeds"],
        60, 0.5, 2, edge_features=True, train_loci=("node", "edge"))
    families = {}
    for name in SHIFT_MODELS:
        families[name] = prof = epoch_profile(name, train, dev)
        log(f"[19] {name} (edge-aware batch {tuple(train['x_t'].shape)}, "
            f"edges {train['edge_src'].shape[1]}): "
            f"{prof['ms_per_epoch']:.3f} ms an epoch; one profiled epoch "
            f"{prof['device_events']} device events, busy "
            f"{prof['device_busy_ms']} ms, share "
            f"{prof['device_busy_share']} on {card}")
    log(f"[19] edge-aware shift sweep in {wall_s:.3f} s on the card")
    return {"shift": dict(points=[dataclasses.asdict(p) for p in pts],
                          table=table, wall_s=wall_s, families=families)}


#: flight off / on turns of phase 20 (alternating, the median fraction)
FLIGHT_TURNS = 2
#: shard counts of phase 20 beside the 1-shard run
SHARD_COUNTS = (2, 4)
#: shard counts phase 20 reruns under the profiler for a busy share (2
#: is phase 21's thread oracle)
PROFILED_SHARD_COUNTS = (1, 2)


def flight_shard_phase(dev, card, cpu_journal) -> dict:
    """Phase 20: the flight recorder and thread shards at the serve bench
    deployment, RCA on.  Flight off and on in alternating turns: the
    decision and RCA pins on every run, decisions equal off / on, the
    card's canonical journal byte-identical to the CPU twin's (phase
    16's), no ring drop, the median overhead fraction with the digest's
    and the tick record's own walls split out.  Shards 2 and 4 on the
    card: states, alerts, verdicts, decisions and the canonical journal
    equal to the 1-shard run's, the staged chunks per width equal, each
    kernel launched from the shard runners' own streams; serve wall,
    launches and a profiled busy share for each count.  Then ``audit
    record``, ``audit replay --shards 2`` and ``audit diff`` through the
    CLI on the card, and a journal with one tick's admission digest
    edited, which ``diff`` must name."""
    import dataclasses
    import io
    import statistics
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch import cli, replay
    from anomod_torch.obs import flight
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve import batcher
    from anomod_torch.serve.engine import (FLIGHT_REPORT_FIELDS,
                                           VARIANT_REPORT_FIELDS,
                                           ServeEngine, run_power_law)
    kw = dict(SERVE_KW, device=dev, rca=True)

    def decisions(r, skip=()):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS + tuple(skip)
                and k != "device"}

    def pins(r, what):
        got = {"p99_latency_s": r.latency["p99_latency_s"],
               "shed_fraction": r.shed_fraction, "n_alerts": r.n_alerts}
        check(got == SERVE_PINS, f"{what}: pins {got} != {SERVE_PINS}")
        rca = {"n_rca_runs": r.n_rca_runs, "rca_eligible": r.rca_eligible,
               "rca_topk_hits": r.rca_topk_hits}
        check(rca == RCA_PINS, f"{what}: rca pins {rca} != {RCA_PINS}")

    # -- flight off / on ---------------------------------------------------
    walls = {"off": [], "on": []}
    digest_walls, tick_rec_walls = [], []
    real_digest = flight.state_digest

    def timed_digest(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_digest(*a, **k)
        finally:
            digest_walls[-1].append(time.perf_counter() - t0)
    runs = {}
    flight.state_digest = timed_digest
    try:
        for leg in ("off", "on") * FLIGHT_TURNS:
            digest_walls.append([])
            with host_walls(ServeEngine, "_flight_tick") as rec_walls:
                eng, rep = run_power_law(flight=leg == "on", **kw)
            walls[leg].append(rep.serve_wall_s)
            if leg == "on":
                tick_rec_walls.append(sum(rec_walls))
            else:
                digest_walls.pop()
            pins(rep, f"flight {leg}")
            runs.setdefault(leg, (eng, rep))
    finally:
        flight.state_digest = real_digest
    (e_off, r_off), (e_on, r_on) = runs["off"], runs["on"]
    check(e_off.flight_recorder is None and not r_off.flight_enabled,
          "flight off: a recorder ran")
    check(serve_fingerprint(e_on) == serve_fingerprint(e_off)
          and decisions(r_on, FLIGHT_REPORT_FIELDS)
          == decisions(r_off, FLIGHT_REPORT_FIELDS),
          "flight: decisions differ between off and on")
    fr = e_on.flight_recorder
    check(r_on.flight_recorded_ticks == r_on.ticks + 1
          and r_on.flight_dropped_ticks == 0,
          f"flight: {r_on.flight_recorded_ticks} records for "
          f"{r_on.ticks} ticks, {r_on.flight_dropped_ticks} dropped")
    journal = fr.canonical_bytes()
    check(journal == cpu_journal,
          "flight: the card's canonical journal differs from the CPU twin's")
    overhead = [on / off - 1.0 for on, off in zip(walls["on"], walls["off"])]
    digests = [len(w) for w in digest_walls]
    digest_s = [sum(w) for w in digest_walls]
    out = {"flight": dict(
        serve_wall_off_s=walls["off"], serve_wall_on_s=walls["on"],
        overhead_fraction=overhead,
        overhead_median=statistics.median(overhead),
        recorded_ticks=r_on.flight_recorded_ticks,
        dropped_ticks=r_on.flight_dropped_ticks,
        digests_per_run=digests, digest_wall_s=digest_s,
        digest_wall_each_s=[d / max(n, 1) for d, n in zip(digest_s, digests)],
        tick_record_wall_s=tick_rec_walls,
        journal_bytes=len(journal))}
    log(f"[20] flight on {card}: pins held off and on, decisions identical, "
        f"canonical journal ({len(journal)} B, {r_on.flight_recorded_ticks} "
        f"records, {r_on.flight_dropped_ticks} dropped) byte-identical to "
        f"the CPU twin's; serve wall off {walls['off']} s, on "
        f"{walls['on']} s (alternating), overhead {overhead}, median "
        f"{out['flight']['overhead_median']:.4g}; the recorder's own wall "
        f"(every _flight_tick, settlement record included) {tick_rec_walls} "
        f"s, of it the state digest {digest_s} s over {digests} digests")

    # -- shards on the card ------------------------------------------------
    want = serve_fingerprint(e_on)
    want_verdicts = [repr(v.to_dict()) for v in e_on.rca_verdicts]
    shard_out = {}
    real_lane = batcher.lane_delta
    for n in (1,) + SHARD_COUNTS:
        streams = set()

        def lane(*a, **k):
            streams.add(torch.cuda.current_stream(dev).cuda_stream)
            return real_lane(*a, **k)
        sk.reset_launches()
        batcher.lane_delta = lane
        stack, legs = serve_split()
        with stack:
            for name, meth in (("score_shard", "_score_shard"),
                               ("fan_out", "_fan_out"),
                               ("rca", "_rca_tick")):
                legs[name] = stack.enter_context(host_walls(ServeEngine,
                                                            meth))
            try:
                eng, rep = run_power_law(shards=n, **kw)
            finally:
                batcher.lane_delta = real_lane
        launches = dict(sk.launches)
        split = split_sums(legs, rep)
        pins(rep, f"{n} shards")
        if n == 1:
            check(streams == {torch.cuda.current_stream(dev).cuda_stream},
                  f"1 shard: lane_delta launched on {streams}")
        else:
            own = {r.stream.cuda_stream for r in eng._runners}
            check(streams == own and len(own) == n
                  and torch.cuda.default_stream(dev).cuda_stream not in own,
                  f"{n} shards: lane_delta launched on {streams}, the "
                  f"runners' streams are {own}")
        check(serve_fingerprint(eng) == want,
              f"{n} shards: states or alert streams differ from 1 shard")
        check(decisions(rep) == decisions(r_on),
              f"{n} shards: decision fields differ from 1 shard: "
              f"{field_diff(decisions(rep), decisions(r_on))}; recovery "
              f"events {recovery_events(eng)}")
        check([repr(v.to_dict()) for v in eng.rca_verdicts] == want_verdicts,
              f"{n} shards: RCA verdicts differ from 1 shard")
        check(eng.flight_recorder.canonical_bytes() == journal,
              f"{n} shards: canonical journal differs from 1 shard")
        check(rep.dispatches_by_width == r_on.dispatches_by_width,
              f"{n} shards: chunks by width {rep.dispatches_by_width}")
        for k, v in launches.items():
            check(v > 0, f"{n} shards: kernel {k} was not launched")
        if n == 2:
            two_shards = (eng, rep)
        shard_out[n] = dict(serve_wall_s=rep.serve_wall_s,
                            launches=launches,
                            chunks_by_width=rep.dispatches_by_width,
                            fused_dispatches=rep.fused_dispatches,
                            lanes_by_bucket=rep.lanes_by_bucket,
                            shard_tenants=rep.shard_tenants,
                            shard_spans=rep.shard_spans,
                            shard_imbalance=rep.shard_imbalance,
                            fold_payload_bytes=rep.fold_payload_bytes,
                            rca_wall_s=rep.rca_wall_s, host_split=split)
        log(f"[20] {n} shard(s) on {card}: recovery events "
            f"{recovery_events(eng)}; states, alerts, "
            f"{len(want_verdicts)} verdicts, decisions and the canonical "
            f"journal equal to the 1-shard run's; lane_delta from "
            f"{len(streams)} stream(s), the runners' own; serve wall "
            f"{rep.serve_wall_s:.4f} s; launches {launches}; fused "
            f"dispatches {rep.fused_dispatches}, lanes "
            f"{rep.lanes_by_bucket}; tenants {rep.shard_tenants}, spans "
            f"{rep.shard_spans}, imbalance {rep.shard_imbalance}; fold "
            f"payload {rep.fold_payload_bytes} B; host legs, s summed "
            f"(calls; threads' walls include their waits for the "
            f"interpreter lock): " + ", ".join(
                f"{k} {v['sum_s']:.4f} ({v['calls']})"
                for k, v in split.items() if isinstance(v, dict)))
    for n in PROFILED_SHARD_COUNTS:
        sk.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, rep = run_power_law(shards=n, **kw)
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        share = None if busy is None else busy / 1e3 / rep.serve_wall_s
        shard_out[n].update(profiled_wall_s=rep.serve_wall_s,
                            device_busy_ms=busy, busy_share=share,
                            profiled_launches=dict(sk.launches))
        log(f"[20] {n} shard(s) profiled: device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'} in a "
            f"{rep.serve_wall_s:.4f} s serve wall, busy share "
            f"{share if share is None else f'{share:.4g}'}; launches "
            f"{dict(sk.launches)}")
    out["shards"] = {str(k): v for k, v in shard_out.items()}

    # -- audit record / replay / diff ---------------------------------------
    args = ["--tenants", "200", "--services", "12", "--capacity", "25000",
            "--overload", "2", "--duration", "60", "--tick", "0.5",
            "--seed", "7", "--window-seconds", "5", "--baseline-windows",
            "4", "--fault-tenants", "2", "--rca", "--device", "cuda"]

    def main_rc(argv):
        buf_out, buf_err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err), probe_skipped():
            rc = cli.main(argv)
        return rc, buf_out.getvalue(), buf_err.getvalue()
    with tempfile.TemporaryDirectory() as tmp:
        a, b, c = (str(Path(tmp) / f"{x}.json") for x in "abc")
        t0 = time.perf_counter()
        rc_rec, rec_out, _ = main_rc(["audit", "record", "--out", a] + args)
        rc_rep, rep_out, _ = main_rc(["audit", "replay", a, "--out", b,
                                      "--shards", "2", "--device", "cuda"])
        rc_diff, _, _ = main_rc(["audit", "diff", a, b])
        check((rc_rec, rc_rep, rc_diff) == (0, 0, 0),
              f"audit: record / replay --shards 2 / diff exited "
              f"{rc_rec} / {rc_rep} / {rc_diff}")
        check(json.loads(rep_out)["shards"] == 2
              and json.loads(rec_out)["device"] == json.loads(rep_out)[
                  "device"] != "cpu", f"audit: {rec_out} / {rep_out}")
        doc = flight.load_journal(b)
        tick = len(doc["ticks"]) // 2
        doc["ticks"][tick]["admission"]["digest"] ^= 1
        Path(c).write_text(json.dumps(doc))
        rc_bad, bad_out, bad_err = main_rc(["audit", "diff", a, c])
        div = json.loads(bad_out).get("divergence", {})
        check(rc_bad == 1 and (div.get("tick"), div.get("plane"))
              == (doc["ticks"][tick]["tick"], "admission"),
              f"audit: the edited journal diffed {rc_bad}, {div}")
        audit_s = time.perf_counter() - t0
    out["audit"] = dict(record=json.loads(rec_out),
                        replay=json.loads(rep_out), edited_tick=tick,
                        divergence=dict(tick=div["tick"],
                                        plane=div["plane"]),
                        wall_s=audit_s)
    log(f"[20] audit on {card}: record {rec_out.strip()}; replay --shards "
        f"2 {rep_out.strip()}; diff exit 0; tick {tick} admission digest "
        f"edited: diff exit {rc_bad}, {bad_err.strip()} ({audit_s:.3f} s)")
    # phase 21 holds its runs to these two (popped by main)
    out["_runs"] = {"flight_on": (e_on, r_on), "two_shards": two_shards}
    return out


#: the JAX serve bench's chaos leg at its 120 ticks (``bench.py:289-295``:
#: crashes at n/3 and 2n/3, a score-path exception at n/2, shard 0)
CHAOS_SCRIPT = ("crash@40:shard=0:phase=dispatch;"
                "except@60:shard=0:phase=score;"
                "crash@80:shard=0:phase=stage")
#: what the JAX capture of that leg reads (and the cadence alone gives:
#: checkpoints at ticks 0, 32, 64, 96 re-execute 9 + 29 + 17 slices)
CHAOS_WANT = {"n_shard_crashes": 3, "n_restored_ticks": 55,
              "n_quarantined": 0, "n_migrated_tenants": 0, "n_respawns": 0}
#: phase 21's process-worker runs after the 2-thread oracle: (shards, fold)
PROC_RUNS = ((2, "sparse"), (1, "sparse"), (2, "dense"), (4, "sparse"))
#: a spawned process worker of phase 21 profiles its device work for its
#: whole life and writes its busy ms into the directory this names
CHILD_PROFILE_ENV = "ANOMOD_SMOKE_CHILD_PROFILE_DIR"
#: the one process run of phase 21 whose children profile themselves (the
#: others' busy share is not measured: a profiled child spends seconds
#: closing its trace)
PROFILED_PROC_RUN = "process-2-sparse"


def _child_profiler(out_dir: str) -> None:
    """Installed in a spawned process worker, where this script is
    re-imported as ``__mp_main__`` before the child's entry is resolved:
    ``torch.profiler`` (CUDA activities) starts at the child's first
    command (its warm-up), after the start-up handshake, and when the
    child exits its device busy ms (the union of its device event
    intervals) lands in ``out_dir/busy_<pid>.json``.  A profiler sees one
    process's CUDA work only, so each child profiles its own."""
    import os

    from anomod_torch.serve import procshard
    real_main = procshard._shard_main
    real_handle = procshard._ShardPlane.handle
    started = []

    def handle(self, msg):
        if not started:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            started.append(prof)
        return real_handle(self, msg)

    def profiled(conn):
        try:
            real_main(conn)
        finally:
            if started:
                import torch
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                started[0].__exit__(None, None, None)
                busy = device_busy_ms(started[0])
                Path(out_dir, f"busy_{os.getpid()}.json").write_text(
                    json.dumps({"busy_ms": busy,
                                "profile_s": time.perf_counter() - t0}))
    procshard._ShardPlane.handle = handle
    procshard._shard_main = profiled


@contextlib.contextmanager
def child_hellos():
    """Record the start-up handshake of every process worker started
    inside the block (``ProcShardWorker.wait_ready``'s reply)."""
    from anomod_torch.serve import procshard
    real = procshard.ProcShardWorker.wait_ready
    got = []

    def wait_ready(self):
        hello = real(self)
        got.append(hello)
        return hello
    procshard.ProcShardWorker.wait_ready = wait_ready
    try:
        yield got
    finally:
        procshard.ProcShardWorker.wait_ready = real


def supervise_proc_phase(dev, card, cpu_journal, fs20) -> dict:
    """Phase 21: supervision, chaos and process shard workers at the serve
    bench deployment, RCA on, flight on.  (1) The supervised default
    (phase 20's first flight-on run, popped from ``fs20``): the pins, 4
    checkpoints, states, alerts, verdicts, decisions and the canonical
    journal equal an unsupervised run's and the CPU twin's journal; the
    checkpoint wall and its fraction of the serve wall.
    (2) The JAX bench's chaos leg at 1 shard: 3 crashes, 55 restored
    ticks, nothing quarantined or migrated, no respawn, and no score gap
    (everything above equal to the fault-free run's); the recovery wall.
    (3) Process workers at 2 shards (sparse fold), 1, 2 (dense) and 4,
    the 2-shard sparse run's children profiling their own device work
    (:data:`PROFILED_PROC_RUN`), against phase 20's 2-shard
    thread run (the oracle): every alert stream, verdict,
    decision and the canonical journal equal the oracle's, the sparse
    payload at most half the dense one, every lane-kernel launch made in
    the children; serve wall beside phase 20's thread walls, the
    children's start wall apart from it, launches summed over the
    children and the busy share.  (4) A 2-shard process run whose shard
    1 child is killed at tick 40: respawned, restored, equal to the
    fault-free run."""
    import dataclasses
    import os
    import tempfile

    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve.engine import (RECOVERY_REPORT_FIELDS,
                                           SUPERVISION_REPORT_FIELDS,
                                           VARIANT_REPORT_FIELDS,
                                           run_power_law)
    kw = dict(SERVE_KW, device=dev, rca=True, flight=True)
    t_phase = time.perf_counter()

    def decisions(r, skip=()):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS + tuple(skip)
                and k != "device"}

    def pins(r, what):
        got = {"p99_latency_s": r.latency["p99_latency_s"],
               "shed_fraction": r.shed_fraction, "n_alerts": r.n_alerts}
        check(got == SERVE_PINS, f"{what}: pins {got} != {SERVE_PINS}")
        rca = {"n_rca_runs": r.n_rca_runs, "rca_eligible": r.rca_eligible,
               "rca_topk_hits": r.rca_topk_hits}
        check(rca == RCA_PINS, f"{what}: rca pins {rca} != {RCA_PINS}")

    def alerts(eng):
        return {tid: [dataclasses.asdict(a) for a in eng.alerts_for(tid)]
                for tid in sorted(eng._tenant_det)}

    def verdicts(eng):
        return [repr(v.to_dict()) for v in eng.rca_verdicts]

    runs20 = fs20.pop("_runs")
    thread_walls = {k: v["serve_wall_s"] for k, v in fs20["shards"].items()}

    # -- (1) the supervised default against supervision off ---------------
    e_sup, r_sup = runs20["flight_on"]
    # each run's wall from start to end, for the phase's split
    split = {}
    t0 = time.perf_counter()
    e_off, r_off = run_power_law(ckpt_every=0, **kw)
    split["unsupervised"] = dict(wall_s=time.perf_counter() - t0,
                                 serve_wall_s=r_off.serve_wall_s)
    pins(r_off, "unsupervised")
    check(r_sup.supervised and r_sup.ckpt_every == 32
          and r_sup.n_checkpoints == 4 and not r_off.supervised
          and r_off.n_checkpoints == 0,
          f"supervision: {r_sup.n_checkpoints} checkpoints at cadence "
          f"{r_sup.ckpt_every}; off-run supervised={r_off.supervised}")
    want_fp = serve_fingerprint(e_sup)
    journal = e_sup.flight_recorder.canonical_bytes()
    check(want_fp == serve_fingerprint(e_off)
          and decisions(r_sup, SUPERVISION_REPORT_FIELDS)
          == decisions(r_off, SUPERVISION_REPORT_FIELDS)
          and verdicts(e_sup) == verdicts(e_off),
          "supervision: decisions differ between on and off: "
          + str(field_diff(decisions(r_sup, SUPERVISION_REPORT_FIELDS),
                           decisions(r_off, SUPERVISION_REPORT_FIELDS)))
          + f"; recovery events {recovery_events(e_sup)}")
    check(journal == e_off.flight_recorder.canonical_bytes() == cpu_journal,
          "supervision: canonical journal differs from the unsupervised "
          "run's or the CPU twin's")
    ckpt_s = e_sup._supervisor.ckpt_wall_s
    out = {"supervision": dict(
        n_checkpoints=r_sup.n_checkpoints, ckpt_wall_s=ckpt_s,
        serve_wall_s=r_sup.serve_wall_s,
        ckpt_fraction=ckpt_s / r_sup.serve_wall_s,
        serve_wall_unsupervised_s=r_off.serve_wall_s)}
    log(f"[21] supervised (the default) on {card}: pins held, "
        f"{r_sup.n_checkpoints} checkpoints every {r_sup.ckpt_every} ticks, "
        f"states, alerts, {len(e_sup.rca_verdicts)} verdicts, decisions "
        f"and the canonical journal equal supervision off and the CPU "
        f"twin's journal; checkpoint wall {ckpt_s:.4f} s of a "
        f"{r_sup.serve_wall_s:.4f} s serve wall (fraction "
        f"{out['supervision']['ckpt_fraction']:.4g}); supervision off "
        f"{r_off.serve_wall_s:.4f} s")

    # -- (2) the JAX bench's chaos leg -------------------------------------
    t0 = time.perf_counter()
    e_ch, r_ch = run_power_law(chaos=CHAOS_SCRIPT, **kw)
    split["chaos"] = dict(wall_s=time.perf_counter() - t0,
                          serve_wall_s=r_ch.serve_wall_s)
    pins(r_ch, "chaos")
    got = {k: getattr(r_ch, k) for k in CHAOS_WANT}
    check(got == CHAOS_WANT, f"chaos: {got} != {CHAOS_WANT}")
    check(serve_fingerprint(e_ch) == want_fp
          and decisions(r_ch, RECOVERY_REPORT_FIELDS)
          == decisions(r_sup, RECOVERY_REPORT_FIELDS)
          and verdicts(e_ch) == verdicts(e_sup),
          "chaos: states, alerts, verdicts or decisions differ from the "
          "fault-free run's")
    check(e_ch.flight_recorder.canonical_bytes() == journal,
          "chaos: the canonical journal differs from the fault-free run's")
    rec_s = e_ch._supervisor.recovery_wall_s
    events = [ev for t in e_ch.flight_recorder.records()
              for ev in t["recovery"]]
    out["chaos"] = dict(script=CHAOS_SCRIPT, **got, recovery_wall_s=rec_s,
                        ckpt_wall_s=e_ch._supervisor.ckpt_wall_s,
                        serve_wall_s=r_ch.serve_wall_s,
                        events=[{k: ev[k] for k in ("tick", "kind",
                                                    "restored_ticks")}
                                for ev in events])
    log(f"[21] chaos leg on {card} ({CHAOS_SCRIPT}): {got}; no score gap "
        f"(states, alerts, verdicts, decisions, canonical journal equal the "
        f"fault-free run's); recovery wall {rec_s:.4f} s, serve wall "
        f"{r_ch.serve_wall_s:.4f} s; events {out['chaos']['events']}")

    # -- (3) process shard workers against the thread oracle ---------------
    e_th, r_th = runs20["two_shards"]
    want_alerts, want_verdicts = alerts(e_th), verdicts(e_th)
    check(e_th.flight_recorder.canonical_bytes() == journal
          and want_alerts == alerts(e_sup),
          "2 threads: journal or alerts differ from 1 shard")
    two = fs20["shards"]["2"]
    runs = {"thread-2": dict(
        serve_wall_s=r_th.serve_wall_s, launches=two["launches"],
        device_busy_ms=two["device_busy_ms"], busy_share=two["busy_share"],
        fold_payload_bytes=r_th.fold_payload_bytes)}
    prev_env = os.environ.get(CHILD_PROFILE_ENV)
    try:
        for n, fold in PROC_RUNS:
            name = f"process-{n}-{fold}"
            with tempfile.TemporaryDirectory() as tmp, \
                    child_hellos() as hellos:
                if name == PROFILED_PROC_RUN:
                    os.environ[CHILD_PROFILE_ENV] = tmp
                else:
                    os.environ.pop(CHILD_PROFILE_ENV, None)
                sk.reset_launches()
                t0 = time.perf_counter()
                eng, rep = run_power_law(shards=n, worker="process",
                                         fold=fold, **kw)
                run_s = time.perf_counter() - t0
                docs = [json.loads(f.read_text())
                        for f in sorted(Path(tmp).glob("busy_*.json"))]
                busy_each = [d["busy_ms"] for d in docs]
            split[name] = dict(wall_s=run_s, serve_wall_s=rep.serve_wall_s,
                               worker_start_s=eng.worker_start_s,
                               child_profile_s=[d["profile_s"]
                                                for d in docs])
            pins(rep, name)
            check(rep.worker == "process" and rep.fold == fold
                  and rep.shards == n, f"{name}: ran as {rep.worker}, "
                  f"{rep.fold}, {rep.shards} shards")
            check(alerts(eng) == want_alerts
                  and verdicts(eng) == want_verdicts
                  and decisions(rep) == decisions(r_th)
                  and rep.dispatches_by_width == r_th.dispatches_by_width,
                  f"{name}: alerts, verdicts or decisions differ from the "
                  f"thread oracle's: "
                  f"{field_diff(decisions(rep), decisions(r_th))}; "
                  f"recovery events {recovery_events(eng)}")
            check(eng.flight_recorder.canonical_bytes() == journal,
                  f"{name}: canonical journal differs from the oracle's")
            coord = dict(sk.launches)
            child = dict(eng.worker_launches)
            check(coord["lane_delta"] == 0 and coord["window_gather"] == 0
                  and child.get("lane_delta", 0) > 0
                  and child.get("window_gather", 0) > 0,
                  f"{name}: launches in the coordinator {coord}, in the "
                  f"children {child}")
            known = [b for b in busy_each if b is not None]
            busy = sum(known) if len(known) == n else None
            runs[name] = dict(
                serve_wall_s=rep.serve_wall_s,
                thread_wall_phase20_s=thread_walls.get(str(n)),
                worker_start_s=eng.worker_start_s,
                child_boot_s=[h["boot_s"] for h in hellos],
                child_init_s=[h["init_s"] for h in hellos], launches=child,
                device_busy_ms=busy, child_busy_ms=busy_each,
                busy_share=(None if busy is None
                            else busy / 1e3 / rep.serve_wall_s),
                fold_payload_bytes=rep.fold_payload_bytes,
                fused_dispatches=rep.fused_dispatches,
                stage_wall_s=rep.stage_wall_s,
                dispatch_wall_s=rep.dispatch_wall_s,
                fold_wall_s=rep.fold_wall_s, score_wall_s=rep.score_wall_s)
    finally:
        if prev_env is None:
            os.environ.pop(CHILD_PROFILE_ENV, None)
        else:
            os.environ[CHILD_PROFILE_ENV] = prev_env
    sparse = runs["process-2-sparse"]["fold_payload_bytes"]
    dense = runs["process-2-dense"]["fold_payload_bytes"]
    check(0 < sparse <= 0.5 * dense,
          f"process fold payload: sparse {sparse} B, dense {dense} B")
    for name, r in runs.items():
        busy, share = r["device_busy_ms"], r["busy_share"]
        busy_txt = "not measured" if busy is None else f"{busy:.3f} ms"
        share_txt = "not measured" if share is None else f"{share:.4g}"
        procs = (f" (phase 20 threads at this count: "
                 f"{r['thread_wall_phase20_s']} s); children's start "
                 f"{r['worker_start_s']:.3f} s (outside the serve wall; "
                 f"each child's interpreter and imports "
                 f"{[round(x, 3) for x in r['child_boot_s']]} s, its shard "
                 f"plane {[round(x, 3) for x in r['child_init_s']]} s)"
                 if name.startswith("process") else " (phase 20's)")
        log(f"[21] {name} on {card}: decisions, alerts, verdicts and the "
            f"canonical journal equal the 2-thread oracle's; serve wall "
            f"{r['serve_wall_s']:.4f} s{procs}; launches {r['launches']}; "
            f"device busy {busy_txt}, busy share {share_txt}; fold "
            f"payload {r['fold_payload_bytes']} B")
    out["process"] = runs

    # -- (4) a child killed and respawned ----------------------------------
    t0 = time.perf_counter()
    eng, rep = run_power_law(shards=2, worker="process",
                             chaos="crash@40:shard=1", **kw)
    split["respawn"] = dict(wall_s=time.perf_counter() - t0,
                            serve_wall_s=rep.serve_wall_s,
                            worker_start_s=eng.worker_start_s)
    pins(rep, "respawn")
    check(rep.n_respawns >= 1 and rep.n_shard_crashes >= 1,
          f"respawn: {rep.n_respawns} respawns, {rep.n_shard_crashes} "
          "crashes")
    check(alerts(eng) == want_alerts and verdicts(eng) == want_verdicts
          and decisions(rep, RECOVERY_REPORT_FIELDS)
          == decisions(r_th, RECOVERY_REPORT_FIELDS)
          and eng.flight_recorder.canonical_bytes() == journal,
          "respawn: a score gap (decisions or journal differ from the "
          "fault-free run's)")
    out["respawn"] = dict(n_respawns=rep.n_respawns,
                          n_shard_crashes=rep.n_shard_crashes,
                          n_restored_ticks=rep.n_restored_ticks,
                          recovery_wall_s=rep.recovery_wall_s,
                          serve_wall_s=rep.serve_wall_s)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    # where the phase's wall goes: each run's wall from start to end, its
    # serve wall, its children's start and (profiled children) the time
    # each took to close its trace and write its busy ms
    for name, r in split.items():
        rest = r["wall_s"] - r["serve_wall_s"] - r.get("worker_start_s", 0.0)
        r["rest_s"] = rest
        prof = r.get("child_profile_s")
        log(f"[21] split {name} on {card}: wall {r['wall_s']:.3f} s = serve "
            f"{r['serve_wall_s']:.3f} s"
            + (f" + children's start {r['worker_start_s']:.3f} s"
               if "worker_start_s" in r else "")
            + f" + the rest {rest:.3f} s"
            + ("" if prof is None else
               f"; children's profile close and write "
               f"{[round(x, 3) for x in prof] if prof else 'not profiled'}"
               f" s"))
    out["phase21_split"] = split
    log(f"[21] respawn on {card}: shard 1's child killed at tick 40, "
        f"{rep.n_respawns} respawn(s), {rep.n_restored_ticks} restored "
        f"ticks, recovery wall {rep.recovery_wall_s:.4f} s, serve wall "
        f"{rep.serve_wall_s:.4f} s; no score gap; phase 21 in "
        f"{out['phase_wall_s']:.1f} s")
    return out


#: phase 22's elastic legs: the JAX serve bench's (``bench.py:368-392``)
#: at its 120 ticks, a 4x surge over ticks 30-44 at 0.6x load
ELASTIC_SURGE = "surge@30:factor=4:ticks=15"
ELASTIC_POLICY = dict(shards=1, chaos=ELASTIC_SURGE, policy="auto",
                      min_shards=1, max_shards=2, cooldown_ticks=5)
#: phase 22's elastic deployment: the serve bench's at 0.6x, RCA off
ELASTIC_KW = dict(SERVE_KW, overload=0.6, rca=False, flight=True)
#: phase 22's tiering pair: the JAX serve bench's (``bench.py:440-470``)
TIER_KW = dict(n_tenants=48, n_services=8, capacity_spans_per_s=800.0,
               overload=0.5, duration_s=24.0, tick_s=1.0, seed=7,
               window_s=5.0, baseline_windows=2, fault_tenants=2,
               buckets=(64, 256), lane_buckets=(1, 2, 4), max_backlog=6400,
               n_windows=16)
TIER_ON = dict(tier_hot=12, tier_demote_after=2, tier_warm_bytes=4096,
               tier_prefetch=2)


@contextlib.contextmanager
def lane_streams(dev):
    """Record the current CUDA stream of every ``lane_delta`` call the
    serve runners make inside the block."""
    import torch

    from anomod_torch.serve import batcher
    real = batcher.lane_delta
    seen = []

    def lane(*a, **k):
        seen.append(torch.cuda.current_stream(dev).cuda_stream)
        return real(*a, **k)
    batcher.lane_delta = lane
    try:
        yield seen
    finally:
        batcher.lane_delta = real


@contextlib.contextmanager
def barrier_probe():
    """Read each deferred-commit barrier inside the block: how many lane
    dispatches were still in the runners' in-flight queues as it began,
    how many of those the card had already finished (their events
    queried, not waited on), and the wall of the barrier's
    ``drain_lanes`` calls (summed over shards: the wait plus the folds
    it enqueues).  Yields the running totals."""
    import threading

    from anomod_torch.serve import engine as eng_mod
    from anomod_torch.serve.batcher import BucketRunner
    real_commit = eng_mod.ServeEngine._commit_deferred
    real_drain = BucketRunner.drain_lanes
    got = {"barriers": 0, "inflight": 0, "done": 0, "drain_s": 0.0}
    lock = threading.Lock()
    inside = threading.Event()

    def commit(self):
        d = self._deferred
        if d is None or not d["pending"] or not any(d["pending"]):
            return real_commit(self)
        got["barriers"] += 1
        for r in self._runners:
            evs = [e[3] for e in r._inflight]
            got["inflight"] += len(evs)
            got["done"] += sum(1 for e in evs if e is not None and e.query())
        inside.set()
        try:
            return real_commit(self)
        finally:
            inside.clear()

    def drain(self):
        if not inside.is_set():
            return real_drain(self)
        t0 = time.perf_counter()
        try:
            return real_drain(self)
        finally:
            with lock:
                got["drain_s"] += time.perf_counter() - t0
    eng_mod.ServeEngine._commit_deferred = commit
    BucketRunner.drain_lanes = drain
    try:
        yield got
    finally:
        eng_mod.ServeEngine._commit_deferred = real_commit
        BucketRunner.drain_lanes = real_drain


def elastic_tier_cpu_twins() -> dict:
    """Phase 22's CPU twins, in a spawned process started before the
    phase's card work, one torch thread: the elastic policy's run (its
    scaling events) and the tiering run (its counters), each with its
    wall."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import tempfile

    import torch
    torch.set_num_threads(1)
    from anomod_torch.serve.engine import (TIERING_REPORT_FIELDS,
                                           run_power_law)
    t0 = time.perf_counter()
    e_cpu, _ = run_power_law(**ELASTIC_POLICY, **ELASTIC_KW, device="cpu")
    out = {"elastic": ([ev for t in e_cpu.flight_recorder.records()
                        for ev in t["scaling"]],
                       time.perf_counter() - t0)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cold:
        _, r_tcpu = run_power_law(shards=1, device="cpu",
                                  tier_cold_dir=cold, **TIER_ON, **TIER_KW)
    out["tiering"] = ([getattr(r_tcpu, k) for k in TIERING_REPORT_FIELDS],
                      time.perf_counter() - t0)
    return out


def elastic_async_tier_phase(dev, card, cpu_journal) -> dict:
    """Phase 22 (:func:`_elastic_async_tier_phase`), its CPU twins run in
    a spawned process (:func:`elastic_tier_cpu_twins`) beside the card's
    work."""
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return _elastic_async_tier_phase(
            dev, card, cpu_journal, pool.apply_async(elastic_tier_cpu_twins))


def _elastic_async_tier_phase(dev, card, cpu_journal, twin_job) -> dict:
    """Phase 22: the deferred-commit tick, the elastic policy and state
    tiering in the serve tick, on the card.  (1) The serve bench
    deployment, RCA on, supervised: pipeline 2 and 1, each synchronous
    and deferred, and 2 thread shards deferred; every run holds the
    decision and RCA pins, equals the synchronous depth-2 run on states,
    alerts, verdicts and decisions, and its canonical journal equals the
    CPU twin's (phase 16's); the deferred runs defer every tick with
    ``commit_defer_wall_s`` > 0, the depth-2 ones with lane dispatches
    in flight at their barriers (:func:`barrier_probe`), and the 2-shard
    run launches the lane
    kernel from its shard runners' streams only.  (2) The JAX bench's
    elastic legs: static, then ``auto`` on 1-2 thread shards and on 1-2
    process children; each elastic run scales up and down, equals the
    static run on states, alerts, decisions and the journal, and its
    scaling events equal the CPU twin's; launches a shard, and the
    spawned child's start inside ``policy_wall_s``.  (3) The JAX bench's
    tiering pair, off, on and on again (a temporary cold directory
    each): all four counters non-zero and equal to the CPU twin's,
    states, alerts and SLO equal to the off run's, the rerun's journal
    equal to the first.  Launch counts are reset before each block and
    read after it."""
    import dataclasses
    import tempfile

    import torch

    from anomod_torch.obs.flight import state_digest
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve import engine as eng_mod
    from anomod_torch.serve.engine import (ASYNC_REPORT_FIELDS,
                                           POLICY_REPORT_FIELDS,
                                           TIERING_REPORT_FIELDS,
                                           VARIANT_REPORT_FIELDS,
                                           run_power_law)
    t_phase = time.perf_counter()

    def decisions(r, skip=()):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS + tuple(skip)
                and k != "device"}

    def verdicts(eng):
        return [repr(v.to_dict()) for v in eng.rca_verdicts]

    def scaling(eng):
        return [ev for t in eng.flight_recorder.records()
                for ev in t["scaling"]]

    # -- (1) the deferred-commit tick --------------------------------------
    kw = dict(SERVE_KW, device=dev, rca=True, flight=True)
    sk.reset_launches()
    runs, probes = {}, {}
    for depth in (2, 1):
        for defer in (False, True):
            name = f"p{depth}-{'deferred' if defer else 'sync'}"
            with barrier_probe() as probes[name]:
                runs[name] = run_power_law(pipeline=depth,
                                           async_commit=defer, **kw)
    with lane_streams(dev) as seen, \
            barrier_probe() as probes["2shards-deferred"]:
        runs["2shards-deferred"] = run_power_law(shards=2,
                                                 async_commit=True, **kw)
    async_launches = dict(sk.launches)
    e_ref, r_ref = runs["p2-sync"]
    want_fp, want_v = serve_fingerprint(e_ref), verdicts(e_ref)
    out = {"async": {}}
    for name, (eng, rep) in runs.items():
        got = {"p99_latency_s": rep.latency["p99_latency_s"],
               "shed_fraction": rep.shed_fraction, "n_alerts": rep.n_alerts}
        check(got == SERVE_PINS, f"{name}: pins {got} != {SERVE_PINS}")
        rca = {"n_rca_runs": rep.n_rca_runs, "rca_eligible": rep.rca_eligible,
               "rca_topk_hits": rep.rca_topk_hits}
        check(rca == RCA_PINS, f"{name}: rca pins {rca} != {RCA_PINS}")
        got, want = (decisions(r, ASYNC_REPORT_FIELDS) for r in (rep, r_ref))
        check(serve_fingerprint(eng) == want_fp and verdicts(eng) == want_v
              and got == want,
              f"{name}: states, alerts, verdicts or decisions differ from "
              f"the synchronous run's: {field_diff(got, want)}")
        check(eng.flight_recorder.canonical_bytes() == cpu_journal,
              f"{name}: canonical journal differs from the CPU twin's")
        deferred = "deferred" in name
        check(rep.async_commit == deferred
              and rep.async_ticks == (rep.ticks if deferred else 0)
              and (rep.commit_defer_wall_s > 0) == deferred,
              f"{name}: async {rep.async_commit}, {rep.async_ticks} of "
              f"{rep.ticks} ticks deferred, {rep.commit_defer_wall_s} s")
        out["async"][name] = dict(
            async_ticks=rep.async_ticks,
            commit_defer_wall_s=rep.commit_defer_wall_s,
            serve_wall_s=rep.serve_wall_s, stage_wall_s=rep.stage_wall_s,
            dispatch_wall_s=rep.dispatch_wall_s,
            fold_wall_s=rep.fold_wall_s, score_wall_s=rep.score_wall_s,
            n_checkpoints=rep.n_checkpoints,
            barriers=probes[name]["barriers"],
            inflight_at_barrier=probes[name]["inflight"],
            done_at_barrier=probes[name]["done"],
            barrier_drain_s=probes[name]["drain_s"])
        if deferred and not name.startswith("p1"):
            # depth 1 retires each dispatch before the next is issued:
            # only depth 2 can leave one in flight under the deferral
            check(probes[name]["inflight"] > 0,
                  f"{name}: no lane dispatch was in flight at any barrier")
    e2 = runs["2shards-deferred"][0]
    own = {r.stream.cuda_stream for r in e2._runners}
    check(set(seen) == own and len(own) == 2
          and torch.cuda.default_stream(dev).cuda_stream not in own,
          f"2 shards deferred: lane_delta launched on {set(seen)}, the "
          f"runners' streams are {own}")
    for k, v in async_launches.items():
        check(v > 0, f"deferred block: kernel {k} was not launched")
    out["async_launches"] = async_launches
    for name, r in out["async"].items():
        log(f"[22] {name} on {card}: pins, states, alerts, verdicts, "
            f"decisions and the CPU twin's journal held; deferred ticks "
            f"{r['async_ticks']}, commit_defer_wall_s "
            f"{r['commit_defer_wall_s']:.6f}; at {r['barriers']} "
            f"barriers {r['inflight_at_barrier']} dispatches in flight, "
            f"{r['done_at_barrier']} of them done, barrier drain "
            f"{r['barrier_drain_s']:.6f} s; serve wall "
            f"{r['serve_wall_s']:.4f} s (stage {r['stage_wall_s']}, "
            f"dispatch {r['dispatch_wall_s']}, fold {r['fold_wall_s']}, "
            f"score {r['score_wall_s']})")
    log(f"[22] deferred block launches {async_launches}; the 2-shard "
        f"deferred run launched lane_delta on its two shard streams only")

    # -- (2) the elastic policy --------------------------------------------
    kw = dict(ELASTIC_KW, device=dev)
    sk.reset_launches()
    e_st, r_st = run_power_law(shards=1, chaos=ELASTIC_SURGE, **kw)
    with lane_streams(dev) as seen:
        e_th, r_th = run_power_law(**ELASTIC_POLICY, **kw)
    stream0 = e_th._runners[0].stream.cuda_stream
    by_shard_th = {"0": sum(1 for x in seen if x == stream0),
                   "1": sum(1 for x in seen if x != stream0)}
    thread_launches = dict(sk.launches)
    child = {}
    real_apply = eng_mod.ServeEngine._apply_shard_reply

    def apply(self, s, rep):
        for k, n in rep.get("launches", {}).items():
            child.setdefault(str(s), {}).setdefault(k, 0)
            child[str(s)][k] += n
        return real_apply(self, s, rep)
    sk.reset_launches()
    eng_mod.ServeEngine._apply_shard_reply = apply
    try:
        with child_hellos() as hellos:
            e_pr, r_pr = run_power_law(worker="process", **ELASTIC_POLICY,
                                       **kw)
    finally:
        eng_mod.ServeEngine._apply_shard_reply = real_apply
    coord_launches = dict(sk.launches)
    t0 = time.perf_counter()
    twins = twin_job.get()
    wait_s = time.perf_counter() - t0
    events, cpu_s = twins["elastic"]
    want_fp = serve_fingerprint(e_st)
    want_alerts = {t: e_st.alerts_for(t) for t in e_st._tenant_det}
    journal = e_st.flight_recorder.canonical_bytes()
    out["elastic"] = {"static_serve_wall_s": r_st.serve_wall_s,
                      "cpu_twin_wall_s": cpu_s,
                      "cpu_twins_wait_s": wait_s,
                      "events": [{k: ev[k] for k in ("kind", "tick")
                                  if k in ev} for ev in events]}
    for name, eng, rep in (("thread", e_th, r_th), ("process", e_pr, r_pr)):
        check(rep.n_scale_ups >= 1 and rep.n_scale_downs >= 1
              and rep.peak_shards == 2 and rep.worker == name,
              f"elastic {name}: {rep.n_scale_ups} up, {rep.n_scale_downs} "
              f"down, peak {rep.peak_shards}, worker {rep.worker}")
        # the children hold the process run's states: its journal's
        # digests stand for them
        got, want = (decisions(r, POLICY_REPORT_FIELDS) for r in (rep, r_st))
        check((serve_fingerprint(eng) == want_fp if name == "thread" else
               {t: eng.alerts_for(t) for t in eng._tenant_det}
               == want_alerts) and got == want,
              f"elastic {name}: states, alerts or decisions differ from "
              f"the static run's: {field_diff(got, want)}")
        check(eng.flight_recorder.canonical_bytes() == journal,
              f"elastic {name}: journal differs from the static run's")
        check(scaling(eng) == events,
              f"elastic {name}: scaling events {scaling(eng)} differ from "
              f"the CPU twin's {events}")
        out["elastic"][name] = dict(
            n_scale_ups=rep.n_scale_ups, n_scale_downs=rep.n_scale_downs,
            n_rebalances=rep.n_rebalances, peak_shards=rep.peak_shards,
            n_policy_migrations=rep.n_policy_migrations,
            brownout_ticks=rep.brownout_ticks,
            policy_wall_s=rep.policy_wall_s, serve_wall_s=rep.serve_wall_s,
            migrated_spans=eng.policy_migrated_spans)
    out["elastic"]["thread"]["launches_by_shard"] = {
        "lane_delta": by_shard_th}
    out["elastic"]["thread"]["launches"] = thread_launches
    check(coord_launches["lane_delta"] == 0
          and child.get("1", {}).get("lane_delta", 0) > 0,
          f"elastic process: coordinator launches {coord_launches}, the "
          f"children's {child}")
    spawned = [dict(boot_s=h["boot_s"], init_s=h["init_s"])
               for h in hellos[1:]]
    out["elastic"]["process"].update(
        launches_by_shard=child, worker_start_s=e_pr.worker_start_s,
        child_start_in_policy_wall_s=spawned)
    for k, v in thread_launches.items():
        check(v > 0, f"elastic block: kernel {k} was not launched")
    for name in ("thread", "process"):
        r = out["elastic"][name]
        log(f"[22] elastic {name} on {card} ({ELASTIC_SURGE}, auto, 1-2 "
            f"shards, cooldown 5): {r['n_scale_ups']} up, "
            f"{r['n_scale_downs']} down, {r['n_rebalances']} rebalances, "
            f"peak {r['peak_shards']} shards, {r['n_policy_migrations']} "
            f"tenants migrated ({r['migrated_spans']} spans), brownout "
            f"ticks {r['brownout_ticks']}; states, alerts, decisions and "
            f"the journal equal the static run's, scaling events the CPU "
            f"twin's; policy_wall_s {r['policy_wall_s']} of a "
            f"{r['serve_wall_s']} s serve wall (static "
            f"{r_st.serve_wall_s}); launches by shard "
            f"{r['launches_by_shard']}"
            + (f"; the scale-up's child start (interpreter and imports, "
               f"shard plane) {spawned} inside policy_wall_s"
               if name == "process" else ""))

    # -- (3) state tiering -------------------------------------------------
    sk.reset_launches()
    e_off, r_off = run_power_law(shards=1, device=dev, **TIER_KW)
    tiered = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as cold:
            tiered.append(run_power_law(shards=1, device=dev,
                                        tier_cold_dir=cold, **TIER_ON,
                                        **TIER_KW))
    tier_launches = dict(sk.launches)
    want, tier_cpu_s = twins["tiering"]
    (e_on, r_on), (e_on2, r_on2) = tiered
    for name, eng, rep in (("on", e_on, r_on), ("rerun", e_on2, r_on2)):
        got = [getattr(rep, k) for k in TIERING_REPORT_FIELDS]
        check(min(got[1:]) > 0 and got == want,
              f"tiering {name}: counters {got}, the CPU twin's {want}")
        check(len(eng._tier) == 0
              and state_digest(eng._tenant_replay)
              == state_digest(e_off._tenant_replay)
              and {t: eng.alerts_for(t) for t in e_off._tenant_det}
              == {t: e_off.alerts_for(t) for t in e_off._tenant_det}
              and (rep.latency, rep.shed_spans, rep.served_spans)
              == (r_off.latency, r_off.shed_spans, r_off.served_spans),
              f"tiering {name}: states, alerts or SLO differ from the "
              "never-evicted run's")
    check(e_on2.flight_recorder.canonical_bytes()
          == e_on.flight_recorder.canonical_bytes(),
          "tiering: the rerun's journal differs from the first")
    for k, v in tier_launches.items():
        check(v > 0, f"tiering block: kernel {k} was not launched")
    out["tiering"] = dict(
        counters=dict(zip(TIERING_REPORT_FIELDS, want)),
        tier_wall_s=[r_on.tier_wall_s, r_on2.tier_wall_s],
        tier_prefetch_hidden=[r_on.tier_prefetch_hidden,
                              r_on2.tier_prefetch_hidden],
        serve_wall_s={"off": r_off.serve_wall_s, "on": r_on.serve_wall_s,
                      "rerun": r_on2.serve_wall_s},
        cpu_twin_wall_s=tier_cpu_s, launches=tier_launches)
    log(f"[22] tiering on {card} (48 tenants, hot 12, demote after 2, "
        f"warm 4096 B, prefetch 2): counters {out['tiering']['counters']} "
        f"equal the CPU twin's; states, alerts and SLO equal the off run's; "
        f"the rerun's journal equals the first; tier_wall_s "
        f"{out['tiering']['tier_wall_s']}, prefetch hidden "
        f"{out['tiering']['tier_prefetch_hidden']} of "
        f"{want[4]} misses; serve wall {out['tiering']['serve_wall_s']}")
    out["launches"] = {
        k: async_launches.get(k, 0) + thread_launches.get(k, 0)
        + sum(c.get(k, 0) for c in child.values()) + tier_launches.get(k, 0)
        for k in ("lane_delta", "window_gather")}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[22] phase 22 in {out['phase_wall_s']:.1f} s; serve kernel "
        f"launches {out['launches']}")
    return {"elastic_async_tier": out}


#: phase 23a: the JAX serve bench's live-feed leg (``bench.py:468-493``):
#: the dogfood loop, 4 tenants and services, 10 s in 1 s ticks
FEED_DOGFOOD = dict(n_tenants=4, n_services=4, capacity_spans_per_s=2000.0,
                    duration_s=10.0, tick_s=1.0, window_s=2.0,
                    baseline_windows=2, buckets=(64,), n_windows=16,
                    flight=True, flight_digest_every=2)
#: phase 23b: the feed at the TT deployment's full width (45 tenants and
#: services, the stream's 60 s windows, 32 windows), over one TT fault
#: experiment at phase 15's 400 traces served by a Jaeger stub
FEED_TT_LABEL = "Lv_P_CPU_preserve"
FEED_TT = dict(n_tenants=45, n_services=45, window_s=60.0, n_windows=32,
               tick_s=60.0, lag_s=2.0)
#: phase 23c: the sidecar's ticks
SIDECAR_TICK_S = 60.0


class JaegerStub:
    """A Jaeger query service on ``127.0.0.1`` over one Jaeger document,
    in the form of the JAX tests' ``JsonStub`` (``tests/test_live.py``):
    ``/api/services`` and ``/api/traces?service=&start=&end=``, a trace
    served for each service it touches once its latest span has started
    inside the ``[start, end]`` window (epoch µs)."""

    def __init__(self, doc):
        import bisect
        import threading
        import urllib.parse
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        by_svc = {}
        for tr in doc["data"]:
            last = max(int(sp["startTime"]) for sp in tr["spans"])
            for svc in sorted({p["serviceName"]
                               for p in tr["processes"].values()}):
                by_svc.setdefault(svc, []).append((last, tr["traceID"], tr))
        for rows in by_svc.values():
            rows.sort(key=lambda r: (r[0], r[1]))
        self.n_requests = 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                stub.n_requests += 1
                parsed = urllib.parse.urlparse(self.path)
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                if parsed.path == "/api/services":
                    body = {"data": sorted(by_svc)}
                elif parsed.path == "/api/traces":
                    rows = by_svc.get(q.get("service"), [])
                    keys = [r[0] for r in rows]
                    lo = bisect.bisect_left(keys, int(q["start"]))
                    hi = bisect.bisect_right(keys, int(q["end"]))
                    body = {"data": [r[2] for r in rows[lo:hi]]}
                else:
                    self.send_error(404)
                    return
                payload = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@contextlib.contextmanager
def traffic_walls():
    """The traffic source's own wall inside the block, summed over every
    call the engine's run loop makes: ``LiveFeed.arrivals`` (the feed's
    polls, span synthesis and windowing) and ``ScriptedTraffic``'s
    ``arrivals`` / ``modality_arrivals`` (the sidecar's slicing)."""
    from anomod_torch.serve.feed import LiveFeed
    from anomod_torch.serve.traffic import ScriptedTraffic
    walls = {"s": 0.0, "calls": 0}
    patched = [(cls, name, getattr(cls, name))
               for cls, name in ((LiveFeed, "arrivals"),
                                 (ScriptedTraffic, "arrivals"),
                                 (ScriptedTraffic, "modality_arrivals"))]

    def timed_method(real):
        def method(self, lo, hi):
            t0 = time.perf_counter()
            try:
                return real(self, lo, hi)
            finally:
                walls["s"] += time.perf_counter() - t0
                walls["calls"] += 1
        return method
    for cls, name, real in patched:
        setattr(cls, name, timed_method(real))
    try:
        yield walls
    finally:
        for cls, name, real in patched:
            setattr(cls, name, real)


def feed_tt_run(f, device):
    """Phase 23b's engine over feed ``f``, built the way ``run_live_feed``
    builds it (its defaults, 60 s ticks, 32 windows): ``(engine,
    report)``."""
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    eng = ServeEngine(f.specs, f.services,
                      serve_plane_cfg(len(f.services), FEED_TT["window_s"],
                                      FEED_TT["n_windows"]),
                      capacity_spans_per_s=2000.0,
                      tick_s=FEED_TT["tick_s"], device=device, flight=True)
    rep = eng.run(f, duration_s=FEED_TT["n_windows"] * FEED_TT["tick_s"])
    return eng, rep


def sidecar_corpus():
    """Phase 23c's fleet: each of the 13 TT labels one tenant, at phase
    15's corpus (``stream_quality("TT", 400, multimodal=True)``'s
    experiments, logs, metrics and API), as a ``ScriptedTraffic``."""
    from anomod_torch import synth
    from anomod_torch.quality import SHIFTS
    from anomod_torch.rca import experiment_plan
    from anomod_torch.serve.queues import TenantSpec
    from anomod_torch.serve.traffic import ScriptedTraffic
    hard = synth.HardMode(severity=1.0, noise=0.0, **SHIFTS["in-dist"])
    exps = [synth.generate_experiment(label, n_traces=400, seed=gen_seed,
                                      hard=mode)
            for label, mode, gen_seed in experiment_plan("TT", 0, hard=hard)]
    services = exps[0].spans.services
    check(all(e.spans.services == services for e in exps),
          "sidecar: the TT experiments do not share one service table")
    t0 = min(int(e.spans.start_us.min()) for e in exps)
    specs = [TenantSpec(tenant_id=i, name=e.name) for i, e in enumerate(exps)]
    return ScriptedTraffic({i: e.spans for i, e in enumerate(exps)},
                           specs, t0, experiments=dict(enumerate(exps)))


def sidecar_run(device, traffic=None):
    """Phase 23c's sidecar engine (``multimodal=True``, ``testbed="TT"``,
    60 s ticks, every span served) over :func:`sidecar_corpus`, under an
    ``ANOMOD_SERVE_POLICY=auto`` setting it turns off:
    ``(engine, report, traffic)``."""
    import dataclasses

    from anomod_torch.config import get_config, set_config
    from anomod_torch.replay import ReplayConfig
    from anomod_torch.serve.engine import ServeEngine
    if traffic is None:
        traffic = sidecar_corpus()
    services = next(iter(traffic.streams.values())).services
    prev = set_config(dataclasses.replace(get_config(), serve_policy="auto"))
    try:
        eng = ServeEngine(traffic.specs, services,
                          ReplayConfig(n_services=len(services),
                                       chunk_size=4096),
                          t0_us=traffic.t0_us,
                          capacity_spans_per_s=10_000_000,
                          tick_s=SIDECAR_TICK_S, max_backlog=10_000_000,
                          multimodal=True, testbed="TT", device=device)
    finally:
        set_config(prev)
    rep = eng.run(traffic, duration_s=traffic.end_s() + SIDECAR_TICK_S)
    return eng, rep, traffic


def _run_digest(eng, rep, f=None) -> dict:
    """What phase 23 holds equal across a run and its twins: the
    canonical journal, states and alerts, latency, shed and the feed's
    counts."""
    out = dict(journal=eng.flight_recorder.canonical_bytes(),
               fingerprint=serve_fingerprint(eng), latency=rep.latency,
               shed_fraction=rep.shed_fraction,
               served_spans=rep.served_spans,
               modality_events=rep.modality_events)
    if f is not None:
        out.update(n_polls=f.n_polls, n_samples=f.n_samples,
                   n_spans=f.n_spans, n_gaps=f.n_gaps)
    return out


def feed_cpu_twin(job: str, wire: str = "") -> tuple:
    """Phase 23's CPU twin, run in a spawned process: ``dogfood`` /
    ``tt`` replay the wire journal at ``wire``, ``sidecar`` builds the
    sidecar run's corpus and serves it; returns the run's digest
    (:func:`_run_digest`) and its wall."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from anomod_torch.obs.registry import Registry, set_registry
    from anomod_torch.serve import feed
    set_registry(Registry(enabled=True))
    t0 = time.perf_counter()
    if job == "dogfood":
        kw = {k: v for k, v in FEED_DOGFOOD.items()
              if k not in ("n_tenants", "n_services")}
        eng, rep, f = feed.run_live_feed(replay=wire, device="cpu", **kw)
        return _run_digest(eng, rep, f), time.perf_counter() - t0
    if job == "tt":
        f = feed.LiveFeed.from_journal(wire)
        eng, rep = feed_tt_run(f, "cpu")
        return _run_digest(eng, rep, f), time.perf_counter() - t0
    import dataclasses
    eng, rep, _ = sidecar_run("cpu")
    d = _run_digest(eng, rep)
    d["alerts"] = {t: [dataclasses.asdict(a) for a in eng.alerts_for(t)]
                   for t in sorted(eng._tenant_det)}
    return d, time.perf_counter() - t0


def _held(name, got, want, keys):
    for k in keys:
        check(got[k] == want[k], f"{name}: {k} differs ({str(got[k])[:200]} "
              f"against {str(want[k])[:200]})")


def live_feed_phase(dev, card) -> dict:
    """Phase 23: the live feed and the multimodal sidecar in the serve
    tick, on the card.  (a) The JAX serve bench's live-feed leg: the
    dogfood loop (an ``ObsHttpServer`` on a fresh registry scraped by
    ``run_live_feed``) live and recorded, replayed on the card, and
    replayed by a CPU twin in a spawned process: equal canonical
    journals, states, alerts, latency and shed, ``n_polls`` wire entries.
    (b) The feed at the TT deployment's full width: a Jaeger stub serving
    one TT fault experiment (400 traces), a ``LiveFeed`` of 45 tenants
    and services pinned to the corpus start, the engine ``run_live_feed``
    builds in 60 s ticks; live, card replay and CPU-twin replay equal,
    gap counts too.  (c) The sidecar: the 13 TT labels one tenant each
    (phase 15's corpus, logs, metrics and API), ``multimodal=True``,
    held to the port's sequential ``MultimodalDetector`` fed the same
    slices on the card (alert lists and first-alert windows; scores
    within ``RTOL_CARD``) and to the CPU twin (alerts and
    ``modality_events`` exactly); supervision and the policy off.  Each
    run's serve wall, the feed's own wall, polls / samples / spans /
    gaps and the serve kernels' launches (counts reset before each run,
    read after) are printed; (b) and (c) give a profiled busy share."""
    import dataclasses
    import multiprocessing
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch import synth
    from anomod_torch.labels import label_for
    from anomod_torch.obs.http import ObsHttpServer
    from anomod_torch.obs.registry import (Registry, get_registry,
                                           set_registry)
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve import feed
    from anomod_torch.stream import MultimodalDetector, StreamReplay
    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory()
    prev_reg = get_registry()
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        twin_sidecar = pool.apply_async(feed_cpu_twin, ("sidecar",))

        def kernel_run(fn):
            sk.reset_launches()
            with traffic_walls() as walls:
                got = fn()
            return got, dict(sk.launches), walls

        def profiled(fn):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = device_busy_ms(prof)
            return dict(profiled_wall_s=wall, device_busy_ms=busy,
                        device_busy_share=None if busy is None
                        else busy / 1e3 / wall)

        def record(name, rep, f, launches, walls):
            r = dict(serve_wall_s=rep.serve_wall_s, feed_wall_s=walls["s"],
                     feed_calls=walls["calls"],
                     served_spans=rep.served_spans, n_alerts=rep.n_alerts,
                     modality_events=rep.modality_events,
                     launches=launches)
            if f is not None:
                r.update(n_polls=f.n_polls, n_samples=f.n_samples,
                         n_spans=f.n_spans, n_gaps=f.n_gaps)
            out.setdefault(name[:3], {})[name] = r
            log(f"[23] {name} on {card}: serve wall {rep.serve_wall_s:.4f} "
                f"s, traffic's own wall {walls['s']:.4f} s over "
                f"{walls['calls']} calls; " + (f"polls {f.n_polls}, samples {f.n_samples}, "
                              f"spans {f.n_spans}, gaps {f.n_gaps}; "
                              if f is not None else "")
                + f"served {rep.served_spans}, alerts {rep.n_alerts}; "
                + (f"modality events {rep.modality_events}; "
                   if rep.modality_events else "")
                + f"launches {launches}")

        # -- (a) the dogfood loop ----------------------------------------
        kw = {k: v for k, v in FEED_DOGFOOD.items()
              if k not in ("n_tenants", "n_services")}
        wire = str(Path(tmp.name) / "dogfood_wire.json")
        set_registry(Registry(enabled=True))
        with ObsHttpServer(port=0) as srv:
            (ea, ra, fa), la, wa = kernel_run(lambda: feed.run_live_feed(
                scrape_url=f"{srv.url}/metrics", n_tenants=4, n_services=4,
                journal=wire, device=dev, **kw))
        twin_a = pool.apply_async(feed_cpu_twin, ("dogfood", wire))
        (eb, rb, fb), lb, wb = kernel_run(lambda: feed.run_live_feed(
            replay=wire, device=dev, **kw))
        doc = feed.load_feed_journal(wire)
        check(len(doc["entries"]) == fa.n_polls == 10,
              f"dogfood: {len(doc['entries'])} wire entries, {fa.n_polls} "
              "polls")
        check(fb.transport.n_served == fa.n_polls,
              "dogfood: the replay served another entry count")
        live_d, rep_d = _run_digest(ea, ra, fa), _run_digest(eb, rb, fb)
        check(ra.served_spans > 0, "dogfood: nothing served")
        keys = ("journal", "fingerprint", "latency", "shed_fraction",
                "served_spans", "n_polls", "n_samples", "n_spans", "n_gaps")
        _held("dogfood card replay", rep_d, live_d, keys)
        for name, launches in (("live", la), ("replay", lb)):
            check(launches["lane_delta"] > 0,
                  f"dogfood {name}: lane_delta was not launched")
        record("23a-live", ra, fa, la, wa)
        record("23a-card-replay", rb, fb, lb, wb)

        # -- (b) the feed at the TT deployment's width -------------------
        exp_spans = synth.generate_spans(label_for(FEED_TT_LABEL),
                                         n_traces=400, seed=0)
        jdoc = synth.spans_to_jaeger_json(exp_spans)
        t0_wall = int(exp_spans.start_us.min()) / 1e6
        stub = JaegerStub(jdoc)
        tt_wire = str(Path(tmp.name) / "tt_wire.json")
        try:
            set_registry(Registry(enabled=True))
            f_live = feed.LiveFeed(jaeger_url=stub.url,
                                   n_tenants=FEED_TT["n_tenants"],
                                   n_services=FEED_TT["n_services"],
                                   lag_s=FEED_TT["lag_s"],
                                   t0_wall_s=t0_wall)
            (ec, rc), lc, wc = kernel_run(lambda: feed_tt_run(f_live, dev))
            f_live.dump_journal(tt_wire)
        finally:
            stub.close()
        twin_b = pool.apply_async(feed_cpu_twin, ("tt", tt_wire))
        f_rep = feed.LiveFeed.from_journal(tt_wire)
        (ed, rd), ld, wd = kernel_run(lambda: feed_tt_run(f_rep, dev))
        live_tt, rep_tt = _run_digest(ec, rc, f_live), _run_digest(ed, rd,
                                                                    f_rep)
        check(rc.served_spans > 0 and f_live.n_spans > 0,
              f"tt feed: {f_live.n_spans} spans, {rc.served_spans} served")
        _held("tt feed card replay", rep_tt, live_tt, keys)
        for name, launches in (("live", lc), ("replay", ld)):
            for k in ("lane_delta", "window_gather"):
                check(launches[k] > 0,
                      f"tt feed {name}: {k} was not launched")
        record("23b-live", rc, f_live, lc, wc)
        record("23b-card-replay", rd, f_rep, ld, wd)
        out["23b"]["stub_requests"] = stub.n_requests
        out["23b"]["wire_bytes"] = Path(tt_wire).stat().st_size
        set_registry(Registry(enabled=True))
        out["23b"]["profile"] = profiled(
            lambda: feed_tt_run(feed.LiveFeed.from_journal(tt_wire), dev))

        # -- (c) the sidecar -----------------------------------------------
        set_registry(Registry(enabled=True))
        traffic = sidecar_corpus()
        (ee, re_, _), le, we = kernel_run(lambda: sidecar_run(dev, traffic))
        check(le["lane_delta"] > 0, "sidecar: lane_delta was not launched")
        check(min(re_.modality_events.get(k, 0)
                  for k in ("logs", "metrics", "api")) > 0,
              f"sidecar: modality events {re_.modality_events}")
        check(not re_.supervised and re_.policy == "off"
              and ee.policy is None and ee.ckpt_every == 0,
              f"sidecar: supervised {re_.supervised}, policy {re_.policy}")
        record("23c-sidecar", re_, None, le, we)
        # the sequential oracle on the card: one MultimodalDetector a
        # tenant on a card StreamReplay (dense_slice_fold), fed the same
        # one-clock slices, modalities first
        t0 = time.perf_counter()
        solo = {t: MultimodalDetector(
            ee.services, ee.cfg, ee.t0_us, testbed="TT",
            replay=StreamReplay(ee.cfg, ee.t0_us, device=dev),
            **ee._det_kw) for t in traffic.streams}
        duration = traffic.end_s() + SIDECAR_TICK_S
        lo = 0.0
        while lo < round(duration / SIDECAR_TICK_S) * SIDECAR_TICK_S:
            hi = lo + SIDECAR_TICK_S
            for tid, kind, mb in traffic.modality_arrivals(lo, hi):
                getattr(solo[tid], f"push_{kind}")(mb)
            for tid, mb in traffic.arrivals(lo, hi):
                solo[tid].push(mb)
            lo = hi
        for det in solo.values():
            det.finish()
        oracle_s = time.perf_counter() - t0
        worst = 0.0
        for tid, det in solo.items():
            got, want = ee.alerts_for(tid), det.alerts
            check([(a.window, a.service, a.evidence) for a in got]
                  == [(a.window, a.service, a.evidence) for a in want],
                  f"sidecar tenant {tid}: alert list differs from the "
                  "sequential detector's")
            check(ee._tenant_det[tid].first_alert_window()
                  == det.first_alert_window(),
                  f"sidecar tenant {tid}: first-alert window differs")
            for a, b in zip(got, want):
                err = abs(a.score - b.score) / max(abs(b.score), 1e-12)
                worst = max(worst, err)
        check(worst <= RTOL_CARD,
              f"sidecar: scores {worst:.3g} from the oracle's")
        out["23c"]["oracle"] = dict(wall_s=oracle_s, score_rtol=worst,
                                    n_alerts=sum(len(d.alerts)
                                                 for d in solo.values()))
        log(f"[23] sidecar vs the sequential MultimodalDetector on the "
            f"card ({oracle_s:.3f} s): alert lists and first-alert windows "
            f"equal, scores within {worst:.3g} (limit {RTOL_CARD})")
        set_registry(Registry(enabled=True))
        out["23c"]["profile"] = profiled(lambda: sidecar_run(dev, traffic))

        # -- the CPU twins ------------------------------------------------
        t0 = time.perf_counter()
        (ta, ta_s), (tb, tb_s), (tc, tc_s) = (
            j.get(timeout=600) for j in (twin_a, twin_b, twin_sidecar))
        wait_s = time.perf_counter() - t0
        _held("dogfood CPU twin", ta, live_d, keys)
        _held("tt feed CPU twin", tb, live_tt, keys)
        got_alerts = {t: [dataclasses.asdict(a) for a in ee.alerts_for(t)]
                      for t in sorted(ee._tenant_det)}
        check(got_alerts == tc["alerts"],
              "sidecar: alerts differ from the CPU twin's")
        _held("sidecar CPU twin", _run_digest(ee, re_), tc,
              ("modality_events", "journal", "fingerprint", "latency",
               "shed_fraction", "served_spans"))
        out["cpu_twin_wall_s"] = {"23a": ta_s, "23b": tb_s, "23c": tc_s,
                                  "wait_s": wait_s}
        log(f"[23] CPU twins (a spawned process): dogfood {ta_s:.2f} s, tt "
            f"feed {tb_s:.2f} s, sidecar {tc_s:.2f} s (waited {wait_s:.2f} "
            f"s): every journal, state, alert, latency, shed, gap count and "
            f"modality count equal the card's")
    finally:
        pool.terminate()
        pool.join()
        set_registry(prev_reg)
        tmp.cleanup()
    for part in ("23b", "23c"):
        p = out[part]["profile"]
        busy = p["device_busy_ms"]
        log(f"[23] {part} profiled on {card}: device busy "
            + ("not measured (no device events)" if busy is None else
               f"{busy:.3f} ms in {p['profiled_wall_s']:.3f} s, share "
               f"{p['device_busy_share']:.4g}"))
    out["launches"] = {
        k: sum(r["launches"].get(k, 0) for part in ("23a", "23b", "23c")
               for r in out[part].values() if isinstance(r, dict)
               and "launches" in r)
        for k in ("lane_delta", "window_gather")}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[23] phase 23 in {out['phase_wall_s']:.1f} s; serve kernel "
        f"launches {out['launches']}")
    return {"live_feed": out}


#: phase 24a: perf off / on turns (alternating; the overhead is the median
#: of the turns' fractions).  Two: on one host the fractions spread from
#: -0.18 to 0.04, so a third turn does not make the median readable
PERF_TURNS = 2
#: phase 24b: the census cadence (the engine's default)
CENSUS_EVERY = 8
#: phase 24c: the tiered sweep's tier geometry (the JAX bench's,
#: ``bench.py:426-438``); its sizes are the untiered sweep's and 10x its
#: largest
SWEEP_TIER = dict(tier_hot=1_000, tier_demote_after=2)
#: the JAX package's committed serve capture
#: (``bench_runs/20260807T091231Z_serve_sustained_throughput_cpu.json``):
#: the JAX engine's CPU figures of the same sweep, printed beside the
#: port's, never compared
JAX_SWEEP_CPU = {"bytes_slope_per_registered": 34.0,
                 "resident_bytes": {1000: 5493112, 10000: 5799112,
                                    100000: 8859112}}
#: the eleven census gauges
CENSUS_GAUGES = ("anomod_census_resident_bytes", "anomod_census_pool_bytes",
                 "anomod_census_scratch_bytes",
                 "anomod_census_admission_bytes", "anomod_census_slo_bytes",
                 "anomod_census_rca_bytes", "anomod_census_recorder_bytes",
                 "anomod_census_registered_tenants",
                 "anomod_census_resident_tenants",
                 "anomod_census_hot_tenants",
                 "anomod_census_slot_occupancy_fraction")


def census_stream(eng) -> str:
    """A run's journal ``census`` stream (census ticks only), serialized
    deterministically: the byte-equality surface."""
    return json.dumps([rec["census"] for rec in eng.flight_recorder.records()
                       if rec["census"]["planes"]],
                      sort_keys=True, separators=(",", ":"))


def sweep_bytes(doc) -> list:
    """The bytes rows of a fleet sweep (what does not depend on walls)."""
    return [(r["registered"], r["resident_bytes"], r["bytes_by_plane"],
             r["pool_reconciled"]) for r in doc["rows"]]


def census_cpu_twin() -> tuple:
    """Phase 24's CPU twin, run in a spawned process: the census run's
    stream and hot-set document, and both sweeps' bytes rows.  One torch
    thread: the plain lane fold's ``index_add_`` piles every padding row
    onto one segment, and those adds contend under torch's thread pool."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    torch.set_num_threads(1)
    from anomod_torch.obs.census import fleet_probe
    from anomod_torch.serve.engine import run_power_law
    t0 = time.perf_counter()
    eng, rep = run_power_law(device="cpu", rca=True, census=True,
                             census_every=CENSUS_EVERY, **SERVE_KW)
    sweep = fleet_probe(device="cpu")
    tiered = fleet_probe(device="cpu", sizes=[*sweep["sizes"],
                                              10 * max(sweep["sizes"])],
                         **SWEEP_TIER)
    return ({"stream": census_stream(eng), "hot": rep.census_hot_set,
             "sweep": sweep_bytes(sweep), "tiered": sweep_bytes(tiered)},
            time.perf_counter() - t0)


def perf_reconciles(name, eng, rep) -> dict:
    """Phase 24a's timeline checks on one perf-on run: every event
    complete and in lifecycle order, the dispatch and fold stamps summing
    to the report's legs within their 4-digit rounding, the stage stamps
    inside the stage leg (the bucket plan is not a dispatch event), the
    wait inside the fold leg and equal to ``fold_wait_s``."""
    from anomod_torch.obs.perf import EVENT_FIELDS
    evs = eng.perf_events
    check(rep.perf_events_recorded > 0 and eng.perf_events_dropped == 0
          and len(evs) == rep.perf_events_recorded,
          f"{name}: {rep.perf_events_recorded} events recorded, "
          f"{eng.perf_events_dropped} dropped, {len(evs)} kept")
    check(all(set(EVENT_FIELDS) == set(e) for e in evs),
          f"{name}: an event lacks a field")
    sums = {leg: sum(e[b] - e[a] for e in evs) for leg, a, b in (
        ("dispatch", "submitted_t0", "submitted"),
        ("fold", "retire_t0", "folded"), ("stage", "staged_t0", "staged"),
        ("wait", "retire_t0", "materialized"))}
    for leg, wall in (("dispatch", rep.dispatch_wall_s),
                      ("fold", rep.fold_wall_s)):
        check(abs(sums[leg] - wall) <= 1e-3 + 0.01 * sums[leg],
              f"{name}: the {leg} stamps sum to {sums[leg]:.6f} s against "
              f"the report's {wall} s")
    check(0.0 < sums["stage"] <= rep.stage_wall_s + 1e-3
          and 0.0 < sums["wait"] <= sums["fold"] + 1e-9
          and abs(sums["wait"] - rep.fold_wait_s) < 1e-6
          and 0.0 <= rep.overlap_headroom_s <= rep.fold_wait_s + 1e-9,
          f"{name}: stage {sums['stage']}, wait {sums['wait']} against the "
          f"legs {rep.stage_wall_s} / {rep.fold_wall_s}, headroom "
          f"{rep.overlap_headroom_s}")
    check(all(e["staged_t0"] <= e["staged"] <= e["submitted_t0"]
              <= e["submitted"] <= e["retire_t0"] <= e["materialized"]
              <= e["folded"] for e in evs),
          f"{name}: an event's stamps are out of lifecycle order")
    return {k: round(v, 6) for k, v in sums.items()}


def observatory_phase(dev, card, cpu_journal) -> dict:
    """Phase 24: the perf and census observatories in the serve tick, on
    the card, at the serve bench deployment, RCA on, the engine's
    defaults.  (a) Perf off and on in alternating turns: the decision
    and RCA pins on every run, decisions, states, alerts and verdicts
    equal off / on, the canonical journal the CPU twin's (phase 16's),
    events recorded and none dropped, the timeline reconciled with the
    report's legs (:func:`perf_reconciles`); the same at 2 thread shards
    (shard tags on the events and the trace's lanes) and with the
    deferred commit (``deferred`` stamps); one Chrome trace written to a
    temporary directory and parsed back, one lane a (shard, scratch
    slot).  (b) The census every 8 ticks: ``pool_reconciled``, the
    ``census`` stream byte-equal to a rerun's and to the CPU twin's, the
    hot-set document the twin's, the eleven gauges in the scrape
    journal.  (c) The registered-fleet sweep at ``ANOMOD_CENSUS_SWEEP``'s
    sizes and the tiered one up to 1e6 registered, each row's bytes the
    twin's.  The twin runs in a spawned process meanwhile.  Launch counts
    are reset at the start and read at the end."""
    import dataclasses
    import multiprocessing
    import statistics
    import tempfile

    from anomod_torch import obs
    from anomod_torch.obs.census import fleet_probe
    from anomod_torch.obs.perf import perf_tracer
    from anomod_torch.obs.registry import Registry
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.serve.engine import VARIANT_REPORT_FIELDS, run_power_law
    from anomod_torch.utils.tracing import spans_from_chrome
    t_phase = time.perf_counter()
    kw = dict(SERVE_KW, device=dev, rca=True)

    def decisions(r, skip=()):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k not in VARIANT_REPORT_FIELDS + tuple(skip)
                and k != "device"}

    def held(eng, rep, what):
        got = {"p99_latency_s": rep.latency["p99_latency_s"],
               "shed_fraction": rep.shed_fraction, "n_alerts": rep.n_alerts}
        check(got == SERVE_PINS, f"{what}: pins {got} != {SERVE_PINS}")
        rca = {"n_rca_runs": rep.n_rca_runs, "rca_eligible": rep.rca_eligible,
               "rca_topk_hits": rep.rca_topk_hits}
        check(rca == RCA_PINS, f"{what}: rca pins {rca} != {RCA_PINS}")
        check(eng.flight_recorder.canonical_bytes() == cpu_journal,
              f"{what}: the canonical journal differs from the CPU twin's")

    out = {"24a": {}, "24b": {}, "24c": {}}
    sk.reset_launches()
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        twin_job = pool.apply_async(census_cpu_twin)

        # -- 24a: perf off / on ---------------------------------------------
        walls = {"off": [], "on": []}
        runs = {}
        for leg in ("off", "on") * PERF_TURNS:
            eng, rep = run_power_law(perf=leg == "on", **kw)
            held(eng, rep, f"perf {leg}")
            walls[leg].append(rep.serve_wall_s)
            runs.setdefault(leg, []).append((eng, rep))
        (e_off, r_off), (e_on, r_on) = runs["off"][0], runs["on"][0]
        check(serve_fingerprint(e_on) == serve_fingerprint(e_off)
              and decisions(r_on, ("perf_enabled",))
              == decisions(r_off, ("perf_enabled",))
              and [repr(v.to_dict()) for v in e_on.rca_verdicts]
              == [repr(v.to_dict()) for v in e_off.rca_verdicts],
              "perf: states, alerts, verdicts or decisions differ off / on")
        recon = [perf_reconciles(f"perf on, turn {i}", e, r)
                 for i, (e, r) in enumerate(runs["on"])]
        overhead = [on / off - 1.0 for on, off in zip(walls["on"],
                                                      walls["off"])]
        on_runs = [dict(fold_wait_s=r.fold_wait_s,
                        overlap_headroom_s=r.overlap_headroom_s,
                        fold_wall_s=r.fold_wall_s,
                        bubble_fractions=r.bubble_fractions,
                        events=r.perf_events_recorded, sums=rc)
                   for (_, r), rc in zip(runs["on"], recon)]
        out["24a"] = dict(serve_wall_off_s=walls["off"],
                          serve_wall_on_s=walls["on"],
                          overhead_fraction=overhead,
                          overhead_median=statistics.median(overhead),
                          on_runs=on_runs)
        log(f"[24a] perf on {card}: pins held off and on, states, alerts, "
            f"verdicts and decisions equal, the canonical journal the CPU "
            f"twin's; serve wall off {walls['off']} s, on {walls['on']} s "
            f"(alternating), overhead {overhead}, median "
            f"{out['24a']['overhead_median']:.4g}; each on run: " + "; ".join(
                f"{d['events']} events, fold_wait_s {d['fold_wait_s']} of "
                f"fold_wall_s {d['fold_wall_s']}, overlap_headroom_s "
                f"{d['overlap_headroom_s']}, bubble_fractions "
                f"{d['bubble_fractions']}, stamp sums {d['sums']}"
                for d in on_runs))
        del runs

        for name, extra in (("2 shards", dict(shards=2)),
                            ("deferred", dict(async_commit=True))):
            eng, rep = run_power_law(perf=True, **kw, **extra)
            held(eng, rep, f"perf {name}")
            mode = ("async_commit", "async_ticks")
            check(serve_fingerprint(eng) == serve_fingerprint(e_off)
                  and decisions(rep, mode) == decisions(r_on, mode),
                  f"perf {name}: states, alerts or decisions differ from "
                  f"the 1-shard run")
            sums = perf_reconciles(f"perf {name}", eng, rep)
            shards = sorted({e["shard"] for e in eng.perf_events})
            deferred = sum(e["deferred"] is not None for e in eng.perf_events)
            if name == "2 shards":
                check(shards == [0, 1], f"perf 2 shards: events of {shards}")
                with tempfile.TemporaryDirectory() as tmp:
                    path = Path(tmp) / "perf_trace.json"
                    perf_tracer(eng.perf_events).dump_chrome(path)
                    spans = spans_from_chrome(json.loads(path.read_text()))
                lanes = {}
                for sp in spans:
                    t = sp["tags"]
                    lanes.setdefault(sp["tid"], set()).add(
                        (t["shard"], t["width"], t["lanes"], t["slot"]))
                check(spans and all(len(v) == 1 for v in lanes.values())
                      and {next(iter(v))[0] for v in lanes.values()}
                      == {"0", "1"},
                      "perf 2 shards: the trace's lanes do not map one to "
                      "one onto (shard, scratch slot)")
                trace = dict(spans=len(spans), lanes=len(lanes),
                             names=sorted({sp["name"] for sp in spans}))
            else:
                check(deferred > 0 and rep.async_ticks == rep.ticks,
                      f"perf deferred: {deferred} deferred stamps over "
                      f"{rep.async_ticks} deferred ticks")
            out["24a"][name] = dict(
                serve_wall_s=rep.serve_wall_s, fold_wait_s=rep.fold_wait_s,
                overlap_headroom_s=rep.overlap_headroom_s,
                fold_wall_s=rep.fold_wall_s,
                bubble_fractions=rep.bubble_fractions,
                events=rep.perf_events_recorded, shards=shards,
                deferred_stamps=deferred,
                commit_defer_wall_s=rep.commit_defer_wall_s, sums=sums)
            log(f"[24a] perf {name} on {card}: pins and the journal held; "
                f"events {rep.perf_events_recorded} on shards {shards}, "
                f"deferred stamps {deferred}; serve wall "
                f"{rep.serve_wall_s:.4f} s, fold_wait_s {rep.fold_wait_s} "
                f"of fold_wall_s {rep.fold_wall_s}, overlap_headroom_s "
                f"{rep.overlap_headroom_s}, bubble_fractions "
                f"{rep.bubble_fractions}, commit_defer_wall_s "
                f"{rep.commit_defer_wall_s}")
        out["24a"]["trace"] = trace
        log(f"[24a] Chrome trace of the 2-shard run: {trace['spans']} spans "
            f"on {trace['lanes']} lanes, one a (shard, scratch slot), parsed "
            f"back; span kinds {trace['names']}")

        # -- 24b: the census ------------------------------------------------
        prev = obs.get_registry()
        reg = Registry(enabled=True)
        obs.set_registry(reg)
        try:
            e_c, r_c = run_power_law(census=True, census_every=CENSUS_EVERY,
                                     **kw)
        finally:
            obs.set_registry(prev)
        held(e_c, r_c, "census")
        skip = ("census_enabled", "census_ticks", "census_hot_set")
        check(serve_fingerprint(e_c) == serve_fingerprint(e_off)
              and decisions(r_c, skip) == decisions(r_off, skip),
              "census: states, alerts or decisions differ from census off")
        rb = r_c.census_resident_bytes
        check(rb.get("pool_reconciled") is True,
              f"census: the pool does not reconcile: {rb}")
        names = {sample[1] for sample in reg.journal()}
        missing = [g for g in CENSUS_GAUGES if g not in names]
        check(not missing, f"census: gauges missing from the scrape "
              f"journal: {missing}")
        stream = census_stream(e_c)
        e_r, r_r = run_power_law(census=True, census_every=CENSUS_EVERY, **kw)
        check(census_stream(e_r) == stream,
              "census: the stream differs from a rerun's on the card")
        out["24b"] = dict(census_ticks=r_c.census_ticks,
                          census_wall_s=[r_c.census_wall_s, r_r.census_wall_s],
                          serve_wall_s=[r_c.serve_wall_s, r_r.serve_wall_s],
                          resident_bytes=rb,
                          hot_set=r_c.census_hot_set,
                          stream_bytes=len(stream))
        log(f"[24b] census every {CENSUS_EVERY} ticks on {card}: pins and "
            f"the journal held, decisions equal to census off; "
            f"{r_c.census_ticks} censuses, pool reconciled, stream "
            f"({len(stream)} B) byte-equal to a rerun's; the "
            f"{len(CENSUS_GAUGES)} gauges in the scrape journal; resident "
            f"bytes {rb}; "
            f"census_wall_s {r_c.census_wall_s} / {r_r.census_wall_s} of "
            f"serve walls {r_c.serve_wall_s:.4f} / {r_r.serve_wall_s:.4f} s; "
            f"hot set {r_c.census_hot_set}")

        # -- 24c: the registered-fleet sweep -------------------------------
        sweeps = {}
        obs.set_registry(Registry(enabled=True))
        try:
            t0 = time.perf_counter()
            sweeps["untiered"] = fleet_probe(device=dev)
            sizes = [*sweeps["untiered"]["sizes"],
                     10 * max(sweeps["untiered"]["sizes"])]
            sweeps["tiered"] = fleet_probe(device=dev, sizes=sizes,
                                           **SWEEP_TIER)
            sweep_s = time.perf_counter() - t0
        finally:
            obs.set_registry(prev)
        for name, doc in sweeps.items():
            check(all(r["pool_reconciled"] is True for r in doc["rows"]),
                  f"sweep {name}: a pool does not reconcile")
            out["24c"][name] = dict(
                rows=[{k: r[k] for k in ("registered", "hot",
                                         "median_tick_wall_s",
                                         "mean_tick_wall_s",
                                         "resident_bytes", "bytes_by_plane")}
                      for r in doc["rows"]],
                **{k: doc[k] for k in ("bytes_slope_per_registered",
                                       "bytes_intercept",
                                       "wall_slope_s_per_registered",
                                       "wall_intercept_s")})
            log(f"[24c] {name} sweep on {card}: " + "; ".join(
                f"{r['registered']} registered: median tick "
                f"{r['median_tick_wall_s']} s, {r['resident_bytes']} B "
                f"{r['bytes_by_plane']}" for r in doc["rows"])
                + f"; slopes {doc['bytes_slope_per_registered']} B and "
                f"{doc['wall_slope_s_per_registered']} s a registered tenant")
        out["24c"]["wall_s"] = sweep_s
        log(f"[24c] beside it, the JAX engine's committed CPU capture of "
            f"the untiered sweep: "
            f"{JAX_SWEEP_CPU['bytes_slope_per_registered']} B a registered "
            f"tenant, resident bytes "
            f"{JAX_SWEEP_CPU['resident_bytes']} (the JAX engine's CPU "
            f"figures, not the port's)")

        # -- the CPU twin ---------------------------------------------------
        t0 = time.perf_counter()
        twin, twin_s = twin_job.get(timeout=900)
        wait_s = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    check(stream == twin["stream"],
          "census: the card's stream differs from the CPU twin's")
    check(r_c.census_hot_set == twin["hot"],
          "census: the hot-set document differs from the CPU twin's")
    for name in ("untiered", "tiered"):
        check(sweep_bytes(sweeps[name]) == twin[name if name == "tiered"
                                                else "sweep"],
              f"sweep {name}: the bytes rows differ from the CPU twin's")
    out["cpu_twin_wall_s"] = twin_s
    out["cpu_twin_wait_s"] = wait_s
    log(f"[24] CPU twin (a spawned process) {twin_s:.2f} s, waited "
        f"{wait_s:.2f} s: the census stream, the hot-set document and both "
        f"sweeps' bytes rows equal the card's")
    out["launches"] = {k: sk.launches.get(k, 0)
                       for k in ("lane_delta", "window_gather")}
    for k, v in out["launches"].items():
        check(v > 0, f"phase 24: kernel {k} was not launched")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[24] phase 24 in {out['phase_wall_s']:.1f} s; serve kernel "
        f"launches {out['launches']}")
    return {"observatories": out}


#: phase 25: the kernels of the sharded paths, as the profiler names them
MESH_KERNELS = ("dense_cluster_fold", "dense_reduce", "dense_slice_fold",
                "hll_update_kernel")


@contextlib.contextmanager
def plain_calls():
    """Count the calls of the dense fold's and the HLL update's plain
    versions (a wrapper takes one for a CPU tensor) while the block
    runs: phase 25 holds the sharded paths on the card to none."""
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import sketch_kernels as skk
    calls = {"replay_dense_plain": 0, "hll_update_plain": 0}
    saved = {}
    for mod, name in ((rk, "replay_dense_plain"), (skk, "hll_update_plain")):
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def run_main(argv):
    """``python -m anomod_torch ARGV`` in this process: (exit code, JSON
    lines of its stdout)."""
    import io
    from anomod_torch.cli import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()), probe_skipped():
        try:
            rc = cli_main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def parallel_phase(dev, card, batch, cfg, rates, stream_rows,
                   unfused_alerts) -> dict:
    """Phase 25: the parallel planes at world size 1 over NCCL on the one
    card.  A mesh or a launch past the attached cards is refused before
    anything spawns.  Inside one world-1 group: each collective on card
    tensors returns its input; the sharded replay (the dense fold in one
    launch, the HLL plane, replicated and scattered) equals
    ``make_replay_fn``'s on the bench corpus (exact planes exactly,
    moments within ``RTOL_CARD``, registers exactly) with the dense fold
    and the HLL kernel launched and no plain version; its spans/s beside
    the single card's and the NCCL merge's device time; the detector on
    the sharded plane (``OnlineDetector(mesh=...)``) over phase 5's 13
    labels equals phase 5 (ranked lists, first-alert windows), its chunk
    fold ``dense_slice_fold``; the serve mesh plane at the bench
    deployment holds the admission pins and every tenant's alerts equal
    phase 8's unfused run's.  Then ``replay`` and ``stream --devices 1``
    through the CLI, and ``replay --devices 2`` refused."""
    import dataclasses
    import functools
    import multiprocessing

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.ops import sketch_kernels as skk
    from anomod_torch.ops.tdigest import tdigest_build
    from anomod_torch.parallel import (launch, make_mesh,
                                       make_sharded_replay_fn,
                                       sharded_throughput, stage_sharded)
    from anomod_torch.parallel import collectives as coll
    from anomod_torch.replay import (make_replay_fn, measure_throughput,
                                     stage_columns)
    from anomod_torch.serve.engine import run_power_law
    from anomod_torch.stream import stream_quality
    t_phase = time.perf_counter()
    out = {}

    # -- (1) past the attached cards: refused, nothing spawned -------------
    n_cards = torch.cuda.device_count()
    want_msg = (f"requested a {n_cards + 1}-device mesh but {n_cards} "
                "device(s) are attached")
    before = set(multiprocessing.active_children())
    for name, call in (("make_mesh", lambda: make_mesh(n_cards + 1)),
                       ("launch", lambda: launch(print, n_cards + 1))):
        try:
            call()
        except ValueError as e:
            check(str(e) == want_msg, f"{name}: {e}")
        else:
            raise SmokeFailure(f"{name}({n_cards + 1}) was not refused")
    check(set(multiprocessing.active_children()) == before,
          "a refused launch spawned a process")
    log(f"[25] make_mesh and launch at {n_cards + 1} devices refused before "
        f"any spawn: {want_msg!r}")

    chunks, n_real = stage_columns(batch, cfg)
    single = make_replay_fn(cfg, device=dev, with_hll=True)(chunks)
    single_acc = torch.cat([single.agg, single.hist], 1).cpu()
    single_hll = single.hll.cpu()
    torch.cuda.synchronize()

    idx = torch.cuda.current_device()

    def plan(n, sw):
        # the dense wrapper's grid for n staged rows into sw segments
        return rk.dense_plan(n, sw, H, rk._sm_count(idx),
                             functools.partial(rk._cluster_capacity, idx))

    def body():
        mesh = make_mesh(1)
        check(mesh.backend == "nccl" and mesh.device.type == "cuda"
              and mesh.world_size == 1, f"world-1 mesh: {mesh}")
        res = {}
        # -- (2) the collectives at world size 1 --------------------------
        g = torch.Generator(device=dev).manual_seed(25)
        x = torch.randn((cfg.sw, 6 + H), device=dev, generator=g)
        regs = torch.randint(0, 20, (cfg.n_services, 256), device=dev,
                             dtype=torch.int32, generator=g)
        mean = torch.sort(torch.randn((4, K_DIGEST), device=dev,
                                      generator=g), -1).values
        weight = torch.randint(1, 5, (4, K_DIGEST), device=dev,
                               generator=g).float()
        for name, got in (("psum", coll.psum(x, mesh)),
                          ("ring_allreduce", coll.ring_allreduce(x, mesh)),
                          ("reduce_scatter_state",
                           coll.reduce_scatter_state(x, mesh))):
            check(torch.equal(got, x), f"{name} at world 1 is not its input")
        check(torch.equal(coll.pmax_merge_hll(regs, mesh), regs),
              "pmax_merge_hll at world 1 is not its input")
        m, w = coll.allgather_merge_tdigests(mean, weight, mesh)
        ref = tdigest_build(mean.cpu().numpy(), k=K_DIGEST,
                            weights=weight.cpu().numpy())
        check(np.array_equal(m.cpu().numpy(), ref.mean)
              and np.array_equal(w.cpu().numpy(), ref.weight),
              "allgather_merge_tdigests at world 1 differs from the host "
              "rebuild of its input")
        log("[25] collectives at world 1 on the card (nccl): psum, ring "
            "(zero steps), reduce_scatter_tensor, all_reduce(MAX) each "
            "return their input; all_gather_into_tensor + the host "
            "rebuild equal tdigest_build of the input")
        # the first profiler trace after the group's first collective
        # read no device events on the card: pay it on a throw-away one
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()

        # -- (3) the sharded replay -----------------------------------------
        shard, n = stage_sharded(batch, mesh, cfg)
        check(n == n_real, f"sharded staging: {n} spans != {n_real}")
        rk.reset_launches()
        skk.reset_launches()
        errs = {}
        with plain_calls() as plain:
            for merge in ("replicated", "scattered"):
                fn = make_sharded_replay_fn(cfg, mesh, kernel="cuda",
                                            with_hll=True, merge=merge)
                st = fn(shard)
                errs[merge] = compare(
                    f"sharded replay {merge}",
                    torch.cat([st.agg, st.hist], 1).cpu(), single_acc,
                    RTOL_CARD)
                check(torch.equal(st.hll.cpu(), single_hll),
                      f"sharded replay {merge}: HLL registers differ")
                check(float(st.agg[:, 0].double().sum()) == n_real,
                      f"sharded replay {merge}: span count")
        launches = {"replay_dense": rk.launches["replay_dense"],
                    "hll_update": skk.launches["hll_update"]}
        check(launches == {"replay_dense": 2, "hll_update": 2}
              and not any(plain.values()),
              f"sharded replay: launches {launches}, plain calls {plain}")
        # the shard's one launch takes the cluster fold; a trace, where it
        # reads device events, names it
        n_rows = int(shard["sid"].numel())
        check(plan(n_rows, cfg.sw).clustered,
              f"sharded replay: {n_rows} rows do not take the cluster fold")
        traced = traced_ms(lambda: fn(shard), MESH_KERNELS, iters=3)
        check(not traced or (traced.get("dense_cluster_fold", [0, 0])[1] >= 1
                             and traced.get("hll_update_kernel",
                                            [0, 0])[1] >= 1),
              f"sharded replay trace: {traced}")
        res["replay"] = dict(max_abs_err=errs, launches=launches,
                             plain_calls=dict(plain),
                             traced=traced or "not measured (no device "
                             "events)")
        log(f"[25] sharded replay (world 1, kernel cuda, with_hll) on the "
            f"bench corpus ({n_real} spans): replicated and scattered equal "
            f"make_replay_fn's (max_abs_err {errs}), registers exact; "
            f"launches {launches}, plain calls {dict(plain)}; {n_rows} "
            f"staged rows a launch: the cluster plan; traced device ms and "
            f"launches a call by kernel {res['replay']['traced']}")
        r = sharded_throughput(batch, mesh, cfg, repeats=3, kernel="cuda")
        one = measure_throughput(batch, cfg, repeats=3, replicate=1,
                                 kernel="cuda", device=dev)
        acc = torch.zeros((cfg.sw, 6 + H), device=dev)
        merge_ms = cuda_ms(lambda: coll.psum(acc, mesh))
        res["throughput"] = dict(
            sharded_spans_per_sec=r.spans_per_sec,
            sharded_wall_s=r.wall_s, sharded_raw_wall_s=r.raw_wall_s,
            single_spans_per_sec=one.spans_per_sec,
            single_wall_s=one.wall_s, single_raw_wall_s=one.raw_wall_s,
            phase4_spans_per_sec=rates["cuda"], merge_ms=merge_ms,
            merge_share=merge_ms / 1e3 / r.wall_s)
        log(f"[25] sharded_throughput at world 1: {r.spans_per_sec:.6g} "
            f"spans/s (median wall {r.wall_s:.6f} s of {r.raw_wall_s}); "
            f"the single card at replicate 1 in this phase "
            f"{one.spans_per_sec:.6g} (median {one.wall_s:.6f} s), phase "
            f"4's at its replicate {rates['cuda']:.6g}; the NCCL merge "
            f"(all_reduce of [{cfg.sw}, {6 + H}] f32) {merge_ms:.4f} ms, "
            f"{merge_ms / 1e3 / r.wall_s:.4g} of the sharded wall, on {card}")

        # -- (4) the detector on the sharded plane --------------------------
        rk.reset_launches()
        t0 = time.perf_counter()
        with plain_calls() as plain:
            rows = stream_quality("TT", n_traces=400, seed=0, device=dev,
                                  mesh=mesh)
        stream_s = time.perf_counter() - t0
        dense = rk.launches["replay_dense"]
        check(len(rows) == len(stream_rows), "sharded stream: row count")
        same_alerts = 0
        for got, want in zip(rows, stream_rows):
            check(got["ranked"] == want["ranked"],
                  f"sharded stream {got['experiment']}: ranked lists differ")
            check(got["first_alert_window"] == want["first_alert_window"],
                  f"sharded stream {got['experiment']}: first alert "
                  "windows differ")
            same_alerts += [(a.window, a.service) for a in got["alerts"]] \
                == [(a.window, a.service) for a in want["alerts"]]
        check(dense > 0 and not any(plain.values()),
              f"sharded stream: dense launches {dense}, plain {plain}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stream_quality("TT", n_traces=400, seed=0, device=dev,
                           mesh=mesh, experiments=[rows[0]["experiment"]])
            torch.cuda.synchronize()
        by_kernel = {k: v for k, v in kernel_device_ms(
            prof, MESH_KERNELS).items() if v[1]}
        # a 4096-span chunk at the 3S id space takes the slice fold
        ecfg_sw = 3 * cfg.sw
        check(not plan(4096, ecfg_sw).clustered,
              "sharded stream: a chunk does not take the slice fold")
        check(not by_kernel
              or (by_kernel.get("dense_slice_fold", [0, 0])[1] > 0
                  and "dense_cluster_fold" not in by_kernel),
              f"sharded stream trace: {by_kernel}")
        by_kernel = by_kernel or "not measured (no device events)"
        res["stream"] = dict(wall_s=stream_s, dense_launches=dense,
                             plain_calls=dict(plain),
                             labels_same_alerts=same_alerts,
                             trace_one_label=by_kernel)
        log(f"[25] OnlineDetector(mesh=...) over 13 TT labels x 400 traces: "
            f"ranked lists and first-alert windows equal phase 5's, alert "
            f"lists equal on {same_alerts} of {len(rows)} labels; "
            f"{dense} dense launches, plain calls {dict(plain)}; wall "
            f"{stream_s:.3f} s (phase 5's single-card run is in its log "
            f"line); one label's trace by kernel {by_kernel}")

        # -- (5) the serve mesh plane ---------------------------------------
        rk.reset_launches()
        sk_before = dict(sk.launches)
        t0 = time.perf_counter()
        with plain_calls() as plain:
            eng, rep = run_power_law(device=dev, mesh=mesh, **SERVE_KW)
        call_s = time.perf_counter() - t0
        got = {"p99_latency_s": rep.latency["p99_latency_s"],
               "shed_fraction": rep.shed_fraction}
        check(got == {k: SERVE_PINS[k] for k in got},
              f"serve mesh pins: {got}")
        check(sorted(unfused_alerts) == sorted(eng._tenant_replay),
              "serve mesh: the served tenants differ from the unfused run")
        keys = ("window", "service", "evidence")
        for tid, want in unfused_alerts.items():
            mine = [tuple(dataclasses.asdict(a)[k] for k in keys)
                    for a in eng.alerts_for(tid)]
            check(mine == [tuple(a[k] for k in keys) for a in want],
                  f"serve mesh: tenant {tid}'s alerts differ from the "
                  "unfused run's")
        score_diff = max(
            (abs(a.score - b["score"]) for tid, want in unfused_alerts.items()
             for a, b in zip(eng.alerts_for(tid), want)), default=0.0)
        dense = rk.launches["replay_dense"]
        lane = {k: v - sk_before[k] for k, v in sk.launches.items()}
        check(dense > 0 and not any(lane.values())
              and not any(plain.values()) and rep.fused is False,
              f"serve mesh: dense {dense}, serve kernels {lane}, plain "
              f"{plain}, fused {rep.fused}")
        res["serve"] = dict(pins=got, serve_wall_s=rep.serve_wall_s,
                            call_s=call_s, n_alerts=rep.n_alerts,
                            dense_launches=dense, serve_kernels=lane,
                            max_score_diff=score_diff,
                            served_spans=rep.served_spans)
        log(f"[25] serve mesh plane at the bench deployment: p99 "
            f"{got['p99_latency_s']} s, shed {got['shed_fraction']} (pins "
            f"held), every tenant's alerts (window, service, evidence) equal "
            f"the unfused card run's ({rep.n_alerts} alerts, scores within "
            f"{score_diff:.3g}); {dense} dense launches, lane kernels "
            f"{lane}; serve wall {rep.serve_wall_s:.4f} s (call "
            f"{call_s:.2f} s) on {card}")
        return res

    out.update(launch(body, 1)[0])

    # -- (6) the CLI --------------------------------------------------------
    t0 = time.perf_counter()
    rc, docs = run_main(["replay", "--devices", "1"])
    check(rc == 0 and docs and docs[0].get("devices") == 1
          and docs[0]["n_spans"] == n_real,
          f"replay --devices 1: rc {rc}, {docs}")
    # a fault label's row: its ranked list is not empty
    want = next(r for r in stream_rows if r.get("top1_hit") is not None)
    label = want["experiment"]
    rc_s, rows = run_main(["stream", label, "--devices", "1"])
    check(rc_s == 0 and rows and rows[0]["ranked"] == want["ranked"]
          and rows[0]["first_alert_window"] == want["first_alert_window"],
          f"stream {label} --devices 1: rc {rc_s}, {rows[:1]}")
    rc2, _ = run_main(["replay", "--devices", str(n_cards + 1)])
    check(rc2 not in (0, None), f"replay --devices {n_cards + 1}: rc {rc2}")
    out["cli"] = dict(replay=docs[0], stream_ranked=rows[0]["ranked"],
                      refused_rc=rc2, wall_s=time.perf_counter() - t0)
    log(f"[25] CLI: replay --devices 1 {docs[0]}; stream {label} --devices "
        f"1 ranked {rows[0]['ranked'][:3]} = phase 5's; replay --devices "
        f"{n_cards + 1} exit {rc2}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[25] phase 25 in {out['phase_wall_s']:.1f} s on {card}")
    return {"parallel": out}


#: phase 26: steps a plane at full width, each beside its one-card oracle
PLANE_STEPS = 5
#: phase 26: one day of 15 s windows through the sequence-parallel scan
SCAN_T = 24 * 3600 // 15


def _step_walls(step, n):
    """``n`` calls of ``step()``, each synchronized: (results, ms each)."""
    import torch
    out, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(float(step()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _held_losses(name, got, want):
    """Every loss of a plane's run within 1e-6 of the first loss of its
    one-card oracle's; returns the largest difference."""
    diff = max(abs(a - b) for a, b in zip(got, want))
    check(len(got) == len(want) and diff <= 1e-6 * abs(want[0]),
          f"{name}: losses {got} vs the one-card run's {want}")
    return diff


def start_torchrun():
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m anomod_torch.parallel.multihost``: the hybrid
    mesh's checks (``initialize_distributed``, ``make_hybrid_mesh``, the
    psum, the HLL merge, one GCN step) in a world-1 NCCL group started by
    torchrun.  Returns ``(process, start time)``; :func:`torchrun_checks`
    reads it."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "anomod_torch.parallel.multihost"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env), time.perf_counter()


def torchrun_checks(dev, started) -> dict:
    """The torchrun run's ``MHRESULT`` held to a world-1 hybrid mesh: its
    shape, the psum, the HLL registers of its 500 items equal to this
    process's plane of them, a finite loss."""
    import torch

    from anomod_torch.ops.hll import hll_add, hll_init
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    wall = time.perf_counter() - t0
    lines = [l for l in stdout.splitlines() if l.startswith("MHRESULT ")]
    check(proc.returncode == 0 and lines,
          f"torchrun multihost: rc {proc.returncode}\n{stdout[-2000:]}\n"
          f"{stderr[-4000:]}")
    doc = json.loads(lines[0][len("MHRESULT "):])
    union = hll_add(hll_init(10, device=dev),
                    torch.arange(0, 500, dtype=torch.int32, device=dev),
                    p=10).cpu().tolist()
    check(doc["shape"] == {"dcn": 1, "data": 1} and doc["backend"] == "nccl"
          and doc["psum"] == doc["expected_psum"] == 0.0
          and doc["hll"] == union and doc["train_loss"] > 0,
          f"torchrun multihost: {dict(doc, hll='...')}")
    doc.pop("hll")
    return dict(doc, wall_s=wall)


def planes_phase(dev, card, train) -> dict:
    """Phase 26 (:func:`_planes_phase`), with its torchrun process stopped
    whatever the phase's outcome."""
    torchrun = start_torchrun()
    try:
        return _planes_phase(dev, card, train, torchrun)
    finally:
        if torchrun[0].poll() is None:
            torchrun[0].kill()
            torchrun[0].wait(timeout=30)


def _planes_phase(dev, card, train, torchrun) -> dict:
    """Phase 26: the rest of the parallel planes at world size 1 over NCCL
    on the one card.  ``graft_entry.dryrun_multichip(1)`` on ``cuda``, with
    the dense fold's and the HLL kernel's launches counted and no plain
    version called.  Then, at full width on the rca CLI's TT batch (phase
    14's: 6 train seeds x 80 traces, 8 windows; the line graph's with the
    per-edge features) with the zoo widths: the distributed train step of
    ``gcn``, ``moe`` and ``linegraph`` on a ``(1, 1)`` ``make_mesh2d``
    against ``train_loop`` from the same parameters; the pipeline train
    step at ``PipelineConfig()`` on one stage against
    ``reference_forward``'s; ``make_sp_transformer`` with ring and with
    Ulysses against the one-card ``TraceTransformer`` forward (``L = S W``
    tokens); ``make_seqpar_recurrence`` over one day of 15 s windows
    against ``linear_recurrence``; and the hybrid mesh under torchrun (a
    process of its own, started with the phase and read at its end)."""
    import copy
    import dataclasses
    import functools

    import numpy as np
    import torch

    from anomod_torch import rca
    from anomod_torch.graft_entry import dryrun_multichip
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import sketch_kernels as skk
    from anomod_torch.parallel import launch, make_mesh, make_sp_transformer
    from anomod_torch.parallel.pipeline import (PipelineConfig,
                                                make_pipe_mesh,
                                                make_pipeline_forward,
                                                make_pipeline_train_step)
    from anomod_torch.parallel.seqscan import (linear_recurrence,
                                               make_seqpar_recurrence)
    from anomod_torch.parallel.train import (LR, make_distributed_train_step,
                                             make_mesh2d)
    t_phase = time.perf_counter()
    out = {}

    # -- (1) the dry run at world size 1 on the card ------------------------
    rk.reset_launches()
    skk.reset_launches()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        run = dryrun_multichip(1)
    launches = {"replay_dense": rk.launches["replay_dense"],
                "hll_update": skk.launches["hll_update"]}
    check(launches["replay_dense"] > 0 and launches["hll_update"] > 0
          and not any(plain.values()),
          f"dryrun_multichip(1): launches {launches}, plain calls {plain}")
    idx = torch.cuda.current_device()
    # the dry run's shard: its spans staged in 256-span chunks
    rows = -(-run["n_spans"] // 256) * 256
    clustered = rk.dense_plan(rows, run["sw"], 8, rk._sm_count(idx),
                              functools.partial(rk._cluster_capacity, idx)
                              ).clustered
    # the dry run reaches rows 1b (the slice fold) and 6; row 1a's cluster
    # fold is held on phase 25's full-width sharded replay
    check(not clustered, f"dryrun_multichip(1): the sharded replay's {rows} "
          f"staged rows take the cluster fold (row 1a), not row 1b's")
    out["dryrun"] = dict(run, wall_s=time.perf_counter() - t0,
                         launches=launches, plain_calls=dict(plain),
                         shard_rows=rows, shard_plan_clustered=clustered)
    log(f"[26] dryrun_multichip(1) on the card: {run}; launches {launches}, "
        f"plain calls {dict(plain)}; the sharded replay's {rows} staged rows "
        f"take the slice fold (row 1b); wall "
        f"{out['dryrun']['wall_s']:.2f} s on {card}")

    # -- (2) the planes at full width -----------------------------------------
    samples, _ = rca.build_dataset("TT", range(6), 80, edge_features=True)
    e_train = rca._stack(samples)
    rca.standardize_features(e_train, [])
    batches = {"gcn": train, "moe": train, "linegraph": e_train}

    def body():
        res = {}
        mesh2d = make_mesh2d(1)
        check(mesh2d.shape == {"data": 1, "model": 1}
              and mesh2d.backend == "nccl", f"make_mesh2d(1): {mesh2d}")
        for name, batch in batches.items():
            model, _, step, put_batch = make_distributed_train_step(
                name, batch, mesh2d)
            dev_batch = put_batch(batch)
            got, ms = _step_walls(lambda: step(dev_batch), PLANE_STEPS)
            one = rca.init_model(name, batch, seed=0, device=dev)
            opt = rca.make_optimizer(one, lr=LR)
            one_batch = rca.to_device(batch, dev)
            want, one_ms = _step_walls(
                lambda: rca.train_loop(name, one, opt, one_batch, 0, 1)[0],
                PLANE_STEPS)
            diff = _held_losses(f"train step {name}", got, want)
            res[name] = dict(losses=got, one_card_losses=want,
                             max_loss_diff=diff, ms=ms, one_card_ms=one_ms,
                             batch=int(batch["target"].shape[0]))
            log(f"[26] {name} train step on (data 1, model 1), batch "
                f"{res[name]['batch']}: losses {got} == train_loop's "
                f"(max diff {diff:.3g}); ms a step {np.round(ms, 3).tolist()}"
                f" vs one card {np.round(one_ms, 3).tolist()} on {card}")

        # the pipeline on one stage against reference_forward's step
        cfg = PipelineConfig()
        pipe = make_pipe_mesh(1)
        stage, _, step, put_batch = make_pipeline_train_step(pipe, cfg, train)
        ref = copy.deepcopy(stage)
        dev_batch = put_batch(train)
        got, ms = _step_walls(lambda: step(dev_batch), PLANE_STEPS)
        S, W = train["x_t"].shape[1:3]
        _, reference_forward = make_pipeline_forward(pipe, cfg, S, W)
        opt = rca.make_optimizer(ref, lr=LR)

        def ref_step():
            opt.zero_grad()
            loss = rca.rca_loss(reference_forward(
                ref, rca.fused_features(dev_batch), dev_batch["adj"]),
                dev_batch)
            loss.backward()
            opt.step()
            return loss.detach()
        want, ref_ms = _step_walls(ref_step, PLANE_STEPS)
        diff = _held_losses("pipeline step", got, want)
        res["pipeline"] = dict(losses=got, reference_losses=want,
                               max_loss_diff=diff, ms=ms, reference_ms=ref_ms,
                               config=dataclasses.asdict(cfg))
        log(f"[26] pipeline train step, PipelineConfig() on 1 stage: losses "
            f"{got} == reference_forward's (max diff {diff:.3g}); ms a step "
            f"{np.round(ms, 3).tolist()} vs {np.round(ref_ms, 3).tolist()}")

        # the sequence-parallel transformer against the one-card forward
        mesh = make_mesh(1)
        model = rca.init_model("transformer", train, seed=0, device=dev)
        x = rca.fused_features(rca.to_device(train, dev))
        adj = torch.as_tensor(train["adj"], device=dev)
        with torch.no_grad():
            want = model(x, adj)
            ref_ms = _step_walls(lambda: model(x, adj)[0, 0], 3)[1]
            sp = {}
            for plane in ("ring", "ulysses"):
                sp_model = make_sp_transformer(mesh, model, plane=plane)
                got = sp_model(x, adj)
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, rtol=2e-4, atol=2e-5),
                      f"sp transformer {plane}: max_abs_err {err}")
                sp[plane] = dict(max_abs_err=err, ms=_step_walls(
                    lambda: sp_model(x, adj)[0, 0], 3)[1])
        res["sp_transformer"] = dict(sp, tokens=int(x.shape[1] * x.shape[2]),
                                     batch=int(x.shape[0]),
                                     one_card_ms=ref_ms)
        log(f"[26] sp transformer at L = S*W = {x.shape[1] * x.shape[2]} "
            f"tokens x {x.shape[0]}: ring / ulysses == the one-card forward "
            f"(max_abs_err {sp['ring']['max_abs_err']:.3g} / "
            f"{sp['ulysses']['max_abs_err']:.3g}); ms a forward ring "
            f"{np.round(sp['ring']['ms'], 3).tolist()}, ulysses "
            f"{np.round(sp['ulysses']['ms'], 3).tolist()}, one card "
            f"{np.round(ref_ms, 3).tolist()}")

        # the sequence-parallel scan over one day of 15 s windows
        g = torch.Generator(device=dev).manual_seed(26)
        xs = torch.randn((SCAN_T, 45, 8), device=dev, generator=g)
        decay = torch.rand((45, 8), device=dev, generator=g) * 0.49 + 0.5
        t0 = time.perf_counter()
        got = make_seqpar_recurrence(mesh)(xs, decay)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = linear_recurrence(xs, decay)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
              f"seqpar recurrence: max_abs_err {err}")
        res["seqscan"] = dict(T=SCAN_T, max_abs_err=err, ms=scan_ms,
                              one_card_ms=one_ms)
        log(f"[26] seqpar recurrence over T={SCAN_T} x [45, 8]: == "
            f"linear_recurrence (max_abs_err {err:.3g}); {scan_ms:.1f} ms vs "
            f"{one_ms:.1f} ms")
        return res

    out.update(launch(body, 1)[0])

    # -- (3) the hybrid mesh under torchrun ---------------------------------
    out["torchrun"] = torchrun_checks(dev, torchrun)
    log(f"[26] torchrun --standalone --nproc-per-node 1 -m "
        f"anomod_torch.parallel.multihost: {out['torchrun']}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[26] phase 26 in {out['phase_wall_s']:.1f} s on {card}")
    return {"planes": out}


#: every probe of the card this script's CLI calls make (the probe
#: function wrapped by :func:`count_probes`): (platform, wall s)
PROBES = []
#: the loss phase 27 injects: CUDA's words for an uncorrectable ECC error
LOSS_MSG = "CUDA error: uncorrectable ECC error encountered"
#: phase 27's small RCA shape (TT, gcn; save every 2 epochs) and sweep
#: (SN: its stream row costs a fifth of TT's on the host)
DD_RCA = dict(train_seeds=range(2), eval_seeds=range(100, 101), epochs=6,
              n_traces=12, save_every=2)
DD_SWEEP = dict(testbed="SN", model_names=("zscore", "stream", "gcn"),
                severities=(0.12,), train_seeds=range(3), eval_seeds=(100,),
                n_traces=12, epochs=5)
#: phase 27's serve run: 20 tenants, 16 virtual seconds
DD_SERVE = dict(n_tenants=20, n_services=8, capacity_spans_per_s=4000,
                overload=1.5, duration_s=16, tick_s=0.5, seed=3,
                flight=False)


def count_probes():
    """Wrap the card probe so every CLI call's probe is timed into
    :data:`PROBES` (the probe itself runs unchanged)."""
    from anomod_torch.utils import platform
    probe = platform.probe_device_platform

    def timed_probe(*a, **k):
        t0 = time.perf_counter()
        out = probe(*a, **k)
        PROBES.append((out[0], time.perf_counter() - t0))
        return out
    platform.probe_device_platform = timed_probe


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` (None: unset) while the block runs,
    with both packages' settings re-read at its start and end."""
    import os

    from anomod_torch.config import set_config
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    set_config(None)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev
        set_config(None)


def all_launches() -> dict:
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.ops import sketch_kernels as skk
    return {**rk.launches, **sk.launches, **skk.launches}


def reset_all_launches() -> None:
    from anomod_torch.ops import replay_kernels as rk
    from anomod_torch.ops import serve_kernels as sk
    from anomod_torch.ops import sketch_kernels as skk
    for mod in (rk, sk, skk):
        mod.reset_launches()


def _raises(fn, exc_type, words) -> str:
    """The message of the ``exc_type`` that ``fn()`` raises (which must
    hold ``words``); fails the phase when it raises nothing."""
    try:
        fn()
    except exc_type as e:
        check(words in str(e), f"expected {words!r} in {e!r}")
        return str(e)
    raise SmokeFailure(f"expected {exc_type.__name__} ({words!r})")


def start_probe():
    """Phase 27 (a)'s probe, started in a thread beside items (b)-(e) (it
    waits on a subprocess and reads no setting they change): returns a
    function that joins it and gives ``(note, wall s)``."""
    import threading

    from anomod_torch.utils import platform
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["note"] = platform.ensure_live_backend()
        except BaseException as e:
            box["error"] = e
        box["wall"] = time.perf_counter() - t0
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join(timeout=300)
        if "error" in box:
            raise box["error"]
        check("note" in box, "probe: no answer within 300 s")
        return box["note"], box["wall"]
    return join


def _probe_item(card, note, wall) -> dict:
    """Phase 27 (a): the probe's answer."""
    check(note == "probe ok: cuda", f"probe: {note} {PROBES}")
    log(f"[27a] probe: {note} in {wall:.3f} s (a subprocess: import torch, "
        f"torch.cuda.init(); beside items b-e), on {card}")
    return {"probe_wall_s": wall, "note": note}


def _failover_item(dev, card) -> dict:
    """Phase 27 (b): ``with_cpu_failover`` alone on the card."""
    import tempfile

    import torch

    from anomod_torch.ops import _build
    from anomod_torch.utils import platform
    t0 = time.perf_counter()
    loss = RuntimeError(LOSS_MSG)

    def flaky(seen):
        def fn(d):
            seen.append(d.type)
            if len(seen) == 1 and d.type == "cuda":
                raise loss
            return float(torch.arange(4.0, device=d).sum())
        return fn
    seen = []
    try:
        platform.with_cpu_failover(flaky(seen), dev)
        raise SmokeFailure("failover: a loss without allow did not raise")
    except RuntimeError as e:
        check(e is loss and seen == ["cuda"],
              f"failover: allow=False gave {e!r}, calls {seen}")
    seen, notes = [], []
    got = platform.with_cpu_failover(flaky(seen), dev, allow=True,
                                     on_failover=notes.append)
    check(got == 6.0 and seen == ["cuda", "cpu"] and notes == [loss],
          f"failover: allow=True gave {got}, calls {seen}, notes {notes}")

    def oom(d):
        free, total = torch.cuda.mem_get_info(d)
        return torch.empty(2 * total, dtype=torch.uint8, device=d)

    def illegal(d):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    def build_error(d):
        # a real nvcc failure of ops/_build.py, on a broken source
        csrc, build_dir = _build.CSRC, _build.BUILD_DIR
        with tempfile.TemporaryDirectory() as tmp:
            _build.CSRC = _build.BUILD_DIR = Path(tmp)
            (Path(tmp) / "broken.cu").write_text(
                "__global__ void k() { this is not CUDA }\n")
            try:
                _build.build(["broken"])
            finally:
                _build.CSRC, _build.BUILD_DIR = csrc, build_dir
                _build.build_logs.pop("broken", None)
    propagated = {}
    for name, fn, exc_type in (("oom", oom, torch.cuda.OutOfMemoryError),
                               ("illegal_address", illegal, RuntimeError),
                               ("build_error", build_error, RuntimeError)):
        calls = []

        def counted(d, _fn=fn):
            calls.append(d.type)
            return _fn(d)
        try:
            platform.with_cpu_failover(counted, dev, allow=True,
                                       on_failover=lambda e: check(
                                           False, f"failover on {e!r}"))
            raise SmokeFailure(f"failover: {name} did not raise")
        except exc_type as e:
            check(calls == ["cuda"] and not platform.is_backend_loss(e),
                  f"failover: {name} retried ({calls})")
            propagated[name] = f"{type(e).__name__}: {str(e)[:120]}"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[27b] with_cpu_failover on the card: a loss re-raised unchanged "
        f"without allow, retried once on the CPU with allow (on_failover "
        f"saw the original); propagated with allow: {propagated}; "
        f"{wall:.3f} s; a real loss of the card is not provoked (one card "
        f"cannot lose its device on request), on {card}")
    return {"wall_s": wall, "propagated": propagated}


def _same_result(a, b) -> bool:
    import torch
    return (a.losses == b.losses
            and (a.top1, a.top3, a.detection_auc, a.n_eval)
            == (b.top1, b.top3, b.detection_auc, b.n_eval)
            and a.params.keys() == b.params.keys()
            and all(torch.equal(v.cpu(), b.params[k].cpu())
                    for k, v in a.params.items()))


def _rca_item(dev, card) -> dict:
    """Phase 27 (c): ``train_rca_resilient(failover=True)`` on the card,
    clean and with a loss injected after its first save."""
    import shutil
    import tempfile

    import torch

    from anomod_torch import rca
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got, note = rca.train_rca_resilient(
            "TT", "gcn", checkpoint_dir=f"{tmp}/clean", failover=True,
            device=dev, **DD_RCA)
        out["clean_s"] = time.perf_counter() - t0
        want = rca.train_rca("TT", "gcn", device=dev, **DD_RCA)
        check(note is None and _same_result(got, want),
              f"rca failover: the clean run ({note}) differs from "
              "train_rca on the card")
        orig_save = rca.save_train_state
        snap = Path(tmp) / "at_loss"

        def failing_save(path, params, opt_state, step, meta=None):
            done = orig_save(path, params, opt_state, step, meta=meta)
            if not snap.exists() and any(t.is_cuda
                                         for t in params.values()):
                shutil.copytree(path, snap)
                raise RuntimeError(LOSS_MSG)
            return done
        rca.save_train_state = failing_save
        try:
            t0 = time.perf_counter()
            got, note = rca.train_rca_resilient(
                "TT", "gcn", checkpoint_dir=f"{tmp}/lost", failover=True,
                device=dev, **DD_RCA)
            out["failover_s"] = time.perf_counter() - t0
        finally:
            rca.save_train_state = orig_save
        check(snap.exists() and note is not None
              and "from the last checkpoint" in note,
              f"rca failover: note {note!r}")
        want = rca.train_rca("TT", "gcn", device="cpu", resume=True,
                             checkpoint_dir=str(snap), **DD_RCA)
        check(_same_result(got, want)
              and all(v.device.type == "cpu" for v in got.params.values()),
              "rca failover: the retry differs from train_rca(device='cpu',"
              " resume=True) from the checkpoint")
    log(f"[27c] train_rca_resilient(failover=True) TT gcn "
        f"{DD_RCA['epochs']} epochs, save every {DD_RCA['save_every']}: "
        f"clean {out['clean_s']:.3f} s, no note, == train_rca on the card; "
        f"loss after the first save: {out['failover_s']:.3f} s, note "
        f"{note!r}, == train_rca(cpu, resume=True) from that checkpoint, "
        f"bit for bit, on {card}")
    return dict(out, note=note)


def _sweep_item(dev, card) -> dict:
    """Phase 27 (d): a small ``severity_sweep(failover=True)`` on the
    card, clean and with a loss injected at ``gcn``."""
    import dataclasses

    import torch

    from anomod_torch import quality

    def rows(pts):
        return {(p.model, p.severity): dataclasses.asdict(p) for p in pts}
    reset_all_launches()
    t0 = time.perf_counter()
    with plain_calls() as calls:
        clean = quality.severity_sweep(device=dev, failover=True,
                                       **DD_SWEEP)
    clean_s = time.perf_counter() - t0
    launches = all_launches()
    check(quality.LAST_FAILOVER is None and launches["replay_dense"] > 0
          and not any(calls.values()),
          f"sweep failover: clean run {quality.LAST_FAILOVER}, launches "
          f"{launches}, plain calls {calls}")
    check(rows(clean) == rows(quality.severity_sweep(device=dev,
                                                     **DD_SWEEP)),
          "sweep failover: the clean run differs from the run without "
          "the flag")
    orig = quality._train_model

    def lossy(*a, device=None, **k):
        if torch.device(device).type == "cuda":
            raise RuntimeError(LOSS_MSG)
        return orig(*a, device=device, **k)
    quality._train_model = lossy
    try:
        t0 = time.perf_counter()
        lost = quality.severity_sweep(device=dev, failover=True,
                                      **DD_SWEEP)
        lost_s = time.perf_counter() - t0
    finally:
        quality._train_model = orig
    note = quality.LAST_FAILOVER
    twin = quality.severity_sweep(device="cpu",
                                  **dict(DD_SWEEP, model_names=("gcn",)))
    got, want = rows(lost), rows(clean)
    check(note is not None and "'gcn'" in note
          and {k: v for k, v in got.items() if k[0] == "gcn"} == rows(twin)
          and {k: v for k, v in got.items() if k[0] != "gcn"}
          == {k: v for k, v in want.items() if k[0] != "gcn"},
          f"sweep failover: note {note!r}, rows {got} vs clean {want} and "
          f"the CPU twin's {rows(twin)}")
    log(f"[27d] severity_sweep(failover=True) SN zscore/stream/gcn at "
        f"severity 0.12: clean {clean_s:.3f} s, LAST_FAILOVER None, "
        f"dense_slice_fold launches {launches['replay_dense']}, no plain "
        f"version, == the run without the flag; a loss at gcn: "
        f"{lost_s:.3f} s, {note!r}, the gcn row == the CPU twin's, on "
        f"{card}")
    return {"clean_s": clean_s, "lost_s": lost_s, "note": note,
            "dense_launches": launches["replay_dense"]}


def _knobs_item(dev, card, batch, cfg) -> dict:
    """Phase 27 (e): the two engine knobs on the card."""
    import numpy as np

    from anomod_torch.replay import replay_percentiles
    from anomod_torch.serve.engine import run_power_law
    out = {"serve_s": {}, "percentiles_s": {}}
    runs = {}
    for value in (None, "auto", "pallas", "PALLAS"):
        with env_set("ANOMOD_SERVE_LANE_ENGINE", value):
            reset_all_launches()
            t0 = time.perf_counter()
            eng, _ = run_power_law(device=dev, **DD_SERVE)
            out["serve_s"][str(value)] = time.perf_counter() - t0
            n = all_launches()
            check(n["lane_delta"] > 0 and n["window_gather"] > 0,
                  f"lane knob {value}: launches {n}")
            runs[value] = serve_fingerprint(eng)
            out.setdefault("serve_launches", {})[str(value)] = {
                k: n[k] for k in ("lane_delta", "window_gather")}
    check(all(runs[v] == runs[None] for v in runs),
          "lane knob: a value's states or alerts differ from the unset run")
    for value in ("matmul", "scatter"):
        with env_set("ANOMOD_SERVE_LANE_ENGINE", value):
            reset_all_launches()
            _raises(lambda: run_power_law(device=dev, **DD_SERVE),
                    ValueError, "names a JAX formulation")
            check(not any(all_launches().values()),
                  f"lane knob {value}: launched before the refusal")
    pcts = {}
    for value in (None, "auto", "pallas", "AUTO"):
        with env_set("ANOMOD_TDIGEST_ENGINE", value):
            reset_all_launches()
            t0 = time.perf_counter()
            pcts[value] = replay_percentiles(batch, cfg, device=dev)
            out["percentiles_s"][str(value)] = time.perf_counter() - t0
            n = all_launches()["tdigest_reduce"]
            check(n > 0, f"t-digest knob {value}: no tdigest_reduce launch")
            out.setdefault("tdigest_launches", {})[str(value)] = n
    check(all(np.array_equal(p, pcts[None]) for p in pcts.values()),
          "t-digest knob: a value's percentiles differ from the unset run")
    for value, words in (("host", "names a JAX formulation"),
                         ("xla", "names a JAX formulation"),
                         ("exact", "unknown t-digest engine")):
        with env_set("ANOMOD_TDIGEST_ENGINE", value):
            reset_all_launches()
            _raises(lambda: replay_percentiles(batch, cfg, device=dev),
                    ValueError, words)
            check(not any(all_launches().values()),
                  f"t-digest knob {value}: launched before the refusal")
    log(f"[27e] ANOMOD_SERVE_LANE_ENGINE unset / auto / pallas / PALLAS: "
        f"serve walls {out['serve_s']} s, launches "
        f"{out['serve_launches']}, states and alerts byte-equal; matmul and "
        f"scatter refused before any launch, on {card}")
    log(f"[27e] ANOMOD_TDIGEST_ENGINE unset / auto / pallas / AUTO: "
        f"replay_percentiles walls {out['percentiles_s']} s (TT bench "
        f"corpus, [{cfg.sw}, 3]), equal bit for bit; host and xla refused "
        f"and exact unknown, before any launch, on {card}")
    return out


def _cli_item(card) -> dict:
    """Phase 27 (f): ``rca --cpu-failover`` through the CLI, timed without
    the probe (``ANOMOD_SKIP_PROBE=1``) and with it (the probe runs beside
    the host dataset and is joined before the card), and
    ``ANOMOD_PLATFORM=cpu detect``."""
    import io

    from anomod_torch.cli import main as cli_main
    from anomod_torch.utils import platform

    def call(argv):
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = cli_main(argv)
        return rc, o.getvalue(), e.getvalue()
    rca_argv = ["rca", "--cpu-failover", "--testbed", "TT", "--epochs", "6",
                "--train-seeds", "2", "--eval-seeds", "1"]
    rca_s, docs = {}, {}
    for mode in ("skipped", "probed", "skipped again"):
        n0 = len(PROBES)
        with env_set("ANOMOD_SKIP_PROBE",
                     "1" if mode.startswith("skipped") else None):
            t0 = time.perf_counter()
            rc, text, err = call(rca_argv)
            rca_s[mode] = time.perf_counter() - t0
        doc = docs[mode] = json.loads(text.strip().splitlines()[-1])
        probes = PROBES[n0:]
        check(rc == 0 and "device_failover" not in doc
              and "device backend lost" not in err
              and [p for p, _ in probes] == (
                  ["cuda"] if mode == "probed" else [])
              and platform._PENDING is None,
              f"cli rca --cpu-failover ({mode}): rc {rc}, {doc}, "
              f"probes {probes}")
        if mode == "probed":
            probe_s = probes[0][1]
    check(docs["probed"] == docs["skipped"],
          "cli rca: the probed run's JSON differs from the skipped one's")
    reset_all_launches()
    n0 = len(PROBES)
    with env_set("ANOMOD_PLATFORM", "cpu"):
        t0 = time.perf_counter()
        rc, text, err = call(["detect", "--testbed", "TT", "--traces", "20"])
        detect_s = time.perf_counter() - t0
    doc = json.loads(text)
    check(rc == 0 and doc["backend"] == "cpu"
          and "ANOMOD_PLATFORM=cpu" in err and len(PROBES) == n0
          and not any(all_launches().values()),
          f"cli ANOMOD_PLATFORM=cpu detect: rc {rc}, backend "
          f"{doc.get('backend')}, launches {all_launches()}")
    skipped = min(rca_s["skipped"], rca_s["skipped again"])
    log(f"[27f] rca --cpu-failover (TT gcn, 6 epochs) on the card, s: "
        f"{ {k: round(v, 3) for k, v in rca_s.items()} } (the probe "
        f"{probe_s:.3f} s beside the host dataset; its cost in the call "
        f"{rca_s['probed'] - skipped:.3f} s against the faster skipped "
        f"call); no device_failover in its JSON, equal with and without "
        f"the probe; ANOMOD_PLATFORM=cpu detect: backend cpu, no kernel "
        f"launched, no probe, {detect_s:.3f} s, on {card}")
    return {"rca_cli_s": rca_s, "rca_cli_probe_s": probe_s,
            "probe_cost_s": rca_s["probed"] - skipped,
            "detect_cpu_s": detect_s}


def device_decisions_phase(dev, card, batch, cfg) -> dict:
    """Phase 27: the device decisions.  (a) the probe of the card; (b)
    ``with_cpu_failover`` alone: a loss re-raised without ``allow``,
    retried once on the CPU with it, and a real out of memory, an
    illegal-address error and a real build error propagated; (c)
    ``train_rca_resilient(failover=True)`` (TT, gcn), clean (==
    ``train_rca`` on the card) and with a loss after its first save (== ``train_rca``
    on the CPU resumed from that checkpoint); (d) a small
    ``severity_sweep(failover=True)`` (SN), clean (``dense_slice_fold``
    launched, no plain version, == the sweep without the flag) and with
    a loss at ``gcn`` (that row == its CPU twin's); (e) both engine knobs:
    each value the card takes launches the kernels with the unset run's
    results, the others are refused before any launch; (f) ``rca
    --cpu-failover`` through the CLI with and without the probe, and
    ``ANOMOD_PLATFORM=cpu detect``.
    The earlier phases' CLI calls skip the probe (:func:`probe_skipped`);
    their count of probes is printed, 0."""
    t_phase = time.perf_counter()
    earlier = list(PROBES)
    log(f"[27] probes run by the earlier phases' CLI calls: {len(earlier)} "
        f"(ANOMOD_SKIP_PROBE=1 around them, probe_skipped)")
    join_probe = start_probe()
    out = {"earlier_probes": len(earlier),
           "failover": _failover_item(dev, card),
           "rca": _rca_item(dev, card),
           "sweep": _sweep_item(dev, card),
           "knobs": _knobs_item(dev, card, batch, cfg)}
    out["probe"] = _probe_item(card, *join_probe())
    out["cli"] = _cli_item(card)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[27] device decisions: {out['wall_s']:.3f} s on {card}")
    return {"device_decisions": out}

#: phase 28's scenario runs under a fault: a TT Chaos Mesh label, a TT
#: ChaosBlade label and an SN label (which the CLI refuses, exit code 1)
FAULT_SCENARIO_LABELS = ("Lv_P_CPU_preserve", "Lv_C_security_check",
                         "Perf_CPU_Contention")
#: the OpenAPI document phase 28 turns into an endpoint pool
FAULT_SPEC = "tests/fixtures/tt_openapi_small.json"
#: what stands for the monitor's temporary output directory in its stdout
OUT_MARK = "<out>"
#: the sha256 of each of phase 28's outputs (:func:`fault_plane_outputs`)
#: as the JAX package gives them; tests/test_torch_workload.py holds this
#: table to the JAX package on the CPU
FAULT_PLANE_DIGESTS = {
    "chaos Normal_Baseline --format yaml":
        "963cf9fca87d293d8bf41d854e46991f9583e7082a347d480cf8dabb615ddd96",
    "chaos Normal_Baseline --format json":
        "b14df6eae1f6187a8de214fc0548e663147b45b53a7a7d551b8e10dcaa215423",
    "chaos Perf_CPU_Contention --format yaml":
        "54e8d453a5aa31d3fb7409b42eb2956ac9d734dd30b6941f86c3ca33b9da37fd",
    "chaos Perf_CPU_Contention --format json":
        "66403d2a722d2020546b9f9542f99b02048c3465e9347bb71fc46e49073c8b12",
    "chaos Perf_Network_Loss --format yaml":
        "4b5bf2835189a18c2cd86aa9769561d9d153111a5533cf4eb893100b353ccd63",
    "chaos Perf_Network_Loss --format json":
        "8537e99caa130cd9a63ea039fe3eec51db5010278173abef7ef3d26b7abeefff",
    "chaos Perf_Disk_IO_Stress --format yaml":
        "894a22aaaa330bbf4af7590d7314254a54a705789845819ffe7e53d213254984",
    "chaos Perf_Disk_IO_Stress --format json":
        "159bf2930bbc881bf78bf95dd0ec01dc05e9bd6b57bdc61c9be556b328892193",
    "chaos Svc_Kill_UserTimeline --format yaml":
        "7d1f8d526d40bc1b4041e801647ef20072d393643bf3c2ef677179c7a3a538a5",
    "chaos Svc_Kill_UserTimeline --format json":
        "851313eb14931d4961ed9c0cbbd6a60d9bbc8cd888d72d2df0967e310781012f",
    "chaos Svc_Kill_Media --format yaml":
        "3ecacb1fc144f1293f00515bf8253893d4eb5841e1e34f8a7b9211b89d45e541",
    "chaos Svc_Kill_Media --format json":
        "4ae2e116768023d5d9d09292cdcec08afed5ae7a35d02c61d68cfdfe84f86f36",
    "chaos Svc_Kill_SocialGraph --format yaml":
        "a76517704f6d15e34d543055fee549ac64cea989176668138af409a696b594a2",
    "chaos Svc_Kill_SocialGraph --format json":
        "ed3f5ab779f9636df631df558a33f4570570620d0dc95a3e32dfa11ed451af2d",
    "chaos DB_Redis_CacheLimit_HomeTimeline --format yaml":
        "ad9495b58673e0efc2ee7297fe284b646ea60041bdea3bd3d3874b01c816fe62",
    "chaos DB_Redis_CacheLimit_HomeTimeline --format json":
        "52ecd1f109f3c7381cee141d58ac108d430133aab81476c634457f50fd751ac4",
    "chaos DB_Redis_CacheLimit_UserTimeline --format yaml":
        "05d575a2ba7688274962eb30a6d88e5c895508fcf9fc992f8728c4649bf39177",
    "chaos DB_Redis_CacheLimit_UserTimeline --format json":
        "06baa4a85d9d5375bf568c475ae87d2ad102700230a2e647fe63048b2f61f283",
    "chaos DB_Redis_CacheLimit_SocialGraph --format yaml":
        "311d428b8cae4cb98f30bdae76697eaec912f8166a258a3072f51e8d7c87c019",
    "chaos DB_Redis_CacheLimit_SocialGraph --format json":
        "6d32c32b50270f74f805febdfc897f4cf8abb319950ee853497b6c5ba6b20fcc",
    "chaos Code_Stop_UserService --format yaml":
        "b20c65bfacc6aeb30ce5c553f3a1be78631723486f43872ebc7e2d33fd4892a8",
    "chaos Code_Stop_UserService --format json":
        "69dcb2200261f2702f702ffea7775b95a0514f77bd53b7134e487955727c3753",
    "chaos Code_Stop_TextService --format yaml":
        "916449bd39bdc6fc4bd7c4d0b4e619ef55ab1ff7c35cb4063649185bbb8bd40b",
    "chaos Code_Stop_TextService --format json":
        "7626a4d4eed941285bca08346241e1051a3e3f415aaf7800a79f69abca09aac6",
    "chaos Code_Stop_MediaService --format yaml":
        "97a63d6ce03acf4aa8e6c196ad5f63b4e7056a06bc88f97c3c896fccc402e35e",
    "chaos Code_Stop_MediaService --format json":
        "8b3dc1623ea696aa69f8e12a3dd2e92c9ee9c236b7663ad33e526d5dc3f10ea1",
    "chaos Normal_case --format yaml":
        "0707a10b4ae683f3f046876931337a184d0df5148c609b8e32e7535c613239f3",
    "chaos Normal_case --format json":
        "7e26b77a5bf244bff937210ab8acd5ad278f843a4362015ab0de41eb23d8d283",
    "chaos Lv_P_CPU_preserve --format yaml":
        "936cacf78895c417f5468178df282a28047c34f3b5cd1acac842bdb2f1b5af51",
    "chaos Lv_P_CPU_preserve --format json":
        "617d1bdef3455ec40d8b6732fe575aa4c18bbb64d67b461520a2ed4fe23232f2",
    "chaos Lv_P_DISKIO_preserve --format yaml":
        "b8e779c03dbdbf61e3a92b090c4d9471a80fb4db2215427d72171fe7cbb681e0",
    "chaos Lv_P_DISKIO_preserve --format json":
        "762e535bb7cb322f01128b9c4c7c3c422f0a1d477c90ca7ef97ddddd9d221dd7",
    "chaos Lv_P_NETLOSS_preserve --format yaml":
        "9e6a6deae37f1887f6f06f3ca9da221ad900cf9e054119b86adb7e15e24c01ff",
    "chaos Lv_P_NETLOSS_preserve --format json":
        "05b95f1f03bf6f7f00052f794eb0d370adb6011f18a55d8f1c664c63c4e2cc6c",
    "chaos Lv_S_DNSFAIL_preserve_no_order --format yaml":
        "9c13354d8e2eb33ffa3253e671a63b223c152d143038b0b9941710537f56a148",
    "chaos Lv_S_DNSFAIL_preserve_no_order --format json":
        "2600a29fa7e01aacc34b865c07ce61e6eccde83995d1f58923a4d528269079a2",
    "chaos Lv_S_HTTPABORT_preserve --format yaml":
        "75236d561b79135818ece54d6ed14f642552fa8a2f3082b3918170e49713f019",
    "chaos Lv_S_HTTPABORT_preserve --format json":
        "67706d2e30a2af033cd8a80e0b4422f9d29ac1472f3dced526cb9a16be78e117",
    "chaos Lv_S_KILLPOD_preserve --format yaml":
        "0eef51f4070eacfb4be56f294e3e3db533e9ff84d66bd7cb317e68e4370a4d14",
    "chaos Lv_S_KILLPOD_preserve --format json":
        "5ba839ef80fd0fa97b5b58bca949b55afc741d99aea3ac5015c909d01d6efeb4",
    "chaos Lv_D_cachelimit --format yaml":
        "c3962eb730b2261b1737831ded527e3687dcfbc04cfacc26deb692470e90983c",
    "chaos Lv_D_cachelimit --format json":
        "95a68d2521e6891997e78efa94b30ec062ac3b1fa5c8f2ce948a66eab8c4e8dc",
    "chaos Lv_D_CONNECTION_POOL_exhaustion --format yaml":
        "a2a319e89bd205969ed04f36a8b50d1a8ef8ef12c6b2440a7a2762f3b9717bdc",
    "chaos Lv_D_CONNECTION_POOL_exhaustion --format json":
        "79ae449cf4767ff66c0f270a9b2cf33d20206eeabe7065911ad64a16268d173b",
    "chaos Lv_D_TRANSACTION_timeout --format yaml":
        "14adb377009d4ce45ebf65348f141f4b9470e1ca526d834838025912c2246028",
    "chaos Lv_D_TRANSACTION_timeout --format json":
        "3e6b6064e349560c7f091a006e27621630e41bcf8d4ffb1514f81837e6918ea4",
    "chaos Lv_C_security_check --format yaml":
        "b01f8c8962064caf2c246a95b422a013a226c2ebef0bc6d4caa5984be6048c44",
    "chaos Lv_C_security_check --format json":
        "9637f5cea4ff7ff4de7040122ac684bf3bb2668ad157a3bdcd7bc08ed1f629d7",
    "chaos Lv_C_exception_injection --format yaml":
        "097f13a80fa81ef6ab79b4530065f00ba6af14ff5f83e36e06edf0751beab5d7",
    "chaos Lv_C_exception_injection --format json":
        "80d7474774431fb51ecb75a9ec101bdf6266c3fbeca98ae88d8e2348a1626879",
    "chaos Lv_C_travel_detail_failure --format yaml":
        "df872bee78c17dd4ea5a409e65a584eea724e30d3f9e045575cf6c87aa765e2d",
    "chaos Lv_C_travel_detail_failure --format json":
        "bc23960897297b739bade7da59274613646c3fd04b5f94235250f07360d64fc1",
    "deploy":
        "70af33b740547b595979c7e59d77433a686ef634d6da19284554922b6799f362",
    "deploy --all":
        "b291fe08fd1b1e12f6f52b40306fdc1757a62054aca02d17c5486d598fb01def",
    "deploy --independent-db":
        "207fd3aad422208aff70b651f72b947d8946ef86c5979eee7abb9511d9742e32",
    "deploy --with-monitoring --with-tracing":
        "02d9faf3e96c6f409c769ab99a2d77d749339077ecb04806ebd6bfad33fb7432",
    "deploy --secrets":
        "43229cfe6e72ebfa7ebb7a173a0f7ff43ba111da308e7c1d65bb25e879a86e93",
    "deploy --secrets --independent-db":
        "e57b89e4f712fd75b9949b959eb706af8d3adbef6074846b78f9459a1cda31a2",
    "deploy --testbed SN":
        "0e99c699fb5ee26e2b9d8c970b64d22b09a8067cfca31ae537effd842aeb6d2e",
    "deploy --testbed SN --down":
        "d85aacc9c0e448a7c9b10df36221b792571196c65e53797d0a4d76c0d52e96ce",
    "scenario --iterations 2 --seed 0":
        "3a6f56bece40d27fc4cfd096b692080b729ee5fe4c84fab92e520feb96fbf0f7",
    "scenario --iterations 2 --seed 0 --chaos Lv_P_CPU_preserve":
        "d0d98d21fdecef8c6462ab64be833774fd120d92e6fce9639de6d24f019ebeb2",
    "scenario --iterations 2 --seed 0 --chaos Lv_C_security_check":
        "2ec418caafce00b57b1086462ee2ef134fb1a6461c1394c174408ac173bce6ce",
    "scenario --iterations 2 --seed 0 --chaos Perf_CPU_Contention":
        "e340cdd9a64d0ed494bc9e66d18ff91f622b0c0862facbfc4001cfcbea64341d",
    "monitor --cycles 10 --wrk2-requests 50 --out <out>":
        "a527a35f10321ba9f4812d2cef028add158fb57bb12e28fc8e109be7553e58b3",
    "monitor --mode passive":
        "d8d09db8890eccaeb28a4016dbd240a633f4b82524e9bf07360fea8616919ce9",
    "monitor file collection_report.json":
        "8517ec1bae964173f2b0c38fe47daeb3cae2d4748273892c739b21f0be06be2e",
    "monitor file endpoint_performance.json":
        "5f4774b66ddab5c5ee4355abcd12a6464dfd5619de72dc768b192b72b2673b75",
    "monitor file openapi_responses.jsonl":
        "ef75027af59c3facb65661ef4e0ec29ecfd1ea42f2868d4cb7036aa6d5f4234e",
    "monitor file response_summary.json":
        "03342c34241ab2cffbb63cade38b105b895afa619bc4516518a3b1a97372395d",
    "monitor file status_code_distribution.csv":
        "8a35e78d640d18f916b59668fca61b719b87c27eab31c813d7613332757419e6",
    "monitor file traffic_analysis.json":
        "5de2df41f74d72fb7084ac15bbe25da3bb0bfd826fb58d73f8f59eb47106f982",
    "run_with_recovery":
        "40abc72f2fb8290fb26a477b62c1d3c1685b0581ab86cee08252cdf21d3dbc11",
    "suite TT 120 s under Lv_S_HTTPABORT_preserve":
        "46c245487eb69654a0d7ad050a358d2f2e16ebd048408fef21c9e83b8a6f2fb5",
    "endpoint_pool_from_spec":
        "a1a0a402340c28b72da92bb1257a66df88b6d974a46cf835e0c5c4d35f21d830",
}


def fault_plane_argvs(labels, out_dir) -> list:
    """Phase 28's CLI calls: ``chaos`` for every label in both formats,
    ``deploy`` (TT bare, ``--all``, ``--independent-db``, monitoring and
    tracing, ``--secrets`` shared and independent; SN up and down),
    ``scenario`` bare and under each of :data:`FAULT_SCENARIO_LABELS`,
    ``monitor`` active (into ``out_dir``) and passive."""
    argvs = [["chaos", lab.experiment, "--format", fmt]
             for lab in labels.ALL_LABELS for fmt in ("yaml", "json")]
    argvs += [["deploy"] + a for a in (
        [], ["--all"], ["--independent-db"],
        ["--with-monitoring", "--with-tracing"], ["--secrets"],
        ["--secrets", "--independent-db"], ["--testbed", "SN"],
        ["--testbed", "SN", "--down"])]
    scen = ["scenario", "--iterations", "2", "--seed", "0"]
    argvs += [scen] + [scen + ["--chaos", x] for x in FAULT_SCENARIO_LABELS]
    argvs += [["monitor", "--cycles", "10", "--wrk2-requests", "50",
               "--out", str(out_dir)], ["monitor", "--mode", "passive"]]
    return argvs


@contextlib.contextmanager
def utc_clock():
    """``TZ=UTC`` while the block runs: the monitor's artifact stamps its
    records in local time (``datetime.fromtimestamp``)."""
    import os
    prev = os.environ.get("TZ")
    os.environ["TZ"] = "UTC"
    time.tzset()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("TZ", None)
        else:
            os.environ["TZ"] = prev
        time.tzset()


def _batch_bytes(batch) -> bytes:
    """A named tuple of numpy columns and name tables, field by field."""
    import numpy as np
    parts = []
    for name in batch._fields:
        v = getattr(batch, name)
        if isinstance(v, np.ndarray):
            parts.append(f"{name} {v.dtype.str} {v.shape}\n".encode()
                         + v.tobytes())
        else:
            parts.append(f"{name} {json.dumps(v)}\n".encode())
    return b"\n".join(parts)


def fault_plane_outputs(pkg, cli_main, root) -> dict:
    """Phase 28's outputs, each as bytes: every call of
    :func:`fault_plane_argvs` through ``cli_main`` in this process (its
    exit code, stdout, and stderr where it fails), each file the active
    monitor writes, and three direct calls: ``run_with_recovery`` on the
    seeded TT cluster, a 120 s TT suite run under an injected fault, and
    the endpoint pool of :data:`FAULT_SPEC` under ``root``.  ``pkg`` is
    the package (its ``labels``, ``chaos``, ``recovery``, ``suite`` and
    ``openapi`` imported); the JAX package's outputs give
    :data:`FAULT_PLANE_DIGESTS` (``tests/test_torch_workload.py`` holds
    them)."""
    import dataclasses
    import io
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp, utc_clock():
        mon = Path(tmp, "monitor")
        for argv in fault_plane_argvs(pkg.labels, mon):
            stdout, stderr = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(stdout), \
                    contextlib.redirect_stderr(stderr):
                try:
                    rc = cli_main(argv)
                except SystemExit as e:
                    rc = e.code
            text = f"rc={rc}\n" + stdout.getvalue().replace(str(mon),
                                                            OUT_MARK)
            if rc:
                text += "\nstderr:\n" + stderr.getvalue()
            out[" ".join(argv).replace(str(mon), OUT_MARK)] = text.encode()
        for f in sorted(mon.iterdir()):
            out[f"monitor file {f.name}"] = f.read_bytes()

        R = pkg.recovery
        cluster = R.cluster_for_testbed("TT", seed=0)
        ctl = pkg.chaos.ChaosController()
        prom = R.PrometheusState(oom_killed=True, ready=False)
        effects = []

        def body():
            effects.append(ctl.active_effects("ts-preserve-service"))
            return "collected"
        result, report = R.run_with_recovery(
            cluster, ctl, "Lv_P_CPU_preserve", body, prometheus=prom)
        out["run_with_recovery"] = json.dumps({
            "result": result, "report": dataclasses.asdict(report),
            "prometheus": dataclasses.asdict(prom), "effects": effects,
            "active_after": len(ctl.status()), "now": cluster.now,
            "pods": {n: dataclasses.asdict(p)
                     for n, p in cluster.pods.items()}},
            sort_keys=True).encode()

        suite = pkg.suite.generate_suite("TT", budget_s=120)
        with ctl.inject("Lv_S_HTTPABORT_preserve"):
            run = pkg.suite.run_suite(suite, iterations=2, seed=5,
                                      controller=ctl)
        out["suite TT 120 s under Lv_S_HTTPABORT_preserve"] = json.dumps({
            "run_id": suite.run_id, "n_tests": suite.n_tests,
            "covered_targets": suite.covered_targets,
            "tests": [[t.name, dataclasses.asdict(t.spec),
                       list(t.expect_status)] for t in suite.tests],
            "pass_rate": run.pass_rate}).encode() + b"\n" + b"\n".join(
            [_batch_bytes(run.api), _batch_bytes(run.spans),
             run.passed.tobytes(), run.trace_of_request.tobytes()])

        spec = pkg.openapi.load_spec(Path(root, FAULT_SPEC))
        out["endpoint_pool_from_spec"] = json.dumps(
            [dataclasses.asdict(s)
             for s in pkg.openapi.endpoint_pool_from_spec(spec)]).encode()
    return out


def fault_plane_phase(card) -> dict:
    """Phase 28: the fault and workload planes, host only.
    :func:`fault_plane_outputs` of the port, with ``yaml`` blocked (the
    port renders its YAML itself) and no probe skipped: each output's
    sha256 equals :data:`FAULT_PLANE_DIGESTS`; no probe of the card
    started, no kernel launched, no device memory taken."""
    import hashlib
    import importlib.util

    import torch

    import anomod_torch
    import anomod_torch.chaos  # noqa: F401  (the outputs' modules)
    import anomod_torch.labels  # noqa: F401
    import anomod_torch.openapi  # noqa: F401
    import anomod_torch.recovery  # noqa: F401
    import anomod_torch.suite  # noqa: F401
    from anomod_torch.cli import main as cli_main
    root = Path(__file__).resolve().parent
    yaml_here = importlib.util.find_spec("yaml") is not None
    n_probes, launches = len(PROBES), all_launches()
    mem = torch.cuda.memory_allocated()
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None        # import yaml raises
    t0 = time.perf_counter()
    try:
        outs = fault_plane_outputs(anomod_torch, cli_main, root)
    finally:
        if saved is None:
            sys.modules.pop("yaml", None)
        else:
            sys.modules["yaml"] = saved
    wall = time.perf_counter() - t0
    got = {k: hashlib.sha256(v).hexdigest() for k, v in outs.items()}
    bad = sorted(k for k in set(got) | set(FAULT_PLANE_DIGESTS)
                 if got.get(k) != FAULT_PLANE_DIGESTS.get(k))
    check(not bad, f"phase 28: {len(bad)} outputs differ from the JAX "
          f"package's: {bad[:8]}")
    check(len(PROBES) == n_probes,
          f"phase 28: {len(PROBES) - n_probes} probes of the card")
    check(all_launches() == launches,
          f"phase 28: launches {all_launches()} != {launches}")
    check(torch.cuda.memory_allocated() == mem,
          f"phase 28: device memory {torch.cuda.memory_allocated()} B, "
          f"was {mem} B")
    check(wall <= 15.0, f"phase 28: {wall:.1f} s, over 15 s")
    out = dict(n_outputs=len(got), wall_s=wall, probes=0,
               yaml_importable=yaml_here,
               n_bytes=sum(len(v) for v in outs.values()))
    log(f"[28] fault and workload planes: {len(got)} outputs (chaos, "
        f"deploy, scenario, monitor through the CLI; the artifact tree; "
        f"run_with_recovery, a TT suite under a fault, a spec's endpoint "
        f"pool) == the JAX package's sha256, yaml blocked (importable on "
        f"this machine: {yaml_here}); 0 probes, 0 launches, device memory "
        f"unchanged; {wall:.3f} s on {card}")
    return {"fault_planes": out}


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
    count_probes()
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
    from anomod_torch.io import native as host_native
    t0 = time.perf_counter()
    host_lib = host_native.build()
    cxx = host_native.cxx()
    log(f"[1] host entries (anomod_torch/csrc/native.cpp) built in "
        f"{time.perf_counter() - t0:.1f} s by {cxx} "
        + subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
        + f" ({' '.join(host_native.CXX_FLAGS)}): {host_lib}")
    t0 = time.perf_counter()
    _build.build(["replay", "serve", "sketch"])
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s; "
        + subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
        .splitlines()[-1])
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
    acc = torch.zeros((SW + 1, rk.N_PAYLOAD + H), device=dev)
    idx = sid.long()
    dense_t = timed(lambda: rk.replay_dense(sid, planes, SW, H),
                    lambda: acc.index_add_(0, idx, payload))
    dense_split = traced_ms(lambda: rk.replay_dense(sid, planes, SW, H),
                            DENSE_KERNELS)
    # both kernels fold the same real spans into the same [SW, 6+H]
    # plane; the dense fold adds hi and lo apart, 9+H columns a span
    fold_bound, fold_by = bound(n_real, SW * (6 + H),
                                n_cols=rk.N_PAYLOAD + H)
    sorted_bound, sorted_by = bound(n_real, SW * (6 + H))
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
    c_acc = torch.zeros((ESW + 1, rk.N_PAYLOAD + H), device=dev)
    c_idx = c_sid.long()
    chunk_t = timed(lambda: rk.replay_dense(c_sid, c_planes, ESW, H),
                    lambda: c_acc.index_add_(0, c_idx, c_payload))
    chunk_split = traced_ms(lambda: rk.replay_dense(c_sid, c_planes, ESW, H),
                            DENSE_KERNELS)
    c_live = int((c_sid < ESW).sum())
    chunk_bound, chunk_by = bound(c_live, ESW * (6 + H),
                                  n_dead=ecfg.chunk_size - c_live,
                                  n_cols=rk.N_PAYLOAD + H)
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
    s_payload = rk.sorted_payload(s_args[1], H)
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
        f"{sorted_bound:.6f} ms; unspun: {sorted_t['ms_unspun']:.4f}, "
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

    # each later phase's wall, for the script's time budget
    phase_walls = {"1-5": time.perf_counter() - t_all}

    def run_phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_walls[name] = time.perf_counter() - t0

    # phases 13's, 14's and 16's CPU runs go on in a spawned process from
    # here
    import multiprocessing
    twin_pool = multiprocessing.get_context("spawn").Pool(1)
    detect_twins = twin_pool.apply_async(detect_cpu_twin)
    twins = twin_pool.apply_async(rca_cpu_twins)
    data = run_phase("5b", data_phase, card)
    serve = run_phase("6-8", serve_phases, dev, card)
    unfused_alerts = serve.pop("serve_unfused_alerts")
    sketch = run_phase("9-11", sketch_phases, dev, card, batch, cfg)
    roof = run_phase("12", roofline_phases, dev, card, kind, sid_np,
                     planes_np, n_real, SW)
    det13 = run_phase("13", detect_phase, dev, card, detect_twins)
    rca14 = run_phase("14", rca_phase, dev, card, twins)
    rca_train = rca14.pop("rca_train_batch")
    mm15 = run_phase("15", multimodal_phase, dev, card, PlainFoldReplay)
    mm_launches = mm15["multimodal_stream"]["dense_launches"]
    rca16 = run_phase("16", rca_serve_phase, dev, card, twins)
    cpu_journal = rca16.pop("cpu_journal")
    twin_pool.close()
    twin_pool.join()
    tele17 = run_phase("17", telemetry_phase, dev, card, PlainFoldReplay)
    ss_launches = tele17["telemetry"]["selfscrape_dense_launches"]
    q18 = run_phase("18", quality_phase, dev, card)
    q_launches = q18["quality"]["dense_launches"]
    s19 = run_phase("19", shift_phase, dev, card)
    fs20 = run_phase("20", flight_shard_phase, dev, card, cpu_journal)
    ps21 = run_phase("21", supervise_proc_phase, dev, card, cpu_journal,
                     fs20)
    p22 = run_phase("22", elastic_async_tier_phase, dev, card, cpu_journal)
    p23 = run_phase("23", live_feed_phase, dev, card)
    p24 = run_phase("24", observatory_phase, dev, card, cpu_journal)
    p25 = run_phase("25", parallel_phase, dev, card, batch, cfg, rates,
                    rows, unfused_alerts)
    par = p25["parallel"]
    p26 = run_phase("26", planes_phase, dev, card, rca_train)
    planes = p26["planes"]
    p27 = run_phase("27", device_decisions_phase, dev, card, batch, cfg)
    dd = p27["device_decisions"]
    p28 = run_phase("28", fault_plane_phase, card)
    log(f"[walls] s by phase: "
        f"{ {k: round(v, 1) for k, v in phase_walls.items()} }")

    # -- report -----------------------------------------------------------
    # the dense kernel's top-level times are the corpus pass's; each path
    # shape has its own entry, launches counted on the main path
    corpus = dict(launches=launches["replay_dense"] - stream_launches,
                  plain_ms=dense_plain_ms, bound_ms=fold_bound,
                  bound_by=fold_by, traced=dense_split, **dense_t)
    chunk = dict(launches=stream_launches + mm_launches + ss_launches
                 + q_launches,
                 span_stream_launches=stream_launches,
                 multimodal_stream_launches=mm_launches,
                 selfscrape_launches=ss_launches,
                 quality_sweep_launches=q_launches,
                 plain_ms=chunk_plain_ms,
                 bound_ms=chunk_bound, bound_by=chunk_by,
                 traced=chunk_split, stream_trace_ms=chunk_trace_ms,
                 **chunk_t)
    kernels = [
        {"name": "replay_dense", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:85", "redesigned": "PR 6",
         "launches": launches["replay_dense"] + mm_launches + ss_launches
         + q_launches,
         "max_abs_err": max(dense_err, err_4320),
         **{k: corpus[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "ms_unspun",
                                   "library_ms_unspun")},
         "bit_identical_launches": {"corpus": dense_bits,
                                    "stream_chunk": chunk_bits},
         # phase 25's sharded replay, sharded stream and serve mesh plane
         "launches_phase25": {
             "sharded_replay": par["replay"]["launches"]["replay_dense"],
             "sharded_stream": par["stream"]["dense_launches"],
             "serve_mesh": par["serve"]["dense_launches"]},
         # phase 26's dry run (the sharded replay and the stream pushes)
         "launches_phase26": planes["dryrun"]["launches"]["replay_dense"],
         "shapes": {"corpus": corpus, "stream_chunk": chunk}},
        {"name": "replay_sorted", "route": "cuda",
         "source": "anomod_torch/csrc/replay.cu",
         "replaces": "anomod/ops/pallas_replay.py:257", "redesigned": "PR 5",
         "launches": launches["replay_sorted"], "max_abs_err": sorted_err,
         "plain_ms": sorted_plain_ms, "bound_ms": sorted_bound,
         "bound_by": sorted_by, **sorted_t},
    ] + serve.pop("kernels") + sketch.pop("kernels") + roof.pop("kernels")
    # the serve kernels' launches on phase 20's sharded runs, beside the
    # main path's 1-shard count
    for k in kernels:
        if k["name"] in ("lane_delta", "window_gather"):
            k["launches_by_shards"] = {
                str(n): fs20["shards"][str(n)]["launches"][k["name"]]
                for n in SHARD_COUNTS}
            # phase 21's process workers: launched in the children, the
            # counts carried home in their replies
            k["launches_by_process_run"] = {
                name: r["launches"].get(k["name"], 0)
                for name, r in ps21["process"].items()
                if name.startswith("process")}
            # phase 22's deferred, elastic and tiered runs
            k["launches_phase22"] = \
                p22["elastic_async_tier"]["launches"][k["name"]]
            # phase 23's feed and sidecar runs
            k["launches_phase23"] = p23["live_feed"]["launches"][k["name"]]
            # phase 24's perf, census and sweep runs
            k["launches_phase24"] = \
                p24["observatories"]["launches"][k["name"]]
        if k["name"] == "hll_update":
            # phase 25's sharded replay (with_hll)
            k["launches_phase25"] = par["replay"]["launches"]["hll_update"]
            # phase 26's dry run (the sharded replay's two routes)
            k["launches_phase26"] = \
                planes["dryrun"]["launches"]["hll_update"]
        # phase 27's runs under the knobs and its small sweep
        if k["name"] in ("lane_delta", "window_gather"):
            k["launches_phase27"] = sum(
                n[k["name"]] for n in dd["knobs"]["serve_launches"].values())
        if k["name"] == "tdigest_reduce":
            k["launches_phase27"] = sum(
                dd["knobs"]["tdigest_launches"].values())
        if k["name"] == "replay_dense":
            k["launches_phase27"] = dd["sweep"]["dense_launches"]
    log(json.dumps({"replay_spans_per_sec": rates, "replicate": replicate,
                    "stream_top1": sum(hits) / len(hits),
                    "stream_wall_s": stream_s,
                    "stream_dense_trace_ms": stream_kernels,
                    "stream_device_busy_ms": busy,
                    "stream_profiled_wall_s": prof_s,
                    "stream_device_busy_share": busy_share,
                    "sorted_ends_ms": end_ms, "dense_ends_ms": dense_end_ms,
                    "l2_eviction_ms": flush, **data, **serve,
                    **sketch, **roof, **det13, **rca14, **mm15, **rca16,
                    **tele17, **q18, **s19, **fs20, **ps21, **p22, **p23,
                    **p24, **p25, **p26, **p27, **p28,
                    "phase_walls_s": phase_walls,
                    "wall_s": time.perf_counter() - t_all}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__mp_main__":
    # a spawned process worker of phase 21 (the spawn start method
    # re-imports this script under that name before the child's entry
    # runs): profile the child when phase 21 asks for it
    import os
    if os.environ.get(CHILD_PROFILE_ENV):
        _child_profiler(os.environ[CHILD_PROFILE_ENV])

if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
