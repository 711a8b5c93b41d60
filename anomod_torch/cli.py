"""``python -m anomod_torch``: the port's command line.

- ``replay``: time the TT/SN span replay fold and print one JSON line
  (the counterpart of ``anomod replay``); ``--percentiles`` adds the
  corpus p50/p95/p99 from the per-segment t-digest plane,
  ``--edge-percentiles`` the five slowest cross edges by p99 with their
  HLL distinct-trace counts.
- ``replay``, ``stream`` and ``serve`` take ``--devices N``: the run goes
  over an N-device mesh (``anomod_torch.parallel``), one rank a device
  (``nccl`` on the cards, ``gloo`` ranks with ``--device cpu``), each rank
  folding its shard and merging through collectives; the sharded replay,
  the sharded streaming plane under the detector, the serve mesh plane.
  Rank 0's result is printed.  N above the attached cards is an error.
- ``detect``: the offline five-modality z-score detector over a
  testbed's 13 experiments (synthetic, or ``--from-data`` through the
  loaders), evaluated against the chaos labels: one JSON document (the
  counterpart of ``anomod detect``).
- ``rca``: train an RCA model (``gcn``, ``gat``, ``sage``, ``temporal``,
  ``lru``, ``transformer``, ``moe``, ``linegraph``) on chaos labels and
  report held-out top-1, top-3 and detection AUC, one JSON line; with
  ``--checkpoint-dir`` (and ``--resume``) it saves and continues (the
  counterpart of ``anomod rca``).
- ``quality``: the de-saturated quality sweep (the counterpart of
  ``anomod quality``): degradation curves over fault severity
  (``--sweep severity``) or the train-shift / eval-shift table (``--sweep
  shift``, ``--edge-aware``), as a markdown table or ``--json`` lines,
  with a ``quality_*_sweep`` capture.
- ``stream``: online detection over one experiment (or ``--all`` of a
  testbed's taxonomy): alert timelines, ranked culprits and top-1 per
  label, one JSON line each; ``--multimodal`` fuses the log, metric and
  API planes, ``--severity`` / ``--noise`` / ``--confounders`` harden the
  generated corpus and ``--shift`` (``--all`` only) draws it from one of
  the quality sweep's shifted generators.  ``--all`` ends with the
  summary line (top-1, top-3, median detection latency) and writes a
  ``stream_quality`` capture (``provenance``).
- ``serve``: the multi-tenant serve plane over a seeded power-law fleet
  on a virtual clock; prints the ``ServeReport`` as JSON (the
  counterpart of ``anomod serve``).  ``--rca`` runs online root-cause
  inference in the tick, ``--trace-out`` dumps the engine's Jaeger-shaped
  trace; with ``ANOMOD_OBS_HTTP`` on, ``/metrics`` (and ``/flight``) is
  served meanwhile.  ``--shards N`` fans the score plane out to N worker
  threads, or processes with ``--worker process`` (``--fold`` picks the
  barrier's registry merge); the flight recorder is on unless
  ``ANOMOD_FLIGHT=0``.  Supervision is on (``--ckpt-every``, default 32
  ticks; 0 turns it off) and ``--chaos`` injects a fault script.
  ``--from-live URL|self`` drives the tick from a live text-exposition
  endpoint instead (``self``: the port's own ``/metrics``, the dogfood
  loop), ``--live-replay JOURNAL`` re-runs a recorded wire journal;
  ``--feed-lag`` and ``--feed-journal`` set the feed's lag budget and
  where its wire journal goes (``anomod_torch.serve.feed``).
- ``audit record | replay | diff``: the flight recorder's forensics (the
  counterpart of ``anomod audit``): ``record`` serves seeded traffic and
  dumps the journal, ``replay`` re-executes a journal from its header's
  ``run`` (``--shards``, ``--pipeline``, ``--state`` and
  ``--digest-every`` override it; a live-feed journal replays through its
  wire journal), ``diff`` compares two journals tick by tick and exits 1
  naming the first divergent tick and plane.
- ``collect prometheus | jaeger | skywalking | es``: pull from a running
  endpoint and write the artifact the loaders read (the counterpart of
  ``anomod collect``'s four HTTP kinds, ``anomod_torch.io.live``); prints
  the ``CollectReport`` as one JSON line.
- ``obs snapshot | export | score``: the telemetry plane (the
  counterpart of ``anomod obs``): a seeded self-exercise serve run fills
  a fresh registry, then its point-in-time state prints (JSON or
  Prometheus text), its journal or the engine's span trace exports, or
  its telemetry (or a TT-CSV capture, ``--from``) scores through the
  detector.
- ``roofline``: the sorted replay kernel's roofline probe (the
  counterpart of ``scripts/bench_kernel_roofline.py``): rates of the
  kernel and its two ablations, one JSON line, one capture.
- ``perf record | diff | history``: the perf observatory (the
  counterpart of ``anomod perf``): ``record`` serves seeded traffic with
  the dispatch-lifecycle timeline on and dumps it (``--chrome``: a
  Perfetto trace too), ``diff`` compares two captures (exit 2 on a
  decision drift or a coverage gap, 1 on a significant wall regression),
  ``history`` indexes a runs directory.  ``serve --perf`` turns the
  timeline on in a serve run.
- ``census record | probe | diff``: the fleet census (the counterpart of
  ``anomod census``): ``record`` dumps a run's census timeline, ``probe``
  runs the registered-fleet sweep, ``diff`` compares two captures'
  census blocks (exit 1 on a regression, 2 on a missing block).
- ``list``, ``synth``, ``ingest`` and ``logscan``: the labels, one
  synthetic experiment's summary, the ingest cache (``--warm-cache``,
  ``--clear``) and a directory's per-file log summaries (the Python
  scanner), as their ``anomod`` counterparts print them.
- ``chaos``, ``deploy``, ``scenario`` and ``monitor``: the fault and
  workload planes, host only (no ``--device``, no probe): an
  experiment's fault-injection plan (Chaos Mesh CRD, ChaosBlade or docker
  argv; YAML through ``utils.yamlsafe``, no PyYAML), the TT helm /
  kubectl plan (``--secrets``: the per-service DB secrets) or the SN
  compose lifecycle, the TT user-journey workload against the synthetic
  SUT (``--chaos``: under a TT fault), and the SN API-response capture
  (``--out``: the artifact family); each prints what its ``anomod``
  counterpart prints.

Every subcommand that runs on the card probes it (:func:`_probe_backend`,
a subprocess with a deadline: ``ANOMOD_PROBE_DEADLINE``, skipped under
``ANOMOD_SKIP_PROBE=1``), started once its flags are validated and run
beside its host work, joined before the card is first touched; a dead or
missing card exits non-zero with the diagnostic and never moves the run
to the host.  The host is asked for with ``--device cpu``, or with
``ANOMOD_PLATFORM=cpu``, which sets ``--device cpu`` wherever no
``--device`` was given (and then bounds ``--devices`` by
``ANOMOD_CPU_DEVICES``, default 1, as the JAX package sizes its CPU
mesh).  ``rca --cpu-failover`` and ``quality --cpu-failover`` let a run
that loses its card mid-run finish on the CPU
(:mod:`anomod_torch.utils.platform`), and say so (``device_failover``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

#: the actions that read no device (they refuse ``--device``):
#: ``ANOMOD_PLATFORM=cpu`` leaves them alone
_HOST_ONLY = {("audit", "diff"), ("perf", "diff"), ("perf", "history"),
              ("census", "diff")}


def _platform_cpu() -> bool:
    return os.environ.get("ANOMOD_PLATFORM", "").strip().lower() == "cpu"


def _pin_platform(args) -> None:
    """``ANOMOD_PLATFORM=cpu``: ``--device cpu`` wherever the caller gave
    no ``--device``, said on stderr.  Only the CLI reads the variable."""
    if not _platform_cpu() or getattr(args, "device", "") is not None \
            or (args.cmd, getattr(args, "action", None)) in _HOST_ONLY:
        return
    args.device = "cpu"
    print("[anomod_torch] ANOMOD_PLATFORM=cpu: running on the host "
          "(--device cpu)", file=sys.stderr)


def _probe_backend(args) -> None:
    """Start the bounded probe of the card, called after the subcommand's
    flag validation so usage errors stay instant.  It runs beside the
    subcommand's host work and is joined before the card is first touched
    (``device.resolve_device``), or at the end of :func:`main`.  Skipped
    when the run will not use the card (``--device cpu``, which
    ``ANOMOD_PLATFORM=cpu`` sets) and under ``ANOMOD_SKIP_PROBE=1``.  A
    dead or missing card raises ``RuntimeError`` with the diagnostic (a
    non-zero exit): the run is never moved to the host.  One probe a
    call."""
    if getattr(args, "probed", False):
        return
    args.probed = True
    device = getattr(args, "device", None)
    if device is not None:
        import torch
        if torch.device(device).type == "cpu":
            return
    from anomod_torch.utils.platform import start_probe
    start_probe()


def _parser() -> argparse.ArgumentParser:
    from anomod_torch.quality import DEFAULT_MODELS, SEVERITIES, SHIFTS
    from anomod_torch.rca import MODELS
    from anomod_torch.replay import KERNELS
    parser = argparse.ArgumentParser(prog="python -m anomod_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("replay", help="measure span replay throughput")
    p.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    p.add_argument("--traces", type=int, default=2000)
    p.add_argument("--replicate", type=int, default=1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--kernel", choices=KERNELS, default="cuda")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.add_argument("--percentiles", action="store_true",
                   help="also report corpus-wide p50/p95/p99 from the "
                        "per-segment t-digest plane, built by the "
                        "tdigest_reduce kernel on the card "
                        "(ANOMOD_TDIGEST_ENGINE: auto or pallas there; "
                        "host and xla name JAX formulations and are "
                        "refused on the card; on the CPU every value "
                        "runs the plain version)")
    p.add_argument("--edge-percentiles", action="store_true",
                   help="also report the slowest call-graph edges by p99 "
                        "from the per-edge t-digest plane, with their HLL "
                        "distinct-trace counts")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the corpus over an N-device mesh (one rank "
                        "a device, an all_reduce merge) instead of the "
                        "single-device path; needs N attached cards, or "
                        "--device cpu for N gloo ranks.  --percentiles "
                        "still builds its digest plane in a separate "
                        "single-device pass")

    d = sub.add_parser("detect", help="run the z-score detector + RCA "
                       "ranking over a corpus")
    d.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    d.add_argument("--traces", type=int, default=100)
    d.add_argument("--from-data", action="store_true",
                   help="load from the data root (LFS stubs -> synth)")
    d.add_argument("--device", default=None,
                   help="cuda (default: the scores on the card) or cpu "
                        "(the numpy oracle)")

    g = sub.add_parser("rca", help="train a GNN RCA model on chaos labels")
    g.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    g.add_argument("--model", choices=sorted(MODELS), default="gcn")
    g.add_argument("--epochs", type=int, default=300)
    g.add_argument("--train-seeds", type=int, default=6)
    g.add_argument("--eval-seeds", type=int, default=2)
    g.add_argument("--checkpoint-dir", default=None,
                   help="persist params / optimizer state every 50 epochs")
    g.add_argument("--resume", action="store_true",
                   help="continue from the epoch saved in --checkpoint-dir")
    g.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    g.add_argument("--cpu-failover", action="store_true",
                   help="if the card is lost mid-train, rerun once on the "
                        "CPU (from this run's last checkpoint, else from "
                        "scratch) and add device_failover to the JSON")

    s = sub.add_parser("stream", help="online detection: replay an "
                       "experiment's spans in arrival order")
    s.add_argument("experiment", nargs="?", default=None)
    s.add_argument("--all", action="store_true",
                   help="every experiment of --testbed")
    s.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    s.add_argument("--traces", type=int, default=400)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--multimodal", action="store_true",
                   help="fuse the log/metric/api planes with the span "
                        "stream")
    s.add_argument("--severity", type=float, default=1.0,
                   help="de-saturate the fault effects (synth.HardMode)")
    s.add_argument("--noise", type=float, default=0.0,
                   help="widen baseline distributions (HardMode)")
    s.add_argument("--confounders", type=int, default=0,
                   help="decoy services per fault experiment")
    s.add_argument("--shift", default="in-dist", choices=list(SHIFTS),
                   help="--all only: evaluate under a shifted generator "
                        "(quality.SHIFTS axes)")
    s.add_argument("--slice-seconds", type=float, default=60.0,
                   help="micro-batch width of the simulated feed")
    s.add_argument("--threshold", type=float, default=4.0,
                   help="z-score alert threshold")
    s.add_argument("--baseline-windows", type=int, default=8)
    s.add_argument("--consecutive", type=int, default=1,
                   help="windows above threshold before alerting")
    s.add_argument("--from-data", action="store_true",
                   help="single-experiment mode: replay the experiment "
                        "from the dataset tree (io.dataset loaders; LFS "
                        "stubs -> synth) instead of generating it")
    s.add_argument("--no-edge-attribution", action="store_true",
                   help="turn off the out-edge attribution plane (default "
                        "on)")
    s.add_argument("--devices", type=int, default=0,
                   help="shard the streaming replay plane (incl. the "
                        "edge-attribution id space) over an N-device mesh "
                        "(--device cpu: N gloo ranks)")
    s.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")

    q = sub.add_parser("quality", help="de-saturated quality sweep: "
                       "degradation curves over fault severity with noise "
                       "+ confounders (HardMode)")
    q.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    q.add_argument("--models", nargs="*", default=list(DEFAULT_MODELS))
    q.add_argument("--severities", nargs="*", type=float,
                   default=list(SEVERITIES))
    q.add_argument("--train-seeds", type=int, default=6)
    q.add_argument("--eval-seeds", type=int, default=3)
    q.add_argument("--traces", type=int, default=60)
    q.add_argument("--epochs", type=int, default=120)
    q.add_argument("--noise", type=float, default=0.5)
    q.add_argument("--confounders", type=int, default=2)
    q.add_argument("--sweep", choices=["severity", "shift"],
                   default="severity",
                   help="severity: degradation curves; shift: train on the "
                        "default effect model, eval under shifted "
                        "generators (effect shape / fault timing / locus)")
    q.add_argument("--shift-severity", type=float, default=0.3,
                   help="fixed fault severity for the shift sweep")
    q.add_argument("--edge-aware", action="store_true",
                   help="--sweep shift only: out-edge feature blocks + "
                        "node+edge mixed-locus training")
    q.add_argument("--json", action="store_true",
                   help="emit one JSON object per sweep point")
    q.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    q.add_argument("--cpu-failover", action="store_true",
                   help="if the card is lost mid-sweep, redo that learned "
                        "row and run the rest on the CPU, and label the "
                        "capture (device_failover)")

    r = sub.add_parser("roofline", help="the sorted replay kernel against "
                       "its count-only and no-histogram ablations")
    r.add_argument("--traces", type=int, default=2000)
    r.add_argument("--replicate", type=int, default=4096)
    r.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")

    v = sub.add_parser("serve", help="multi-tenant serving plane: "
                       "admission, fused lane dispatch, device state pool "
                       "and batched scoring over a seeded power-law fleet")
    v.add_argument("--tenants", type=int, default=200)
    v.add_argument("--services", type=int, default=8)
    v.add_argument("--duration", type=float, default=120.0,
                   help="virtual seconds to serve")
    v.add_argument("--tick", type=float, default=1.0,
                   help="virtual scheduler tick (seconds)")
    v.add_argument("--capacity", type=float, default=20_000.0,
                   help="serving capacity in spans/sec")
    v.add_argument("--overload", type=float, default=1.0,
                   help="offered load as a multiple of capacity")
    v.add_argument("--alpha", type=float, default=1.2,
                   help="power-law exponent of the tenant rates")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--window-seconds", type=float, default=5.0)
    v.add_argument("--baseline-windows", type=int, default=4)
    v.add_argument("--threshold", type=float, default=4.0)
    v.add_argument("--pipeline", type=int, default=None,
                   help="in-flight fused dispatches plus one (default: "
                        "ANOMOD_SERVE_PIPELINE, 2)")
    v.add_argument("--no-fuse", action="store_true",
                   help="one dispatch per tenant micro-batch")
    v.add_argument("--buckets", default=None,
                   help="comma-separated micro-batch bucket widths "
                        "(default: ANOMOD_SERVE_BUCKETS)")
    v.add_argument("--lane-buckets", default=None,
                   help="comma-separated fused-dispatch lane counts "
                        "(default: ANOMOD_SERVE_LANE_BUCKETS)")
    v.add_argument("--max-backlog", type=int, default=None,
                   help="global backlog bound in spans (default: "
                        "ANOMOD_SERVE_MAX_BACKLOG, 200000)")
    v.add_argument("--fault-tenants", type=int, default=2)
    v.add_argument("--state", choices=["auto", "host", "device"],
                   default=None,
                   help="tenant states in the device pool or on the host "
                        "(default: ANOMOD_SERVE_STATE, auto = device)")
    v.add_argument("--no-native", action="store_true",
                   help="the interpreter scratch fill instead of the C++ "
                        "one (byte-identical; default: ANOMOD_NATIVE)")
    v.add_argument("--native-drain", choices=["auto", "on", "off"],
                   default=None,
                   help="the admission drain: auto / on = the C++ "
                        "columnar engine, off = the Python heap loop (the "
                        "oracle; default: ANOMOD_SERVE_NATIVE_DRAIN)")
    v.add_argument("--perf", action="store_true",
                   help="the dispatch-lifecycle timeline and overlap "
                        "accounting (anomod_torch.obs.perf; default: "
                        "ANOMOD_PERF); decisions byte-identical either way")
    v.add_argument("--no-score", action="store_true",
                   help="fold only; no detectors")
    v.add_argument("--rca", action="store_true",
                   help="online root-cause inference in the serve tick "
                        "(default: ANOMOD_SERVE_RCA)")
    v.add_argument("--trace-out", default=None,
                   help="dump the engine's own Jaeger-shaped trace")
    v.add_argument("--shards", type=int, default=None,
                   help="engine worker threads, tenants partitioned "
                        "(default: ANOMOD_SERVE_SHARDS, 1)")
    v.add_argument("--fold", choices=["sparse", "dense"], default=None,
                   help="the shard barrier's registry merge (default: "
                        "ANOMOD_SERVE_FOLD, sparse)")
    v.add_argument("--worker", choices=["thread", "process"], default=None,
                   help="shard workers: thread = in-process threads (the "
                        "byte-parity oracle); process = one spawned "
                        "process a shard owning its detectors, states and "
                        "runner; every decision and the canonical journal "
                        "equal either way (default: ANOMOD_SERVE_WORKER)")
    v.add_argument("--chaos", default=None,
                   help="scripted serve-plane fault injection, e.g. "
                        "'crash@5:shard=1;stall@8:ms=20' (default: "
                        "ANOMOD_SERVE_CHAOS, empty = off)")
    v.add_argument("--ckpt-every", type=int, default=None,
                   help="shard-checkpoint cadence in ticks for supervised "
                        "no-score-gap recovery (default: "
                        "ANOMOD_SERVE_CKPT_EVERY, 32; 0 disables "
                        "supervision)")
    v.add_argument("--policy", choices=["off", "auto", "script"],
                   default=None,
                   help="elastic scaling policy: auto = the signal-fed "
                        "autoscaler at every tick end, script = the "
                        "--policy-script schedule; scaling is a function "
                        "of the seed and leaves states, alerts, SLO and "
                        "shed equal to a static run's (default: "
                        "ANOMOD_SERVE_POLICY)")
    v.add_argument("--policy-script", default=None,
                   help="scaling schedule for --policy script, e.g. "
                        "'up@10;rebalance@25:k=2;down@40' (default: "
                        "ANOMOD_SERVE_POLICY_SCRIPT)")
    v.add_argument("--min-shards", type=int, default=None,
                   help="elastic scale-down floor (default: "
                        "ANOMOD_SERVE_POLICY_MIN_SHARDS)")
    v.add_argument("--max-shards", type=int, default=None,
                   help="elastic scale-up ceiling; past it sustained "
                        "overload climbs the brownout ladder (default: "
                        "ANOMOD_SERVE_POLICY_MAX_SHARDS)")
    v.add_argument("--async-commit", action="store_true",
                   help="deferred-commit tick: issue the lane dispatches "
                        "without waiting, run the next tick's admission, "
                        "drain, shed and SLO while they run, commit at the "
                        "next barrier; decisions and the canonical "
                        "journal equal the synchronous tick's (default: "
                        "ANOMOD_SERVE_ASYNC_COMMIT)")
    v.add_argument("--no-async-commit", action="store_true",
                   help="force the synchronous tick even when "
                        "ANOMOD_SERVE_ASYNC_COMMIT is on")
    v.add_argument("--from-live", default=None, metavar="URL",
                   help="drive the tick from a live Prometheus "
                        "text-exposition endpoint instead of the seeded "
                        "fleet; 'self' serves this process's own registry "
                        "on /metrics and scrapes it (the dogfood loop)")
    v.add_argument("--live-replay", default=None, metavar="JOURNAL",
                   help="re-run a recorded live-feed wire journal through "
                        "the replay transport: the same planes, no "
                        "network; the feed's shape comes from the "
                        "journal's header (--tenants/--services are "
                        "ignored)")
    v.add_argument("--feed-lag", type=float, default=None,
                   help="live-feed wall-to-virtual lag budget in seconds "
                        "(default: ANOMOD_SERVE_FEED_LAG_S)")
    v.add_argument("--feed-journal", default=None,
                   help="record the live feed's wire journal to this path "
                        "(default: ANOMOD_FEED_JOURNAL)")
    v.add_argument("--devices", type=int, default=0,
                   help="serve over an N-device mesh plane (a "
                        "ShardedStreamReplay a tenant; --device cpu: N "
                        "gloo ranks)")
    v.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")

    c = sub.add_parser(
        "collect", help="live-transport collection: pull from a running "
        "Prometheus / Jaeger / SkyWalking / Elasticsearch endpoint and "
        "write loader-compatible artifacts (the exec kinds kube-logs, "
        "docker-logs, jacoco and gcov wait for the port of "
        "io/live_exec.py)")
    c.add_argument("kind", choices=["prometheus", "jaeger", "skywalking",
                                    "es"])
    c.add_argument("--url",
                   help="base URL (prometheus/jaeger/es) or the GraphQL "
                        "endpoint (skywalking)")
    c.add_argument("--out", required=True,
                   help="output dir (prometheus --testbed SN) or artifact "
                        "file path (the others)")
    c.add_argument("--testbed", choices=["SN", "TT"], default="SN",
                   help="prometheus only: SN = per-query CSV dir from the "
                        "SN catalog; TT = one long CSV from the TT catalog")
    c.add_argument("--hours-back", type=float, default=1.0)
    c.add_argument("--step", default="15s",
                   help="prometheus query_range step")
    c.add_argument("--limit", type=int, default=1000,
                   help="jaeger: traces per service; skywalking: total "
                        "trace budget; es: segment budget")
    c.add_argument("--experiment", default="live",
                   help="skywalking: experiment name stamped into the "
                        "artifact metadata")
    c.add_argument("--timeout", type=float, default=30.0)
    c.add_argument("--retries", type=int, default=3)

    a = sub.add_parser(
        "audit", help="flight-recorder forensics: `record` serves seeded "
        "traffic with the tick journal on and dumps it, `replay` "
        "re-executes a journal from its header (optionally at another "
        "shard count / pipeline depth / state residency), `diff` "
        "compares two journals tick by tick and names the first "
        "divergent tick and plane, exiting 1")
    a.add_argument("action", choices=["record", "replay", "diff"])
    a.add_argument("journals", nargs="*",
                   help="replay: the journal to re-execute; diff: the two "
                        "journals to compare")
    a.add_argument("--out", default=None,
                   help="record / replay: journal output path (required)")
    # record-only flags default to None so replay and diff can refuse
    # them; the record branch resolves the real defaults
    for flag, kind, default in (("--tenants", int, 24),
                                ("--services", int, 8),
                                ("--duration", float, 30.0),
                                ("--tick", float, 0.5),
                                ("--capacity", float, 4000.0),
                                ("--overload", float, 1.5),
                                ("--seed", int, 0),
                                ("--window-seconds", float, 5.0),
                                ("--baseline-windows", int, 2),
                                ("--threshold", float, 4.0),
                                ("--fault-tenants", int, 1)):
        a.add_argument(flag, type=kind, default=None,
                       help=f"record only (default {default})")
    a.add_argument("--rca", action="store_true",
                   help="record: journal the online-RCA verdict plane too")
    a.add_argument("--digest-every", type=int, default=None,
                   help="record / replay: tenant-state digest cadence in "
                        "ticks (default: ANOMOD_FLIGHT_DIGEST_EVERY)")
    a.add_argument("--shards", type=int, default=None,
                   help="record: engine shard count; replay: override the "
                        "recorded one")
    a.add_argument("--pipeline", type=int, default=None,
                   help="record: dispatch pipeline depth; replay: override")
    a.add_argument("--state", choices=["auto", "host", "device"],
                   default=None,
                   help="record: tenant-state residency; replay: override")
    a.add_argument("--device", default=None,
                   help="record / replay: cuda (default) or cpu")

    o = sub.add_parser(
        "obs", help="self-scraping telemetry plane: snapshot the metrics "
        "registry, export it (Prometheus text / TT metric CSV / the "
        "engine's span trace), or score a self-scrape capture through "
        "the detector")
    o.add_argument("action", choices=["snapshot", "export", "score"])
    o.add_argument("--from", dest="from_path", default=None,
                   help="score: TT-CSV self-scrape capture to load "
                        "(default: run the self-exercise and score its "
                        "own telemetry)")
    o.add_argument("--out", default=None,
                   help="export: output file path (required)")
    o.add_argument("--format", choices=["json", "prom", "tt-csv", "chrome",
                                        "jaeger"], default=None,
                   help="snapshot: json (default) or prom; export: tt-csv "
                        "(default), prom, or the self-exercise engine's "
                        "span trace as chrome or jaeger")
    o.add_argument("--serve-seconds", type=float, default=20.0,
                   help="virtual seconds of the seeded self-exercise "
                        "serve run that fills the registry")
    o.add_argument("--tenants", type=int, default=24)
    o.add_argument("--capacity", type=float, default=4000.0,
                   help="self-exercise serving capacity (spans/sec)")
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--window-seconds", type=float, default=5.0,
                   help="score: detector window width")
    o.add_argument("--baseline-windows", type=int, default=4)
    o.add_argument("--threshold", type=float, default=4.0)
    o.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")

    pf = sub.add_parser(
        "perf", help="the perf observatory (anomod_torch.obs.perf): "
        "`record` serves seeded traffic with the dispatch-lifecycle "
        "timeline on and dumps it with its overlap analysis (--chrome adds "
        "a Chrome / Perfetto trace, one lane a shard and scratch slot); "
        "`diff` compares two captures, decisions byte-exact and walls by "
        "bootstrap CIs of their raw_wall_s samples against the noise "
        "floor, exiting 2 on a decision drift or coverage gap and 1 on a "
        "significant wall regression; `history` indexes a runs directory")
    pf.add_argument("action", choices=["record", "diff", "history"])
    pf.add_argument("paths", nargs="*",
                    help="diff: the two capture JSONs (A then B); history: "
                         "the runs directory (default bench_runs/)")
    pf.add_argument("--out", default=None,
                    help="record: timeline JSON output path (required)")
    pf.add_argument("--chrome", default=None,
                    help="record: also dump the timeline as a Chrome "
                         "trace-event array")
    pf.add_argument("--tenants", type=int, default=24)
    pf.add_argument("--duration", type=float, default=30.0,
                    help="record: virtual seconds to serve")
    pf.add_argument("--tick", type=float, default=0.5)
    pf.add_argument("--capacity", type=float, default=4000.0)
    pf.add_argument("--overload", type=float, default=1.5)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--shards", type=int, default=None,
                    help="record: shard count (default: ANOMOD_SERVE_SHARDS)")
    pf.add_argument("--pipeline", type=int, default=None,
                    help="record: pipeline depth (default: "
                         "ANOMOD_SERVE_PIPELINE)")
    pf.add_argument("--noise-floor", type=float, default=None,
                    help="diff: the noise fraction the wall-ratio CIs must "
                         "clear (default: ANOMOD_PERF_NOISE_FLOOR, 0.35)")
    pf.add_argument("--device", default=None,
                    help="record: cuda (default) or cpu")

    ce = sub.add_parser(
        "census", help="the fleet census (anomod_torch.obs.census): "
        "`record` serves seeded traffic with the resident-bytes and "
        "hot-set census on and dumps its timeline; `probe` sweeps "
        "registered-fleet sizes at fixed hot traffic and fits the tick "
        "wall and resident bytes against them; `diff` compares two "
        "captures' census blocks, bytes exactly and the wall slope within "
        "the noise tolerance, exiting nonzero on a regression")
    ce.add_argument("action", choices=["record", "probe", "diff"])
    ce.add_argument("paths", nargs="*",
                    help="diff: the two capture JSONs (A then B)")
    ce.add_argument("--out", default=None,
                    help="record: census-timeline JSON output path "
                         "(required); probe: optional sweep output path")
    # the shape flags default to None so the other actions can refuse
    # them: a silently ignored flag parameterizes nothing
    for flag, kind, hlp in (
            ("--tenants", int, "record only (default 24)"),
            ("--duration", float, "record: virtual seconds (default 30)"),
            ("--tick", float, "record only (default 0.5)"),
            ("--capacity", float, "record only (default 4000)"),
            ("--overload", float, "record only (default 1.5)"),
            ("--seed", int, "record / probe (default 0)"),
            ("--shards", int, "record: shard count (default: "
                              "ANOMOD_SERVE_SHARDS)"),
            ("--every", int, "record: census cadence in ticks (default: "
                             "ANOMOD_CENSUS_EVERY)"),
            ("--hot", int, "probe: hot-traffic tenant count (default 1000)"),
            ("--ticks", int, "probe: measured ticks a size (default 8)"),
            ("--tolerance", float, "diff: the wall-slope noise tolerance "
                                   "(default: ANOMOD_PERF_NOISE_FLOOR)")):
        ce.add_argument(flag, type=kind, default=None, help=hlp)
    ce.add_argument("--sizes", default=None,
                    help="probe: comma-separated registered-fleet sizes "
                         "(default: ANOMOD_CENSUS_SWEEP)")
    ce.add_argument("--device", default=None,
                    help="record / probe: cuda (default) or cpu")

    ls = sub.add_parser("list", help="list experiments + fault labels")
    ls.add_argument("--testbed", choices=["SN", "TT"], default=None)

    sy = sub.add_parser("synth",
                        help="generate a synthetic experiment summary")
    sy.add_argument("experiment")
    sy.add_argument("--traces", type=int, default=100)

    ig = sub.add_parser(
        "ingest", help="ingest-cache management (anomod_torch.io.cache): "
        "warm the corpus cache, report its state, or clear it")
    ig.add_argument("--warm-cache", action="store_true",
                    help="load the full corpus (and the replay bench "
                         "corpus) through the cache so later runs are warm")
    ig.add_argument("--testbed", choices=["SN", "TT", "both"], default="TT")
    ig.add_argument("--traces", type=int, default=200,
                    help="n_synth_traces for the corpus loaders")
    ig.add_argument("--bench-traces", type=int, default=2_000,
                    help="n_traces of the replay bench corpus to warm (0 "
                         "skips it)")
    ig.add_argument("--workers", type=int, default=None,
                    help="process-pool size for the corpus load (default: "
                         "ANOMOD_INGEST_WORKERS)")
    ig.add_argument("--cache-dir", default=None,
                    help="override ANOMOD_CACHE_DIR for this invocation")
    ig.add_argument("--data-root", default=None,
                    help="override ANOMOD_DATA_ROOT for this invocation")
    ig.add_argument("--clear", action="store_true",
                    help="delete every cache entry first")

    lg = sub.add_parser("logscan", help="per-file log summary sweep over a "
                        "directory (the Python scanner)")
    lg.add_argument("dir")
    lg.add_argument("--glob", default="**/*.log")

    p_chaos = sub.add_parser(
        "chaos", help="render the fault-injection plan for an experiment "
        "(Chaos Mesh CRD YAML / ChaosBlade argv / docker argv)")
    p_chaos.add_argument("experiment")
    p_chaos.add_argument("--format", choices=["yaml", "json"], default="yaml")

    p_scen = sub.add_parser(
        "scenario", help="drive the TT user-journey workload against the "
        "synthetic SUT (optionally under an injected fault)")
    p_scen.add_argument("--iterations", type=int, default=1)
    p_scen.add_argument("--seed", type=int, default=0)
    p_scen.add_argument("--chaos", default=None,
                        help="experiment name to inject during the run")

    p_deploy = sub.add_parser(
        "deploy", help="render the deployment plan (helm/kubectl action "
        "list for TT, compose lifecycle for SN)")
    p_deploy.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    # the deploy.sh argument surface, as real flags
    p_deploy.add_argument("--all", action="store_true", dest="deploy_all")
    p_deploy.add_argument("--independent-db", action="store_true")
    p_deploy.add_argument("--with-monitoring", action="store_true")
    p_deploy.add_argument("--with-tracing", action="store_true")
    p_deploy.add_argument("--down", action="store_true",
                          help="SN only: render the teardown instead")
    p_deploy.add_argument("--secrets", action="store_true",
                          help="TT only: print the 27 per-service DB secrets")

    p_mon = sub.add_parser(
        "monitor", help="SN API-response monitor over the synthetic SUT "
        "(active: 12 wrk2-api endpoints; passive: GET-only fallback)")
    p_mon.add_argument("--mode", choices=["active", "passive"],
                       default="active")
    p_mon.add_argument("--cycles", type=int, default=10)
    p_mon.add_argument("--seed", type=int, default=0)
    p_mon.add_argument("--chaos", default=None,
                       help="experiment name to inject during the capture")
    p_mon.add_argument("--out", default=None,
                       help="materialize the api_responses artifact family")
    p_mon.add_argument("--wrk2-requests", type=int, default=0,
                       help="interleave N wrk2 mixed-workload requests "
                            "(full compose content model) with the capture")
    return parser


def _serve(args, parser) -> int:
    from anomod_torch.serve.config import (validate_lane_buckets,
                                           validate_serve_buckets)
    for flag, val in (("--tenants", args.tenants),
                      ("--services", args.services)):
        if val < 1:
            parser.error(f"{flag} must be >= 1")
    for flag, val in (("--capacity", args.capacity), ("--tick", args.tick),
                      ("--window-seconds", args.window_seconds),
                      ("--overload", args.overload)):
        if val <= 0:
            parser.error(f"{flag} must be positive")
    if args.fault_tenants < 0:
        parser.error("--fault-tenants must be >= 0")
    if args.pipeline is not None and args.pipeline < 1:
        parser.error("--pipeline must be >= 1")
    if args.shards is not None and not 1 <= args.shards <= 256:
        parser.error("--shards must be in [1, 256]")
    if args.rca and args.no_score:
        parser.error("--rca consumes the detectors' alert stream; "
                     "it cannot combine with --no-score")
    if args.ckpt_every is not None and args.ckpt_every < 0:
        parser.error("--ckpt-every must be >= 0 (0 = supervision off)")
    _check_devices(args, parser)
    if args.devices and args.ckpt_every:
        parser.error("shard supervision cannot checkpoint the mesh "
                     "plane's sharded state; --devices runs with "
                     "--ckpt-every 0")
    from anomod_torch.config import get_config
    policy_mode = (args.policy if args.policy is not None
                   else get_config().serve_policy)
    if args.policy_script is not None:
        from anomod_torch.config import validate_policy_script
        try:
            validate_policy_script(args.policy_script)
        except ValueError as e:
            parser.error(f"--policy-script: {e}")
        if policy_mode != "script":
            parser.error("--policy-script applies to --policy script (it "
                         "would be silently ignored)")
    for flag, val in (("--min-shards", args.min_shards),
                      ("--max-shards", args.max_shards)):
        if val is not None:
            if policy_mode == "off":
                parser.error(f"{flag} applies to an elastic policy "
                             "(--policy auto|script)")
            if val < 1:
                parser.error(f"{flag} must be >= 1")
    if args.devices and args.policy is not None and args.policy != "off":
        # an env-sourced policy is off at the engine beside the mesh
        parser.error("the elastic policy migrates tenants through the "
                     "bucket-runner state seams; --devices runs with "
                     "--policy off")
    if args.async_commit and args.no_async_commit:
        parser.error("--async-commit contradicts --no-async-commit")
    if args.devices and args.async_commit:
        parser.error("the deferred-commit tick splits the bucket-runner "
                     "issue/commit seam; --devices runs with the "
                     "synchronous tick (drop --async-commit)")
    if args.devices and args.worker == "process":
        parser.error("the mesh plane shards across devices inside one "
                     "process; --devices runs with the thread worker "
                     "engine (drop --worker process)")
    if args.devices and args.shards is not None and args.shards > 1:
        parser.error("the mesh plane manages its own sharded dispatch; "
                     "run it with shards=1 (ANOMOD_SERVE_SHARDS=1)")
    if args.devices and args.state == "device":
        parser.error("the mesh plane manages its own sharded state; a "
                     "device state pool cannot apply "
                     "(ANOMOD_SERVE_STATE=host or auto)")
    if args.chaos:
        from anomod_torch.config import validate_chaos_script
        try:
            faults = validate_chaos_script(args.chaos)
        except ValueError as e:
            parser.error(f"--chaos: {e}")
        n_sh = (args.shards if args.shards is not None
                else get_config().serve_shards)
        if policy_mode != "off":
            # an elastic run may target any shard id its ceiling reaches
            n_sh = max(n_sh, args.max_shards if args.max_shards is not None
                       else get_config().serve_policy_max_shards)
        bad = sorted({f["shard"] for f in faults
                      if f["kind"] != "surge" and f["shard"] >= n_sh})
        if bad:
            parser.error(
                f"--chaos targets shard(s) {bad} but the run has "
                f"{n_sh} reachable shard(s) (ids 0..{n_sh - 1}) — "
                "the fault(s) could never fire")
    try:
        buckets = (None if args.buckets is None else validate_serve_buckets(
            p for p in args.buckets.split(",") if p.strip()))
        lanes = (None if args.lane_buckets is None else validate_lane_buckets(
            p for p in args.lane_buckets.split(",") if p.strip()))
    except ValueError as e:
        parser.error(str(e))
    if args.from_live or args.live_replay:
        return _serve_live(args, parser, buckets, lanes)
    _probe_backend(args)
    kw = dict(
        n_tenants=args.tenants, n_services=args.services,
        capacity_spans_per_s=args.capacity, overload=args.overload,
        duration_s=args.duration, tick_s=args.tick, seed=args.seed,
        alpha=args.alpha, window_s=args.window_seconds,
        baseline_windows=args.baseline_windows,
        z_threshold=args.threshold, buckets=buckets,
        max_backlog=args.max_backlog,
        fault_tenants=args.fault_tenants, score=not args.no_score,
        fuse=False if args.no_fuse else None, lane_buckets=lanes,
        pipeline=args.pipeline, device=args.device,
        # ``auto`` is the device pool, or beside the mesh the host seam
        state=("device" if args.state == "auto" and not args.devices
               else args.state),
        native_stage=False if args.no_native else None,
        native_drain=args.native_drain,
        perf=True if args.perf else None,
        # --no-score forces RCA off even under ANOMOD_SERVE_RCA=1
        rca=True if args.rca else (False if args.no_score else None),
        shards=args.shards, fold=args.fold,
        worker=args.worker, chaos=args.chaos,
        ckpt_every=args.ckpt_every, policy=args.policy,
        policy_script=args.policy_script, min_shards=args.min_shards,
        max_shards=args.max_shards,
        async_commit=(True if args.async_commit
                      else (False if args.no_async_commit else None)))
    if args.devices:
        from anomod_torch.parallel import launch
        report = launch(_serve_rank, args.devices, device=args.device,
                        args=(kw, args.devices, args.trace_out))[0]
    else:
        report = _serve_rank(kw, 0, args.trace_out)
    print(json.dumps(report))
    return 0


def _serve_rank(kw: dict, devices: int, trace_out: Optional[str]) -> dict:
    """One serve run (a rank's, over a ``devices`` mesh, when
    ``devices``): the report as a dict.  The endpoint and the trace dump
    ride rank 0."""
    from anomod_torch.obs.http import maybe_serve
    from anomod_torch.serve.engine import run_power_law
    from anomod_torch.utils.tracing import Tracer
    mesh = None
    if devices:
        from anomod_torch.parallel import make_mesh
        mesh = make_mesh(devices, device=kw["device"])
    lead = mesh is None or mesh.rank == 0
    tracer = Tracer("anomod-serve") if trace_out else None
    # the endpoint rides the run when ANOMOD_OBS_HTTP is on: pure
    # registry reads, decisions byte-identical either way
    endpoint = maybe_serve() if lead else None
    try:
        _, report = run_power_law(tracer=tracer, mesh=mesh, **kw)
    finally:
        if endpoint is not None:
            endpoint.stop()
    if tracer is not None and lead:
        tracer.dump(trace_out)
    return report.to_dict()


def _serve_live(args, parser, buckets, lanes) -> int:
    """``serve --from-live`` / ``--live-replay``: the live feed's run
    (``run_live_feed``), with the JAX CLI's checks."""
    if args.from_live and args.live_replay:
        parser.error("--from-live contradicts --live-replay")
    for flag, bad in (("--devices", args.devices),
                      ("--chaos", args.chaos), ("--rca", args.rca),
                      ("--policy", args.policy),
                      ("--policy-script", args.policy_script),
                      ("--async-commit", args.async_commit),
                      ("--worker", args.worker), ("--fold", args.fold),
                      ("--state", args.state),
                      ("--ckpt-every", args.ckpt_every),
                      ("--trace-out", args.trace_out),
                      ("--perf", args.perf),
                      ("--no-native", args.no_native),
                      ("--native-drain", args.native_drain)):
        if bad:
            parser.error(f"{flag} is not supported on the live-feed path")
    from anomod_torch.serve.feed import run_live_feed
    endpoint = None
    scrape_url = args.from_live
    if scrape_url and scrape_url.strip().lower() == "self":
        # the dogfood loop: serve this process's own registry over real
        # HTTP and point the feed at it
        from anomod_torch.config import get_config
        from anomod_torch.obs.http import ObsHttpServer
        endpoint = ObsHttpServer(port=get_config().obs_http_port).start()
        scrape_url = f"{endpoint.url}/metrics"
    elif scrape_url and "://" not in scrape_url:
        parser.error("--from-live takes a URL (or 'self')")
    common = dict(capacity_spans_per_s=args.capacity,
                  duration_s=args.duration, tick_s=args.tick,
                  lag_s=args.feed_lag, window_s=args.window_seconds,
                  baseline_windows=args.baseline_windows,
                  z_threshold=args.threshold, buckets=buckets,
                  lane_buckets=lanes, max_backlog=args.max_backlog,
                  score=not args.no_score,
                  fuse=False if args.no_fuse else None,
                  shards=args.shards, pipeline=args.pipeline,
                  device=args.device)
    try:
        _probe_backend(args)
        if args.live_replay:
            _, report, _ = run_live_feed(replay=args.live_replay, **common)
        else:
            _, report, _ = run_live_feed(
                scrape_url=scrape_url, n_tenants=args.tenants,
                n_services=args.services, journal=args.feed_journal,
                **common)
    finally:
        if endpoint is not None:
            endpoint.stop()
    print(json.dumps(report.to_dict()))
    return 0


#: ``audit record``'s run shape: flag, run_power_law argument, default
_AUDIT_RECORD = (("--tenants", "n_tenants", 24),
                 ("--services", "n_services", 8),
                 ("--duration", "duration_s", 30.0),
                 ("--tick", "tick_s", 0.5),
                 ("--capacity", "capacity_spans_per_s", 4000.0),
                 ("--overload", "overload", 1.5),
                 ("--seed", "seed", 0),
                 ("--window-seconds", "window_s", 5.0),
                 ("--baseline-windows", "baseline_windows", 2),
                 ("--threshold", "z_threshold", 4.0),
                 ("--fault-tenants", "fault_tenants", 1))


def _audit(args, parser) -> int:
    from anomod_torch.obs.flight import diff_journals, load_journal
    given = {flag: getattr(args, flag[2:].replace("-", "_"))
             for flag, _, _ in _AUDIT_RECORD}
    if args.action != "record":
        # replay takes its run from the journal header: a record flag
        # there would draw conclusions from a run nobody asked for
        for flag, got in list(given.items()) + [("--rca",
                                                 args.rca or None)]:
            if got is not None:
                parser.error(
                    f"{flag} applies to audit record; {args.action} takes "
                    "its run from the journal header"
                    + (" (--shards/--pipeline/--state/--digest-every "
                       "override)" if args.action == "replay" else ""))
    if args.action == "diff":
        for flag, val in (("--shards", args.shards),
                          ("--pipeline", args.pipeline),
                          ("--state", args.state),
                          ("--digest-every", args.digest_every),
                          ("--device", args.device),
                          ("--out", args.out)):
            if val is not None:
                parser.error(f"{flag} applies to audit record/replay")
        if len(args.journals) != 2:
            parser.error("audit diff takes exactly two journal paths")
        a = load_journal(args.journals[0])
        b = load_journal(args.journals[1])
        d = diff_journals(a, b)
        out = {"action": "diff", "a": args.journals[0],
               "b": args.journals[1], "ticks_a": len(a["ticks"]),
               "ticks_b": len(b["ticks"]), "identical": d is None}
        if d is not None:
            out["divergence"] = d
        print(json.dumps(out, indent=2))
        if d is not None:
            print(f"audit diff: first divergence at tick {d['tick']} in "
                  f"the {d['plane']} plane", file=sys.stderr)
            return 1
        return 0
    if not args.out:
        parser.error(f"audit {args.action} needs --out")
    if args.action == "record":
        if args.journals:
            parser.error("audit record takes no journal arguments")
        kw = {name: default if given[flag] is None else given[flag]
              for flag, name, default in _AUDIT_RECORD}
        kw.update(shards=args.shards, pipeline=args.pipeline,
                  state="device" if args.state == "auto" else args.state,
                  rca=True if args.rca else None)
    else:
        if len(args.journals) != 1:
            parser.error("audit replay takes exactly one journal path")
        run = load_journal(args.journals[0]).get("header", {}).get("run")
        if not run:
            parser.error("journal header carries no run parameters (not "
                         "recorded through `audit record` / run_power_law)"
                         ": cannot replay")
        kw = dict(run)
        for key in ("buckets", "lane_buckets"):
            kw[key] = tuple(kw[key]) if kw.get(key) else None
        if kw.get("traffic") != "live_feed":
            # a journal recorded before state tiering carries no tier
            # geometry: replay it untiered, never under this process's
            # env
            kw.setdefault("tier_hot", 0)
        elif args.state is not None:
            parser.error("--state applies to power-law journals; "
                         "live-feed replays take the engine shape from "
                         "the journal header")
        # the forensic overrides: the same decisions at another shard
        # count / depth / residency, which diff then holds equal
        for name, val in (("shards", args.shards),
                          ("pipeline", args.pipeline),
                          ("state", "device" if args.state == "auto"
                           else args.state)):
            if val is not None:
                kw[name] = val
    if args.digest_every is not None:
        kw["flight_digest_every"] = args.digest_every
    kw["flight"] = True
    _probe_backend(args)
    if kw.pop("traffic", None) == "live_feed":
        # a live-feed run replays through its wire journal (the response
        # sequence is the ground truth), not by polling again
        from pathlib import Path
        feed_journal = kw.pop("feed_journal", "")
        if not feed_journal or not Path(feed_journal).exists():
            parser.error(
                "the run's wire journal is missing "
                f"({feed_journal or 'not recorded'}) — record live runs "
                "with ANOMOD_FEED_JOURNAL/--feed-journal to make them "
                "replayable")
        from anomod_torch.serve.feed import run_live_feed
        eng, rep, _ = run_live_feed(replay=feed_journal, device=args.device,
                                    **kw)
    else:
        from anomod_torch.serve.engine import run_power_law
        eng, rep = run_power_law(device=args.device, **kw)
    doc = eng.flight_recorder.dump(args.out)
    print(json.dumps({
        "action": args.action, "out": args.out,
        "ticks": doc["n_recorded"], "dropped": doc["n_dropped"],
        "seed": doc["header"]["run"].get("seed"),
        "shards": doc["header"]["engine"]["shards"],
        "serve_state": doc["header"]["engine"]["serve_state"],
        "digest_every": doc["header"]["digest_every"],
        "device": doc["header"]["engine"]["device"],
        "served_spans": rep.served_spans, "n_alerts": rep.n_alerts}))
    return 0


def _obs(args, parser) -> int:
    if args.action == "export" and not args.out:
        parser.error("obs export needs --out")
    if args.action != "score" and args.from_path:
        parser.error("--from applies to obs score")
    if args.action == "snapshot" and args.format in ("tt-csv", "chrome",
                                                     "jaeger"):
        parser.error("snapshot prints point-in-time state; the time "
                     "series export is `obs export` (tt-csv), the "
                     "span trace is `obs export --format "
                     "chrome|jaeger`")
    if args.action == "export" and args.format == "json":
        parser.error("obs export writes prom, tt-csv, chrome or "
                     "jaeger; `obs snapshot` is the JSON view")
    if args.action == "score" and args.format in ("chrome", "jaeger"):
        parser.error("--format chrome/jaeger applies to obs export")
    _probe_backend(args)
    from anomod_torch.obs import export
    from anomod_torch.obs.selfscrape import score_self_scrape, self_exercise
    score_kw = dict(window_s=args.window_seconds,
                    baseline_windows=args.baseline_windows,
                    z_threshold=args.threshold, device=args.device)
    if args.action == "score" and args.from_path:
        print(json.dumps(score_self_scrape(args.from_path, **score_kw),
                         indent=2))
        return 0
    tracer = None
    if args.action == "export" and args.format in ("chrome", "jaeger"):
        # the span exporters dump the self-exercise engine's own trace
        from anomod_torch.utils.tracing import Tracer
        tracer = Tracer("anomod-serve")
    reg = self_exercise(duration_s=args.serve_seconds,
                        n_tenants=args.tenants,
                        capacity_spans_per_s=args.capacity, seed=args.seed,
                        tracer=tracer, device=args.device)
    if tracer is not None:
        if args.format == "chrome":
            tracer.dump_chrome(args.out)
        else:
            tracer.dump(args.out)
        print(json.dumps({"out": args.out, "format": args.format,
                          "spans": tracer.n_spans}))
        return 0
    if args.action == "snapshot":
        if args.format == "prom":
            print(export.to_prometheus_text(reg), end="")
        else:
            print(json.dumps({"n_journal_samples": reg.n_samples,
                              "metrics": reg.snapshot()}, indent=2))
        return 0
    if args.action == "export":
        if args.format == "prom":
            # a point-in-time view: count metrics, not journal samples
            n = export.export_prometheus_text(reg, args.out)
            print(json.dumps({"out": args.out, "format": "prom",
                              "metrics": n}))
        else:
            n = export.export_tt_csv(reg, args.out)
            print(json.dumps({"out": args.out, "format": "tt-csv",
                              "samples": n}))
        return 0
    # score the self-exercise's own telemetry, no file round trip
    print(json.dumps(score_self_scrape(export.to_metric_batch(reg),
                                       **score_kw), indent=2))
    return 0


def _check_devices(args, parser) -> None:
    """``--devices``: >= 0, and on the cards at most the attached count
    (the mesh's own refusal, before any rank starts)."""
    if args.devices < 0:
        parser.error("--devices must be >= 0")
    if args.devices:
        from anomod_torch.device import resolve_device
        from anomod_torch.parallel.mesh import (attached_devices,
                                                check_mesh_size)
        from anomod_torch.utils.platform import env_number
        # the probe comes before the card's count is read (resolve_device
        # joins it)
        _probe_backend(args)
        dev = resolve_device(args.device)
        # on the host under ANOMOD_PLATFORM=cpu, ANOMOD_CPU_DEVICES is the
        # count of attached devices (gloo ranks), as the JAX CPU mesh's
        attached = (attached_devices("cuda") if dev.type == "cuda"
                    else env_number("ANOMOD_CPU_DEVICES", 1)
                    if _platform_cpu() else None)
        if attached is not None:
            try:
                check_mesh_size(args.devices, attached)
            except ValueError as e:
                parser.error(str(e))


def _replay(args, parser) -> int:
    _check_devices(args, parser)
    if args.devices and args.replicate != 1:
        parser.error("--replicate is not supported with --devices")
    if args.devices and args.kernel == "numpy":
        parser.error("--kernel numpy is the single-chip host engine; "
                     "the sharded path needs a device kernel")
    if args.devices and args.kernel == "cuda-sorted":
        parser.error("--kernel cuda-sorted stages on the host for one "
                     "chip; the sharded path uses 'cuda' or 'matmul'")
    # a host-only run (numpy engine, no mesh, no digest plane) touches no
    # card: it pays no probe
    if args.kernel != "numpy" or args.devices or args.percentiles \
            or args.edge_percentiles:
        _probe_backend(args)
    if args.devices:
        from anomod_torch.parallel import launch
        out = launch(_replay_rank, args.devices, device=args.device,
                     args=(vars(args),))[0]
    else:
        out = _replay_rank(vars(args))
    print(json.dumps(out))
    return 0


def _replay_rank(a: dict) -> dict:
    """The replay's JSON document, from one device or (``devices``) one
    rank of the mesh; the digest planes in a single-device pass on rank
    0 only."""
    from anomod_torch.io.dataset import load_bench_corpus
    from anomod_torch.replay import ReplayConfig, measure_throughput
    args = argparse.Namespace(**a)
    batch = load_bench_corpus(args.testbed, args.traces)
    cfg = ReplayConfig(n_services=batch.n_services)
    device = args.device
    if args.devices:
        from anomod_torch.parallel import make_mesh, sharded_throughput
        mesh = make_mesh(args.devices, device=args.device)
        r = sharded_throughput(batch, mesh, cfg, repeats=args.repeats,
                               kernel=args.kernel)
        device = mesh.device
        if mesh.rank:
            return {}
    else:
        r = measure_throughput(batch, cfg, repeats=args.repeats,
                               replicate=args.replicate, kernel=args.kernel,
                               device=device)
    out = {
        "n_spans": r.n_spans, "wall_s": round(r.wall_s, 6),
        "spans_per_sec": round(r.spans_per_sec, 1),
        "compile_s": round(r.compile_s, 3), "kernel": r.kernel,
        "device": r.device}
    if args.devices:
        out["devices"] = int(mesh.devices.size)
    if args.percentiles:
        out["latency_us"] = corpus_latency_us(batch, cfg, device)
    if args.edge_percentiles:
        out["edge_p99_us_top"] = edge_p99_top(batch, cfg, device)
    return out


def corpus_latency_us(batch, cfg, device=None) -> dict:
    """Corpus-wide p50/p95/p99 in µs: the per-segment digest plane, built
    on ``device``, merged on the host (a weighted rebuild) into ONE corpus
    digest, so the tail is the corpus's, not a median across segments.
    Empty when the corpus has no spans."""
    import numpy as np

    from anomod_torch.ops.tdigest import tdigest_build, tdigest_quantile
    from anomod_torch.replay import replay_digests
    d = replay_digests(batch, cfg, device=device)
    if not float(d.weight.sum()) > 0:
        return {}
    corpus = tdigest_build(d.mean.reshape(-1), k=64,
                           weights=d.weight.reshape(-1))
    return {name: round(float(np.expm1(tdigest_quantile(corpus, q))), 1)
            for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))}


def edge_p99_top(batch, cfg, device=None, top: int = 5) -> list:
    """The ``top`` cross edges (caller != callee) by their worst window's
    p99, with their distinct-trace counts, from one
    ``replay_edge_features`` pass on ``device``."""
    import numpy as np

    from anomod_torch.replay import replay_edge_features
    pct, distinct, table = replay_edge_features(batch, cfg, device=device)
    p99 = np.nan_to_num(pct[:, -1].reshape(len(table), cfg.n_windows))
    worst = p99.max(axis=1)
    rows = sorted(((float(worst[i]), i, a, b)
                   for i, (a, b) in enumerate(table)
                   if a != b and worst[i] > 0), reverse=True)
    return [{"edge": f"{batch.services[a]}->{batch.services[b]}",
             "p99_us": round(v, 1),
             "distinct_traces": round(float(distinct[i]), 1)}
            for v, i, a, b in rows[:top]]


def _stream(args, parser) -> int:
    from anomod_torch import labels
    if bool(args.experiment) == bool(args.all):
        parser.error("give an experiment name OR --all")
    if args.all and args.from_data:
        parser.error("--from-data is single-experiment only; --all sweeps "
                     "the generator taxonomy")
    experiments = None
    testbed = args.testbed
    if args.experiment:
        label = labels.label_for(args.experiment)
        if label is None:
            parser.error(f"unknown experiment {args.experiment!r}")
        experiments, testbed = [label.experiment], label.testbed
    if args.confounders < 0:
        parser.error("--confounders must be >= 0")
    if args.shift != "in-dist" and not args.all:
        parser.error("--shift applies to --all; it would be silently "
                     "ignored in single-experiment mode")
    if args.from_data and (args.severity != 1.0 or args.noise != 0.0
                           or args.seed != 0 or args.confounders):
        parser.error("--severity/--noise/--seed/--confounders shape the "
                     "generator; with --from-data the archived experiment "
                     "is what it is")
    _check_devices(args, parser)
    _probe_backend(args)
    if args.devices:
        from anomod_torch.parallel import launch
        rows = launch(_stream_rank, args.devices, device=args.device,
                      args=(vars(args), testbed, experiments))[0]
    else:
        rows = _stream_rank(vars(args), testbed, experiments)
    for r in rows:
        print(json.dumps(r))
    summary = stream_summary(testbed, rows)
    print(json.dumps({"summary": summary}))
    if args.all:
        from anomod_torch.device import device_name, resolve_device
        from anomod_torch.provenance import capture_record, write_capture
        rec = capture_record(
            "stream_quality", float(len(rows)), "experiments",
            device=device_name(resolve_device(args.device)), testbed=testbed,
            params=dict(n_traces=args.traces, seed=args.seed,
                        multimodal=args.multimodal, severity=args.severity,
                        noise=args.noise, confounders=args.confounders,
                        shift=args.shift),
            summary=summary, rows=rows)
        path = write_capture(rec)
        if path:
            print(f"capture: {path}", file=sys.stderr)
    return 0


def _stream_rank(a: dict, testbed: str, experiments) -> list:
    """The stream's rows (alerts as dicts), from one device or
    (``devices``) one rank of the mesh, every rank's detector on the
    sharded plane."""
    from anomod_torch import labels
    from anomod_torch.stream import stream_quality
    args = argparse.Namespace(**a)
    kw = dict(slice_s=args.slice_seconds, z_threshold=args.threshold,
              baseline_windows=args.baseline_windows,
              consecutive=args.consecutive, device=args.device)
    if args.no_edge_attribution:
        kw["edge_attribution"] = False
    if args.devices:
        from anomod_torch.parallel import make_mesh
        kw["mesh"] = make_mesh(args.devices, device=args.device)
    if args.from_data:
        rows = [_stream_from_data(labels.label_for(args.experiment), args,
                                  kw)]
    else:
        rows = stream_quality(testbed, n_traces=args.traces, seed=args.seed,
                              experiments=experiments,
                              multimodal=args.multimodal,
                              severity=args.severity, noise=args.noise,
                              n_confounders=args.confounders,
                              shift=args.shift, **kw)
    for r in rows:
        r["alerts"] = [dataclasses.asdict(a) for a in r["alerts"]]
    return rows


def _stream_from_data(label, args, kw) -> dict:
    """``stream EXPERIMENT --from-data``: the experiment from the dataset
    tree (LFS stubs and missing modalities synthesized), its row in
    ``stream_quality``'s shape.  No detection latency: an archived
    experiment's fault timing is its own."""
    from anomod_torch.io import dataset
    from anomod_torch.stream import (stream_experiment,
                                     stream_experiment_multimodal)
    mods = (["traces", "metrics", "logs", "api"] if args.multimodal
            else ["traces"])
    exp = dataset.load_experiment(label.experiment, modalities=mods,
                                  n_synth_traces=args.traces)
    det = (stream_experiment_multimodal(exp, **kw) if args.multimodal
           else stream_experiment(exp.spans, **kw))
    ranked = det.ranked_services()
    row = dict(experiment=label.experiment, testbed=label.testbed,
               target_service=label.target_service,
               n_alerts=len(det.alerts), ranked=ranked,
               first_alert_window=det.first_alert_window(),
               alerts=list(det.alerts))
    if label.is_anomaly and label.target_service:
        row.update(top1_hit=bool(ranked)
                   and ranked[0] == label.target_service,
                   top3_hit=label.target_service in ranked[:3])
    return row


def stream_summary(testbed: str, rows: list) -> dict:
    """The ``stream --all`` summary: top-1 and top-3 hit rates over the
    labelled faults and their median detection latency in windows."""
    import statistics
    rca = [r for r in rows if "top1_hit" in r]
    lats = [r["detection_latency_windows"] for r in rca
            if r.get("detection_latency_windows") is not None]
    return {"testbed": testbed, "n_experiments": len(rows),
            "top1": sum(r["top1_hit"] for r in rca) / len(rca)
            if rca else None,
            "top3": sum(r["top3_hit"] for r in rca) / len(rca)
            if rca else None,
            "median_detection_latency_windows":
                statistics.median(lats) if lats else None}


def _detect(args) -> int:
    from anomod_torch import detect, labels, synth
    from anomod_torch.io import dataset
    _probe_backend(args)
    if args.from_data:
        corpus = dataset.load_corpus(args.testbed,
                                     n_synth_traces=args.traces)
    else:
        corpus = [synth.generate_experiment(l, n_traces=args.traces)
                  for l in labels.labels_for_testbed(args.testbed)]
    s = detect.evaluate_corpus(corpus, device=args.device)
    print(json.dumps({
        "testbed": args.testbed, "backend": args.device or "cuda",
        "top1": s.top1, "top3": s.top3, "top5": s.top5,
        "detection_accuracy": s.detection_accuracy,
        "n_rca_cases": s.n_rca_cases,
        "per_level": detect.per_level_breakdown(s),
        "per_experiment": {r.experiment: {
            "score": round(r.score, 4),
            "top3": r.ranked_services[:3],
            "target": r.target_service} for r in s.results},
    }, indent=2))
    return 0


def _rca(args, parser) -> int:
    from anomod_torch.rca import train_rca_resilient
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume requires --checkpoint-dir")
    _probe_backend(args)
    r, failover = train_rca_resilient(
        args.testbed, args.model,
        train_seeds=range(args.train_seeds),
        eval_seeds=range(100, 100 + args.eval_seeds),
        epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        failover=args.cpu_failover, device=args.device)
    if failover:
        print(f"[anomod_torch] {failover}", file=sys.stderr)
    out = {
        "testbed": args.testbed, "model": r.model_name,
        "top1": r.top1, "top3": r.top3,
        "detection_auc": r.detection_auc, "n_eval": r.n_eval}
    if failover:
        out["device_failover"] = failover
    print(json.dumps(out))
    return 0


def _quality(args, parser) -> int:
    from anomod_torch import quality
    from anomod_torch.device import device_name, resolve_device
    from anomod_torch.provenance import capture_record, write_capture
    from anomod_torch.quality import (SEVERITIES, TRAINING_FREE,
                                      render_markdown,
                                      render_shift_markdown, severity_sweep,
                                      shift_sweep)
    from anomod_torch.rca import MODELS
    unknown = [m for m in args.models
               if m not in TRAINING_FREE and m not in MODELS]
    if unknown:
        parser.error(f"unknown --models {unknown} (have: "
                     f"{', '.join(TRAINING_FREE + tuple(MODELS))})")
    # a flag of the other sweep kind must not be silently dropped (a
    # value other than the parser's default means the user passed it)
    if args.sweep == "shift" and args.severities != list(SEVERITIES):
        parser.error("--severities applies to --sweep severity; "
                     "use --shift-severity for the shift sweep")
    if args.sweep == "severity" and args.shift_severity != 0.3:
        parser.error("--shift-severity applies to --sweep shift")
    if args.sweep == "severity" and args.edge_aware:
        parser.error("--edge-aware applies to --sweep shift")
    _probe_backend(args)
    dev = resolve_device(args.device)
    common = dict(
        testbed=args.testbed, model_names=args.models,
        train_seeds=range(args.train_seeds),
        eval_seeds=range(100, 100 + args.eval_seeds),
        n_traces=args.traces, epochs=args.epochs, noise=args.noise,
        n_confounders=args.confounders, verbose=not args.json)
    if args.sweep == "shift":
        pts = shift_sweep(severity=args.shift_severity,
                          edge_aware=args.edge_aware, device=dev,
                          failover=args.cpu_failover, **common)
        render = render_shift_markdown
    else:
        pts = severity_sweep(severities=args.severities, device=dev,
                             failover=args.cpu_failover, **common)
        render = render_markdown
    # a sweep that lost its card and finished on the CPU is labeled so
    failover = ({"device_failover": quality.LAST_FAILOVER}
                if quality.LAST_FAILOVER else {})
    rec = capture_record(
        f"quality_{args.sweep}_sweep", float(len(pts)), "points",
        device=device_name(dev), testbed=args.testbed,
        models=list(args.models),
        params={**{k: (list(v) if isinstance(v, range) else v)
                   for k, v in common.items()
                   if k not in ("verbose", "testbed", "model_names")},
                **({"shift_severity": args.shift_severity,
                    "edge_aware": bool(args.edge_aware)}
                   if args.sweep == "shift"
                   else {"severities": args.severities})},
        points=[dataclasses.asdict(p) for p in pts], **failover)
    path = write_capture(rec)
    if args.json:
        # one QualityPoint a stdout line; the capture path to stderr
        for p in pts:
            print(json.dumps(dataclasses.asdict(p)))
        if path:
            print(f"capture: {path}", file=sys.stderr)
    else:
        print(render(pts))
        if path:
            print(f"\ncapture: {path}")
    return 0


def _collect(args, parser) -> int:
    import time

    from anomod_torch.io.live import (ElasticsearchClient, HttpTransport,
                                      JaegerClient, PrometheusClient,
                                      SkyWalkingClient)
    if not args.url:
        parser.error(f"--url is required for kind {args.kind}")
    tp = HttpTransport(timeout=args.timeout, max_retries=args.retries)
    now = time.time()
    start = now - args.hours_back * 3600.0
    if args.kind == "prometheus":
        client = PrometheusClient(args.url, transport=tp)
        if args.testbed == "SN":
            # catalog names double as identity queries against a stub or
            # relabeling proxy; a real deployment maps names to the
            # recorded PromQL (collect_metric.sh's query table)
            from anomod_torch.metrics_catalog import SN_METRIC_FILES
            rep = client.collect_sn({n: n for n in SN_METRIC_FILES},
                                    args.out, start, now, step=args.step)
        else:
            from anomod_torch.metrics_catalog import TT_ALL_QUERIES
            rep = client.collect_tt(TT_ALL_QUERIES, args.out, start, now,
                                    step=args.step)
    elif args.kind == "jaeger":
        rep = JaegerClient(args.url, transport=tp).collect_all(
            args.out, limit=args.limit,
            lookback_ms=int(args.hours_back * 3_600_000))
    elif args.kind == "skywalking":
        rep = SkyWalkingClient(args.url, transport=tp).collect(
            args.out, experiment=args.experiment, limit=args.limit,
            hours_back=args.hours_back)
    else:
        rep = ElasticsearchClient(args.url, transport=tp).collect(
            args.out, size=args.limit, hours_back=args.hours_back)
    print(json.dumps(rep.to_json()))
    return 0


def _roofline(args, parser) -> int:
    from anomod_torch.roofline import kernel_roofline
    if args.traces < 1 or args.replicate < 1:
        parser.error("--traces and --replicate must be >= 1")
    _probe_backend(args)
    print(json.dumps(kernel_roofline(n_traces=args.traces,
                                     replicate=args.replicate,
                                     device=args.device)))
    return 0


def _perf(args, parser) -> int:
    """``perf record | diff | history`` (the JAX CLI's flags, defaults,
    refusals and exit codes)."""
    from pathlib import Path
    if args.action == "history":
        if len(args.paths) > 1:
            parser.error("perf history takes at most one runs directory")
        for flag, val in (("--out", args.out), ("--chrome", args.chrome),
                          ("--noise-floor", args.noise_floor)):
            if val is not None:
                parser.error(f"{flag} applies to perf "
                             + ("diff" if flag == "--noise-floor"
                                else "record") + ", not history")
        from anomod_torch.obs.perf import capture_history
        rows = capture_history(args.paths[0] if args.paths
                               else "bench_runs")
        print(json.dumps({"check": "anomod_perf_history",
                          "n_captures": len(rows), "runs": rows},
                         indent=2))
        return 0
    if args.action == "diff":
        if len(args.paths) != 2:
            parser.error("perf diff takes exactly two capture paths "
                         "(A then B)")
        if args.out or args.chrome:
            parser.error("--out/--chrome apply to perf record")
        from anomod_torch.obs.perf import diff_captures
        try:
            a = json.loads(Path(args.paths[0]).read_text())
            b = json.loads(Path(args.paths[1]).read_text())
        except (OSError, ValueError) as e:
            parser.error(f"cannot load capture: {e}")
        doc = diff_captures(a, b, noise_floor=args.noise_floor)
        print(json.dumps(doc, indent=2))
        if doc["decision_mismatches"]:
            m = doc["decision_mismatches"][0]
            print(f"perf diff: decision drift at {m['path']} "
                  f"(a={m['a']!r}, b={m['b']!r}): decision metrics are "
                  "byte-exact across same-seed captures; this is not "
                  "noise", file=sys.stderr)
            return 2
        if doc["status"] == "decision-coverage-gap":
            print("perf diff: the two captures share no decision metric, "
                  "so nothing was compared byte-exact", file=sys.stderr)
            return 2
        if doc["regressions"]:
            r = doc["regressions"][0]
            print(f"perf diff: significant wall regression at {r['path']}"
                  f": B/A mean ratio {r['ratio']} (95% CI {r['ci95']}) "
                  f"clears the 1+{doc['noise_model']['floor_fraction']} "
                  "noise floor", file=sys.stderr)
            return 1
        return 0
    if not args.out:
        parser.error("perf record needs --out")
    if args.paths:
        parser.error("perf record takes no positional paths")
    if args.noise_floor is not None:
        parser.error("--noise-floor applies to perf diff")
    _probe_backend(args)
    from anomod_torch.obs.flight import _atomic_write_json
    from anomod_torch.obs.perf import (PERF_FORMAT, analyze_events,
                                       perf_tracer, round_events)
    from anomod_torch.serve.engine import run_power_law
    eng, rep = run_power_law(
        n_tenants=args.tenants, n_services=8,
        capacity_spans_per_s=args.capacity, overload=args.overload,
        duration_s=args.duration, tick_s=args.tick, seed=args.seed,
        shards=args.shards, pipeline=args.pipeline, perf=True,
        device=args.device)
    stats = analyze_events(eng.perf_events, eng.pipeline)
    _atomic_write_json(args.out, {
        "perf_format": PERF_FORMAT,
        "engine": {"shards": rep.shards, "pipeline": rep.pipeline,
                   "seed": args.seed, "tick_s": args.tick,
                   "device": rep.device},
        "report": {
            "perf_events_recorded": rep.perf_events_recorded,
            "events_dropped": eng.perf_events_dropped,
            "overlap_headroom_s": rep.overlap_headroom_s,
            "fold_wait_s": rep.fold_wait_s,
            "bubble_fractions": rep.bubble_fractions,
            "stage_wall_s": rep.stage_wall_s,
            "dispatch_wall_s": rep.dispatch_wall_s,
            "fold_wall_s": rep.fold_wall_s,
            "score_wall_s": rep.score_wall_s,
            "serve_wall_s": rep.serve_wall_s},
        "raw_wall_s": [round(t, 6) for t in eng.tick_walls],
        "events": round_events(eng.perf_events)})
    out = {"action": "record", "out": args.out,
           "events": rep.perf_events_recorded,
           "overlap_headroom_s": rep.overlap_headroom_s,
           "fold_wait_s": rep.fold_wait_s,
           "fold_wall_s": rep.fold_wall_s,
           "headroom_of_fold": rep.bubble_fractions.get("headroom_of_fold"),
           "analysis": {k: round(v, 6) if isinstance(v, float) else v
                        for k, v in stats.items()}}
    if args.chrome:
        tr = perf_tracer(eng.perf_events)
        tr.dump_chrome(Path(args.chrome))
        out["chrome"] = {"out": args.chrome, "spans": tr.n_spans}
    print(json.dumps(out, indent=2))
    return 0


def _census(args, parser) -> int:
    """``census record | probe | diff`` (the JAX CLI's flags, defaults,
    refusals and exit codes)."""
    from pathlib import Path
    record_only = (("--tenants", args.tenants), ("--duration", args.duration),
                   ("--tick", args.tick), ("--capacity", args.capacity),
                   ("--overload", args.overload), ("--shards", args.shards),
                   ("--every", args.every))
    probe_only = (("--sizes", args.sizes), ("--hot", args.hot),
                  ("--ticks", args.ticks))
    if args.action != "record":
        for flag, got in record_only:
            if got is not None:
                parser.error(f"{flag} applies to census record, "
                             f"not {args.action}")
    if args.action != "probe":
        for flag, got in probe_only:
            if got is not None:
                parser.error(f"{flag} applies to census probe, "
                             f"not {args.action}")
    if args.action == "diff":
        if len(args.paths) != 2:
            parser.error("census diff takes exactly two capture paths "
                         "(A then B)")
        for flag, val in (("--out", args.out), ("--seed", args.seed),
                          ("--device", args.device)):
            if val is not None:
                parser.error(f"{flag} applies to census record/probe")
        from anomod_torch.obs.census import diff_census
        try:
            a = json.loads(Path(args.paths[0]).read_text())
            b = json.loads(Path(args.paths[1]).read_text())
        except (OSError, ValueError) as e:
            parser.error(f"cannot load capture: {e}")
        doc = diff_census(a, b, tolerance=args.tolerance)
        print(json.dumps(doc, indent=2))
        if doc["status"] == "census-missing":
            print("census diff: capture(s) carry no census block (missing "
                  f"in {doc['missing_in']}), so nothing was compared",
                  file=sys.stderr)
            return 2
        if doc["status"] == "bytes-regression":
            r = doc["bytes_regressions"][0]
            print(f"census diff: resident bytes grew on the {r['plane']!r} "
                  f"plane ({r['a']} -> {r['b']}); byte counts are "
                  "deterministic, so this is real growth", file=sys.stderr)
            return 1
        if doc["status"] == "slope-regression":
            r = doc["slope_regressions"][0]
            if r["exact"]:
                print(f"census diff: the {r['slope']} baseline grew "
                      f"(a={r['a']}, b={r['b']}); this slope is "
                      "deterministic", file=sys.stderr)
            else:
                print(f"census diff: the {r['slope']} baseline regressed "
                      f"(a={r['a']}, b={r['b']}) past the "
                      f"1+{doc['tolerance']} noise tolerance",
                      file=sys.stderr)
            return 1
        return 0
    if args.tolerance is not None:
        parser.error("--tolerance applies to census diff")
    if args.paths:
        parser.error(f"census {args.action} takes no positional paths")
    from anomod_torch.obs.census import CENSUS_FORMAT
    from anomod_torch.obs.flight import _atomic_write_json
    seed = 0 if args.seed is None else args.seed
    if args.action == "probe":
        sizes = None
        if args.sizes is not None:
            try:
                sizes = tuple(int(p.strip()) for p in args.sizes.split(",")
                              if p.strip())
                if len(sizes) < 2 or any(x < 1 for x in sizes) \
                        or any(a >= b for a, b in zip(sizes, sizes[1:])):
                    raise ValueError("need >= 2 strictly ascending positive "
                                     "sizes")
            except ValueError as e:
                parser.error(f"--sizes: {e}")
        if args.ticks is not None and args.ticks < 1:
            parser.error("--ticks must be >= 1")
        if args.hot is not None and args.hot < 1:
            parser.error("--hot must be >= 1")
        _probe_backend(args)
        from anomod_torch.obs.census import fleet_probe
        doc = {"census_format": CENSUS_FORMAT,
               "sweep": fleet_probe(
                   sizes=sizes, hot=1000 if args.hot is None else args.hot,
                   ticks=8 if args.ticks is None else args.ticks,
                   seed=seed, device=args.device)}
        if args.out:
            _atomic_write_json(args.out, doc)
            doc["out"] = args.out
        print(json.dumps(doc, indent=2))
        return 0
    if not args.out:
        parser.error("census record needs --out")

    def _or(v, default):
        return default if v is None else v

    _probe_backend(args)
    from anomod_torch.serve.engine import run_power_law
    eng, rep = run_power_law(
        n_tenants=_or(args.tenants, 24), n_services=8,
        capacity_spans_per_s=_or(args.capacity, 4000.0),
        overload=_or(args.overload, 1.5),
        duration_s=_or(args.duration, 30.0),
        tick_s=_or(args.tick, 0.5), seed=seed, shards=args.shards,
        census=True, census_every=args.every, flight=True,
        device=args.device)
    stream = [rec["census"] for rec in eng.flight_recorder.records()
              if rec["census"]["planes"]]
    _atomic_write_json(args.out, {
        "census_format": CENSUS_FORMAT,
        "engine": {"shards": rep.shards, "seed": seed,
                   "tick_s": _or(args.tick, 0.5),
                   "census_every": eng.census_every, "device": rep.device},
        "report": {"census_ticks": rep.census_ticks,
                   "census_hot_set": rep.census_hot_set,
                   "census_resident_bytes": rep.census_resident_bytes},
        "stream": stream})
    print(json.dumps({
        "action": "record", "out": args.out,
        "census_ticks": rep.census_ticks,
        "resident_bytes": rep.census_resident_bytes.get("total"),
        "pool_reconciled": rep.census_resident_bytes.get("pool_reconciled"),
        "hot_set": rep.census_hot_set}, indent=2))
    return 0


def _list(args) -> int:
    from anomod_torch import labels
    rows = labels.ALL_LABELS if args.testbed is None else \
        labels.labels_for_testbed(args.testbed)
    for lab in rows:
        print(f"{lab.testbed}  {lab.experiment:40s} {lab.anomaly_level:12s} "
              f"{lab.anomaly_type:28s} {lab.target_service}")
    return 0


def _synth(args) -> int:
    from anomod_torch import synth
    exp = synth.generate_experiment(args.experiment, n_traces=args.traces)
    print(json.dumps({
        "experiment": exp.name, "testbed": exp.testbed,
        "spans": exp.spans.n_spans, "traces": exp.spans.n_traces,
        "services": exp.spans.n_services,
        "metric_samples": exp.metrics.n_samples,
        "log_lines": exp.logs.n_lines,
        "api_records": exp.api.n_records}))
    return 0


def _ingest(args) -> int:
    """``ingest``: warm, report or clear the ingest cache."""
    import time
    from pathlib import Path

    from anomod_torch.config import get_config
    from anomod_torch.io import cache as ingest_cache
    from anomod_torch.io import dataset
    cfg = get_config()
    if args.cache_dir is not None:
        cfg = dataclasses.replace(cfg, cache_dir=Path(args.cache_dir))
    if args.data_root is not None:
        cfg = dataclasses.replace(cfg, data_root=Path(args.data_root))
    root = ingest_cache.cache_root(cfg)
    out = {"cache_dir": str(root) if root else None}
    if root is None:
        print(json.dumps({**out, "error":
                          "caching disabled (ANOMOD_CACHE_DIR=off)"}))
        return 1
    if args.clear:
        out["cleared"] = ingest_cache.clear(root)
    if args.warm_cache:
        ingest_cache.reset_stats()
        testbeds = ["SN", "TT"] if args.testbed == "both" else [args.testbed]
        t0 = time.perf_counter()
        for tb in testbeds:
            dataset.load_corpus(tb, cfg=cfg, n_synth_traces=args.traces,
                                workers=args.workers)
            if args.bench_traces:
                dataset.load_bench_corpus(tb, args.bench_traces, cfg)
        out.update(warmed=testbeds,
                   wall_s=round(time.perf_counter() - t0, 3),
                   **ingest_cache.stats().to_dict())
    out["entries"] = ingest_cache.entry_count(root)
    print(json.dumps(out))
    return 0


def _logscan(args) -> int:
    """``logscan``: per-file log summaries over a directory, through the
    Python scanner (``native`` is false: the port has no native log
    scanner yet)."""
    from pathlib import Path

    from anomod_torch.io.lfs import is_lfs_pointer
    from anomod_torch.io.logs import summarize_log_files
    root = Path(args.dir)
    if not root.is_dir():
        print(f"not a directory: {root}", file=sys.stderr)
        return 1
    candidates = sorted(root.glob(args.glob))
    paths = [p for p in candidates if not is_lfs_pointer(p)]
    summaries = summarize_log_files(paths)
    print(json.dumps({
        "dir": str(root), "n_files": len(paths),
        "n_lfs_stubs": len(candidates) - len(paths),
        "native": False,
        "totals": {"lines": sum(x.n_lines for x in summaries),
                   "errors": sum(x.n_error for x in summaries),
                   "warnings": sum(x.n_warn for x in summaries),
                   "bytes": sum(x.size_bytes for x in summaries)},
        "files": [{"path": str(p.relative_to(root)), "service": x.service,
                   "lines": x.n_lines, "errors": x.n_error,
                   "warnings": x.n_warn, "info": x.n_info,
                   "bytes": x.size_bytes}
                  for p, x in zip(paths, summaries)]}, indent=2))
    return 0


def _chaos(args) -> int:
    """``chaos``: the fault-injection plan of one experiment."""
    from anomod_torch import chaos, labels
    from anomod_torch.utils import yamlsafe
    label = labels.label_for(args.experiment)
    if label is None:
        print(f"unknown experiment: {args.experiment}", file=sys.stderr)
        return 1
    plan = {"experiment": label.experiment, "tool": label.chaos_tool}
    if label.chaos_tool == "chaosmesh":
        if args.format == "yaml":
            print(chaos.mesh_crd_yaml(label))
            return 0
        plan["crd"] = chaos.build_mesh_crd(label)
    elif label.chaos_tool == "chaosblade":
        cmd = chaos.blade_create_command(label)
        if cmd is not None:
            plan["blade"] = list(cmd.args)
            plan["needs_sudo"] = cmd.needs_sudo
        dc = chaos.docker_command(label)
        if dc is not None:
            plan["docker"] = list(dc)
    if args.format == "yaml":
        print(yamlsafe.dump(plan), end="")
    else:
        print(json.dumps(plan, indent=2))
    return 0


def _scenario(args) -> int:
    """``scenario``: the TT user-journey workload, optionally under a
    fault."""
    import numpy as np

    from anomod_torch import labels, scenario
    from anomod_torch.chaos import ChaosController
    if args.iterations < 1:
        print("--iterations must be >= 1", file=sys.stderr)
        return 1
    ctl = None
    if args.chaos:
        label = labels.label_for(args.chaos)
        if label is None:
            print(f"unknown experiment: {args.chaos}", file=sys.stderr)
            return 1
        if label.testbed != "TT":
            print(f"{label.experiment} is an {label.testbed} fault; the "
                  "scenario workload drives the TT testbed", file=sys.stderr)
            return 1
        ctl = ChaosController()
        ctl.create(label)
    batch = scenario.run_scenario(iterations=args.iterations,
                                  seed=args.seed, controller=ctl)
    by_status = {str(c): int((batch.status == c).sum())
                 for c in np.unique(batch.status)}
    print(json.dumps({
        "requests": batch.n_records,
        "endpoints": len(batch.endpoints),
        "status_codes": by_status,
        "error_rate": round(float((batch.status >= 500).mean()), 4),
        "avg_latency_ms": round(float(batch.latency_ms.mean()), 2),
        "p99_latency_ms": round(float(np.percentile(batch.latency_ms, 99)), 2),
        "chaos": args.chaos,
    }))
    return 0


def _deploy(args) -> int:
    """``deploy``: the TT helm / kubectl plan (or its secrets), the SN
    compose lifecycle."""
    from anomod_torch import deploy
    from anomod_torch.utils import yamlsafe
    if args.testbed == "SN":
        print(deploy.render_plan(deploy.sn_compose_plan(up=not args.down)),
              end="")
        return 0
    flags = deploy.DeployFlags(
        all=args.deploy_all, independent_db=args.independent_db,
        with_monitoring=args.with_monitoring,
        with_tracing=args.with_tracing)
    if args.secrets:
        host = None if flags.independent_db else "tsdb-mysql-leader"
        print(yamlsafe.dump_all(deploy.gen_mysql_secrets(host)), end="")
        return 0
    print(deploy.render_plan(deploy.tt_deploy_plan(flags)), end="")
    return 0


def _monitor(args) -> int:
    """``monitor``: the SN API-response capture, active or passive."""
    import numpy as np

    from anomod_torch.monitor import capture_openapi_responses
    report = capture_openapi_responses(
        args.out, mode=args.mode, cycles=args.cycles,
        seed=args.seed, chaos=args.chaos,
        wrk2_requests=args.wrk2_requests)
    b = report.batch
    print(json.dumps({
        "mode": report.mode, "cycles": report.n_cycles,
        "requests": b.n_records, "endpoints": len(b.endpoints),
        "reachable": sum(report.connectivity.values()),
        "status_codes": {str(c): int((b.status == c).sum())
                         for c in np.unique(b.status)},
        "error_rate": round(float((b.status >= 500).mean()), 4),
        "p99_latency_ms": round(float(np.percentile(b.latency_ms, 99)), 2),
        "out": args.out, "chaos": args.chaos,
    }))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from anomod_torch.utils.platform import await_probe
    parser = _parser()
    args = parser.parse_args(argv)
    _pin_platform(args)
    try:
        rc = _run(args, parser)
    except BaseException:
        await_probe(quiet=True)
        raise
    # the probe's verdict holds even where no card was resolved
    await_probe()
    return rc


def _run(args, parser) -> int:
    if args.cmd == "replay":
        return _replay(args, parser)
    if args.cmd == "serve":
        return _serve(args, parser)
    if args.cmd == "roofline":
        return _roofline(args, parser)
    if args.cmd == "detect":
        return _detect(args)
    if args.cmd == "rca":
        return _rca(args, parser)
    if args.cmd == "obs":
        return _obs(args, parser)
    if args.cmd == "audit":
        return _audit(args, parser)
    if args.cmd == "quality":
        return _quality(args, parser)
    if args.cmd == "collect":
        return _collect(args, parser)
    if args.cmd == "perf":
        return _perf(args, parser)
    if args.cmd == "census":
        return _census(args, parser)
    if args.cmd == "list":
        return _list(args)
    if args.cmd == "synth":
        return _synth(args)
    if args.cmd == "ingest":
        return _ingest(args)
    if args.cmd == "logscan":
        return _logscan(args)
    if args.cmd == "chaos":
        return _chaos(args)
    if args.cmd == "scenario":
        return _scenario(args)
    if args.cmd == "deploy":
        return _deploy(args)
    if args.cmd == "monitor":
        return _monitor(args)
    return _stream(args, parser)


if __name__ == "__main__":
    sys.exit(main())
