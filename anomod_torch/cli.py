"""``python -m anomod_torch``: the port's command line.

- ``replay``: time the TT/SN span replay fold and print one JSON line
  (the counterpart of ``anomod replay``); ``--percentiles`` adds the
  corpus p50/p95/p99 from the per-segment t-digest plane,
  ``--edge-percentiles`` the five slowest cross edges by p99 with their
  HLL distinct-trace counts.
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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional


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
                        "per-segment t-digest plane")
    p.add_argument("--edge-percentiles", action="store_true",
                   help="also report the slowest call-graph edges by p99 "
                        "from the per-edge t-digest plane, with their HLL "
                        "distinct-trace counts")

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
                   help="in-flight fused dispatches plus one (default 2)")
    v.add_argument("--no-fuse", action="store_true",
                   help="one dispatch per tenant micro-batch")
    v.add_argument("--buckets", default=None,
                   help="comma-separated micro-batch bucket widths")
    v.add_argument("--lane-buckets", default=None,
                   help="comma-separated fused-dispatch lane counts")
    v.add_argument("--max-backlog", type=int, default=None,
                   help="global backlog bound in spans (default 200000)")
    v.add_argument("--fault-tenants", type=int, default=2)
    v.add_argument("--state", choices=["host", "device"], default=None,
                   help="tenant states in the device pool (the default) or "
                        "on the host")
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
    a.add_argument("--state", choices=["host", "device"], default=None,
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
    return parser


def _serve(args, parser) -> int:
    from anomod_torch.serve.config import (validate_lane_buckets,
                                           validate_serve_buckets)
    from anomod_torch.serve.engine import run_power_law
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
    if args.async_commit and args.no_async_commit:
        parser.error("--async-commit contradicts --no-async-commit")
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
    from anomod_torch.obs.http import maybe_serve
    from anomod_torch.utils.tracing import Tracer
    tracer = Tracer("anomod-serve") if args.trace_out else None
    # the endpoint rides the run when ANOMOD_OBS_HTTP is on: pure
    # registry reads, decisions byte-identical either way
    endpoint = maybe_serve()
    try:
        _, report = run_power_law(
            n_tenants=args.tenants, n_services=args.services,
            capacity_spans_per_s=args.capacity, overload=args.overload,
            duration_s=args.duration, tick_s=args.tick, seed=args.seed,
            alpha=args.alpha, window_s=args.window_seconds,
            baseline_windows=args.baseline_windows,
            z_threshold=args.threshold, buckets=buckets,
            max_backlog=args.max_backlog,
            fault_tenants=args.fault_tenants, score=not args.no_score,
            fuse=not args.no_fuse, lane_buckets=lanes,
            pipeline=args.pipeline, state=args.state or "device",
            device=args.device,
            # --no-score forces RCA off even under ANOMOD_SERVE_RCA=1
            rca=True if args.rca else (False if args.no_score else None),
            tracer=tracer, shards=args.shards, fold=args.fold,
            worker=args.worker, chaos=args.chaos,
            ckpt_every=args.ckpt_every, policy=args.policy,
            policy_script=args.policy_script, min_shards=args.min_shards,
            max_shards=args.max_shards,
            async_commit=(True if args.async_commit
                          else (False if args.no_async_commit else None)))
    finally:
        if endpoint is not None:
            endpoint.stop()
    if tracer is not None:
        tracer.dump(args.trace_out)
    print(json.dumps(report.to_dict()))
    return 0


def _serve_live(args, parser, buckets, lanes) -> int:
    """``serve --from-live`` / ``--live-replay``: the live feed's run
    (``run_live_feed``), with the JAX CLI's checks."""
    if args.from_live and args.live_replay:
        parser.error("--from-live contradicts --live-replay")
    for flag, bad in (("--chaos", args.chaos), ("--rca", args.rca),
                      ("--policy", args.policy),
                      ("--policy-script", args.policy_script),
                      ("--async-commit", args.async_commit),
                      ("--worker", args.worker), ("--fold", args.fold),
                      ("--state", args.state),
                      ("--ckpt-every", args.ckpt_every),
                      ("--trace-out", args.trace_out)):
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
                  state=args.state or "device",
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
                          ("state", args.state)):
            if val is not None:
                kw[name] = val
    if args.digest_every is not None:
        kw["flight_digest_every"] = args.digest_every
    kw["flight"] = True
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


def _replay(args) -> int:
    from anomod_torch.io.dataset import load_bench_corpus
    from anomod_torch.replay import ReplayConfig, measure_throughput
    batch = load_bench_corpus(args.testbed, args.traces)
    cfg = ReplayConfig(n_services=batch.n_services)
    r = measure_throughput(batch, cfg, repeats=args.repeats,
                           replicate=args.replicate, kernel=args.kernel,
                           device=args.device)
    out = {
        "n_spans": r.n_spans, "wall_s": round(r.wall_s, 6),
        "spans_per_sec": round(r.spans_per_sec, 1),
        "compile_s": round(r.compile_s, 3), "kernel": r.kernel,
        "device": r.device}
    if args.percentiles:
        out["latency_us"] = corpus_latency_us(batch, cfg, args.device)
    if args.edge_percentiles:
        out["edge_p99_us_top"] = edge_p99_top(batch, cfg, args.device)
    print(json.dumps(out))
    return 0


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
    from anomod_torch.stream import stream_quality
    if bool(args.experiment) == bool(args.all):
        parser.error("give an experiment name OR --all")
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
    rows = stream_quality(testbed, n_traces=args.traces, seed=args.seed,
                          experiments=experiments,
                          multimodal=args.multimodal,
                          severity=args.severity, noise=args.noise,
                          n_confounders=args.confounders, shift=args.shift,
                          device=args.device)
    for r in rows:
        r["alerts"] = [dataclasses.asdict(a) for a in r["alerts"]]
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
    from anomod_torch.rca import train_rca
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume requires --checkpoint-dir")
    r = train_rca(args.testbed, args.model,
                  train_seeds=range(args.train_seeds),
                  eval_seeds=range(100, 100 + args.eval_seeds),
                  epochs=args.epochs,
                  checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                  device=args.device)
    print(json.dumps({
        "testbed": args.testbed, "model": r.model_name,
        "top1": r.top1, "top3": r.top3,
        "detection_auc": r.detection_auc, "n_eval": r.n_eval}))
    return 0


def _quality(args, parser) -> int:
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
    dev = resolve_device(args.device)
    common = dict(
        testbed=args.testbed, model_names=args.models,
        train_seeds=range(args.train_seeds),
        eval_seeds=range(100, 100 + args.eval_seeds),
        n_traces=args.traces, epochs=args.epochs, noise=args.noise,
        n_confounders=args.confounders, verbose=not args.json)
    if args.sweep == "shift":
        pts = shift_sweep(severity=args.shift_severity,
                          edge_aware=args.edge_aware, device=dev, **common)
        render = render_shift_markdown
    else:
        pts = severity_sweep(severities=args.severities, device=dev,
                             **common)
        render = render_markdown
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
        points=[dataclasses.asdict(p) for p in pts])
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
    print(json.dumps(kernel_roofline(n_traces=args.traces,
                                     replicate=args.replicate,
                                     device=args.device)))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.cmd == "replay":
        return _replay(args)
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
    return _stream(args, parser)


if __name__ == "__main__":
    sys.exit(main())
