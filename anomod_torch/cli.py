"""``python -m anomod_torch``: the port's command line.

- ``replay``: time the TT/SN span replay fold and print one JSON line
  (the counterpart of ``anomod replay``).
- ``stream``: online detection over one experiment (or ``--all`` of a
  testbed's taxonomy, in distribution): alert timelines, ranked culprits
  and top-1 per label, one JSON line each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
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

    s = sub.add_parser("stream", help="online detection: replay an "
                       "experiment's spans in arrival order")
    s.add_argument("experiment", nargs="?", default=None)
    s.add_argument("--all", action="store_true",
                   help="every experiment of --testbed")
    s.add_argument("--testbed", choices=["SN", "TT"], default="TT")
    s.add_argument("--traces", type=int, default=400)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    return parser


def _replay(args) -> int:
    from anomod_torch.io.dataset import load_bench_corpus
    from anomod_torch.replay import ReplayConfig, measure_throughput
    batch = load_bench_corpus(args.testbed, args.traces)
    cfg = ReplayConfig(n_services=batch.n_services)
    r = measure_throughput(batch, cfg, repeats=args.repeats,
                           replicate=args.replicate, kernel=args.kernel,
                           device=args.device)
    print(json.dumps({
        "n_spans": r.n_spans, "wall_s": round(r.wall_s, 6),
        "spans_per_sec": round(r.spans_per_sec, 1),
        "compile_s": round(r.compile_s, 3), "kernel": r.kernel,
        "device": r.device}))
    return 0


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
    rows = stream_quality(testbed, n_traces=args.traces, seed=args.seed,
                          experiments=experiments, device=args.device)
    for r in rows:
        r["alerts"] = [dataclasses.asdict(a) for a in r["alerts"]]
        print(json.dumps(r))
    hits = [r["top1_hit"] for r in rows if "top1_hit" in r]
    print(json.dumps({"summary": {
        "testbed": testbed, "n_experiments": len(rows),
        "top1": sum(hits) / len(hits) if hits else None}}))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.cmd == "replay":
        return _replay(args)
    return _stream(args, parser)


if __name__ == "__main__":
    sys.exit(main())
