"""Campaign runner + dataset materializer — the collection-toolchain analog.

Counterpart of ``anomod/campaign.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_collection.py``.

The reference's orchestrators run 13 experiments per testbed and archive five
modalities per experiment under a naming convention
(automated_multimodal_collection.sh:787-891; run_all_experiments.sh:549-598;
layout at collect_all_data.sh:207-211 and T-Dataset/README.md:9-17).  This
module reproduces that pipeline against the synthetic SUT: each "run" injects
a fault (by conditioning the generator), "collects" all modalities, and
archives them in the exact reference tree shape, so the output directory is a
drop-in SN_data/TT_data replacement with materialized payloads (no LFS stubs):

  SN: <out>/SN_data/{log,metric,trace,coverage}_data/<Exp>_<ts>_<modality>_<ts2>/
      + api_responses/<Exp>_<ts>_openapi_<ts2>/openapi_responses.jsonl
  TT: <out>/TT_data/{log,metric,trace,api_responses,coverage_report}/<Exp>_<ts>_em/

Timestamps are derived deterministically from the experiment seed so trees are
reproducible.
"""

from __future__ import annotations

import datetime as dt
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from anomod_torch import labels as labels_mod
from anomod_torch import synth
from anomod_torch.io.api import write_api_jsonl
from anomod_torch.io.metrics import write_metric_batch_tt_csv
from anomod_torch.schemas import Experiment, LOG_ERROR, LOG_INFO, LOG_WARN

_BASE_TS = dt.datetime(2026, 1, 5, 12, 0, 0)


def _ts_for(name: str, style: str) -> str:
    off = int(synth._seed_for(name, 9) % 86_400)
    t = _BASE_TS + dt.timedelta(seconds=off)
    if style == "sn":
        return t.strftime("%Y%m%d_%H%M%S")
    if style == "sn2":
        return t.strftime("%Y-%m-%d_%H-%M-%S")
    return t.strftime("%Y%m%dT%H%M%SZ")  # tt


def _write_log_text(exp: Experiment, svc_idx: int, path: Path) -> dict:
    """Render a plausible log file from the LogBatch lines of one service."""
    lvl_name = {LOG_INFO: "INFO", LOG_WARN: "WARN", LOG_ERROR: "ERROR"}
    rows = np.flatnonzero(exp.logs.service == svc_idx)
    lines = []
    for r in rows:
        t = dt.datetime.fromtimestamp(float(exp.logs.t_s[r]), dt.timezone.utc)
        lvl = lvl_name.get(int(exp.logs.level[r]), "DEBUG")
        lines.append(f"{t.strftime('%Y-%m-%d %H:%M:%S')} {lvl} "
                     f"{exp.logs.services[svc_idx]}: request handled")
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
    lvls = exp.logs.level[rows]
    return {"lines": len(rows),
            "errors": int((lvls == LOG_ERROR).sum()),
            "warnings": int((lvls == LOG_WARN).sum())}


def _materialize_sn(exp: Experiment, label, root: Path) -> None:
    ts1, ts2 = _ts_for(exp.name, "sn"), _ts_for(exp.name, "sn2")
    base = f"{label.experiment}_{ts1}"

    # traces: all_traces.json + csv-ish flat export
    tdir = root / "trace_data" / f"{base}_traces_{ts2}"
    tdir.mkdir(parents=True, exist_ok=True)
    doc = synth.spans_to_jaeger_json(exp.spans)
    (tdir / "all_traces.json").write_text(json.dumps(doc))
    from anomod_torch.io.sn_traces import write_jaeger_csv
    write_jaeger_csv(exp.spans, tdir / "all_traces.csv")
    (tdir / "available_services.json").write_text(json.dumps(
        {"data": sorted(set(exp.spans.services)), "total": exp.spans.n_services}))

    # metrics: per-metric CSVs (timestamp,value,metric + label columns)
    mdir = root / "metric_data" / f"{base}_metrics_{ts2}"
    mdir.mkdir(parents=True, exist_ok=True)
    m = exp.metrics
    for mi, mname in enumerate(m.metric_names):
        rows = np.flatnonzero(m.metric == mi)
        with open(mdir / f"{mname}.csv", "w") as f:
            f.write("timestamp,value,metric\n")
            for r in rows:
                t = dt.datetime.fromtimestamp(float(m.t_s[r]))
                f.write(f"{t},{m.value[r]},\"{m.series_keys[int(m.series[r])]}\"\n")
    # window line follows the reference's app-start discovery + clamp
    # semantics (metric_collector.py:480-525) — pod start = first sample
    from anomod_torch.metrics_catalog import experiment_window, fmt_window
    w0, w1 = experiment_window([float(m.t_s.min())] if m.n_samples else None,
                               float(m.t_s.max()) if m.n_samples else 0.0)
    (mdir / "metadata.txt").write_text(
        f"experiment: {exp.name}\nqueries: {len(m.metric_names)}\n"
        f"step: 15s\nwindow: {fmt_window(w0, w1)}\n")

    # logs: <Service>_<ts>.log + summary.txt (collect_log.sh:113-137 shape)
    ldir = root / "log_data" / f"{base}_logs_{ts2}"
    ldir.mkdir(parents=True, exist_ok=True)
    summary_lines = [f"Collection timestamp: {ts1}",
                     "Time window: full history",
                     f"Services captured: {len(exp.logs.services)}", "",
                     "Log file summary:"]
    for si, svc in enumerate(exp.logs.services):
        display = "".join(w.capitalize() for w in svc.split("-"))
        stats = _write_log_text(exp, si, ldir / f"{display}_{ts1}.log")
        summary_lines.append(
            f"- {display}: {stats['lines']*90//1024}K ({stats['lines']} lines) | "
            f"errors={stats['errors']}, warnings={stats['warnings']}, startup=1")
    (ldir / "summary.txt").write_text("\n".join(summary_lines) + "\n")

    # api responses (enhanced_openapi_monitor.py output family)
    from anomod_torch.io.api import write_api_artifact_family
    write_api_artifact_family(
        exp.api, root / "api_responses" / f"{base}_openapi_{ts2}")

    # coverage: per-service gcov text
    cdir = root / "coverage_data" / f"{base}_coverage_{ts2}"
    for fi in range(len(exp.coverage.paths)):
        svc = exp.coverage.services[int(exp.coverage.service[fi])]
        sdir = cdir / svc
        sdir.mkdir(parents=True, exist_ok=True)
        total = int(exp.coverage.lines_total[fi])
        covered = int(exp.coverage.lines_covered[fi])
        src = exp.coverage.paths[fi]
        gname = "#" + src.replace("/", "#") + ".gcov"
        lines = [f"        -:    0:Source:/{src}"]
        for ln in range(1, total + 1):
            cnt = "5" if ln <= covered else "#####"
            lines.append(f"        {cnt}:{ln:5d}:  line_{ln};")
        (sdir / gname).write_text("\n".join(lines) + "\n")


def _materialize_tt(exp: Experiment, label, root: Path) -> None:
    ts = _ts_for(exp.name, "tt")
    base = (f"{label.experiment}_{ts}_em" if label.is_anomaly
            else f"{label.experiment}_em_{ts}")

    tdir = root / "trace_data" / base
    tdir.mkdir(parents=True, exist_ok=True)
    doc = synth.spans_to_skywalking_json(exp.spans, base)
    stamp = ts.replace("T", "_").replace("Z", "")
    (tdir / f"{base}_skywalking_traces_{stamp}.json").write_text(json.dumps(doc))
    # ES-collector analysis artifact alongside the raw traces
    # (enhanced_trace_collector.py's collect-and-analyze pipeline)
    from anomod_torch.io.tt_traces_es import write_trace_analysis
    write_trace_analysis(exp.spans, tdir, timestamp=stamp)

    mdir = root / "metric_data" / base
    mdir.mkdir(parents=True, exist_ok=True)
    write_metric_batch_tt_csv(exp.metrics, mdir / f"{base}_metrics_{stamp}.csv")

    ldir = root / "log_data" / base
    for si, svc in enumerate(exp.logs.services):
        pod = f"{svc}-{synth._seed_for(svc, 1) % 0xfffff:05x}"
        pdir = ldir / pod
        pdir.mkdir(parents=True, exist_ok=True)
        _write_log_text(exp, si, pdir / f"{pod}_{stamp}.log")
    (ldir / f"log_collection_report_{stamp}.json").write_text(json.dumps({
        "experiment": base, "pods": len(exp.logs.services),
        "total_lines": int(exp.logs.n_lines)}))
    (ldir / f"kubernetes_events_{stamp}.json").write_text(json.dumps(
        {"items": []}))

    adir = root / "api_responses" / base / _BASE_TS.strftime("%Y%m%d")
    adir.mkdir(parents=True, exist_ok=True)
    write_api_jsonl(exp.api, adir / "api_responses.jsonl")

    # coverage: per-pod exec-analog dumps + per-service merged report tree
    # (collect_coverage_reports.sh:54-191 pipeline shape)
    from anomod_torch.io.coverage_report import (batch_to_dumps,
                                                 collect_coverage_reports)
    dumps = batch_to_dumps(exp.coverage,
                           seed=int(synth._seed_for(exp.name, 13) % 2**31))
    # pod identity must match the log tree's naming (same salt) so modalities
    # correlate by pod the way the reference dataset does
    pods = {f"{d.service}-{synth._seed_for(d.service, 1) % 0xfffff:05x}": [d]
            for d in dumps}
    collect_coverage_reports(pods, root / "coverage_data" / base,
                             root / "coverage_report" / base)


def run_campaign(testbed: str, out_dir: Path,
                 experiments: Optional[Sequence[str]] = None,
                 n_traces: int = 200, seed: Optional[int] = None) -> List[str]:
    """Generate + archive experiments in the reference tree shape.

    The campaign traces ITSELF (generate/materialize spans per experiment,
    anomod_torch.utils.tracing) and archives the trace as
    ``<out>/campaign_trace_<testbed>.json`` in Jaeger shape — the
    framework-level analog of the reference instrumenting its own toolchain
    with Jaeger/SkyWalking, loadable back through anomod_torch.io.sn_traces.
    The
    trace is written even when a run fails partway (that is when per-stage
    timings matter most).

    Returns the list of archived experiment dir basenames.
    """
    from anomod_torch.utils.tracing import Tracer

    out_dir = Path(out_dir)
    root = out_dir / f"{testbed}_data"
    chosen = [labels_mod.label_for(e) for e in experiments] if experiments \
        else labels_mod.labels_for_testbed(testbed)
    done = []
    tracer = Tracer(service=f"anomod-campaign-{testbed}")
    try:
        with tracer.span(f"campaign[{testbed}]"):
            for label in chosen:
                if label is None or label.testbed != testbed:
                    raise ValueError(f"bad experiment for {testbed}: {label}")
                with tracer.span(f"experiment[{label.experiment}]"):
                    with tracer.span("generate"):
                        exp = synth.generate_experiment(
                            label, n_traces=n_traces, seed=seed)
                    with tracer.span("materialize"):
                        if testbed == "SN":
                            _materialize_sn(exp, label, root)
                        else:
                            _materialize_tt(exp, label, root)
                done.append(label.experiment)
    finally:
        out_dir.mkdir(parents=True, exist_ok=True)
        tracer.dump(out_dir / f"campaign_trace_{testbed}.json")
    return done
