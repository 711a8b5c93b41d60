"""Golden run over the REAL reference dataset trees.

Counterpart of ``anomod/golden.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_collection.py``.  It reads the
tree under the port's ``Config`` data root (``ANOMOD_DATA_ROOT``; unset,
both testbeds read as missing).

The shipped checkout's payloads are mostly git-LFS pointer stubs, but not
all of it: both coverage trees are real content (SN_data/coverage_data —
8.5k gcov text files; TT_data/coverage_report — 27.5k JaCoCo xml/html
artifacts), plus a handful of SN log/metric files.  This module is the
committed evidence that the loaders and the coverage-modality detector run
over the ACTUAL dataset, not only its synthetic shadow:

  1. :func:`scan_tree` — the loadability census: per modality, how many
     files are real vs LFS-stubbed, and which experiments' artifacts the
     typed loaders actually parse (synth fallback disabled).
  2. :func:`coverage_signal` — the coverage-modality detector on real
     data: artifact-absence fingerprinting + blast-discounted coverage
     -ratio deltas + producer triangulation, vs the normal-baseline run —
     the real-data counterpart of the ``coverage_ratio`` feature in
     anomod_torch.detect.
  3. :func:`log_signal` — the log-modality detector on the real
     summary.txt error/warn/line counts (collect_log.sh:101-137).

``python -m anomod_torch golden`` prints the full report as JSON
(``--markdown`` for the docs body, whose provenance line is
``docs/GOLDEN_REPORT.md``'s own); that document carries the committed run
over the AnoMod reference checkout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from anomod_torch import labels as labels_mod
from anomod_torch.config import Config, get_config
from anomod_torch.io.lfs import is_lfs_pointer

_MODALITY_SUBDIRS = {
    "SN": ("log_data", "metric_data", "trace_data", "api_responses",
           "coverage_data"),
    "TT": ("log_data", "metric_data", "trace_data", "api_responses",
           "coverage_data", "coverage_report"),
}


def _count_files(base: Path) -> Dict[str, int]:
    files = [p for p in base.rglob("*") if p.is_file()]
    stubs = sum(1 for p in files if is_lfs_pointer(p))
    return {"n_files": len(files), "n_lfs_stubs": stubs,
            "n_real": len(files) - stubs}


def _try_load(testbed: str, modality: str, d: Path):
    """Attempt the typed load of one experiment-modality dir; None when the
    artifact is missing/stubbed (synth fallback deliberately NOT taken)."""
    from anomod_torch.io import api as api_io
    from anomod_torch.io import coverage as cov_io
    from anomod_torch.io import logs as logs_io
    from anomod_torch.io import metrics as met_io
    from anomod_torch.io import sn_traces, tt_traces
    if modality == "traces":
        if testbed == "TT":
            art = tt_traces.find_trace_artifact(d)
            return tt_traces.load_skywalking_json(art) if art else None
        art = sn_traces.find_trace_artifact(d)
        if art is None:
            return None
        return (sn_traces.load_jaeger_json(art) if art.suffix == ".json"
                else sn_traces.load_jaeger_csv(art))
    if modality == "metrics":
        if testbed == "TT":
            art = met_io.find_tt_metric_artifact(d)
            return met_io.load_tt_metric_csv(art) if art else None
        return met_io.load_sn_metric_dir(d)
    if modality == "logs":
        loader = (logs_io.load_tt_log_dir if testbed == "TT"
                  else logs_io.load_sn_log_dir)
        batch, _ = loader(d)
        # a LogBatch built from zero-line stub parses is NOT real content;
        # this criterion must live here so the standalone census agrees
        # with the _load_log_summaries preload path
        return batch if batch is not None and batch.n_lines > 0 else None
    if modality == "api":
        art = api_io.find_api_artifact(d)
        return api_io.load_api_jsonl(art) if art else None
    if modality == "coverage":
        loader = (cov_io.load_tt_coverage_report if testbed == "TT"
                  else cov_io.load_sn_coverage_dir)
        return loader(d)
    raise ValueError(modality)


def _load_coverage_batches(testbed: str, cfg: Config) -> Dict[str, object]:
    """Load every experiment's real coverage tree ONCE — shared by the
    census and the detection pass (TT's coverage_report is 27.5k files;
    parsing it twice per report would double the most expensive I/O)."""
    from anomod_torch.io import dataset
    out: Dict[str, object] = {}
    for ed in dataset.discover(testbed, cfg):
        if "coverage" not in ed.dirs:
            continue
        cb = _try_load(testbed, "coverage", ed.dirs["coverage"])
        if cb is not None and len(cb.services):
            out[ed.name] = cb
    return out


def _load_log_summaries(testbed: str, cfg: Config) -> Dict[str, tuple]:
    """Parse every experiment's log dir ONCE — shared by the census and
    the log-signal pass (same pattern as :func:`_load_coverage_batches`).
    Returns ``{name: (line_content_is_real, summaries)}``: the census
    marks "real" on parsed LINE content (a LogBatch), while detection
    consumes the summary counts, which summary.txt carries even where the
    per-service .log payloads are LFS-stubbed."""
    from anomod_torch.io import dataset
    from anomod_torch.io.logs import load_sn_log_dir, load_tt_log_dir
    loader = load_tt_log_dir if testbed == "TT" else load_sn_log_dir
    out: Dict[str, tuple] = {}
    for ed in dataset.discover(testbed, cfg):
        if "logs" not in ed.dirs:
            continue
        try:
            batch, summaries = loader(ed.dirs["logs"])
        except Exception as e:
            # census contract: one unreadable tree yields an "error:" row
            # for that experiment, never an aborted report
            out[ed.name] = (f"error: {type(e).__name__}", [])
            continue
        out[ed.name] = (batch is not None and batch.n_lines > 0,
                        summaries or [])
    return out


def scan_tree(testbed: str, cfg: Optional[Config] = None,
              coverage_batches: Optional[Dict[str, object]] = None,
              log_loads: Optional[Dict[str, tuple]] = None) -> dict:
    """The loadability census for one testbed's archive tree.

    ``coverage_batches`` (from :func:`_load_coverage_batches`) and
    ``log_loads`` (from :func:`_load_log_summaries`) substitute for
    re-parsing those trees when the caller already loaded them."""
    from anomod_torch.io import dataset
    cfg = cfg or get_config()
    root = cfg.sn_data if testbed == "SN" else cfg.tt_data
    out: dict = {"testbed": testbed, "root": str(root), "modality_files": {},
                 "experiments": {}}
    if root is None or not root.is_dir():
        out["missing"] = True
        return out
    for sub in _MODALITY_SUBDIRS[testbed]:
        base = root / sub
        if base.is_dir():
            out["modality_files"][sub] = _count_files(base)
    for ed in sorted(dataset.discover(testbed, cfg), key=lambda e: e.name):
        row = {}
        for modality, d in sorted(ed.dirs.items()):
            if modality == "coverage" and coverage_batches is not None:
                row[modality] = ("real" if ed.name in coverage_batches
                                 else "stub")
                continue
            if modality == "logs" and log_loads is not None:
                flag = log_loads.get(ed.name, (False,))[0]
                row[modality] = (flag if isinstance(flag, str)
                                 else "real" if flag else "stub")
                continue
            try:
                batch = _try_load(testbed, modality, d)
            except Exception as e:           # a real but unparseable file
                row[modality] = f"error: {type(e).__name__}"
                continue
            row[modality] = "real" if batch is not None else "stub"
        out["experiments"][ed.name] = row
    mods = out["experiments"].values()
    out["n_experiments"] = len(out["experiments"])
    out["real_loads"] = {m: sum(1 for r in mods if r.get(m) == "real")
                         for m in ("traces", "metrics", "logs", "api",
                                   "coverage")}
    return out


def _pick_normal(names) -> Optional[str]:
    """The normal-baseline experiment among ``names`` (None when absent)."""
    return next((n for n in names
                 if labels_mod.label_for(n) is not None
                 and not labels_mod.label_for(n).is_anomaly), None)


def _mark_hits(row: dict, target: str, ranked: List[str]) -> tuple:
    """Shared hit accounting for the modality scorers: annotate ``row``
    with top1/top3 hits (service names canonicalized — SN logs use
    CamelCase where the chaos labels use kebab-case) and return the
    (scored, top1, top3) increments."""
    if not ranked:
        row["no_signal"] = True
    if not (target and ranked):
        return 0, 0, 0
    want = _canon_service(target)
    got = [_canon_service(s) for s in ranked]
    row["top1_hit"] = got[0] == want
    row["top3_hit"] = want in got[:3]
    return 1, int(row["top1_hit"]), int(row["top3_hit"])


def coverage_signal(testbed: str, cfg: Optional[Config] = None,
                    batches: Optional[Dict[str, object]] = None,
                    repeat_tol: float = 0.005,
                    upstream_w: float = 1.1) -> dict:
    """Coverage-modality detection over the REAL coverage artifacts.

    Per fault experiment: per-service coverage-ratio delta vs the normal
    baseline run (services aligned by name), then culprit ranking by a
    BLAST-DISCOUNTED, PRODUCER-ATTRIBUTED score.  Raw |delta| ranking is
    confounded two ways in the real SN artifacts (the round-4 report's
    shared-top-delta artifact): (1) a fault anywhere in the compose
    pipeline starves the same downstream set by the SAME amounts — e.g.
    post-storage-service drops exactly 0.0887 under every Code_Stop —
    so a delta that repeats across other fault experiments (within
    ``repeat_tol``) is a deterministic secondary effect and is divided by
    (1 + 2·repeats); (2) a stopped service's OWN coverage never moves
    (the cumulative gcov counters already covered its paths), while its
    unique downstream consumers starve.  So when TWO OR MORE of one
    producer's callees show unique (non-repeated) starvation, they
    triangulate that producer: it inherits ``upstream_w`` x the max such
    starvation, with ``upstream_w`` > 1 because the producer cannot
    self-evidence in this data.  One uniquely starved callee alone is
    ambiguous — a killed service and a starved service look identical
    from inside their own artifact — so single-callee starvation stays
    where it is (which is exactly what lets Svc_Kill self-attribute).
    This is the real-data counterpart of the offline detector's
    ``coverage_ratio`` feature channel (anomod_torch.detect) plus its
    dependency-attribution idea."""
    from anomod_torch import synth
    cfg = cfg or get_config()
    if batches is None:
        batches = _load_coverage_batches(testbed, cfg)
    normal_name = _pick_normal(batches)
    out: dict = {"testbed": testbed, "n_loaded": len(batches),
                 "normal_baseline": normal_name, "experiments": []}
    if normal_name is None:
        return out
    base = batches[normal_name]
    base_ratio = dict(zip(base.services, base.service_ratio()))
    # signed per-service deltas for EVERY fault experiment up front: the
    # repeat-discount needs each delta's frequency across the others
    signed: Dict[str, Dict[str, float]] = {}
    for name, cb in batches.items():
        if name == normal_name:
            continue
        ratio = cb.service_ratio()
        signed[name] = {svc: float(ratio[si] - base_ratio[svc])
                        for si, svc in enumerate(cb.services)
                        if svc in base_ratio}
    callees_of: Dict[str, List[str]] = {}
    try:
        for a, c in synth._topology(testbed)[1]:
            callees_of.setdefault(a, []).append(c)
    except Exception:
        # triangulation degrades to delta-only ranking without topology —
        # surfaced in the record so a silent regression is visible
        pass
    out["topology_available"] = bool(callees_of)
    hits1 = hits3 = scored = 0
    max_delta = 0.0
    n_absent = 0
    n_absence_hits = 0
    for name in sorted(signed):
        label = labels_mod.label_for(name)
        if label is None:
            continue
        dmap = signed[name]
        if dmap:
            max_delta = max(max_delta, max(abs(d) for d in dmap.values()))
        disc: Dict[str, float] = {}
        unique_mover: Dict[str, bool] = {}
        for svc, d in dmap.items():
            repeats = sum(
                1 for other, od in signed.items()
                if other != name
                and abs(od.get(svc, 0.0) - d) <= repeat_tol
                and abs(od.get(svc, 0.0)) > 1e-9)
            moved = abs(d) > 1e-9
            disc[svc] = abs(d) / (1.0 + 2.0 * repeats) if moved else 0.0
            unique_mover[svc] = moved and repeats == 0
        score: Dict[str, float] = dict(disc)
        for svc in dmap:
            starve = [disc[c] for c in callees_of.get(svc, ())
                      if unique_mover.get(c) and dmap.get(c, 0.0) < 0]
            if len(starve) >= 2:
                score[svc] = max(score[svc], upstream_w * max(starve))
        # ABSENCE tier, above every delta: a service that reported
        # coverage at baseline but produced NO artifact under the fault
        # stopped executing outright — a stopped binary cannot flush its
        # gcov counters at collection time.  In the real SN tree this is
        # exactly the Code_Stop culprits' fingerprint (each is the one
        # service missing from its own experiment's coverage_data).
        absent = [svc for svc in base_ratio if svc not in dmap]
        n_absent += len(absent)
        top_disc = max(score.values(), default=0.0)
        for svc in absent:
            # among multiple absences, the higher-baseline-coverage (more
            # load-bearing) service ranks first — never the alphabetical
            # accident of the tuple sort
            score[svc] = top_disc + 1.0 + 1e-3 * base_ratio[svc]
        deltas = sorted(((s, svc) for svc, s in score.items()),
                        reverse=True)
        # a rank is only meaningful where the delta plane is non-zero:
        # zero-signal experiments must not score, or ties would credit and
        # deny hits by the sort's alphabetical accident
        ranked = [svc for s, svc in deltas if s > 1e-9]
        target = label.target_service
        row = {"experiment": name, "target": target,
               "n_services_aligned": len(dmap),
               "top3": [
                   dict({"service": svc, "score": round(s, 4),
                         "abs_delta": round(abs(dmap.get(svc, 0.0)), 4)},
                        **({"absent": True} if svc in absent else {}))
                   for s, svc in deltas[:3]]}
        ds, d1, d3 = _mark_hits(row, target, ranked)
        scored += ds
        hits1 += d1
        hits3 += d3
        if d1 and row["top3"] and row["top3"][0].get("absent"):
            n_absence_hits += 1
        out["experiments"].append(row)
    out["scored"] = scored
    out["top1"] = round(hits1 / scored, 3) if scored else None
    out["top3"] = round(hits3 / scored, 3) if scored else None
    # An all-zero delta plane means the ARTIFACTS carry no per-experiment
    # signal (the shipped TT coverage-summary.txt files are byte-identical
    # across experiments), not that the detector failed — distinguish the
    # two in the committed record.
    out["max_abs_delta"] = round(max_delta, 6)
    out["n_absent_artifacts"] = n_absent
    out["n_absence_top1_hits"] = n_absence_hits
    # absence is signal too (an experiment could carry ONLY the missing
    # -artifact fingerprint and still score)
    out["signal_present"] = max_delta > 1e-9 or n_absent > 0
    return out


def _canon_service(name: str) -> str:
    """SN logs name services in CamelCase (``MediaService``) while the
    chaos labels use kebab-case (``media-service``); canonicalize both for
    target matching (collect_log.sh's SERVICES list vs the label
    taxonomy)."""
    import re
    s = re.sub(r"(?<!^)(?=[A-Z])", "-", name).lower()
    return s.strip("-")


def log_signal(testbed: str, cfg: Optional[Config] = None,
               log_loads: Optional[Dict[str, tuple]] = None) -> dict:
    """Log-modality detection over the REAL log artifacts.

    Per fault experiment with real (non-stub) logs: per-service error-rate
    and warn-rate deltas vs the normal-baseline run (services aligned by
    name), culprit ranking by the error-rate delta with warn-rate and
    log-VOLUME shift (|ln(lines_exp / lines_base)|) as tiebreak channels —
    volume is what a kill/stop fault moves when it never writes an error
    line (the service just goes quiet).  All three come from the same
    per-service error/warn/line counts the reference's collector writes
    into ``summary.txt`` (collect_log.sh:101-137); the offline detector's
    ``log_err_rate`` feature is the synthetic counterpart
    (anomod_torch.detect FEATURES).  ``log_loads`` (from
    :func:`_load_log_summaries`) substitutes for re-parsing the log
    trees."""
    import math

    cfg = cfg or get_config()
    if log_loads is None:
        log_loads = _load_log_summaries(testbed, cfg)
    rates: Dict[str, Dict[str, tuple]] = {}
    for name, (_, summaries) in log_loads.items():
        by_svc: Dict[str, List[int]] = {}
        for s in summaries:
            agg = by_svc.setdefault(s.service, [0, 0, 0])
            agg[0] += s.n_lines
            agg[1] += s.n_error
            agg[2] += s.n_warn
        svc_rates = {
            svc: (err / n, warn / n, n)
            for svc, (n, err, warn) in by_svc.items() if n > 0}
        # an experiment whose every parsed file is empty (LFS stub dirs
        # with zero-byte logs) has no real log content — do not count it
        # as loaded, or "loaded" overstates the census
        if svc_rates:
            rates[name] = svc_rates
    normal_name = _pick_normal(rates)
    out: dict = {"testbed": testbed, "n_loaded": len(rates),
                 "normal_baseline": normal_name, "experiments": []}
    if normal_name is None:
        return out
    base = rates[normal_name]
    hits1 = hits3 = scored = 0
    max_delta = 0.0
    max_vol = 0.0
    for name, svc_rates in sorted(rates.items()):
        label = labels_mod.label_for(name)
        if name == normal_name or label is None:
            continue
        deltas = []
        for svc, (err, warn, n) in svc_rates.items():
            if svc in base:
                b_err, b_warn, b_n = base[svc]
                dv = abs(math.log(n / b_n))
                deltas.append((abs(err - b_err), abs(warn - b_warn), dv,
                               svc))
        deltas.sort(reverse=True)
        if deltas:
            max_delta = max(max_delta, deltas[0][0])
            max_vol = max(max_vol, max(d[2] for d in deltas))
        # Volume as evidence, two regimes.  The SN collector gathers the
        # FULL cumulative log history per experiment (summary.txt header:
        # unbounded time range), so most services' line counts are
        # bit-identical to the baseline.  When nearly everything is
        # exactly unchanged (<= 3 movers), the baseline is deterministic
        # and ANY mover is significant — a killed service's file goes
        # quiet, a ~0.2% dip at exactly one service.  When volume moves
        # broadly, counts jitter and only a >10% shift is evidence.
        n_movers = sum(1 for de, dw, dv, svc in deltas if dv > 1e-12)
        vol_eps = 1e-12 if n_movers <= 3 else 0.1
        ranked = [svc for de, dw, dv, svc in deltas
                  if de > 1e-12 or dw > 1e-12 or dv > vol_eps]
        # ABSENCE tier, above every delta (mirrors coverage_signal): a
        # service that logged at baseline but has NO (or zero-line) rows
        # under the fault went silent outright — the strongest kill
        # fingerprint a non-cumulative collector would produce.  Among
        # multiple absences the higher-volume baseline service ranks
        # first (never the sort's alphabetical accident).
        absent = sorted((svc for svc in base if svc not in svc_rates),
                        key=lambda svc: -base[svc][2])
        ranked = absent + ranked
        target = label.target_service
        row = {"experiment": name, "target": target,
               "n_services_aligned": len(deltas),
               "top3": ([{"service": svc, "absent": True}
                         for svc in absent[:3]]
                        + [{"service": svc, "err_delta": round(de, 5),
                            "warn_delta": round(dw, 5),
                            "vol_shift": round(dv, 6)}
                           for de, dw, dv, svc in deltas[:3]])[:3]}
        ds, d1, d3 = _mark_hits(row, target, ranked)
        scored += ds
        hits1 += d1
        hits3 += d3
        out["experiments"].append(row)
    out["scored"] = scored
    out["top1"] = round(hits1 / scored, 3) if scored else None
    out["top3"] = round(hits3 / scored, 3) if scored else None
    out["max_abs_err_delta"] = round(max_delta, 6)
    out["max_abs_vol_shift"] = round(max_vol, 6)
    # hits can ride EITHER channel (the Svc_Kill hits are volume-only),
    # so signal presence must cover both or the record contradicts itself
    out["signal_present"] = max_delta > 1e-12 or max_vol > 1e-12
    return out


def golden_report(cfg: Optional[Config] = None) -> dict:
    """The full committed golden run: census + real-data coverage and
    log-modality detection for both testbeds (coverage trees parsed once
    each)."""
    cfg = cfg or get_config()
    out: dict = {"scan": {}, "coverage_detection": {}, "log_detection": {}}
    for tb in ("SN", "TT"):
        batches = _load_coverage_batches(tb, cfg)
        log_loads = _load_log_summaries(tb, cfg)
        out["scan"][tb] = scan_tree(tb, cfg, coverage_batches=batches,
                                    log_loads=log_loads)
        out["coverage_detection"][tb] = coverage_signal(tb, cfg,
                                                        batches=batches)
        out["log_detection"][tb] = log_signal(tb, cfg, log_loads=log_loads)
    return out


def _provenance_line() -> str:
    """The body's provenance line: where the committed run was generated
    and how to regenerate it, as ``docs/GOLDEN_REPORT.md`` (the document
    this body regenerates) states it on its third line."""
    doc = Path(__file__).resolve().parents[1] / "docs" / "GOLDEN_REPORT.md"
    lines = doc.read_text().splitlines() if doc.is_file() else []
    if len(lines) > 2 and lines[2].startswith("Generated by "):
        return lines[2]
    return ("Generated by `python -m anomod_torch golden --markdown` over "
            "the data root.")


def format_markdown(report: dict) -> str:
    """docs/GOLDEN_REPORT.md body from a report dict."""
    lines: List[str] = [
        "# Golden run over the real reference dataset",
        "",
        _provenance_line(),
        "",
        "## Loadability census (typed loaders, synth fallback disabled)",
        "",
        "The logs column counts experiments whose per-LINE log content "
        "parses (a non-empty LogBatch; zero-line parses of LFS-stub dirs "
        "were miscounted as real in earlier report revisions).  "
        "Summary-level log content (summary.txt error/warn/line counts) "
        "is censused and scored separately in the log-modality section "
        "below: " + "; ".join(
            "{} line-content loads={}, summary loads={}".format(
                tb,
                report["scan"][tb].get("real_loads", {}).get("logs", 0),
                report.get("log_detection", {}).get(tb, {})
                      .get("n_loaded", 0))
            for tb in report.get("scan", {})) + ".",
        "",
    ]
    for tb, scan in report["scan"].items():
        lines += [f"### {tb}_data", "",
                  "| modality dir | files | LFS stubs | real |",
                  "|---|---|---|---|"]
        for sub, c in scan.get("modality_files", {}).items():
            lines.append(f"| {sub} | {c['n_files']} | {c['n_lfs_stubs']} "
                         f"| {c['n_real']} |")
        rl = scan.get("real_loads", {})
        lines += ["",
                  f"{scan.get('n_experiments', 0)} experiments discovered; "
                  f"real (non-stub) loads per modality: "
                  + ", ".join(f"{m}={n}" for m, n in rl.items()) + ".", ""]
    lines += ["## Coverage-modality detection on real artifacts",
              "",
              "Ranking is three-tiered (coverage_signal): (1) a service "
              "present in the baseline but missing from the fault run's "
              "coverage tree outranks everything — a stopped binary "
              "cannot flush its gcov counters, so artifact ABSENCE is "
              "the stop-fault fingerprint; (2) deltas that repeat "
              "identically across other fault experiments are "
              "deterministic pipeline blast and are discounted; (3) two "
              "or more uniquely starved callees triangulate their "
              "shared producer through the call topology.",
              ""]
    for tb, cov in report["coverage_detection"].items():
        lines += [f"### {tb}",
                  "",
                  f"- experiments with loadable real coverage: "
                  f"{cov['n_loaded']}",
                  f"- normal baseline: `{cov.get('normal_baseline')}`",
                  f"- culprit ranking (absence tier + blast-discounted "
                  f"deltas + producer triangulation): "
                  f"top-1 {cov.get('top1')}, top-3 {cov.get('top3')} over "
                  f"{cov.get('scored', 0)} scored faults"
                  + (f"; {cov.get('n_absence_top1_hits', 0)} culprits "
                     f"identified by artifact absence"
                     if cov.get("n_absence_top1_hits") else ""),
                  f"- max |delta| anywhere: {cov.get('max_abs_delta')} "
                  + ("(real per-experiment signal present)"
                     if cov.get("signal_present") else
                     "(the shipped artifacts are IDENTICAL across "
                     "experiments — the modality carries no culprit "
                     "signal in this dataset, which the synthetic "
                     "corpus deliberately does not replicate)"), ""]
        for row in cov.get("experiments", []):
            t3 = ", ".join(
                f"{e['service']} (ABSENT)" if e.get("absent")
                else f"{e['service']} ({e['abs_delta']})"
                for e in row["top3"])
            mark = ("no signal (unscored)" if row.get("no_signal")
                    else "hit" if row.get("top1_hit")
                    else "top3" if row.get("top3_hit") else "miss")
            lines.append(f"- `{row['experiment']}` target "
                         f"`{row['target']}` -> {mark}; largest deltas: "
                         f"{t3}")
        lines.append("")
    lines += ["## Log-modality detection on real artifacts",
              "",
              "Per-service error/warn RATES (errors / lines, the "
              "collect_log.sh:101-137 summary counts normalized by "
              "volume) plus the log-VOLUME shift |ln(lines/baseline)|, "
              "deltas vs the normal baseline.  Ranking is two-tiered: a "
              "service that logged at baseline but has NO countable row "
              "under the fault (summary.txt records no log file) "
              "outranks everything — going silent is the stop/kill "
              "fingerprint — then error-rate delta with warn-rate and "
              "volume as tiebreak channels.",
              ""]
    # the two dataset findings are emitted only when THIS run's rows
    # exhibit them — a regeneration after `git lfs pull` (or against a
    # different checkout) must not carry stale narrative
    sn_rows = report.get("log_detection", {}).get("SN", {}) \
                    .get("experiments", [])
    sink_misses = [r for r in sn_rows
                   if r.get("top1_hit") is False and r["top3"]
                   and r["top3"][0]["service"] == "ComposePostService"
                   and r["top3"][0].get("err_delta", 0) > 0]
    vol_hits = [r for r in sn_rows
                if r.get("top1_hit") and r["top3"]
                and r["top3"][0].get("err_delta", 1) == 0
                and r["top3"][0].get("vol_shift", 0) > 0]
    if vol_hits or sink_misses:
        finding_bits = []
        if vol_hits:
            finding_bits.append(
                "the SN collector gathers the FULL cumulative log history "
                "per experiment (summary.txt header: unbounded time "
                "range), so most services' counts are bit-identical "
                "across experiments and only accumulating effects "
                "register — which also means a lone mover in an "
                "otherwise frozen plane is significant (the "
                f"{len(vol_hits)} volume-only hits below ride a small "
                "volume dip at exactly the killed service)")
        if sink_misses:
            finding_bits.append(
                f"{len(sink_misses)} faults log their errors at "
                "`ComposePostService` — the orchestrator CALLING the "
                "faulted service — so summary-level log evidence "
                "localizes the propagation SINK, one call-graph hop "
                "downstream of the culprit; the per-line log text that "
                "could resolve the hop is LFS-stubbed in the shipped "
                "checkout")
        lines += ["Dataset findings exhibited by this run: "
                  + "; ".join(finding_bits) + ".", ""]
    for tb, lg in report.get("log_detection", {}).items():
        lines += [f"### {tb}",
                  "",
                  f"- experiments with real (non-stub) logs: "
                  f"{lg['n_loaded']}",
                  f"- normal baseline: `{lg.get('normal_baseline')}`",
                  f"- culprit ranking (absence tier + error-rate "
                  f"delta): top-1 {lg.get('top1')}, top-3 "
                  f"{lg.get('top3')} over {lg.get('scored', 0)} "
                  f"scored faults",
                  f"- max |err-rate delta| anywhere: "
                  f"{lg.get('max_abs_err_delta')}", ""]
        for row in lg.get("experiments", []):
            t3 = ", ".join(
                f"{e['service']} (ABSENT)" if e.get("absent")
                else f"{e['service']} (err {e['err_delta']}, "
                     f"vol {e['vol_shift']})" for e in row["top3"])
            mark = ("no signal (unscored)" if row.get("no_signal")
                    else "hit" if row.get("top1_hit")
                    else "top3" if row.get("top3_hit") else "miss")
            lines.append(f"- `{row['experiment']}` target "
                         f"`{row['target']}` -> {mark}; largest deltas: "
                         f"{t3}")
        lines.append("")
    return "\n".join(lines)
