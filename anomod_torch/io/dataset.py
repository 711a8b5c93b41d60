"""Dataset discovery + experiment loading with synthetic fallback
(counterpart of ``anomod/io/dataset.py``).

Archive layout (SURVEY.md §2.3 / L7):
  SN_data/{log,metric,trace,coverage}_data + api_responses, experiment dirs
  named ``<Exp>_<YYYYMMDD_HHMMSS>_<modality>_<...>`` (collect_all_data.sh:207-211).
  TT_data/{log,metric,trace,api_responses,coverage_data,coverage_report}
  with dirs named ``<Lv_*|Normal_case>_<ISO8601>_em`` (T-Dataset/README.md:9-17).

Every payload that is a git-LFS pointer stub falls back to the deterministic
synthetic generator (config.synth_on_lfs), keeping the full 2x13-experiment
corpus loadable without the archive.

Ingest fast path (anomod_torch.io.cache): every parsed or synth-generated modality
is read through the content-addressed cache — keyed by loader version +
source-file stat fingerprint (parsed) or generator version + label + seed +
n_traces (synth) — so warm loads skip CSV/JSON/gcov parsing and synth
regeneration entirely.  ``load_corpus`` additionally fans experiments across
a spawn-context process pool (``Config.ingest_workers`` / the
``workers`` argument); the serial path is kept and parity-tested.  The
settings come from :mod:`anomod_torch.config`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from anomod_torch import labels as labels_mod
from anomod_torch import synth
from anomod_torch.config import Config
from anomod_torch.config import get_config
from anomod_torch.io import api as api_io
from anomod_torch.io import cache
from anomod_torch.io import coverage as cov_io
from anomod_torch.io import logs as logs_io
from anomod_torch.io import metrics as met_io
from anomod_torch.io import sn_traces, tt_traces
from anomod_torch.schemas import Experiment, SpanBatch, concat_span_batches

_SN_MODALITY_DIRS = {
    "traces": "trace_data", "metrics": "metric_data", "logs": "log_data",
    "api": "api_responses", "coverage": "coverage_data",
}
_TT_MODALITY_DIRS = {
    "traces": "trace_data", "metrics": "metric_data", "logs": "log_data",
    "api": "api_responses", "coverage": "coverage_report",
}

MODALITIES = ("traces", "metrics", "logs", "api", "coverage")


@dataclasses.dataclass
class ExperimentDirs:
    name: str                      # canonical experiment name
    testbed: str
    dirs: Dict[str, Path]          # modality -> experiment dir


def discover(testbed: str, cfg: Optional[Config] = None) -> List[ExperimentDirs]:
    """Walk the archive tree, grouping modality dirs by canonical experiment."""
    cfg = cfg or get_config()
    root = cfg.sn_data if testbed == "SN" else cfg.tt_data
    if root is None:
        return []
    modality_dirs = _SN_MODALITY_DIRS if testbed == "SN" else _TT_MODALITY_DIRS
    found: Dict[str, ExperimentDirs] = {}
    for modality, sub in modality_dirs.items():
        base = root / sub
        if not base.is_dir():
            continue
        for d in sorted(base.iterdir()):
            if not d.is_dir():
                continue
            canon = labels_mod.canonical_experiment(d.name)
            if labels_mod.label_for(canon) is None:
                continue
            ed = found.setdefault(canon, ExperimentDirs(canon, testbed, {}))
            ed.dirs.setdefault(modality, d)
    return list(found.values())


def loader_version(modality: str, testbed: str) -> int:
    """The owning loader module's LOADER_VERSION — part of the cache key, so
    bumping one loader invalidates exactly its modality's entries."""
    if modality == "traces":
        mod = tt_traces if testbed == "TT" else sn_traces
    else:
        mod = {"metrics": met_io, "logs": logs_io, "api": api_io,
               "coverage": cov_io}[modality]
    return mod.LOADER_VERSION


def _parse_modality(modality: str, testbed: str, d: Path):
    """Run the raw (uncached) loader for one modality dir.

    Value conventions: ``logs`` yields the ``(LogBatch|None, summaries)``
    pair; every other modality yields its batch or None.
    """
    if modality == "traces":
        if testbed == "TT":
            art = tt_traces.find_trace_artifact(d)
            return tt_traces.load_skywalking_json(art) if art else None
        art = sn_traces.find_trace_artifact(d)
        if art and art.suffix == ".json":
            return sn_traces.load_jaeger_json(art)
        return sn_traces.load_jaeger_csv(art) if art else None
    if modality == "metrics":
        if testbed == "TT":
            art = met_io.find_tt_metric_artifact(d)
            return met_io.load_tt_metric_csv(art) if art else None
        return met_io.load_sn_metric_dir(d)
    if modality == "logs":
        loader = (logs_io.load_tt_log_dir if testbed == "TT"
                  else logs_io.load_sn_log_dir)
        return loader(d)
    if modality == "api":
        art = api_io.find_api_artifact(d)
        return api_io.load_api_jsonl(art) if art else None
    if modality == "coverage":
        loader = (cov_io.load_tt_coverage_report if testbed == "TT"
                  else cov_io.load_sn_coverage_dir)
        return loader(d)
    raise ValueError(f"unknown modality {modality!r}")


def _synth_modality(modality: str, label, n_synth_traces: int):
    if modality == "traces":
        return synth.generate_spans(label, n_traces=n_synth_traces)
    if modality == "metrics":
        return synth.generate_metrics(label)
    if modality == "logs":
        return synth.generate_logs(label)
    if modality == "api":
        return synth.generate_api(label)
    if modality == "coverage":
        return synth.generate_coverage(label)
    raise ValueError(f"unknown modality {modality!r}")


def _cache_kind(modality: str) -> str:
    return {"traces": "spans", "metrics": "metrics", "logs": "logs",
            "api": "api", "coverage": "coverage"}[modality]


def synth_key_parts(modality: str, label, n_synth_traces: int,
                    cfg: Config) -> dict:
    """Cache key parts for a synth-fallback modality: generator version +
    label (+ n_traces for the trace generator).  The generators derive
    their seeds from the label name alone (synth._seed_for), so no config
    seed belongs in the key — it would only manufacture spurious misses."""
    parts = {
        "source": "synth",
        "synth_version": synth.SYNTH_VERSION,
        "modality": modality,
        "testbed": label.testbed,
        "experiment": label.experiment,
    }
    if modality == "traces":
        parts["n_traces"] = n_synth_traces
    return parts


def _source_key_parts(modality: str, testbed: str, experiment: str,
                      d: Path) -> dict:
    return {
        "source": "parse",
        "loader_version": loader_version(modality, testbed),
        "modality": modality,
        "testbed": testbed,
        "experiment": experiment,
        "fingerprint": cache.dir_fingerprint(d),
    }


def _modality_present(modality: str, value) -> bool:
    if modality == "logs":
        return value is not None and value[0] is not None
    return value is not None


def _load_modality(modality: str, label, testbed: str, d: Optional[Path],
                   n_synth_traces: int, cfg: Config):
    """One modality through the cache: parse path first, synth fallback.

    Returns ``(value, synthetic)`` with the logs pair convention.  Parsed
    results that come back empty are not cached (the parse was cheap);
    partial logs results (real summaries, no lines) ARE cached.
    """
    value = None
    caching = cache.cache_root(cfg) is not None
    if d is not None:
        if caching:
            def cacheable(v):
                if modality == "logs":
                    return v is not None and (v[0] is not None
                                              or (v[1] or None) is not None)
                return v is not None
            value, _, _ = cache.cached(
                _cache_kind(modality),
                _source_key_parts(modality, testbed, label.experiment, d),
                lambda: _parse_modality(modality, testbed, d),
                cfg=cfg, cacheable=cacheable)
        else:
            # no cache root: don't pay the source-fingerprint dir walk
            # for a key nobody will use
            value = _parse_modality(modality, testbed, d)
    if modality == "logs" and value is None:
        value = (None, None)
    if _modality_present(modality, value) or not cfg.synth_on_lfs:
        return value, False
    syn, _, _ = cache.cached(
        _cache_kind(modality),
        synth_key_parts(modality, label, n_synth_traces, cfg),
        lambda: _synth_modality(modality, label, n_synth_traces),
        cfg=cfg)
    if modality == "logs":
        # keep real summaries when only the line payloads were stubs
        syn_batch, syn_sum = syn
        real_sum = value[1]
        return (syn_batch, real_sum if real_sum else syn_sum), True
    return syn, True


def load_experiment(name: str, testbed: Optional[str] = None,
                    cfg: Optional[Config] = None,
                    modalities: Optional[List[str]] = None,
                    n_synth_traces: int = 200) -> Experiment:
    """Load one experiment's modalities; synth-fill anything unavailable."""
    cfg = cfg or get_config()
    label = labels_mod.label_for(name)
    if label is None:
        raise KeyError(f"unknown experiment: {name}")
    testbed = testbed or label.testbed
    modalities = modalities or list(MODALITIES)
    dirs = {e.name: e for e in discover(testbed, cfg)}.get(label.experiment)
    exp = Experiment(name=label.experiment, testbed=testbed)
    any_synth = False

    d = dirs.dirs if dirs else {}
    for modality in modalities:
        value, syn = _load_modality(modality, label, testbed,
                                    d.get(modality), n_synth_traces, cfg)
        any_synth = any_synth or syn
        if modality == "traces":
            exp.spans = value
        elif modality == "metrics":
            exp.metrics = value
        elif modality == "logs":
            exp.logs, exp.log_summaries = value
        elif modality == "api":
            exp.api = value
        elif modality == "coverage":
            exp.coverage = value

    exp.synthetic = any_synth
    return exp


def _load_experiment_task(name: str, testbed: str, cfg: Config,
                          modalities: Optional[List[str]],
                          n_synth_traces: int):
    """Top-level (picklable) worker entry for the process-pool loader.

    Ships the worker's cache-counter snapshot home with the Experiment —
    the spawn child's module globals never propagate back on their own,
    and an all-zero report would defeat the hit/miss honesty signal."""
    cache.reset_stats()
    exp = load_experiment(name, testbed, cfg, modalities, n_synth_traces)
    return exp, cache.stats().to_dict()


def load_corpus(testbed: str, cfg: Optional[Config] = None,
                modalities: Optional[List[str]] = None,
                n_synth_traces: int = 200,
                workers: Optional[int] = None) -> List[Experiment]:
    """All 13 experiments of a testbed (12 faults + normal).

    ``workers`` (default ``Config.ingest_workers``; 0/1 = serial) fans
    the per-experiment loads across a spawn-context process pool — spawn,
    not fork, because the parent may hold an initialized CUDA context and
    the loaders only need numpy.  Cache writes from workers are safe: entries
    publish atomically and collisions are identical by construction.
    """
    cfg = cfg or get_config()
    names = [l.experiment for l in labels_mod.labels_for_testbed(testbed)]
    if workers is None:
        workers = cfg.ingest_workers
    if workers and workers > 1 and len(names) > 1:
        import multiprocessing
        import time
        from concurrent.futures import ProcessPoolExecutor

        from anomod_torch import obs
        depth = obs.gauge("anomod_ingest_pool_pending")
        wall = obs.histogram("anomod_ingest_pool_experiment_seconds")
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, len(names)),
                                 mp_context=ctx) as pool:
            t0 = time.perf_counter()

            def done(_f):
                # submit-to-result wall and pending depth, recorded at
                # completion (the executor's callback thread), so a fast
                # experiment behind a slow one keeps its own wall
                wall.observe(time.perf_counter() - t0)
                depth.dec()

            futs = []
            for n in names:
                depth.inc()        # before submit: a dec never races it
                f = pool.submit(_load_experiment_task, n, testbed, cfg,
                                modalities, n_synth_traces)
                f.add_done_callback(done)
                futs.append(f)
            out = []
            for f in futs:
                exp, worker_stats = f.result()
                cache.merge_stats(worker_stats)
                out.append(exp)
            return out
    return [load_experiment(n, testbed, cfg, modalities, n_synth_traces)
            for n in names]


# ---------------------------------------------------------------------------
# The bench replay corpus, read through the cache at the CONCATENATED
# level: one entry per (testbed, n_traces), so the warm path is a single
# bulk columnar read with no per-label re-intern concat.
# ---------------------------------------------------------------------------

def bench_corpus_key_parts(testbed: str, n_traces: int) -> dict:
    return {
        "source": "synth-corpus",
        "synth_version": synth.SYNTH_VERSION,
        "testbed": testbed,
        "n_traces": n_traces,
        "experiments": [l.experiment
                        for l in labels_mod.labels_for_testbed(testbed)],
    }


def load_bench_corpus(testbed: str, n_traces: int,
                      cfg: Optional[Config] = None) -> SpanBatch:
    """The concatenated replay corpus: ``synth.generate_spans`` over every
    label of ``testbed`` (13 experiments), ``n_traces`` traces each, read
    through the cache."""
    def compute():
        return concat_span_batches(
            [synth.generate_spans(l, n_traces=n_traces)
             for l in labels_mod.labels_for_testbed(testbed)])

    batch, _, _ = cache.cached(
        "spans", bench_corpus_key_parts(testbed, n_traces), compute,
        cfg=cfg or get_config())
    return batch


def bench_cache_status(testbed: str, n_traces: int,
                       cfg: Optional[Config] = None) -> Tuple[int, int]:
    """(present, total) bench-corpus cache entries, without loading
    anything."""
    root = cache.cache_root(cfg or get_config())
    if root is None:
        return 0, 1
    key = cache.full_key("spans", bench_corpus_key_parts(testbed, n_traces))
    return (1 if cache.entry_paths(root, key)[0].is_file() else 0), 1
