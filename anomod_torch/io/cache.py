"""Content-addressed on-disk ingest cache for parsed modal batches
(counterpart of ``anomod/io/cache.py``: the same key recipe, payload
layout and publish order, so a key the two packages compute for the same
parts is the same key).

Every parsed (or synth-generated) modality of an experiment is cached as a
columnar entry — one flat ``.npc`` payload (JSON header + raw C-order
column bytes; one open, one bulk read, zero-copy ``np.frombuffer`` column
views) plus a ``.json`` sidecar holding the key parts, versions, and the
recorded cold parse wall — so a warm ``load_corpus`` is a handful of
columnar reads instead of CSV/JSON/gcov parsing or synth regeneration.

Key contract (what addresses an entry):
  - ``CACHE_FORMAT_VERSION`` (this module's serialization layout),
  - the owning loader's ``LOADER_VERSION`` (per io module — bumping a
    loader invalidates exactly its modality) or ``synth.SYNTH_VERSION``
    for generator-produced fallbacks,
  - the modality kind + testbed + canonical experiment name,
  - for file-backed loads: the source fingerprint — sorted
    ``(relpath, size, mtime_ns)`` of every file under the modality dir,
    so any artifact change or addition invalidates the entry,
  - for synth fallbacks: ``n_traces`` (trace generator only) — every
    generator derives its seed from the label name, so label + version
    fully determines the output.

Crash/concurrency safety: each file is
written to a same-directory temp name and atomically published with
``os.replace``, npz first and the json sidecar LAST — a reader that sees
the sidecar sees a complete entry, and a torn/corrupt entry is treated as a
miss (re-parse), never an error.

The hit/miss/store/error counts live in this module's :class:`CacheStats`
(:func:`stats`, :func:`reset_stats`, :func:`merge_stats`), each event
mirrored into the process registry as ``anomod_ingest_cache_{event}_total``
beside ``anomod_ingest_cache_read_bytes_total`` / ``_written_bytes_total``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from anomod_torch import obs
from anomod_torch.schemas import (ApiBatch, CoverageBatch, LogBatch,
                                  LogSummary, MetricBatch, SpanBatch)

#: Bump to invalidate every entry (serialization layout change).
CACHE_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Hit/miss accounting.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    errors: int = 0      # corrupt/torn entries dropped back to a re-parse

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_STATS = CacheStats()


def _count(event: str, n: int = 1) -> None:
    """Bump the process CacheStats counter AND its registry mirror (one
    call site per event, so the two views never drift)."""
    setattr(_STATS, event, getattr(_STATS, event) + n)
    obs.counter(f"anomod_ingest_cache_{event}_total").inc(n)


def stats() -> CacheStats:
    return _STATS


def reset_stats() -> None:
    global _STATS
    _STATS = CacheStats()


def merge_stats(other: dict) -> None:
    """Fold a worker process's counter snapshot into this process's stats
    (the spawn-pool loader's globals never propagate back on their own)."""
    for k, v in other.items():
        if hasattr(_STATS, k):
            _count(k, int(v))


# ---------------------------------------------------------------------------
# Keys and fingerprints
# ---------------------------------------------------------------------------

def cache_key(parts: Dict[str, Any]) -> str:
    """Content address: sha256 over the canonical JSON of the key parts."""
    blob = json.dumps(parts, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def full_key(kind: str, key_parts: Dict[str, Any]) -> str:
    """The ONE composition of caller key parts + kind + format version —
    shared by :func:`cached` and presence probes (the pre-bench gate), so
    the two can never desync on the key recipe."""
    return cache_key({**key_parts, "kind": kind,
                      "cache_format_version": CACHE_FORMAT_VERSION})


def dir_fingerprint(path: Path, max_files: int = 4096) -> List[Any]:
    """Sorted (relpath, size, mtime_ns) of every file under ``path``.

    The stat fingerprint is the cache's change detector: any edit, addition
    or removal of a source artifact changes the key.  Stat calls are
    bounded so a pathological tree cannot turn key computation into the
    slow path — but the TOTAL file count is always appended, so adding or
    removing files beyond the stat cap still changes the key instead of
    silently serving stale data.
    """
    path = Path(path)
    out: List[Any] = []
    n_files = 0
    try:
        for p in sorted(path.rglob("*")):
            if not p.is_file():
                continue
            n_files += 1
            if len(out) < max_files:
                st = p.stat()
                out.append([str(p.relative_to(path)), st.st_size,
                            st.st_mtime_ns])
    except OSError:
        pass
    out.append(["__n_files__", n_files])
    return out


def cache_root(cfg=None) -> Optional[Path]:
    """The configured cache directory, or None when caching is disabled."""
    if cfg is None:
        from anomod_torch.config import get_config
        cfg = get_config()
    root = getattr(cfg, "cache_dir", None)
    return Path(root) if root else None


def entry_paths(root: Path, key: str) -> Tuple[Path, Path]:
    """(payload, json-sidecar) paths for a key, sharded by first hex byte."""
    d = Path(root) / key[:2]
    return d / f"{key}.npc", d / f"{key}.json"


# ---------------------------------------------------------------------------
# Per-kind encode/decode.  Arrays (including unicode string tables) go into
# the npz; only metadata lives in the sidecar.  ``None`` inside composite
# values (the logs (batch, summaries) pair) is encoded explicitly.
# ---------------------------------------------------------------------------

def _strs(values) -> np.ndarray:
    return np.asarray(list(values), dtype=np.str_)


def _encode(kind: str, value) -> Tuple[Dict[str, np.ndarray], dict]:
    if kind == "spans":
        b: SpanBatch = value
        arrays = {f: getattr(b, f) for f in
                  ("trace", "parent", "service", "endpoint", "start_us",
                   "duration_us", "is_error", "status", "kind")}
        arrays.update(tbl_services=_strs(b.services),
                      tbl_endpoints=_strs(b.endpoints),
                      tbl_trace_ids=_strs(b.trace_ids))
        return arrays, {}
    if kind == "metrics":
        m: MetricBatch = value
        arrays = {"metric": m.metric, "series": m.series, "t_s": m.t_s,
                  "value": m.value, "series_service": m.series_service,
                  "tbl_metric_names": _strs(m.metric_names),
                  "tbl_series_keys": _strs(m.series_keys),
                  "tbl_services": _strs(m.services)}
        return arrays, {}
    if kind == "logs":
        batch, summaries = value
        arrays: Dict[str, np.ndarray] = {}
        meta: dict = {"has_batch": batch is not None,
                      "summaries": None}
        if batch is not None:
            arrays = {"service": batch.service, "t_s": batch.t_s,
                      "level": batch.level,
                      "tbl_services": _strs(batch.services)}
        if summaries is not None:
            meta["summaries"] = [dataclasses.asdict(s) for s in summaries]
        return arrays, meta
    if kind == "api":
        a: ApiBatch = value
        arrays = {"endpoint": a.endpoint, "t_s": a.t_s, "status": a.status,
                  "latency_ms": a.latency_ms,
                  "content_length": a.content_length,
                  "tbl_endpoints": _strs(a.endpoints)}
        return arrays, {}
    if kind == "coverage":
        c: CoverageBatch = value
        arrays = {"service": c.service, "lines_total": c.lines_total,
                  "lines_covered": c.lines_covered,
                  "tbl_services": _strs(c.services),
                  "tbl_paths": _strs(c.paths)}
        return arrays, {}
    raise ValueError(f"unknown cache kind {kind!r}")


def _decode(kind: str, arrays: Dict[str, np.ndarray], meta: dict):
    def tbl(name):
        return tuple(arrays[name].tolist()) if name in arrays else ()
    if kind == "spans":
        return SpanBatch(
            trace=arrays["trace"], parent=arrays["parent"],
            service=arrays["service"], endpoint=arrays["endpoint"],
            start_us=arrays["start_us"], duration_us=arrays["duration_us"],
            is_error=arrays["is_error"], status=arrays["status"],
            kind=arrays["kind"],
            services=tbl("tbl_services"), endpoints=tbl("tbl_endpoints"),
            trace_ids=tbl("tbl_trace_ids"))
    if kind == "metrics":
        return MetricBatch(
            metric=arrays["metric"], series=arrays["series"],
            t_s=arrays["t_s"], value=arrays["value"],
            metric_names=tbl("tbl_metric_names"),
            series_keys=tbl("tbl_series_keys"),
            series_service=arrays["series_service"],
            services=tbl("tbl_services"))
    if kind == "logs":
        batch = None
        if meta.get("has_batch"):
            batch = LogBatch(service=arrays["service"], t_s=arrays["t_s"],
                             level=arrays["level"],
                             services=tbl("tbl_services"))
        summaries = meta.get("summaries")
        if summaries is not None:
            summaries = [LogSummary(**s) for s in summaries]
        return batch, summaries
    if kind == "api":
        return ApiBatch(
            endpoint=arrays["endpoint"], t_s=arrays["t_s"],
            status=arrays["status"], latency_ms=arrays["latency_ms"],
            content_length=arrays["content_length"],
            endpoints=tbl("tbl_endpoints"))
    if kind == "coverage":
        return CoverageBatch(
            service=arrays["service"], lines_total=arrays["lines_total"],
            lines_covered=arrays["lines_covered"],
            services=tbl("tbl_services"), paths=tbl("tbl_paths"))
    raise ValueError(f"unknown cache kind {kind!r}")


# ---------------------------------------------------------------------------
# Store / load with atomic publish.
#
# Payload layout (``.npc`` — "numpy columns"): the zip/CRC/per-array-header
# machinery of a real ``.npz`` costs milliseconds PER ENTRY on this class of
# filesystem (many tiny reads + ast-parsed headers), which would eat the
# warm-path win.  Instead: one flat file = magic + length-prefixed JSON
# header (entry meta + per-column dtype/shape/offset) + the raw C-order
# column bytes.  A warm read is ONE open + ONE bulk read; columns are
# zero-copy ``np.frombuffer`` views over the (writable) bytearray.
# ---------------------------------------------------------------------------

_MAGIC = b"ANOMODC1"


def _atomic_publish(path: Path, writer: Callable[[Any], None],
                    mode: str = "wb") -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, mode) as f:
        writer(f)
    os.replace(tmp, path)


def _write_payload(f, arrays: Dict[str, np.ndarray], meta: dict) -> None:
    cols = []
    offset = 0
    contig = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        contig[name] = a
        cols.append({"name": name, "dtype": a.dtype.str,
                     "shape": list(a.shape), "offset": offset,
                     "nbytes": a.nbytes})
        offset += a.nbytes
    header = json.dumps({"meta": meta, "columns": cols},
                        sort_keys=True).encode()
    f.write(_MAGIC)
    f.write(len(header).to_bytes(8, "little"))
    f.write(header)
    for name in arrays:
        f.write(contig[name].tobytes())


def _read_payload(data: bytes):
    """(arrays, meta) from payload bytes; raises on any corruption."""
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("bad magic")
    n = int.from_bytes(data[len(_MAGIC):len(_MAGIC) + 8], "little")
    body_at = len(_MAGIC) + 8
    doc = json.loads(data[body_at:body_at + n].decode())
    base = body_at + n
    buf = memoryview(data)
    arrays: Dict[str, np.ndarray] = {}
    for col in doc["columns"]:
        lo = base + col["offset"]
        hi = lo + col["nbytes"]
        if hi > len(data):
            raise ValueError("truncated payload")
        arrays[col["name"]] = np.frombuffer(
            buf[lo:hi], dtype=np.dtype(col["dtype"])
        ).reshape(col["shape"])
    return arrays, doc["meta"]


def store(root: Path, key: str, kind: str, value,
          extra_meta: Optional[dict] = None) -> bool:
    """Publish an entry; returns False (never raises) on filesystem refusal."""
    payload_path, json_path = entry_paths(root, key)
    try:
        payload_path.parent.mkdir(parents=True, exist_ok=True)
        arrays, meta = _encode(kind, value)
        meta.update(extra_meta or {})
        meta.update(key=key, kind=kind,
                    cache_format_version=CACHE_FORMAT_VERSION)
        # payload first, sidecar last;
        # both atomic, so a reader never sees a torn file — the sidecar is
        # the human-readable provenance view (key parts, parse wall) and
        # the pre-bench gate's presence marker, never the hot read path
        _atomic_publish(payload_path,
                        lambda f: _write_payload(f, arrays, meta))
        _atomic_publish(json_path,
                        lambda f: json.dump(meta, f, sort_keys=True),
                        mode="w")
        _count("stores")
        obs.counter("anomod_ingest_cache_written_bytes_total").inc(
            sum(int(a.nbytes) for a in arrays.values()))
        return True
    except OSError:
        return False


def load(root: Path, key: str, kind: str):
    """Return ``(value, meta)`` on a hit, None on miss/corrupt.

    A torn or corrupt entry (missing payload, truncated columns, wrong key
    in the header) counts as a miss — the caller re-parses and
    re-publishes.  Columns come back as writable views over one bytearray.
    """
    payload_path, _ = entry_paths(root, key)
    try:
        with open(payload_path, "rb") as f:
            data = bytearray(f.read())
    except OSError:
        return None
    obs.counter("anomod_ingest_cache_read_bytes_total").inc(len(data))
    try:
        arrays, meta = _read_payload(data)
        if (meta.get("key") != key or meta.get("kind") != kind
                or meta.get("cache_format_version") != CACHE_FORMAT_VERSION):
            _count("errors")
            return None
        return _decode(kind, arrays, meta), meta
    except Exception:
        _count("errors")
        return None


def cached(kind: str, key_parts: Dict[str, Any],
           compute: Callable[[], Any], cfg=None,
           cacheable: Callable[[Any], bool] = lambda v: v is not None):
    """The one read-through entry point: ``(value, hit, meta)``.

    On a miss, ``compute()`` runs and — when ``cacheable(value)`` — the
    result is published together with the measured cold parse wall
    (``meta["parse_s"]``), which warm hits then report back for honest
    cold-number accounting.
    """
    root = cache_root(cfg)
    key = full_key(kind, key_parts)
    if root is not None:
        got = load(root, key, kind)
        if got is not None:
            _count("hits")
            return got[0], True, got[1]
        _count("misses")
    t0 = time.perf_counter()
    value = compute()
    parse_s = time.perf_counter() - t0
    meta = {"parse_s": parse_s}
    if root is not None and cacheable(value):
        store(root, key, kind, value, extra_meta=meta)
    return value, False, meta


def entry_count(root: Optional[Path]) -> int:
    """Number of published entries under a cache root (0 when disabled)."""
    if not root or not Path(root).is_dir():
        return 0
    return sum(1 for _ in Path(root).glob("*/*.json"))


def clear(root: Optional[Path]) -> int:
    """Delete every entry; returns the number of files removed."""
    if not root or not Path(root).is_dir():
        return 0
    n = 0
    for p in list(Path(root).glob("*/*")):
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n
