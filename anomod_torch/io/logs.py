"""Log loaders → LogBatch / LogSummary (counterpart of
``anomod/io/logs.py``): line scans and file summaries through the C++
scanners of :mod:`anomod_torch.io.native` unless ``ANOMOD_NATIVE=off``,
the Python loops below being their oracle.

SN layout: ``<exp>/<Service>_<ts>.log`` + ``summary.txt`` with per-service
line/error/warn counts (collect_log.sh:101-137; the shipped dataset's summary
uses an older localized format — parsed tolerantly by regex).

TT layout: ``<exp>/<pod>/<pod>_<ts>.log`` (+ ``_previous_``),
``kubernetes_events_*.json``, ``log_collection_report_*.json``
(log_collector.py:66-123,179-200).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch.io.lfs import read_text_or_none
from anomod_torch.schemas import (LOG_ERROR, LOG_INFO, LOG_OTHER, LOG_WARN,
                                  LogBatch, LogSummary)

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the log entries.
LOADER_VERSION = 1

# "- ComposePostService: 124K (1001行) - 错误: 200, ..." or
# "- ComposePostService: 124K (1001 lines) | errors=200, warnings=0, ..."
_SUMMARY_LINE = re.compile(
    r"^-\s*(?P<svc>[\w.-]+):\s*(?P<size>[\d.]+[KMG]?)\s*\((?P<lines>\d+)")
_NUM = re.compile(r"(\d+)")

_SIZE_MULT = {"K": 1024, "M": 1024**2, "G": 1024**3}


def _parse_size(s: str) -> int:
    if s and s[-1] in _SIZE_MULT:
        return int(float(s[:-1]) * _SIZE_MULT[s[-1]])
    try:
        return int(float(s))
    except ValueError:
        return 0


def parse_sn_summary(text: str) -> List[LogSummary]:
    """Parse SN summary.txt (tolerant of the localized legacy format)."""
    out = []
    for line in text.splitlines():
        m = _SUMMARY_LINE.match(line.strip())
        if not m:
            continue
        # error/warn counts: first two integers after the line count
        rest = line[m.end():]
        nums = [int(x) for x in _NUM.findall(rest)]
        out.append(LogSummary(
            service=m.group("svc"), n_lines=int(m.group("lines")),
            n_error=nums[0] if nums else 0,
            n_warn=nums[1] if len(nums) > 1 else 0,
            size_bytes=_parse_size(m.group("size"))))
    return out


# substring + case-insensitive, matching the reference's `grep -c -i error`
# semantics (collect_log.sh:104-106); "exception" added for Java stacks
_LEVEL_PAT = [
    (re.compile(r"error|exception", re.I), LOG_ERROR),
    (re.compile(r"warn", re.I), LOG_WARN),
    (re.compile(r"info", re.I), LOG_INFO),
]
# ISO-ish timestamp prefix e.g. "2025-11-03 22:02:28" or "2025-11-03T22:02:28"
_TS_PAT = re.compile(r"(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2}):(\d{2})")


def parse_log_lines(text: str, service_idx: int,
                    default_t: float = 0.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Line-level classification, reproducing the reference's grep -c -i
    info/warn/error counting (collect_log.sh:104-106).

    Through the C++ scanner unless ``ANOMOD_NATIVE=off``; there a line
    ends at ``\\n`` only and a timestamp the scan reads as 0 (none, or
    the epoch itself) becomes ``default_t``, as in the JAX package's
    native route.  The Python loop below is the oracle."""
    from anomod_torch.io import native
    if native.enabled():
        lvl, t = native.scan_log(text.encode("utf-8", errors="replace"))
        t = np.where(t == 0.0, default_t, t)
        svc = np.full(lvl.shape[0], service_idx, np.int32)
        return svc, t, lvl.astype(np.int8)
    import calendar
    lines = text.splitlines()
    n = len(lines)
    svc = np.full(n, service_idx, np.int32)
    t = np.full(n, default_t, np.float64)
    lvl = np.full(n, LOG_OTHER, np.int8)
    for i, line in enumerate(lines):
        m = _TS_PAT.search(line[:64])
        if m:
            y, mo, d, h, mi, s = map(int, m.groups())
            t[i] = calendar.timegm((y, mo, d, h, mi, s, 0, 0, 0))
        for pat, code in _LEVEL_PAT:
            if pat.search(line):
                lvl[i] = code
                break
    return svc, t, lvl


def summarize_log_files(paths: List[Path],
                        service_of=lambda p: Path(p).stem.rsplit("_", 1)[0]
                        ) -> List[LogSummary]:
    """Per-file log summaries without building a LogBatch — the sweep of
    collect_log.sh:101-137 over an arbitrary file list.

    Unless ``ANOMOD_NATIVE=off``, one call into the C++ pool, a file a
    task: an unreadable file gets zeros, an LFS pointer is summarized as
    the text it is.  The Python loop below is the oracle (zeros for a
    pointer)."""
    from anomod_torch.io import native
    paths = [Path(p) for p in paths]
    if native.enabled():
        res = native.summarize_log_files(paths)
        if res is not None:
            counts, _ts = res
            return [LogSummary(service=service_of(p), n_lines=int(c[0]),
                               n_error=int(c[3]), n_warn=int(c[2]),
                               n_info=int(c[1]), size_bytes=int(c[4]))
                    for p, c in zip(paths, counts)]
    out = []
    for p in paths:
        text = read_text_or_none(p)
        if text is None:
            out.append(LogSummary(service=service_of(p), n_lines=0,
                                  n_error=0, n_warn=0, n_info=0,
                                  size_bytes=0))
            continue
        _, _, lvl = parse_log_lines(text, 0)
        out.append(LogSummary(
            service=service_of(p), n_lines=len(lvl),
            n_error=int((lvl == LOG_ERROR).sum()),
            n_warn=int((lvl == LOG_WARN).sum()),
            n_info=int((lvl == LOG_INFO).sum()),
            size_bytes=p.stat().st_size))
    return out


def load_sn_log_dir(exp_dir: Path) -> Tuple[Optional[LogBatch], Optional[List[LogSummary]]]:
    exp_dir = Path(exp_dir)
    summaries = None
    stext = read_text_or_none(exp_dir / "summary.txt")
    if stext:
        summaries = parse_sn_summary(stext)
    services: Dict[str, int] = {}
    svc_col, t_col, lvl_col = [], [], []
    derived: List[LogSummary] = []
    for p in sorted(exp_dir.glob("*.log")):
        text = read_text_or_none(p)
        if text is None:
            continue
        svc_name = p.stem.rsplit("_", 1)[0]
        s_idx = services.setdefault(svc_name, len(services))
        svc, t, lvl = parse_log_lines(text, s_idx)
        svc_col.append(svc); t_col.append(t); lvl_col.append(lvl)
        derived.append(LogSummary(
            service=svc_name, n_lines=len(lvl),
            n_error=int((lvl == LOG_ERROR).sum()),
            n_warn=int((lvl == LOG_WARN).sum()),
            n_info=int((lvl == LOG_INFO).sum()),
            size_bytes=p.stat().st_size))
    if summaries is None and derived:
        # no (or stub) summary.txt: regenerate it from the already-parsed
        # lines, the way collect_log.sh:113-137 derives it at collection time
        summaries = derived
    batch = None
    if svc_col:
        batch = LogBatch(service=np.concatenate(svc_col),
                         t_s=np.concatenate(t_col),
                         level=np.concatenate(lvl_col),
                         services=tuple(services))
    return batch, summaries


_POD_HASH = re.compile(r"(-(?=[a-z0-9]*\d)[a-z0-9]{4,10}){1,2}$|-\d+$")


def pod_to_service(pod: str) -> str:
    """ts-order-service-86d6f7876-99bhf -> ts-order-service (log_collector.py:38-47)."""
    return _POD_HASH.sub("", pod)


def load_tt_log_dir(exp_dir: Path) -> Tuple[Optional[LogBatch], Optional[List[LogSummary]]]:
    exp_dir = Path(exp_dir)
    services: Dict[str, int] = {}
    svc_col, t_col, lvl_col = [], [], []
    summaries: List[LogSummary] = []
    for pod_dir in sorted(p for p in exp_dir.iterdir() if p.is_dir()):
        svc_name = pod_to_service(pod_dir.name)
        s_idx = services.setdefault(svc_name, len(services))
        for logf in sorted(pod_dir.glob("*.log")):
            if "_previous_" in logf.name:
                continue
            text = read_text_or_none(logf)
            if text is None:
                continue
            svc, t, lvl = parse_log_lines(text, s_idx)
            svc_col.append(svc); t_col.append(t); lvl_col.append(lvl)
            summaries.append(LogSummary(
                service=svc_name, n_lines=len(t),
                n_error=int((lvl == LOG_ERROR).sum()),
                n_warn=int((lvl == LOG_WARN).sum()),
                n_info=int((lvl == LOG_INFO).sum()),
                size_bytes=logf.stat().st_size))
    batch = None
    if svc_col:
        batch = LogBatch(service=np.concatenate(svc_col),
                         t_s=np.concatenate(t_col),
                         level=np.concatenate(lvl_col),
                         services=tuple(services))
    return batch, summaries or None


def load_tt_events(exp_dir: Path) -> Optional[list]:
    """kubernetes_events_*.json (log_collector.py:121-123)."""
    for p in sorted(Path(exp_dir).glob("kubernetes_events_*.json")):
        text = read_text_or_none(p)
        if text:
            try:
                doc = json.loads(text)
                return doc.get("items", doc) if isinstance(doc, dict) else doc
            except json.JSONDecodeError:
                return None
    return None
