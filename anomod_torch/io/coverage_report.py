"""Coverage dump / merge / report pipeline — the jacococli analog.

Counterpart of ``anomod/io/coverage_report.py``: the same host code
(no device, no CUDA), held to it by ``tests/test_torch_collection.py``.

The reference's TT coverage path is: JaCoCo agents expose a tcpserver dump
port; per pod, ``jacococli dump --reset`` pulls a binary ``.exec`` file
(collect_coverage_reports.sh:54-63); per service, exec files are merged
(``jacococli merge``, coverage_summary.py:40-65), rendered to XML+HTML
(:68-94), and the top-level LINE counter becomes ``coverage-summary.txt``
(:97-125).

Here the ``.exec`` analog is a :class:`CoverageDump`: per source file, a
boolean covered-line mask (what JaCoCo's probe array encodes, reduced to line
granularity).  Merge is exact — element-wise OR, the same union-of-probes
semantics as ``jacococli merge`` — and reports are written in the reference's
exact artifact shapes (JaCoCo XML LINE counters; the boxed summary text that
`parse_summary_txt` in :mod:`anomod_torch.io.coverage` reads back).  Dumps
serialize to ``.npz`` (our binary wire format) so a campaign can archive
per-pod dumps the way ``kubectl cp`` archives exec files.
"""

from __future__ import annotations

import dataclasses
import io as _io
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import numpy as np

from anomod_torch.schemas import (CoverageBatch, FileCoverage,
                                  coverage_batch_from_files)


@dataclasses.dataclass
class CoverageDump:
    """Per-service covered-line masks, keyed by source path."""
    service: str
    files: Dict[str, np.ndarray]   # path → bool[n_lines]

    @property
    def lines_total(self) -> int:
        return int(sum(m.size for m in self.files.values()))

    @property
    def lines_covered(self) -> int:
        return int(sum(int(m.sum()) for m in self.files.values()))

    def to_file_coverage(self) -> List[FileCoverage]:
        return [FileCoverage(self.service, path, int(m.size), int(m.sum()))
                for path, m in sorted(self.files.items())]


def merge_dumps(dumps: Sequence[CoverageDump]) -> CoverageDump:
    """Union-of-probes merge (jacococli merge semantics): a line is covered
    if any dump covered it; files union; length mismatches pad with
    uncovered."""
    if not dumps:
        raise ValueError("nothing to merge")
    service = dumps[0].service
    if any(d.service != service for d in dumps):
        raise ValueError("merge_dumps merges one service at a time")
    merged: Dict[str, np.ndarray] = {}
    for d in dumps:
        for path, mask in d.files.items():
            mask = np.asarray(mask, bool)
            if path not in merged:
                merged[path] = mask.copy()
                continue
            a = merged[path]
            if a.size < mask.size:
                a = np.pad(a, (0, mask.size - a.size))
            elif mask.size < a.size:
                mask = np.pad(mask, (0, a.size - mask.size))
            merged[path] = a | mask
    return CoverageDump(service, merged)


def save_dump(dump: CoverageDump, path: Path) -> None:
    """Binary archive of one dump (the `.exec` analog, npz wire format)."""
    arrays = {f"mask_{i}": np.packbits(m)
              for i, m in enumerate(dump.files.values())}
    sizes = np.array([m.size for m in dump.files.values()], np.int64)
    names = np.array(list(dump.files.keys()))
    np.savez_compressed(path, service=np.array(dump.service), names=names,
                        sizes=sizes, **arrays)


def load_dump(path: Path) -> CoverageDump:
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["names"]]
        sizes = z["sizes"]
        files = {}
        for i, (name, size) in enumerate(zip(names, sizes)):
            files[name] = np.unpackbits(z[f"mask_{i}"])[:int(size)].astype(bool)
        return CoverageDump(str(z["service"][()]), files)


# ---------------------------------------------------------------------------
# Report rendering (coverage_summary.py artifact shapes)
# ---------------------------------------------------------------------------

def write_jacoco_xml(dump: CoverageDump) -> str:
    """JaCoCo-shaped XML: per-sourcefile LINE counters + a report-level LINE
    counter (the element `parse_jacoco_xml` and the reference's
    parse_total_from_xml read)."""
    parts = [f'<?xml version="1.0" encoding="UTF-8"?>'
             f'<report name="{dump.service}">',
             f'<package name="{dump.service}">']
    for path, mask in sorted(dump.files.items()):
        covered = int(mask.sum())
        missed = int(mask.size) - covered
        parts.append(f'<sourcefile name="{path}">'
                     f'<counter type="LINE" missed="{missed}" '
                     f'covered="{covered}"/></sourcefile>')
    parts.append("</package>")
    missed_total = dump.lines_total - dump.lines_covered
    parts.append(f'<counter type="LINE" missed="{missed_total}" '
                 f'covered="{dump.lines_covered}"/>')
    parts.append("</report>")
    return "".join(parts)


def write_summary_txt(service: str, lines_total: int, lines_covered: int) -> str:
    """The boxed coverage-summary.txt (coverage_summary.py:110-125 shape,
    e.g. TT_data/.../ts-order-service/coverage-summary.txt:6)."""
    pct = 0 if lines_total == 0 else int(round(100 * lines_covered / lines_total))
    bar = "-" * 66
    return ("=" * 66 + "\n"
            "  Simple Code Coverage Report\n"
            f"{bar}\n"
            f"Service: {service}\n"
            f"{bar}\n"
            + "TOTAL".ljust(20) + f"Lines {lines_total:6d}  Cover {pct:3d}%\n"
            + f"{bar}\n")


def parse_total_from_xml(text: str) -> Dict[str, int]:
    """Top-level LINE counter from report XML (coverage_summary.py:97-108)."""
    import xml.etree.ElementTree as ET
    root = ET.parse(_io.StringIO(text)).getroot()
    for c in root.findall("counter"):
        if c.get("type") == "LINE":
            return {"covered": int(c.get("covered")),
                    "missed": int(c.get("missed"))}
    return {"covered": 0, "missed": 0}


# ---------------------------------------------------------------------------
# Batch ↔ dump bridges + collection orchestration
# ---------------------------------------------------------------------------

def batch_to_dumps(batch: CoverageBatch, seed: int = 0) -> List[CoverageDump]:
    """Expand counter rows into per-service dumps with concrete line masks.

    Covered lines are placed deterministically (seeded per file) — the
    counter marginals are preserved exactly, so batch → dumps → report
    round-trips the totals."""
    rng = np.random.default_rng(seed)
    by_service: Dict[str, Dict[str, np.ndarray]] = {}
    for fi in range(len(batch.paths)):
        svc = batch.services[int(batch.service[fi])]
        total = int(batch.lines_total[fi])
        covered = int(batch.lines_covered[fi])
        mask = np.zeros(total, bool)
        if covered:
            mask[rng.choice(total, size=covered, replace=False)] = True
        by_service.setdefault(svc, {})[batch.paths[fi]] = mask
    return [CoverageDump(svc, files) for svc, files in
            sorted(by_service.items())]


def dumps_to_batch(dumps: Sequence[CoverageDump]) -> CoverageBatch:
    files: List[FileCoverage] = []
    for d in dumps:
        files += d.to_file_coverage()
    return coverage_batch_from_files(files)


def collect_coverage_reports(dumps_by_pod: Dict[str, Sequence[CoverageDump]],
                             data_dir: Path, report_dir: Path) -> Dict[str, dict]:
    """The collect_coverage_reports.sh pipeline over in-memory dumps:
    archive each pod's dump (`coverage_data/<pod>__jacoco-<pod>.npz`), then
    per service merge → xml + summary (`coverage_report/<svc>/...`).
    Returns per-service totals."""
    data_dir = Path(data_dir)
    report_dir = Path(report_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    per_service: Dict[str, List[CoverageDump]] = {}
    for pod, dumps in sorted(dumps_by_pod.items()):
        for i, d in enumerate(dumps):
            save_dump(d, data_dir / f"{pod}__jacoco-{pod}-{i}.npz")
            per_service.setdefault(d.service, []).append(d)
    totals: Dict[str, dict] = {}
    for svc, dumps in sorted(per_service.items()):
        merged = merge_dumps(dumps)
        sdir = report_dir / svc
        sdir.mkdir(parents=True, exist_ok=True)
        save_dump(merged, sdir / "merged.npz")
        (sdir / "coverage.xml").write_text(write_jacoco_xml(merged))
        (sdir / "coverage-summary.txt").write_text(
            write_summary_txt(svc, merged.lines_total, merged.lines_covered))
        totals[svc] = {"lines_total": merged.lines_total,
                       "lines_covered": merged.lines_covered}
    return totals
