"""Coverage loaders → CoverageBatch
(counterpart of ``anomod/io/coverage.py``).

SN: gcov text per service dir — files named ``#path#to#file.gcov`` with lines
``<count>:<lineno>:<source>`` where count ``-`` = non-executable, ``#####`` =
uncovered (the materialized content in SN_data/coverage_data).

TT: JaCoCo — ``coverage-summary.txt`` ("TOTAL  Lines  500  Cover  43%",
coverage_summary.py:97-125) and ``coverage.xml`` LINE counters
(``<counter type="LINE" missed=".." covered=".."/>``).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Optional

from anomod_torch.io.lfs import read_text_or_none
from anomod_torch.schemas import (CoverageBatch, FileCoverage,
                                  coverage_batch_from_files)

#: Ingest-cache key component (anomod_torch.io.cache): bump when this module's
#: parsing semantics change, invalidating exactly the coverage entries.
LOADER_VERSION = 1

_GCOV_LINE = re.compile(r"^\s*([#\-\d]+[*]?):\s*(\d+):")
_SUMMARY_TOTAL = re.compile(r"TOTAL\s+Lines\s+(\d+)\s+Cover\s+(\d+)%")


def parse_gcov(text: str, service: str, path: str) -> FileCoverage:
    total = covered = 0
    for line in text.splitlines():
        m = _GCOV_LINE.match(line)
        if not m:
            continue
        count = m.group(1).rstrip("*")
        if count == "-":
            continue
        total += 1
        if count != "#####" and count != "=====":
            covered += 1
    return FileCoverage(service=service, path=path,
                        lines_total=total, lines_covered=covered)


def load_sn_coverage_dir(exp_dir: Path) -> Optional[CoverageBatch]:
    """Per-service dirs of .gcov text (SN_data/coverage_data/<exp>/<svc>/)."""
    exp_dir = Path(exp_dir)
    files: List[FileCoverage] = []
    for svc_dir in sorted(p for p in exp_dir.iterdir() if p.is_dir()):
        for g in sorted(svc_dir.glob("*.gcov")):
            text = read_text_or_none(g)
            if text is None:
                continue
            src = g.name.replace("#", "/").removesuffix(".gcov")
            files.append(parse_gcov(text, svc_dir.name, src))
    return coverage_batch_from_files(files) if files else None


def parse_jacoco_xml(text: str, service: str) -> List[FileCoverage]:
    """Extract per-sourcefile LINE counters from a JaCoCo report XML."""
    out: List[FileCoverage] = []
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        return out
    for pkg in root.iter("package"):
        pkg_name = pkg.get("name", "")
        for sf in pkg.findall("sourcefile"):
            for c in sf.findall("counter"):
                if c.get("type") == "LINE":
                    missed = int(c.get("missed", 0))
                    covered = int(c.get("covered", 0))
                    out.append(FileCoverage(
                        service=service,
                        path=f"{pkg_name}/{sf.get('name', '')}",
                        lines_total=missed + covered,
                        lines_covered=covered))
    return out


def parse_summary_txt(text: str, service: str) -> Optional[FileCoverage]:
    """coverage-summary.txt TOTAL line (coverage_summary.py:97-125)."""
    m = _SUMMARY_TOTAL.search(text)
    if not m:
        return None
    total = int(m.group(1))
    pct = int(m.group(2))
    return FileCoverage(service=service, path="TOTAL",
                        lines_total=total, lines_covered=total * pct // 100)


def load_tt_coverage_report(report_dir: Path) -> Optional[CoverageBatch]:
    """TT_data/coverage_report/<exp>/<svc>/{coverage.xml,coverage-summary.txt}."""
    report_dir = Path(report_dir)
    files: List[FileCoverage] = []
    for svc_dir in sorted(p for p in report_dir.iterdir() if p.is_dir()):
        svc = svc_dir.name
        xml_text = read_text_or_none(svc_dir / "coverage.xml")
        if xml_text:
            per_file = parse_jacoco_xml(xml_text, svc)
            if per_file:
                files.extend(per_file)
                continue
        sum_text = read_text_or_none(svc_dir / "coverage-summary.txt")
        if sum_text:
            fc = parse_summary_txt(sum_text, svc)
            if fc:
                files.append(fc)
    return coverage_batch_from_files(files) if files else None
