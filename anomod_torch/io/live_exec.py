"""Live exec-transport collectors: the subprocess-driven collection paths.

Counterpart of ``anomod/io/live_exec.py``: the same host code (no
device, no CUDA), held to it by ``tests/test_torch_collection.py``.

The reference's remaining live collectors do not speak HTTP — they shell
out: per-pod ``kubectl logs`` (current + ``--previous``) plus cluster
events (TT_collection-scripts/T-Dataset/log_collector.py:38-123), per
-container ``docker logs`` with the summary.txt pass
(SN_collection-scripts/Dataset/log_data/collect_log.sh:31-137), and the
JaCoCo ``jacococli dump`` + ``kubectl cp`` loop
(TT_collection-scripts/T-Dataset/coverage_tools/
collect_coverage_reports.sh:54-101).  This module is their exec-transport
half, mirroring how :mod:`anomod_torch.io.live` is the HTTP-transport
half:

  - ONE injectable :class:`ExecRunner` carries every subprocess call, so
    the full collection logic is testable against a fake runner
    (tests/test_live_exec.py) with no cluster anywhere — the same design
    that keeps the HTTP clients stub-server-tested.
  - collectors emit EXACTLY the artifact shapes the offline loaders
    consume: ``anomod_torch.io.logs.load_tt_log_dir`` (pod dirs),
    ``load_sn_log_dir`` (<Display>_<ts>.log + summary.txt), and the
    ``coverage_data``/``coverage_report`` trees of
    ``anomod_torch.io.coverage_report`` / ``anomod_torch.io.coverage``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from anomod_torch.io.live import CollectReport


@dataclasses.dataclass
class ExecResult:
    returncode: int
    stdout: str = ""
    stderr: str = ""


@dataclasses.dataclass
class ExecRunner:
    """Bounded subprocess transport shared by every exec collector.

    ``run_fn`` is injectable: tests swap in a fake that scripts the
    cluster's answers; production keeps the subprocess default.  A
    timeout or spawn failure degrades to a nonzero :class:`ExecResult`
    (collectors skip-and-continue, the reference scripts' behavior) —
    one wedged pod must not abort a whole collection sweep."""
    timeout: float = 60.0
    run_fn: Optional[Callable[[List[str]], ExecResult]] = None

    def run(self, cmd: List[str]) -> ExecResult:
        if self.run_fn is not None:
            return self.run_fn(list(cmd))
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self.timeout)
            return ExecResult(r.returncode, r.stdout, r.stderr)
        except subprocess.TimeoutExpired:
            return ExecResult(124, "", f"timeout after {self.timeout}s")
        except OSError as e:
            return ExecResult(127, "", str(e))


# ---------------------------------------------------------------------------
# TT: kubectl log collection (log_collector.py:38-123)
# ---------------------------------------------------------------------------

_TT_POD_PREFIXES = ("ts-", "nacos", "rabbitmq")


@dataclasses.dataclass
class KubeLogCollector:
    """Per-pod ``kubectl logs`` sweep -> the load_tt_log_dir layout.

    ``<out>/<pod>/<pod>_<stamp>.log`` per running pod (current instance),
    ``<pod>_previous_<stamp>.log`` when the pod has a previous run (only
    written on rc==0 AND non-empty stdout — log_collector.py:100-107),
    plus ``kubernetes_events_<stamp>.json`` at the top level."""
    runner: ExecRunner = dataclasses.field(default_factory=ExecRunner)
    namespace: str = "default"

    def list_pods(self) -> List[str]:
        r = self.runner.run(["kubectl", "get", "pods", "--namespace",
                             self.namespace, "-o", "json"])
        if r.returncode != 0:
            return []
        try:
            items = json.loads(r.stdout).get("items", [])
        except json.JSONDecodeError:
            return []
        return [p["metadata"]["name"] for p in items
                if str(p.get("metadata", {}).get("name", ""))
                .startswith(_TT_POD_PREFIXES)]

    def collect(self, out_dir: Path, stamp: str, tail: int = 1000,
                with_events: bool = True) -> CollectReport:
        out_dir = Path(out_dir)
        files: List[str] = []
        skipped = 0
        n_lines = 0
        for pod in self.list_pods():
            cur = self.runner.run(["kubectl", "logs", pod, "--namespace",
                                   self.namespace, "--tail", str(tail)])
            if cur.returncode != 0:
                skipped += 1
            else:
                pod_dir = out_dir / pod
                pod_dir.mkdir(parents=True, exist_ok=True)
                path = pod_dir / f"{pod}_{stamp}.log"
                path.write_text(cur.stdout)
                files.append(str(path))
                n_lines += cur.stdout.count("\n")
            prev = self.runner.run(["kubectl", "logs", pod, "--namespace",
                                    self.namespace, "--previous"])
            if prev.returncode == 0 and prev.stdout.strip():
                pod_dir = out_dir / pod
                pod_dir.mkdir(parents=True, exist_ok=True)
                path = pod_dir / f"{pod}_previous_{stamp}.log"
                path.write_text(prev.stdout)
                files.append(str(path))
        if with_events:
            ev = self.runner.run(["kubectl", "get", "events", "-o", "json"])
            if ev.returncode == 0:
                out_dir.mkdir(parents=True, exist_ok=True)
                path = out_dir / f"kubernetes_events_{stamp}.json"
                path.write_text(ev.stdout)
                files.append(str(path))
        return CollectReport(kind="kubectl_logs", files=tuple(files),
                             n_records=n_lines, n_skipped=skipped)


# ---------------------------------------------------------------------------
# SN: docker log collection + summary (collect_log.sh:31-137)
# ---------------------------------------------------------------------------

SN_LOG_SERVICES: Tuple[str, ...] = (
    "compose-post-service", "post-storage-service", "user-service",
    "user-mention-service", "unique-id-service", "media-service",
    "social-graph-service", "user-timeline-service", "url-shorten-service",
    "home-timeline-service", "text-service", "nginx-thrift")


def _compose_container_re(project: str, svc: str):
    """The compose v1 container-name convention
    (``<project>_<service>_<replica>``) — single source for every
    collector that locates SN containers."""
    return re.compile(rf"{re.escape(project)}_{re.escape(svc)}_\d+")


def _display_name(svc: str) -> str:
    """compose-post-service -> ComposePostService (collect_log.sh's
    DISPLAY_NAMES table, derived instead of hand-enumerated)."""
    return "".join(w.capitalize() for w in svc.split("-"))


@dataclasses.dataclass
class DockerLogCollector:
    """``docker ps`` + per-container ``docker logs`` sweep -> the
    load_sn_log_dir layout: ``<Display>_<stamp>.log`` per service plus
    the ``summary.txt`` contract (collect_log.sh:101-137 — per-service
    size/lines and error/warn counts; a service with no running
    container is skipped with a 未找到日志文件 row, the stop-fault
    fingerprint the golden run's absence tier reads)."""
    runner: ExecRunner = dataclasses.field(default_factory=ExecRunner)
    services: Sequence[str] = SN_LOG_SERVICES
    compose_project: str = "socialnetwork"

    def _container_ids(self) -> Dict[str, str]:
        r = self.runner.run(["docker", "ps", "--format",
                             "{{.ID}} {{.Names}}"])
        if r.returncode != 0:
            return {}
        out: Dict[str, str] = {}
        for line in r.stdout.splitlines():
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            cid, cname = parts
            for svc in self.services:
                if _compose_container_re(self.compose_project,
                                         svc).search(cname):
                    out[svc] = cid
        return out

    def collect(self, out_dir: Path, stamp: str,
                time_range: Optional[str] = None) -> CollectReport:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        containers = self._container_ids()
        files: List[str] = []
        skipped = 0
        total_lines = 0
        # load_sn_log_dir derives the service via stem.rsplit('_', 1)[0],
        # so the filename stamp must carry NO underscore or every derived
        # service name would absorb the stamp's first segment
        fstamp = stamp.replace("_", "-")
        summary = [f"Collection timestamp: {stamp}",
                   "Time window: " + (time_range or "full history"),
                   f"Services captured: {len(self.services)}", "",
                   "Log file summary:"]
        for svc in self.services:
            display = _display_name(svc)
            cid = containers.get(svc)
            if cid is None:
                summary.append(f"- {display}: 未找到日志文件")
                skipped += 1
                continue
            cmd = ["docker", "logs"]
            if time_range:
                cmd += ["--since", time_range]
            r = self.runner.run(cmd + [cid])
            if r.returncode != 0:
                summary.append(f"- {display}: 未找到日志文件")
                skipped += 1
                continue
            text = r.stdout
            path = out_dir / f"{display}_{fstamp}.log"
            path.write_text(text)
            files.append(str(path))
            lines = text.splitlines()
            total_lines += len(lines)
            # LINE counts, the grep -c -i contract (collect_log.sh:129-131)
            # — substring totals would double-count "ERROR: upstream error"
            n_err = sum(1 for l in lines if "error" in l.lower())
            n_warn = sum(1 for l in lines if "warn" in l.lower())
            n_start = sum(1 for l in lines if "Starting" in l)
            summary.append(
                f"- {display}: {max(path.stat().st_size // 1024, 1)}K "
                f"({len(lines)} lines) | errors={n_err}, "
                f"warnings={n_warn}, startup={n_start}")
        spath = out_dir / "summary.txt"
        spath.write_text("\n".join(summary) + "\n")
        files.append(str(spath))
        return CollectReport(kind="docker_logs", files=tuple(files),
                             n_records=total_lines, n_skipped=skipped)


# ---------------------------------------------------------------------------
# SN: gcov flush + in-container collection (collect_all_data.sh:500-560)
# ---------------------------------------------------------------------------

SN_GCOV_SERVICES: Tuple[str, ...] = tuple(
    s for s in SN_LOG_SERVICES if s != "nginx-thrift")


@dataclasses.dataclass
class GcovCoverageCollector:
    """The SN gcov collection loop: SIGUSR1 flush + per-container collect
    script + host-mounted report pickup.

    Contract (collect_all_data.sh:500-560): every running
    ``socialnetwork_*service`` container gets ``kill -USR1 1`` (the gcov
    flush signal), then each service container runs its baked-in
    ``/usr/local/bin/collect_coverage.sh`` with EXPERIMENT_BASE_NAME /
    SERVICE_NAME / TIMESTAMP env, writing ``.gcov`` text into the
    compose-mounted ``coverage-reports/<base>_<stamp>/<service>/``; the
    host then moves that tree into
    ``coverage_data/`` where
    :func:`anomod_torch.io.coverage.load_sn_coverage_dir`
    reads per-service dirs of ``.gcov`` files."""
    runner: ExecRunner = dataclasses.field(default_factory=ExecRunner)
    services: Sequence[str] = SN_GCOV_SERVICES
    compose_project: str = "socialnetwork"

    def _running(self) -> List[str]:
        """One ``docker ps`` listing shared by flush + per-service lookup
        (a wedged daemon must cost one timeout, not one per service)."""
        r = self.runner.run(["docker", "ps", "--filter",
                             f"name={self.compose_project}_.*service",
                             "--format", "{{.Names}}"])
        return r.stdout.split() if r.returncode == 0 else []

    def _flush(self, running: Sequence[str]) -> int:
        """SIGUSR1 every running service container; returns the count."""
        n = 0
        for cname in running:
            if self.runner.run(["docker", "exec", cname, "kill", "-USR1",
                                "1"]).returncode == 0:
                n += 1
        return n

    def collect(self, mount_root: Path, out_dir: Path, base: str,
                stamp: str) -> CollectReport:
        """Flush, run each container's collect script, then move the
        host-mounted report tree to its ``coverage_data`` home."""
        import shutil
        running = self._running()
        flushed = self._flush(running)
        skipped = 0
        for svc in self.services:
            # any replica suffix, the same convention the log collector
            # matches — a service recreated as _2 must still be collected
            pat = _compose_container_re(self.compose_project, svc)
            cname = next((c for c in running if pat.fullmatch(c)), None)
            if cname is None:
                skipped += 1
                continue
            r = self.runner.run(
                ["docker", "exec",
                 "-e", f"EXPERIMENT_BASE_NAME={base}",
                 "-e", f"SERVICE_NAME={svc}",
                 "-e", f"TIMESTAMP={stamp}",
                 cname, "/usr/local/bin/collect_coverage.sh"])
            if r.returncode != 0:
                skipped += 1
        src = Path(mount_root) / f"{base}_{stamp}"
        out_dir = Path(out_dir)
        files: List[str] = []
        notes = [f"flushed={flushed}"]
        if src.is_dir():
            if out_dir.exists():
                # moving INTO an existing dir would nest the tree one
                # level deep — a shape load_sn_coverage_dir cannot read;
                # degrade loudly instead of corrupting silently
                notes.append(f"target exists, not moved: {out_dir}")
            else:
                out_dir.parent.mkdir(parents=True, exist_ok=True)
                shutil.move(str(src), str(out_dir))
                files = [str(p) for p in sorted(out_dir.rglob("*.gcov"))]
        return CollectReport(kind="gcov_coverage", files=tuple(files),
                             n_records=len(files), n_skipped=skipped,
                             notes=tuple(notes))


# ---------------------------------------------------------------------------
# TT: JaCoCo dump + cp loop (collect_coverage_reports.sh:54-101)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JacocoCoverageCollector:
    """The jacococli dump/pull loop over ts- pods.

    Per pod: probe for the CLI jar, ``jacococli dump --reset`` into
    ``/coverage/jacoco-<pod>.exec``, list exec files, and ``kubectl cp``
    each to ``<exec_dir>/<pod>__<basename>`` — then the offline
    :func:`anomod_torch.io.coverage_report.collect_coverage_reports`
    pipeline merges per service and renders the ``coverage_report`` tree the
    loaders read.  Our binary dump format is the CoverageDump ``.npz``
    (the ``.exec`` analog), so a fake runner "cp"s by writing one."""
    runner: ExecRunner = dataclasses.field(default_factory=ExecRunner)
    namespace: str = "default"
    port: int = 6300

    def _pods(self) -> List[str]:
        r = self.runner.run(["kubectl", "-n", self.namespace, "get", "pods",
                             "-l", "app", "-o",
                             "jsonpath={.items[*].metadata.name}"])
        if r.returncode != 0:
            return []
        return [p for p in r.stdout.split() if p.startswith("ts-")]

    def pull_execs(self, exec_dir: Path) -> Tuple[List[Path], int]:
        """Dump + pull every pod's exec files; returns (paths, skipped)."""
        exec_dir = Path(exec_dir)
        exec_dir.mkdir(parents=True, exist_ok=True)
        pulled: List[Path] = []
        skipped = 0
        for pod in self._pods():
            probe = self.runner.run(
                ["kubectl", "-n", self.namespace, "exec", pod, "--", "sh",
                 "-c", "test -f /jacoco/jacococli.jar"])
            if probe.returncode != 0:
                skipped += 1
                continue
            dump = self.runner.run(
                ["kubectl", "-n", self.namespace, "exec", pod, "--", "sh",
                 "-c",
                 f"mkdir -p /coverage && env -u JAVA_TOOL_OPTIONS java -jar "
                 f"/jacoco/jacococli.jar dump --address localhost --port "
                 f"{self.port} --destfile /coverage/jacoco-{pod}.exec "
                 f"--reset"])
            if dump.returncode != 0:
                skipped += 1
                continue
            ls = self.runner.run(
                ["kubectl", "-n", self.namespace, "exec", pod, "--", "sh",
                 "-c", "ls -1 /coverage/*.exec 2>/dev/null || true"])
            for f in ls.stdout.split():
                base = f.rsplit("/", 1)[-1]
                dst = exec_dir / f"{pod}__{base}"
                cp = self.runner.run(
                    ["kubectl", "-n", self.namespace, "cp",
                     f"{pod}:{f}", str(dst)])
                if cp.returncode == 0 and dst.exists():
                    pulled.append(dst)
                else:
                    skipped += 1
        return pulled, skipped

    def collect(self, data_dir: Path, report_dir: Path) -> CollectReport:
        """Full pipeline: dump/pull execs, then merge + render the
        ``coverage_report`` tree per service (the .sh script's follow-on
        coverage_summary.py stage)."""
        from anomod_torch.io.coverage_report import (
            collect_coverage_reports, load_dump)
        from anomod_torch.io.logs import pod_to_service
        pulled, skipped = self.pull_execs(data_dir)
        dumps_by_pod: Dict[str, List] = {}
        for path in pulled:
            pod = path.name.split("__", 1)[0]
            try:
                d = load_dump(path)
            except Exception:
                skipped += 1
                continue
            # dump ownership follows the POD the exec came from (the
            # reference merges per service by pod name)
            d = dataclasses.replace(d, service=pod_to_service(pod))
            dumps_by_pod.setdefault(pod, []).append(d)
        totals = collect_coverage_reports(dumps_by_pod, data_dir,
                                          report_dir)
        files = tuple(str(p) for p in pulled)
        return CollectReport(
            kind="jacoco_coverage", files=files,
            n_records=sum(t["lines_covered"] for t in totals.values()),
            n_skipped=skipped,
            notes=tuple(f"{s}: {t['lines_covered']}/{t['lines_total']}"
                        for s, t in sorted(totals.items())))
