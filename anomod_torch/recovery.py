"""Failure detection + elastic recovery — the reference's self-healing layer.

Counterpart of ``anomod/recovery.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_faultplanes.py``.

The reference keeps a chaos-battered cluster collectable with four pieces of
recovery machinery (SURVEY §5):

- ``wait_for_pods_ready`` (run_experiment.sh:147-258): poll pod phases until
  every pod is Ready; **force-delete** pods stuck in CrashLoopBackOff /
  Error / ImagePullBackOff so their ReplicaSet respawns them; pods that sit
  *Running but not Ready* past a stuck deadline (180 s) get restarted too;
  give up at a global timeout.
- Prometheus OOM guard (run_experiment.sh:416-455): before each run, restart
  the Prometheus deployment if its pod was OOMKilled / is unready, then wait
  for it to come back.
- ERR/EXIT traps (run_experiment.sh:407-411, run_all_experiments.sh:12-30,
  automated_multimodal_collection.sh:13-39): any failure path destroys the
  active chaos experiments before the process exits.
- Pre-run sweeps (run_all_experiments.sh:169-217): destroy *all* leftover
  ChaosBlade/Chaos-Mesh experiments from previous crashed runs.

Here those behaviors are a deterministic, tick-based controller over a
synthetic pod cluster (no wall-clock sleeps — a virtual clock advances in
poll intervals), so recovery policy is unit-testable: seeded failure
scenarios (slow starters, crash-loopers, stuck-not-ready pods, OOM-killed
Prometheus) must converge to all-Ready within the modeled deadlines exactly
as the reference's bash loops would.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from anomod_torch.chaos import ChaosController


class Phase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    CRASHLOOP = "CrashLoopBackOff"
    ERROR = "Error"
    IMAGEPULL = "ImagePullBackOff"


#: phases the reference force-deletes on sight (run_experiment.sh:177-199
#: greps for CrashLoopBackOff|Error|ImagePullBackOff and deletes --force)
FORCE_DELETE_PHASES = (Phase.CRASHLOOP, Phase.ERROR, Phase.IMAGEPULL)


@dataclasses.dataclass
class Pod:
    """One pod's deterministic lifecycle script.

    ``startup_s`` — virtual seconds from (re)creation until Running+Ready.
    ``crashloop`` — if True the pod enters CrashLoopBackOff instead of
    Running until it has been force-deleted ``crashes_before_ok`` times
    (modeling the transient image/init failures the reference recovers from
    by deletion-respawn).
    ``stuck_unready`` — if True the pod reaches Running but never flips
    Ready until restarted once (the Running-not-Ready hang the reference
    restarts after 180 s).
    """
    name: str
    service: str
    startup_s: float = 20.0
    crashloop: bool = False
    crashes_before_ok: int = 1
    stuck_unready: bool = False
    # mutable runtime state
    created_at: float = 0.0
    restarts: int = 0
    deletions: int = 0

    def phase_at(self, t: float) -> Tuple[Phase, bool]:
        """(phase, ready) at virtual time ``t``."""
        age = t - self.created_at
        if self.crashloop and self.deletions < self.crashes_before_ok:
            return (Phase.PENDING, False) if age < 5.0 else (Phase.CRASHLOOP, False)
        if age < self.startup_s:
            return Phase.PENDING, False
        if self.stuck_unready and self.restarts == 0:
            return Phase.RUNNING, False
        return Phase.RUNNING, True


class SyntheticCluster:
    """A deterministic pod set driven by a virtual clock.

    ``delete_pod`` models `kubectl delete pod --force --grace-period=0`: the
    ReplicaSet immediately respawns the pod with a fresh creation time
    (run_experiment.sh:186-199); crash-loopers count deletions and come up
    clean once the scripted number of respawns has happened.
    """

    def __init__(self, pods: Iterable[Pod], t0: float = 0.0) -> None:
        self.now = t0
        self.pods: Dict[str, Pod] = {}
        for p in pods:
            p.created_at = t0
            self.pods[p.name] = p

    def advance(self, dt: float) -> None:
        self.now += dt

    def snapshot(self) -> Dict[str, Tuple[Phase, bool]]:
        return {n: p.phase_at(self.now) for n, p in self.pods.items()}

    def delete_pod(self, name: str) -> None:
        p = self.pods[name]
        p.deletions += 1
        p.created_at = self.now          # respawned by the ReplicaSet
        if p.stuck_unready:
            p.restarts += 1

    def restart_pod(self, name: str) -> None:
        """Model `kubectl delete pod` on a Running pod (graceful restart)."""
        self.delete_pod(name)


def cluster_for_testbed(testbed: str, seed: int = 0,
                        n_slow: int = 2, n_crashloop: int = 1,
                        n_stuck: int = 1) -> SyntheticCluster:
    """A seeded cluster over the testbed's service table with a deterministic
    sprinkling of the three failure archetypes the reference recovers from."""
    from anomod_torch.synth import SN_SERVICES, TT_SERVICES
    services = SN_SERVICES if testbed == "SN" else TT_SERVICES
    if n_slow + n_crashloop + n_stuck > len(services):
        raise ValueError(
            f"{n_slow + n_crashloop + n_stuck} troubled pods requested but "
            f"{testbed} has only {len(services)} services")
    pods: List[Pod] = []
    order = sorted(services, key=lambda s: hashlib.sha1(
        f"{seed}:{s}".encode()).hexdigest())
    troubled = {s: kind
                for s, kind in zip(order, ["slow"] * n_slow
                                   + ["crashloop"] * n_crashloop
                                   + ["stuck"] * n_stuck)}
    for svc in services:
        suffix = hashlib.sha1(f"{seed}:{svc}:pod".encode()).hexdigest()[:5]
        kind = troubled.get(svc)
        pods.append(Pod(
            name=f"{svc}-{suffix}", service=svc,
            startup_s=90.0 if kind == "slow" else 20.0,
            crashloop=kind == "crashloop",
            stuck_unready=kind == "stuck"))
    return SyntheticCluster(pods)


@dataclasses.dataclass
class ReadinessReport:
    ready: bool
    waited_s: float
    polls: int
    force_deleted: List[str]
    restarted_stuck: List[str]
    unready_at_timeout: List[str]


class ReadinessController:
    """The ``wait_for_pods_ready`` policy as a reusable controller.

    Defaults mirror the reference: 10 s poll interval, 180 s stuck deadline,
    600 s global timeout (run_experiment.sh:147-258 — its loop polls every
    10 s, tracks `not_ready_since` per pod, and bails after the deadline).
    """

    def __init__(self, poll_s: float = 10.0, stuck_deadline_s: float = 180.0,
                 timeout_s: float = 600.0) -> None:
        self.poll_s = poll_s
        self.stuck_deadline_s = stuck_deadline_s
        self.timeout_s = timeout_s

    def wait_for_pods_ready(self, cluster: SyntheticCluster) -> ReadinessReport:
        t_start = cluster.now
        not_ready_since: Dict[str, float] = {}
        force_deleted: List[str] = []
        restarted: List[str] = []
        polls = 0
        while True:
            polls += 1
            snap = cluster.snapshot()
            unready = [n for n, (_, ok) in snap.items() if not ok]
            if not unready:
                return ReadinessReport(True, cluster.now - t_start, polls,
                                       force_deleted, restarted, [])
            for name in unready:
                phase, _ = snap[name]
                if phase in FORCE_DELETE_PHASES:
                    cluster.delete_pod(name)
                    force_deleted.append(name)
                    not_ready_since.pop(name, None)
                    continue
                if phase is not Phase.RUNNING:
                    # deadline counts Running-not-Ready time only, not Pending
                    not_ready_since.pop(name, None)
                    continue
                since = not_ready_since.setdefault(name, cluster.now)
                if cluster.now - since >= self.stuck_deadline_s:
                    cluster.restart_pod(name)
                    restarted.append(name)
                    not_ready_since[name] = cluster.now
            if cluster.now - t_start >= self.timeout_s:
                snap = cluster.snapshot()
                return ReadinessReport(
                    False, cluster.now - t_start, polls, force_deleted,
                    restarted, [n for n, (_, ok) in snap.items() if not ok])
            cluster.advance(self.poll_s)


# ---------------------------------------------------------------------------
# Prometheus OOM guard (run_experiment.sh:416-455)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrometheusState:
    """The monitoring pod the reference restarts between runs because long
    24 h PromQL ranges OOM it (run_all_experiments.sh:316-355)."""
    oom_killed: bool = False
    ready: bool = True
    restart_count: int = 0
    startup_s: float = 30.0
    restarted_at: Optional[float] = None

    def needs_restart(self) -> bool:
        return self.oom_killed or not self.ready


def guard_prometheus(state: PrometheusState, cluster: SyntheticCluster,
                     poll_s: float = 10.0, timeout_s: float = 300.0) -> bool:
    """Restart-if-unhealthy then wait-until-ready.  Returns readiness."""
    if state.needs_restart():
        state.restart_count += 1
        state.oom_killed = False
        state.ready = False
        state.restarted_at = cluster.now
    waited = 0.0
    while not state.ready and waited < timeout_s:
        cluster.advance(poll_s)
        waited += poll_s
        if (state.restarted_at is not None
                and cluster.now - state.restarted_at >= state.startup_s):
            state.ready = True
    return state.ready


# ---------------------------------------------------------------------------
# Guarded runs: trap-equivalent chaos teardown + pre-run sweep
# ---------------------------------------------------------------------------

class GuardedRun:
    """Context manager with the reference's trap semantics.

    On entry: pre-run sweep destroys every leftover chaos experiment
    (run_all_experiments.sh:169-217, cleanup_all_previous_anomalies).  On
    exit — **including exceptions**, the ERR/EXIT trap path — all chaos
    created during the run is destroyed.
    """

    def __init__(self, controller: ChaosController) -> None:
        self.controller = controller
        self.swept_on_entry = 0

    def __enter__(self) -> "GuardedRun":
        self.swept_on_entry = self.controller.destroy_all()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.controller.destroy_all()


def run_with_recovery(cluster: SyntheticCluster,
                      controller: ChaosController,
                      label_or_name,
                      body: Callable[[], object],
                      prometheus: Optional[PrometheusState] = None,
                      readiness: Optional[ReadinessController] = None,
                      ) -> Tuple[object, ReadinessReport]:
    """One experiment with the full recovery envelope, in reference order:
    sweep leftovers → Prometheus guard → wait for pods → inject → body →
    teardown (guaranteed).  Raises if the cluster never becomes ready, like
    run_experiment.sh aborting the run."""
    readiness = readiness or ReadinessController()
    with GuardedRun(controller):
        if prometheus is not None:
            if not guard_prometheus(prometheus, cluster):
                raise RuntimeError("prometheus did not recover")
        report = readiness.wait_for_pods_ready(cluster)
        if not report.ready:
            raise RuntimeError(
                f"pods not ready after {report.waited_s:.0f}s: "
                f"{report.unready_at_timeout}")
        with controller.inject(label_or_name):
            result = body()
    return result, report
