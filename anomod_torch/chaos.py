"""Fault-injection subsystem — the framework analog of the reference chaos layer.

Counterpart of ``anomod/chaos.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_faultplanes.py``.

The reference injects faults two ways:

- **Chaos Mesh CRDs** for TT performance/service/database faults
  (chaos-experiments/*.yaml applied by start_chaos.sh:41, removed by
  stop_chaos.sh + the campaign-level sweep run_all_experiments.sh:169-217).
- **ChaosBlade CLI** for every SN fault (host-level cpu/network/disk, process
  kill, redis cache-limit — automated_multimodal_collection.sh:323-497) and
  for the TT code-level JVM faults (`blade create k8s container-jvm
  return/throwCustomException`, run_experiment.sh:293-351).  SN code-level
  faults are plain ``docker stop`` (automated_multimodal_collection.sh:464-479).

This module models all three dispatch planes as data: each
:class:`~anomod_torch.labels.FaultLabel` renders to the CRD document / blade argv /
docker argv the reference would have issued, parses back (CRD metadata labels
carry anomaly_level/anomaly_type/target_service — Lv_P_CPU_preserve.yaml:6-11),
and an in-process :class:`ChaosController` owns the inject→status→destroy
lifecycle (UID extraction semantics of run_experiment.sh:357-372, pre-run
sweep semantics of cleanup_all_previous_anomalies,
automated_multimodal_collection.sh:732-781) against the synthetic SUT: active
faults condition the generator via the same (latency×, error-rate) effect
model the corpus is built from.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

from anomod_torch.labels import FaultLabel, label_for
from anomod_torch.utils import yamlsafe

# ---------------------------------------------------------------------------
# Chaos Mesh CRDs (TT chaosmesh faults)
# ---------------------------------------------------------------------------

_API_VERSION = "chaos-mesh.org/v1alpha1"
_CRD_NAMESPACE = "chaos-mesh"
_TARGET_NAMESPACE = "default"

# Per-experiment CRD shape parameters, matching the reference definitions
# (chaos-experiments/<experiment>.yaml) semantically: kind, chaos action and
# its tuning knobs.  The selector always pins ``app: <pod app label>``.
_MESH_SHAPES: Dict[str, Dict] = {
    # StressChaos, 2 workers × 80% load (Lv_P_CPU_preserve.yaml:18-22)
    "Lv_P_CPU_preserve": dict(
        kind="StressChaos", name="preserve-cpu-contention",
        app="ts-preserve-service", mode="fixed-percent", value="100",
        spec={"stressors": {"cpu": {"workers": 2, "load": 80}}}),
    # StressChaos via stress-ng iomix (Lv_P_DISKIO_preserve.yaml:19)
    "Lv_P_DISKIO_preserve": dict(
        kind="StressChaos", name="preserve-disk-io-stress",
        app="ts-preserve-service", mode="fixed-percent", value="100",
        spec={"stressngStressors": "--iomix 2 --iomix-bytes 1G --timeout 0"}),
    # NetworkChaos 90% loss (Lv_P_NETLOSS_preserve.yaml:17-20)
    "Lv_P_NETLOSS_preserve": dict(
        kind="NetworkChaos", name="preserve-network-loss",
        app="ts-preserve-service", mode="fixed-percent", value="100",
        spec={"action": "loss", "loss": {"loss": "90", "correlation": "0"}}),
    # DNSChaos: order-service names fail to resolve
    # (Lv_S_DNSFAIL_preserve_no_order.yaml:12-20)
    "Lv_S_DNSFAIL_preserve_no_order": dict(
        kind="DNSChaos", name="preserve-dns-no-order",
        app="ts-preserve-service", mode="one",
        spec={"action": "error",
              "patterns": ["ts-order-service*", "ts-order-other-service*"]}),
    # HTTPChaos 70% abort → 503 on the preserve API
    # (Lv_S_HTTPABORT_preserve.yaml:13-24)
    "Lv_S_HTTPABORT_preserve": dict(
        kind="HTTPChaos", name="preserve-http-abort",
        app="ts-preserve-service", mode="fixed-percent", value="70",
        spec={"target": "Request", "port": 14568, "method": "POST",
              "path": "/api/v1/preserveservice/*", "abort": True,
              "replace": {"code": 503}}),
    # Schedule wrapping PodChaos pod-kill every 3 s
    # (Lv_S_KILLPOD_preserve.yaml:15-22)
    "Lv_S_KILLPOD_preserve": dict(
        kind="Schedule", name="preserve-kill-scheduled",
        app="ts-preserve-service", mode=None,
        spec={"schedule": "@every 3s", "type": "PodChaos",
              "podChaos": {
                  "action": "pod-kill", "mode": "one",
                  "selector": {"namespaces": [_TARGET_NAMESPACE],
                               "labelSelectors": {"app": "ts-preserve-service"}}}}),
    # StressChaos memory 85% on the shared MySQL (Lv_D_cachelimit.yaml:17-21)
    "Lv_D_cachelimit": dict(
        kind="StressChaos", name="db-cache-limit",
        app="tsdb-mysql", mode="fixed-percent", value="100",
        spec={"stressors": {"memory": {"workers": 1, "size": "85%"}}}),
    # NetworkChaos 8s±2s delay app→MySQL
    # (Lv_D_CONNECTION_POOL_exhaustion.yaml:17-32)
    "Lv_D_CONNECTION_POOL_exhaustion": dict(
        kind="NetworkChaos", name="db-connection-pool-exhaustion",
        app="tsdb-mysql", mode="all",
        spec={"action": "delay",
              "delay": {"latency": "8s", "jitter": "2s", "correlation": "0"},
              "direction": "from",
              "target": {"mode": "all", "selector": {
                  "namespaces": [_TARGET_NAMESPACE],
                  "expressionSelectors": [{
                      "key": "app", "operator": "In",
                      "values": ["ts-order-service", "ts-preserve-service",
                                 "ts-user-service"]}]}}}),
    # NetworkChaos 15s±5s delay MySQL→app (Lv_D_TRANSACTION_timeout.yaml:17-31)
    "Lv_D_TRANSACTION_timeout": dict(
        kind="NetworkChaos", name="db-transaction-timeout",
        app="tsdb-mysql", mode="all",
        spec={"action": "delay",
              "delay": {"latency": "15s", "jitter": "5s", "correlation": "0"},
              "direction": "to",
              "target": {"mode": "all", "selector": {
                  "namespaces": [_TARGET_NAMESPACE],
                  "expressionSelectors": [{
                      "key": "app", "operator": "In",
                      "values": ["ts-order-service", "ts-preserve-service",
                                 "ts-travel-service", "ts-user-service"]}]}}}),
}


def build_mesh_crd(label_or_name) -> Dict:
    """Render the Chaos Mesh CRD document for a TT chaosmesh experiment."""
    label = _as_label(label_or_name)
    shape = _MESH_SHAPES.get(label.experiment)
    if shape is None:
        raise ValueError(f"{label.experiment} is not a Chaos Mesh experiment")
    doc: Dict = {
        "apiVersion": _API_VERSION,
        "kind": shape["kind"],
        "metadata": {
            "name": shape["name"],
            "namespace": _CRD_NAMESPACE,
            "labels": {
                "experiment_id": f"chaos-{shape['name']}",
                "anomaly_level": label.anomaly_level,
                "anomaly_type": label.anomaly_type,
                "target_service": shape["app"],
            },
        },
        "spec": dict(shape["spec"]),
    }
    if shape["kind"] != "Schedule":  # Schedule nests the selector in podChaos
        doc["spec"]["selector"] = {
            "namespaces": [_TARGET_NAMESPACE],
            "labelSelectors": {"app": shape["app"]},
        }
        if shape["mode"] is not None:
            doc["spec"]["mode"] = shape["mode"]
        if shape.get("value") is not None:
            doc["spec"]["value"] = shape["value"]
    return doc


def parse_mesh_crd(doc: Dict) -> Optional[FaultLabel]:
    """Recover the FaultLabel from a CRD's metadata labels.

    Mirrors how start_chaos.sh:24-27 reads experiment metadata back out of the
    YAML.  Matching is by (anomaly_level, anomaly_type) + CRD name against the
    known taxonomy; returns None for unknown documents.
    """
    meta = doc.get("metadata", {}).get("labels", {})
    lvl, typ = meta.get("anomaly_level"), meta.get("anomaly_type")
    name = doc.get("metadata", {}).get("name")
    for exp, shape in _MESH_SHAPES.items():
        label = label_for(exp)
        if shape["name"] == name or (
                label and label.anomaly_level == lvl and label.anomaly_type == typ):
            return label
    return None


def mesh_crd_yaml(label_or_name) -> str:
    """CRD as YAML text (what `kubectl apply -f` would consume), the bytes
    PyYAML's ``safe_dump(..., sort_keys=False)`` gives, written by the
    port's own :mod:`~anomod_torch.utils.yamlsafe`."""
    return yamlsafe.dump(build_mesh_crd(label_or_name))


def parse_mesh_crd_yaml(text: str) -> Optional[FaultLabel]:
    return parse_mesh_crd(yamlsafe.load(text))


# ---------------------------------------------------------------------------
# ChaosBlade argv (SN host faults + TT JVM faults) and docker argv
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BladeCommand:
    """One `blade create ...` invocation (argv after the binary)."""
    args: Tuple[str, ...]
    needs_sudo: bool = False          # automated_multimodal_collection.sh:347,377
    k8s: bool = False                 # TT container-jvm faults

    @property
    def action(self) -> str:
        return " ".join(self.args[1:3] if not self.k8s else self.args[1:4])


# SN process-kill targets: service → C++ process name
# (automated_multimodal_collection.sh:376,391,402).
_SN_PROCESS = {
    "user-timeline-service": "UserTimelineService",
    "media-service": "MediaService",
    "social-graph-service": "SocialGraphService",
}
# SN redis cache-limit targets: culprit service → redis compose container
# (automated_multimodal_collection.sh:416-418).
_SN_REDIS = {
    "home-timeline-service": "socialnetwork_home-timeline-redis_1",
    "user-timeline-service": "socialnetwork_user-timeline-redis_1",
    "social-graph-service": "socialnetwork_social-graph-redis_1",
}
# TT JVM fault plans: experiment → (blade jvm action, class, method, extras)
# (run_experiment.sh:299-346).
_TT_JVM = {
    "Lv_C_security_check": (
        "return", "security.service.SecurityServiceImpl", "check",
        ("--value",
         "new edu.fudan.common.util.Response(0, 'CHAOS_SECURITY_CHECK_FAILURE', null)")),
    "Lv_C_exception_injection": (
        "throwCustomException", "order.service.OrderServiceImpl", "create",
        ("--exception", "java.lang.RuntimeException",
         "--exception-message", "CHAOS_EXCEPTION_INJECTION")),
    "Lv_C_travel_detail_failure": (
        "return", "travel.service.TravelServiceImpl", "getTripAllDetailInfo",
        ("--value", "null")),
}


def blade_create_command(label_or_name) -> Optional[BladeCommand]:
    """The `blade create` argv for a chaosblade experiment; None when the
    fault is not blade-driven (Chaos Mesh, docker stop, or normal)."""
    label = _as_label(label_or_name)
    if label.chaos_tool != "chaosblade":
        return None
    exp, typ, tgt = label.experiment, label.anomaly_type, label.target_service
    if label.testbed == "TT":
        action, cls, method, extras = _TT_JVM[exp]
        pod = f"{tgt}-0"  # synthetic pod name; live path resolves via kubectl
        return BladeCommand(
            ("create", "k8s", "container-jvm", action,
             "--classname", cls, "--methodname", method, *extras,
             "--names", pod, "--container-names", tgt,
             "--process", "java", "--namespace", _TARGET_NAMESPACE),
            needs_sudo=False, k8s=True)
    if typ == "cpu_contention":
        return BladeCommand(("create", "cpu", "load",
                             "--cpu-percent", "100", "--timeout", "300"))
    if typ == "network_loss":
        return BladeCommand(("create", "network", "loss", "--interface",
                             "docker0", "--percent", "50", "--timeout", "300"),
                            needs_sudo=True)
    if typ == "disk_io_stress":
        return BladeCommand(("create", "disk", "burn", "--read", "--write",
                             "--path", "/var/log", "--size", "1024",
                             "--timeout", "300"))
    if typ == "kill_service_instance":
        return BladeCommand(("create", "process", "kill", "--process",
                             _SN_PROCESS[tgt], "--signal", "9"),
                            needs_sudo=True)
    if typ == "cache_limit":
        return BladeCommand(("create", "redis", "cache-limit", "--addr",
                             f"{_SN_REDIS[tgt]}:6379", "--password", "",
                             "--percent", "50", "--timeout", "300"))
    if typ == "process_stop":
        return None  # docker stop, not blade — see docker_command
    raise ValueError(f"no blade plan for {exp}")


def docker_command(label_or_name) -> Optional[Tuple[str, ...]]:
    """SN code-level faults are plain container stops
    (automated_multimodal_collection.sh:464-479)."""
    label = _as_label(label_or_name)
    if label.testbed == "SN" and label.anomaly_type == "process_stop":
        return ("docker", "stop", f"socialnetwork_{label.target_service}_1")
    return None


# UID extraction, the three observed ChaosBlade output formats
# (run_experiment.sh:357-368).
_UID_RESULT = re.compile(r'"result"\s*:\s*"([^"]+)"')
_UID_UID = re.compile(r'"Uid"\s*:\s*"([^"]+)"')
_UID_TEXT = re.compile(r"uid\s*:\s*(\S+)")


def parse_blade_output(output: str) -> Optional[str]:
    """Extract the experiment UID from `blade create` output (JSON
    ``result``/``Uid`` fields, or legacy ``uid: <x>`` text), else None."""
    for pat in (_UID_RESULT, _UID_UID, _UID_TEXT):
        m = pat.search(output)
        if m:
            return m.group(1)
    return None


# ---------------------------------------------------------------------------
# In-process controller (lifecycle over the synthetic SUT)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosHandle:
    uid: str
    label: FaultLabel
    plan: str          # "mesh" | "blade" | "docker" | "none"


class ChaosController:
    """Owns inject→status→destroy for synthetic experiments.

    Lifecycle semantics follow the reference: `create` returns a UID
    (blade-style JSON), `status` lists active experiments (`blade status
    --type create`), `destroy`/`destroy_all` tear down (stop_chaos.sh; the
    pre-run sweep of automated_multimodal_collection.sh:732-781 destroys
    *everything* left over).  Active faults expose the generator's effect
    model so collection conditioned through a controller matches collection
    conditioned directly by label.
    """

    def __init__(self) -> None:
        self._active: Dict[str, ChaosHandle] = {}
        self._counter = 0

    def _new_uid(self, label: FaultLabel) -> str:
        self._counter += 1
        h = hashlib.sha1(f"{label.experiment}:{self._counter}".encode())
        return h.hexdigest()[:16]

    def create(self, label_or_name) -> ChaosHandle:
        label = _as_label(label_or_name)
        if not label.is_anomaly:
            plan = "none"
        elif label.chaos_tool == "chaosmesh":
            build_mesh_crd(label)          # validates a CRD shape exists
            plan = "mesh"
        elif docker_command(label) is not None:
            plan = "docker"
        else:
            cmd = blade_create_command(label)
            if cmd is None:
                raise ValueError(f"no injection plan for {label.experiment}")
            plan = "blade"
        handle = ChaosHandle(self._new_uid(label), label, plan)
        if label.is_anomaly:
            self._active[handle.uid] = handle
        return handle

    def create_result_json(self, label_or_name) -> str:
        """Blade-shaped create output (what parse_blade_output consumes)."""
        h = self.create(label_or_name)
        return json.dumps({"code": 200, "success": True, "result": h.uid})

    def status(self) -> List[ChaosHandle]:
        return list(self._active.values())

    def destroy(self, uid: str) -> bool:
        return self._active.pop(uid, None) is not None

    def destroy_all(self) -> int:
        n = len(self._active)
        self._active.clear()
        return n

    def active_effects(self, service: str) -> Tuple[float, float]:
        """Aggregate (latency_multiplier, error_probability) the active
        faults impose on ``service`` — the synthetic SUT's response to
        injection.  Multiple faults compound multiplicatively on latency and
        take the max error rate, floored at the generator's baseline."""
        from anomod_torch.synth import _fault_effects
        lat, err = 1.0, 0.002
        for h in self._active.values():
            f_lat, f_err = _fault_effects(h.label)
            tgt = h.label.target_service
            if tgt == service or tgt == "":   # host-level faults hit everyone
                lat *= f_lat
                err = max(err, f_err)
        return lat, err

    # Context-manager form: the reference guards every run with ERR/EXIT
    # traps that destroy chaos on the way out (run_experiment.sh:407-411,
    # run_all_experiments.sh:12-30).
    def inject(self, label_or_name) -> "_Injection":
        return _Injection(self, _as_label(label_or_name))


class _Injection:
    def __init__(self, ctl: ChaosController, label: FaultLabel) -> None:
        self._ctl, self._label = ctl, label
        self.handle: Optional[ChaosHandle] = None

    def __enter__(self) -> ChaosHandle:
        self.handle = self._ctl.create(self._label)
        return self.handle

    def __exit__(self, *exc) -> None:
        if self.handle is not None:
            self._ctl.destroy(self.handle.uid)


def _as_label(label_or_name) -> FaultLabel:
    if isinstance(label_or_name, FaultLabel):
        return label_or_name
    label = label_for(str(label_or_name))
    if label is None:
        raise ValueError(f"unknown experiment: {label_or_name!r}")
    return label


def mesh_experiments() -> List[str]:
    return sorted(_MESH_SHAPES)
