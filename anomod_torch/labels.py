"""Fault taxonomy + ground-truth labels for both testbeds.

Sources (reference, read-only):
  - SN experiment menu: automated_multimodal_collection.sh:904-916
    (12 anomalies + Normal_Baseline; format ``type:Name``).
  - TT experiment menu: run_all_experiments.sh:661-672
    (format ``name:chaos_type:display``); Normal_case via run_normal_case:437.
  - TT chaos metadata labels (anomaly_level / anomaly_type / target_service):
    chaos-experiments/*.yaml, e.g. Lv_P_CPU_preserve.yaml:6-11.
  - TT JVM (code-level) faults: run_experiment.sh:293-351 — ChaosBlade
    container-jvm against ts-security-service / ts-order-service /
    ts-travel-service.
  - Taxonomy table: chaos-experiments/README.md:23-37.

Four anomaly levels: performance / service / database / code, plus "normal".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

LEVELS = ("normal", "performance", "service", "database", "code")


@dataclasses.dataclass(frozen=True)
class FaultLabel:
    experiment: str          # canonical experiment base name (no timestamp)
    testbed: str             # "SN" | "TT"
    anomaly_level: str       # one of LEVELS
    anomaly_type: str        # e.g. "cpu_contention"
    target_service: str      # culprit service name ("" for normal/host-level)
    chaos_tool: str          # "chaosblade" | "chaosmesh" | "none"

    @property
    def is_anomaly(self) -> bool:
        return self.anomaly_level != "normal"


# --- SN: 12 anomalies + baseline (ChaosBlade on a single Docker host).
# Host-level performance faults have no single culprit *service*; the
# reference's sanity checks look at host metrics instead
# (SN_collection-scripts/README.md:106).  We record the stressed component.
SN_LABELS: Tuple[FaultLabel, ...] = (
    FaultLabel("Normal_Baseline", "SN", "normal", "baseline", "", "none"),
    FaultLabel("Perf_CPU_Contention", "SN", "performance", "cpu_contention", "", "chaosblade"),
    FaultLabel("Perf_Network_Loss", "SN", "performance", "network_loss", "", "chaosblade"),
    FaultLabel("Perf_Disk_IO_Stress", "SN", "performance", "disk_io_stress", "", "chaosblade"),
    FaultLabel("Svc_Kill_UserTimeline", "SN", "service", "kill_service_instance",
               "user-timeline-service", "chaosblade"),
    FaultLabel("Svc_Kill_Media", "SN", "service", "kill_service_instance",
               "media-service", "chaosblade"),
    FaultLabel("Svc_Kill_SocialGraph", "SN", "service", "kill_service_instance",
               "social-graph-service", "chaosblade"),
    FaultLabel("DB_Redis_CacheLimit_HomeTimeline", "SN", "database", "cache_limit",
               "home-timeline-service", "chaosblade"),
    FaultLabel("DB_Redis_CacheLimit_UserTimeline", "SN", "database", "cache_limit",
               "user-timeline-service", "chaosblade"),
    FaultLabel("DB_Redis_CacheLimit_SocialGraph", "SN", "database", "cache_limit",
               "social-graph-service", "chaosblade"),
    FaultLabel("Code_Stop_UserService", "SN", "code", "process_stop",
               "user-service", "chaosblade"),
    FaultLabel("Code_Stop_TextService", "SN", "code", "process_stop",
               "text-service", "chaosblade"),
    FaultLabel("Code_Stop_MediaService", "SN", "code", "process_stop",
               "media-service", "chaosblade"),
)

# --- TT: 12 anomalies + Normal_case (Chaos Mesh CRDs + ChaosBlade JVM).
TT_LABELS: Tuple[FaultLabel, ...] = (
    FaultLabel("Normal_case", "TT", "normal", "baseline", "", "none"),
    FaultLabel("Lv_P_CPU_preserve", "TT", "performance", "cpu_contention",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_P_DISKIO_preserve", "TT", "performance", "disk_io_stress",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_P_NETLOSS_preserve", "TT", "performance", "network_loss",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_S_DNSFAIL_preserve_no_order", "TT", "service", "dns_failure",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_S_HTTPABORT_preserve", "TT", "service", "http_abort",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_S_KILLPOD_preserve", "TT", "service", "kill_service_instance",
               "ts-preserve-service", "chaosmesh"),
    FaultLabel("Lv_D_cachelimit", "TT", "database", "cache_limit",
               "ts-order-service", "chaosmesh"),  # MySQL mem stress upstream of order
    FaultLabel("Lv_D_CONNECTION_POOL_exhaustion", "TT", "database", "connection_pool_exhaustion",
               "ts-order-service", "chaosmesh"),
    FaultLabel("Lv_D_TRANSACTION_timeout", "TT", "database", "transaction_timeout",
               "ts-order-service", "chaosmesh"),
    FaultLabel("Lv_C_security_check", "TT", "code", "return_fault",
               "ts-security-service", "chaosblade"),
    FaultLabel("Lv_C_exception_injection", "TT", "code", "throw_exception",
               "ts-order-service", "chaosblade"),
    FaultLabel("Lv_C_travel_detail_failure", "TT", "code", "return_fault",
               "ts-travel-service", "chaosblade"),
)

ALL_LABELS: Tuple[FaultLabel, ...] = SN_LABELS + TT_LABELS

_BY_NAME: Dict[str, FaultLabel] = {l.experiment: l for l in ALL_LABELS}

# Experiment dir names carry timestamps:
#   SN: <Base>_<YYYYMMDD_HHMMSS>[_<modality>_<YYYY-MM-DD_HH-MM-SS>]
#   TT: <Base>_<ISO8601Z>_em   (run_all_experiments.sh:554-555)
_SN_TS = re.compile(r"_\d{8}_\d{6}.*$")
_TT_TS = re.compile(r"_\d{8}T\d{6}Z(_em)?.*$")


def canonical_experiment(dir_name: str) -> str:
    """Strip timestamp/modality suffixes from an experiment directory name.

    Handles both suffix orders: ``<Base>_<ts>_em`` (anomalies) and
    ``Normal_case_em_<ts>`` (run_all_experiments.sh:554-555 vs :447).
    """
    base = _TT_TS.sub("", dir_name)
    base = _SN_TS.sub("", base)
    if base.endswith("_em"):
        base = base[:-3]
    return base


def label_for(dir_or_name: str) -> Optional[FaultLabel]:
    return _BY_NAME.get(canonical_experiment(dir_or_name))


def labels_for_testbed(testbed: str) -> List[FaultLabel]:
    return [l for l in ALL_LABELS if l.testbed == testbed]


def anomalous_labels(testbed: Optional[str] = None) -> List[FaultLabel]:
    return [l for l in ALL_LABELS
            if l.is_anomaly and (testbed is None or l.testbed == testbed)]
