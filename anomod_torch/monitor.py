"""SN API-response monitoring subsystem — active/passive monitors + capture
orchestrator, re-designed as deterministic request programs over the
synthetic SUT.

Counterpart of ``anomod/monitor.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

Reference behavior contracts (all under
``SN_collection-scripts/Dataset/api_responses/``):

- ``enhanced_openapi_monitor.py`` — the *active* monitor: probes the 12
  wrk2-api endpoints (:36-49), POST for
  register/login/compose/upload/follow/unfollow with per-endpoint body
  synthesis (:104-134), connectivity pre-check before the monitoring loop
  (:82-96), JSONL record append (:297-298), summary/p95/p99 + per-endpoint
  reports (:318-397).
- ``monitor_http_responses.py`` — the *passive* fallback: GET-only sampling
  limited to the first 3 endpoints per cycle (:126-127), same record
  contract.
- ``collect_openapi_response.sh`` — the orchestrator: runs the monitor
  concurrently with collection (:84-89), optionally captures gateway traffic
  and post-processes it into ``traffic_analysis.json`` (:117-142, via
  tshark; here the captured :class:`~anomod_torch.schemas.ApiBatch` is analyzed
  directly by :func:`anomod_torch.io.api.analyze_api_batch` — same output, no
  pcap detour).

Requests execute against :class:`anomod_torch.scenario.SyntheticGateway` (routing
by explicit SN owner service), so an active
:class:`~anomod_torch.chaos.ChaosController` fault conditions monitor traffic the
same way it conditions every other modality.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch.scenario import RequestSpec, SyntheticGateway
from anomod_torch.schemas import ApiBatch
from anomod_torch.workload import sample_wrk2_request

# The 12 SN gateway endpoints (enhanced_openapi_monitor.py:36-49) with their
# owning services (docker-compose-gcov.yml service set) and the method rule
# of make_sample_request (POST iff register/login/compose/upload/
# follow/unfollow, :104).
SN_ENDPOINTS: Tuple[Tuple[str, str, str], ...] = (
    ("POST", "/wrk2-api/user/register", "user-service"),
    ("POST", "/wrk2-api/user/follow", "social-graph-service"),
    ("POST", "/wrk2-api/user/unfollow", "social-graph-service"),
    ("POST", "/wrk2-api/user/login", "user-service"),
    ("POST", "/wrk2-api/post/compose", "compose-post-service"),
    ("GET", "/wrk2-api/home-timeline/read", "home-timeline-service"),
    ("GET", "/wrk2-api/user-timeline/read", "user-timeline-service"),
    ("GET", "/wrk2-api/user/profile", "user-service"),
    ("POST", "/wrk2-api/media/upload", "media-service"),
    ("POST", "/wrk2-api/text/upload", "text-service"),
    ("GET", "/wrk2-api/url/shorten", "url-shorten-service"),
    ("POST", "/wrk2-api/user-mention/upload", "user-mention-service"),
)


def synthesize_body(path: str, seq: int) -> Optional[dict]:
    """Deterministic POST-body synthesis per endpoint kind
    (enhanced_openapi_monitor.py:104-134; time-derived uniqueness replaced
    by the monotone ``seq`` so runs are reproducible)."""
    if "register" in path:
        return {"first_name": "Test", "last_name": "User",
                "username": f"testuser_{seq}", "password": "testpass",
                "user_id": seq % 10_000}
    if "login" in path:
        return {"username": "testuser", "password": "testpass"}
    if "compose" in path:
        return {"username": "testuser", "user_id": 1, "text": "Test post",
                "media_ids": [], "media_types": [], "post_type": 0}
    if path.split("/")[-1] in ("upload", "follow", "unfollow"):
        return {}
    return None


def _form_encode(body: Optional[dict]) -> Optional[str]:
    """Flat ``k=v&k=v`` encoding of a synthesized probe body (the monitor
    sends form/JSON payloads; the gateway records the encoded length)."""
    if not body:
        return None
    return "&".join(f"{k}={v}" for k, v in body.items())


def _spec(method: str, path: str, owner: str,
          body: Optional[str] = None) -> RequestSpec:
    return RequestSpec(method, path, path, flow="monitor", owner=owner,
                       body=body)


# The three wrk2 mixed-workload templates (mixed-workload.lua:111-125),
# owner-resolved from the single SN_ENDPOINTS catalog so the two tables
# cannot drift.
_WRK2_TEMPLATES = ("/wrk2-api/post/compose", "/wrk2-api/home-timeline/read",
                   "/wrk2-api/user-timeline/read")
SN_OWNER_BY_TEMPLATE = {path: owner for _, path, owner in SN_ENDPOINTS
                        if path in _WRK2_TEMPLATES}


def run_wrk2_workload(gateway: SyntheticGateway, n_requests: int,
                      seed: int = 0,
                      rng: Optional[np.random.Generator] = None) -> List[int]:
    """Drive ``n_requests`` wrk2 mixed-workload requests (60/30/10 mix with
    the full compose content model, mixed-workload.lua:111-125) through the
    gateway.  Pass ``rng`` to continue one workload stream across several
    calls (the capture orchestrator drives a chunk between monitor cycles)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    statuses: List[int] = []
    for _ in range(n_requests):
        req = sample_wrk2_request(rng)
        owner = SN_OWNER_BY_TEMPLATE[req.template]
        spec = RequestSpec(req.method, req.path, req.template,
                           flow="wrk2", owner=owner, body=req.body)
        statuses += gateway.execute([spec])
    return statuses


@dataclasses.dataclass
class MonitorReport:
    batch: ApiBatch
    connectivity: Dict[str, bool]
    n_cycles: int
    mode: str


class ActiveMonitor:
    """The enhanced monitor: every cycle probes all 12 endpoints with the
    method/body rules above.

    Intentional redesign vs the reference (enhanced_openapi_monitor.py):
    the reference samples only the first 5 *reachable* endpoints per cycle
    (:260,:279) and keeps its connectivity pre-check responses out of
    ``openapi_responses.jsonl``; this monitor probes all 12 endpoints every
    cycle regardless of connectivity and records the 12 pre-check probes in
    the batch.  Deterministic full coverage beats a reachability-dependent
    prefix for a synthetic SUT: the record count is exactly
    ``12 + cycles*12``, so artifacts are reproducible and fault-conditioned
    endpoint gaps can't silently shrink the sample.

    A second intentional deviation rides the gateway's record schema: the
    artifact ``content_length`` is the *request-body* length for POSTs that
    carry one (the synthesized wrk2/monitor body) and a synthetic
    *response* size otherwise, whereas the reference records the response
    Content-Length header for every exchange
    (enhanced_openapi_monitor.py:165).  Consumers of the api_responses
    artifact family should treat content_length as "dominant byte flow of
    the exchange", not strictly response size — chosen so the artifact's
    byte histogram reflects the wrk2 content model the corpus is built
    around (scenario.SyntheticGateway.execute)."""

    mode = "active"
    endpoints = SN_ENDPOINTS

    def __init__(self, seed: int = 0, controller=None) -> None:
        self._gw = SyntheticGateway(seed=seed, controller=controller)
        self._seq = 0

    def connectivity_check(self) -> Dict[str, bool]:
        """One GET per endpoint before monitoring
        (enhanced_openapi_monitor.py:82-96).  Against the synthetic SUT an
        endpoint is unreachable when its probe is *service-aborted* (503,
        the gateway's high-error fault response) — a sporadic baseline 500
        is an application error, not a connection failure, and the
        reference's pre-check only trips on connection errors."""
        out = {}
        for _, path, owner in self.endpoints:
            status = self._gw.execute([_spec("GET", path, owner)])[0]
            out[path] = status != 503
        return out

    def bodies(self) -> List[Optional[dict]]:
        """The POST bodies the next cycle would send (the reference's
        request-data synthesis, observable for tests/tools)."""
        out = []
        for method, path, _ in self.endpoints:
            out.append(synthesize_body(path, self._seq)
                       if method == "POST" else None)
            self._seq += 1
        return out

    def cycle(self) -> List[int]:
        bodies = self.bodies()    # advances the request-id sequence
        specs = [_spec(method, path, owner, body=_form_encode(body))
                 for (method, path, owner), body
                 in zip(self.endpoints, bodies)]
        return self._gw.execute(specs)

    def run(self, cycles: int = 10, before_cycle=None) -> MonitorReport:
        """Pre-check + probe cycles.  ``before_cycle(i)`` (when given) runs
        ahead of each cycle — the capture orchestrator uses it to land a
        chunk of wrk2 workload traffic on the shared gateway.  The
        connectivity pre-check always runs first (even for a workload-only
        cycles=0 capture) so the probe's RNG draws are position-stable."""
        connectivity = self.connectivity_check()
        if cycles == 0 and before_cycle is not None:
            before_cycle(0)
        for c in range(cycles):
            if before_cycle is not None:
                before_cycle(c)
            self.cycle()
        return MonitorReport(self._gw.to_api_batch(), connectivity,
                             cycles, self.mode)


class PassiveMonitor(ActiveMonitor):
    """The fallback sampler: GET-only, limited to the first 3 endpoints per
    cycle (monitor_http_responses.py:126-127)."""

    mode = "passive"

    def cycle(self) -> List[int]:
        specs = [_spec("GET", path, owner)
                 for _, path, owner in self.endpoints[:3]]
        return self._gw.execute(specs)


def capture_openapi_responses(out_dir: Optional[Path] = None,
                              mode: str = "active", cycles: int = 10,
                              seed: int = 0,
                              chaos: Optional[str] = None,
                              wrk2_requests: int = 0) -> MonitorReport:
    """Orchestrate a monitoring capture (collect_openapi_response.sh:60-143):
    optionally inject a fault, run the monitor (with ``wrk2_requests`` of
    concurrent mixed-workload traffic through the same gateway, the
    reference's monitor-plus-wrk2 arrangement), tear down (even on failure,
    like the reference's traps), and — when ``out_dir`` is given —
    materialize the full api_responses artifact family + collection report."""
    controller = None
    if chaos is not None:
        from anomod_torch.chaos import ChaosController
        controller = ChaosController()
        controller.create(chaos)
    try:
        cls = ActiveMonitor if mode == "active" else PassiveMonitor
        monitor = cls(seed=seed, controller=controller)
        before_cycle = None
        if wrk2_requests:
            # interleave the workload with the probe cycles — the
            # reference's monitor-plus-wrk2 concurrency (collect_all_data.sh
            # :319-346) rendered as a deterministic round-robin: a chunk of
            # workload traffic lands on the shared gateway before every
            # monitor cycle, so artifact timestamps mix the two flows.
            wrk2_rng = np.random.default_rng(seed)
            n_cycles = max(cycles, 1)
            per = wrk2_requests // n_cycles
            extra = wrk2_requests - per * n_cycles

            def before_cycle(c):
                # remainder spread one-per-cycle (not lumped into cycle 0)
                # so small request counts still interleave with the probes
                run_wrk2_workload(monitor._gw,
                                  per + (1 if c < extra else 0),
                                  rng=wrk2_rng)
        report = monitor.run(cycles, before_cycle=before_cycle)
    finally:
        if controller is not None:
            controller.destroy_all()
    if out_dir is not None:
        from anomod_torch.io.api import write_api_artifact_family
        out_dir = Path(out_dir)
        write_api_artifact_family(report.batch, out_dir)
        (out_dir / "collection_report.json").write_text(json.dumps({
            "mode": report.mode, "cycles": report.n_cycles,
            "chaos": chaos,
            "endpoints_monitored": [p for _, p, _ in SN_ENDPOINTS],
            "connectivity": report.connectivity,
            "total_requests": int(report.batch.n_records),
        }, indent=2))
    return report
