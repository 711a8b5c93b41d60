"""Generated test suites + the run-id cross-modal join (EvoMaster analog).

Counterpart of ``anomod/suite.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

The reference's workload of record is EvoMaster-generated black-box unittest
suites replayed against the gateway: SN ships 13 tests covering 72 targets
from a 2-minute budget (BlackBox_tests/Final_version_2m/
EvoMaster_successes_Test.py:17-27), TT ships 256 tests covering 825 targets
from a 10-minute budget, every request tagged ``x-evomaster-run-id`` so
traces can be joined back to the driving suite run
(Evomaster/runs/auth_fixed_10m/EvoMaster_successes_Test.py:33-41,65;
run_experiment.sh:534).  Campaigns can also regenerate suites on the fly
from the OpenAPI spec with a time budget (run_experiment.sh:500-555).

Here a suite is *derived* deterministically from the endpoint catalog (the
synthetic SUT's spec): the budget→test-count calibration matches the two
reference data points, tests are success-path request specs with status
assertions, and executing a suite produces BOTH an ApiBatch and the SpanBatch
of traces those requests caused — trace ids carry the run id, so the
cross-modal join the reference does with headers is a first-class indexed
operation here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch.scenario import (RequestSpec, ScenarioDriver,
                                   SyntheticGateway, _spec)
from anomod_torch.schemas import (ApiBatch, KIND_ENTRY, KIND_EXIT, SpanBatch)
from anomod_torch.synth import SN_SERVICES, TT_EDGES, TT_SERVICES

# Reference calibration points: (budget seconds, shipped tests, covered targets)
_CALIBRATION = {"SN": (120.0, 13, 72), "TT": (600.0, 256, 825)}

# SN suite endpoint pool: the wrk2-api surface
# (enhanced_openapi_monitor.py:36-49).
SN_SUITE_ENDPOINTS: Tuple[Tuple[str, str], ...] = (
    ("POST", "/wrk2-api/user/register"),
    ("POST", "/wrk2-api/user/follow"),
    ("POST", "/wrk2-api/user/unfollow"),
    ("POST", "/wrk2-api/user/login"),
    ("POST", "/wrk2-api/post/compose"),
    ("GET", "/wrk2-api/home-timeline/read"),
    ("GET", "/wrk2-api/user-timeline/read"),
    ("GET", "/wrk2-api/user/profile"),
    ("POST", "/wrk2-api/media/upload"),
    ("POST", "/wrk2-api/text/upload"),
    ("POST", "/wrk2-api/url/shorten"),
    ("POST", "/wrk2-api/user-mention/upload"),
)

# wrk2-api path → SN owning service (the nginx route table)
SN_ROUTE = {
    "/wrk2-api/user/register": "user-service",
    "/wrk2-api/user/follow": "social-graph-service",
    "/wrk2-api/user/unfollow": "social-graph-service",
    "/wrk2-api/user/login": "user-service",
    "/wrk2-api/post/compose": "compose-post-service",
    "/wrk2-api/home-timeline/read": "home-timeline-service",
    "/wrk2-api/user-timeline/read": "user-timeline-service",
    "/wrk2-api/user/profile": "user-service",
    "/wrk2-api/media/upload": "media-service",
    "/wrk2-api/text/upload": "text-service",
    "/wrk2-api/url/shorten": "url-shorten-service",
    "/wrk2-api/user-mention/upload": "user-mention-service",
}


@dataclasses.dataclass(frozen=True)
class SuiteTest:
    name: str                      # test_0 … test_N (generated naming)
    spec: RequestSpec
    expect_status: Tuple[int, ...] = (200, 201)


@dataclasses.dataclass(frozen=True)
class Suite:
    testbed: str
    run_id: str
    budget_s: float
    tests: Tuple[SuiteTest, ...]

    @property
    def n_tests(self) -> int:
        return len(self.tests)

    @property
    def covered_targets(self) -> int:
        """Coverage-target count scaled from the reference calibration
        (72 targets at 13 SN tests; 825 at 256 TT tests), saturating at the
        reference ceiling."""
        _, ref_tests, ref_targets = _CALIBRATION[self.testbed]
        return int(round(ref_targets * min(1.0, self.n_tests / ref_tests)))


def n_tests_for_budget(testbed: str, budget_s: float) -> int:
    """Linear budget→tests using the testbed's reference rate."""
    ref_budget, ref_tests, _ = _CALIBRATION[testbed]
    return max(1, int(round(ref_tests * budget_s / ref_budget)))


def _endpoint_pool(testbed: str) -> List[RequestSpec]:
    if testbed == "SN":
        return [_spec(m, p) for m, p in SN_SUITE_ENDPOINTS]
    # TT: the unique request templates one scenario pass exercises
    seen: Dict[str, RequestSpec] = {}
    for s in ScenarioDriver(seed=0).iteration():
        seen.setdefault(s.endpoint, s)
    return [seen[k] for k in sorted(seen)]


def generate_suite(testbed: str, budget_s: Optional[float] = None,
                   n_tests: Optional[int] = None, seed: int = 0,
                   spec: Optional[dict] = None) -> Suite:
    """Deterministic suite from the endpoint catalog.

    ``budget_s`` mirrors the on-the-fly `--maxTime` generation flow
    (run_experiment.sh:523-535); ``n_tests`` pins the count directly (the
    shipped-suite flow).  Defaults to the testbed's reference budget.

    ``spec`` switches the endpoint pool to a parsed OpenAPI/Swagger
    document (anomod_torch.openapi) — the ``--bbSwaggerUrl`` flow: the suite's
    request surface comes from the spec instead of the internal catalog,
    with the same budget calibration and run-id stamping."""
    if testbed not in _CALIBRATION:
        raise ValueError(f"unknown testbed: {testbed!r}")
    if budget_s is None and n_tests is None:
        budget_s = _CALIBRATION[testbed][0]
    if n_tests is None:
        n_tests = n_tests_for_budget(testbed, budget_s)
    if spec is not None:
        from anomod_torch.openapi import endpoint_pool_from_spec
        pool = endpoint_pool_from_spec(spec, seed=seed)
    else:
        pool = _endpoint_pool(testbed)
    rng = np.random.default_rng(seed)
    run_id = "em-" + hashlib.sha1(
        f"{testbed}:{n_tests}:{seed}".encode()).hexdigest()[:12]
    tests = []
    for i in range(n_tests):
        # round-robin guarantees pool coverage; rng breaks phase alignment
        req = pool[i % len(pool)] if i < len(pool) else \
            pool[int(rng.integers(len(pool)))]
        tests.append(SuiteTest(f"test_{i}", req))
    return Suite(testbed, run_id, float(budget_s or 0.0), tuple(tests))


# ---------------------------------------------------------------------------
# Execution: requests + the traces they cause, joined by run id
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SuiteRun:
    suite: Suite
    api: ApiBatch
    spans: SpanBatch
    passed: np.ndarray          # bool per (iteration, test), flattened
    trace_of_request: np.ndarray  # int32: api record i → trace index

    @property
    def pass_rate(self) -> float:
        return float(self.passed.mean()) if self.passed.size else 0.0


def _service_of(testbed: str, spec: RequestSpec) -> str:
    if testbed == "SN":
        return SN_ROUTE.get(spec.template, "nginx-web-server")
    return spec.service


def _downstream(testbed: str, service: str, rng) -> List[str]:
    """One seeded downstream hop chain from the entry service."""
    if testbed == "SN":
        from anomod_torch.synth import SN_EDGES
        edges = SN_EDGES
    else:
        edges = TT_EDGES
    out: List[str] = []
    cur = service
    for _ in range(2):
        kids = [b for a, b in edges if a == cur]
        if not kids or rng.random() < 0.3:
            break
        cur = kids[int(rng.integers(len(kids)))]
        out.append(cur)
    return out


def run_suite(suite: Suite, iterations: int = 1, seed: int = 0,
              controller=None) -> SuiteRun:
    """Replay the suite ``iterations`` times (collect_all_modalities.sh:152-171
    replays the TT suite EVOMASTER_TEST_ITERATIONS times) against the
    synthetic SUT; emit the api records AND the traces they cause."""
    testbed = suite.testbed
    services = SN_SERVICES if testbed == "SN" else TT_SERVICES
    svc_idx = {s: i for i, s in enumerate(services)}
    gateway_svc = "nginx-web-server" if testbed == "SN" else "ts-gateway-service"
    gw = SyntheticGateway(seed=seed, controller=controller)
    rng = np.random.default_rng(seed + 1)

    # span columns
    trace_c: List[int] = []; parent_c: List[int] = []
    service_c: List[int] = []; endpoint_c: List[int] = []
    start_c: List[int] = []; dur_c: List[int] = []
    err_c: List[bool] = []; status_c: List[int] = []; kind_c: List[int] = []
    trace_ids: List[str] = []
    endpoints: Dict[str, int] = {}
    passed: List[bool] = []
    trace_of_request: List[int] = []

    for it in range(iterations):
        for ti, test in enumerate(suite.tests):
            statuses = gw.execute([test.spec])
            status = statuses[0]
            _, t_s, _, latency_ms, _ = gw.last_row
            passed.append(status in test.expect_status)

            # the trace this request caused, id stamped with the run id
            # (the x-evomaster-run-id join, EvoMaster_successes_Test.py:65)
            tid = len(trace_ids)
            trace_ids.append(f"{suite.run_id}-{it}-{ti}")
            trace_of_request.append(tid)
            ep = endpoints.setdefault(test.spec.endpoint, len(endpoints))
            entry_svc = _service_of(testbed, test.spec)
            start_us = int(t_s * 1e6)
            total_us = max(int(latency_ms * 1e3), 10)

            def emit(svc: str, parent_row: int, kind: int, frac: float) -> int:
                service_c.append(svc_idx.get(svc, 0))
                trace_c.append(tid)
                parent_c.append(parent_row)
                endpoint_c.append(ep)
                start_c.append(start_us + int(total_us * (1 - frac) * 0.2))
                dur_c.append(max(int(total_us * frac), 5))
                err_c.append(status >= 500)
                status_c.append(status)
                kind_c.append(kind)
                return len(trace_c) - 1

            root = emit(gateway_svc, -1, KIND_ENTRY, 1.0)
            ex = emit(gateway_svc, root, KIND_EXIT, 0.9)
            entry = emit(entry_svc, ex, KIND_ENTRY, 0.85)
            prev, prev_svc = entry, entry_svc
            frac = 0.6
            for svc in _downstream(testbed, entry_svc, rng):
                ex2 = emit(prev_svc, prev, KIND_EXIT, frac)
                prev = emit(svc, ex2, KIND_ENTRY, frac * 0.9)
                prev_svc = svc
                frac *= 0.6

    spans = SpanBatch(
        trace=np.array(trace_c, np.int32),
        parent=np.array(parent_c, np.int32),
        service=np.array(service_c, np.int32),
        endpoint=np.array(endpoint_c, np.int32),
        start_us=np.array(start_c, np.int64),
        duration_us=np.array(dur_c, np.int64),
        is_error=np.array(err_c, np.bool_),
        status=np.array(status_c, np.int16),
        kind=np.array(kind_c, np.int8),
        services=tuple(services),
        endpoints=tuple(endpoints),
        trace_ids=tuple(trace_ids),
    )
    return SuiteRun(suite, gw.to_api_batch(), spans,
                    np.array(passed, np.bool_),
                    np.array(trace_of_request, np.int32))


def traces_for_run(spans: SpanBatch, run_id: str) -> np.ndarray:
    """Trace indices belonging to a suite run — the join the reference does
    by filtering SkyWalking traces on the x-evomaster-run-id tag."""
    wanted = np.array([tid.startswith(run_id + "-")
                       for tid in spans.trace_ids], np.bool_)
    return np.flatnonzero(wanted)


def endpoint_owner(endpoint: str, testbed: str) -> str:
    """Owning service for a monitored endpoint — topology ground truth.

    SN: the nginx route table over the wrk2-api surface (the monitor's
    endpoint list, enhanced_openapi_monitor.py:36-49); full URLs are reduced
    to their path first.  TT: endpoints are ``/api/v1/<short>service`` per
    the gateway's path convention (atomic_queries.py), inverted back to the
    ``ts-*-service`` name.
    """
    if testbed == "SN":
        from urllib.parse import urlparse
        path = urlparse(endpoint).path if "://" in endpoint else endpoint
        return SN_ROUTE.get(path, "nginx-web-server")
    for s in TT_SERVICES:
        short = s.replace("ts-", "").replace("-service", "")
        if endpoint.rstrip("/").endswith(f"/{short}service"):
            return s
    return "ts-gateway-service"
