"""TT scenario driver — the hand-written user-journey workload, re-designed
as a deterministic request-program generator over the synthetic SUT.

Counterpart of ``anomod/scenario.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

The reference drives a live Train-Ticket cluster with ~25 atomic HTTP
primitives (train-ticket-auto-query/atomic_queries.py: `_login`:31,
`_query_high_speed_ticket`:71, `_query_orders`:256, `_pay_one_order`:370,
`_cancel_one_order`:389, `_collect_one_order`:403, `_enter_station`:415,
`_rebook_ticket`:499, `_put_consign`:329, admin queries :475-525) chained
into service-category flows plus a condensed booking flow
(test_all_services.py: core :127-196, auxiliary :198-265, admin :267-297,
extended :299-384, complete flow :386-427), with a token refresh every 10
iterations (:436-441).

Here the same flows are *programs*: each primitive emits a
:class:`RequestSpec` (method, path, owning service); the
:class:`ScenarioDriver` sequences them with the same data dependencies
(query orders → pay first unpaid → collect/enter first paid → rebook) over an
explicit order state machine; and the :class:`SyntheticGateway` executes the
program against the synthetic SUT — routing by path the way the real gateway
does, applying any active :class:`~anomod_torch.chaos.ChaosController` faults to
latency/error, and accumulating a schema-exact
:class:`~anomod_torch.schemas.ApiBatch`.  Execution is seeded and fully
reproducible, so the driver doubles as a traffic model for the generator and
a workload for replay benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch.schemas import ApiBatch

# ---------------------------------------------------------------------------
# Routing: path prefix → owning ts-* service (the gateway's dispatch table).
# Endpoints from atomic_queries.py / test_all_services.py cited above.
# ---------------------------------------------------------------------------

PATH_SERVICE: Tuple[Tuple[str, str], ...] = (
    ("/api/v1/users/login", "ts-user-service"),
    ("/api/v1/auth", "ts-auth-service"),
    ("/api/v1/travelservice", "ts-travel-service"),
    ("/api/v1/travel2service", "ts-travel2-service"),
    ("/api/v1/travelplanservice", "ts-travel-plan-service"),
    ("/api/v1/routeplanservice", "ts-route-plan-service"),
    ("/api/v1/routeservice", "ts-route-service"),
    ("/api/v1/assuranceservice", "ts-assurance-service"),
    ("/api/v1/foodservice", "ts-food-service"),
    ("/api/v1/stationfoodservice", "ts-station-food-service"),
    ("/api/v1/trainfoodservice", "ts-train-food-service"),
    ("/api/v1/fooddeliveryservice", "ts-food-delivery-service"),
    ("/api/v1/contactservice", "ts-contacts-service"),
    ("/api/v1/orderOtherService", "ts-order-other-service"),
    ("/api/v1/orderservice", "ts-order-service"),
    ("/api/v1/preserveservice", "ts-preserve-service"),
    ("/api/v1/preserveotherservice", "ts-preserve-other-service"),
    ("/api/v1/securityservice", "ts-security-service"),
    ("/api/v1/inside_pay_service", "ts-inside-payment-service"),
    ("/api/v1/paymentservice", "ts-payment-service"),
    ("/api/v1/cancelservice", "ts-cancel-service"),
    ("/api/v1/executeservice", "ts-execute-service"),
    ("/api/v1/rebookservice", "ts-rebook-service"),
    ("/api/v1/consignservice", "ts-consign-service"),
    ("/api/v1/consignpriceservice", "ts-consign-price-service"),
    ("/api/v1/deliveryservice", "ts-delivery-service"),
    ("/api/v1/notificationservice", "ts-notification-service"),
    ("/api/v1/newsservice", "ts-news-service"),
    ("/api/v1/voucherservice", "ts-voucher-service"),
    ("/api/v1/waitorderservice", "ts-wait-order-service"),
    ("/api/v1/basicservice", "ts-basic-service"),
    ("/api/v1/configservice", "ts-config-service"),
    ("/api/v1/stationservice", "ts-station-service"),
    ("/api/v1/trainservice", "ts-train-service"),
    ("/api/v1/adminbasicservice", "ts-admin-basic-info-service"),
    ("/api/v1/admintravelservice", "ts-admin-travel-service"),
    ("/api/v1/adminorderservice", "ts-admin-order-service"),
    ("/api/v1/adminrouteservice", "ts-admin-route-service"),
    ("/api/v1/adminuserservice", "ts-admin-user-service"),
    ("/api/v1/avatarservice", "ts-avatar-service"),
    ("/api/v1/verifycode", "ts-verification-code-service"),
)


def route(path: str) -> str:
    """Owning service for a request path (longest-prefix wins)."""
    best = ""
    svc = "ts-gateway-service"
    for prefix, service in PATH_SERVICE:
        if path.startswith(prefix) and len(prefix) > len(best):
            best, svc = prefix, service
    return svc


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    method: str
    path: str            # instantiated path
    template: str        # canonical path template (stable endpoint vocab)
    flow: str = ""       # which scenario flow emitted it
    owner: str = ""      # explicit owning service (SN specs); "" = TT route
    body: Optional[str] = None   # synthesized request body (wrk2 model)

    @property
    def service(self) -> str:
        return self.owner or route(self.path)

    @property
    def endpoint(self) -> str:
        return f"{self.method} {self.template}"


def _spec(method: str, path: str, template: Optional[str] = None,
          flow: str = "") -> RequestSpec:
    return RequestSpec(method, path, template or path, flow)


# ---------------------------------------------------------------------------
# Atomic primitives (atomic_queries.py equivalents, citations above).
# Each returns the RequestSpec(s) the reference primitive would issue.
# ---------------------------------------------------------------------------

def login() -> RequestSpec:
    return _spec("POST", "/api/v1/users/login")


def query_high_speed_ticket() -> RequestSpec:
    return _spec("POST", "/api/v1/travelservice/trips/left")


def query_high_speed_ticket_parallel() -> RequestSpec:
    return _spec("POST", "/api/v1/travelservice/trips/left_parallel")


def query_normal_ticket() -> RequestSpec:
    return _spec("POST", "/api/v1/travel2service/trips/left")


def query_advanced_ticket(plan_type: str) -> RequestSpec:
    return _spec("POST", f"/api/v1/travelplanservice/travelPlan/{plan_type}",
                 "/api/v1/travelplanservice/travelPlan/{type}")


def query_assurances() -> RequestSpec:
    return _spec("GET", "/api/v1/assuranceservice/assurances/types")


def query_food(date: str = "2026-01-05", src: str = "Shang Hai",
               dst: str = "Su Zhou", train: str = "D1345") -> RequestSpec:
    return _spec("GET", f"/api/v1/foodservice/foods/{date}/{src}/{dst}/{train}",
                 "/api/v1/foodservice/foods/{date}/{from}/{to}/{train}")


def query_contacts(account_id: str = "uid-0") -> RequestSpec:
    return _spec("GET", f"/api/v1/contactservice/contacts/account/{account_id}",
                 "/api/v1/contactservice/contacts/account/{id}")


def query_orders(other: bool = False) -> RequestSpec:
    if other:
        return _spec("POST", "/api/v1/orderOtherService/orderOther/refresh")
    return _spec("POST", "/api/v1/orderservice/order/refresh")


def put_consign() -> RequestSpec:
    return _spec("PUT", "/api/v1/consignservice/consigns")


def query_route(route_id: str = "route-0") -> RequestSpec:
    return _spec("GET", f"/api/v1/routeservice/routes/{route_id}",
                 "/api/v1/routeservice/routes/{id}")


def preserve() -> RequestSpec:
    """Create a booking — the path the Lv_S_HTTPABORT fault targets
    (Lv_S_HTTPABORT_preserve.yaml:23: /api/v1/preserveservice/*)."""
    return _spec("POST", "/api/v1/preserveservice/preserve")


def pay_one_order(order_id: str) -> RequestSpec:
    return _spec("POST", "/api/v1/inside_pay_service/inside_payment")


def cancel_one_order(order_id: str, uuid: str = "uid-0") -> RequestSpec:
    return _spec("GET", f"/api/v1/cancelservice/cancel/{order_id}/{uuid}",
                 "/api/v1/cancelservice/cancel/{orderId}/{uuid}")


def collect_one_order(order_id: str) -> RequestSpec:
    return _spec("GET", f"/api/v1/executeservice/execute/collected/{order_id}",
                 "/api/v1/executeservice/execute/collected/{orderId}")


def enter_station(order_id: str) -> RequestSpec:
    return _spec("GET", f"/api/v1/executeservice/execute/execute/{order_id}",
                 "/api/v1/executeservice/execute/execute/{orderId}")


def rebook_ticket(old_order_id: str) -> RequestSpec:
    return _spec("POST", "/api/v1/rebookservice/rebook")


def query_cheapest() -> RequestSpec:
    return query_advanced_ticket("cheapest")


def query_min_station() -> RequestSpec:
    return query_advanced_ticket("minStation")


def query_quickest() -> RequestSpec:
    return query_advanced_ticket("quickest")


def query_admin_basic_price() -> RequestSpec:
    return _spec("GET", "/api/v1/adminbasicservice/adminbasic/prices")


def query_admin_basic_config() -> RequestSpec:
    return _spec("GET", "/api/v1/adminbasicservice/adminbasic/configs")


def query_admin_travel() -> RequestSpec:
    return _spec("GET", "/api/v1/admintravelservice/admintravel")


# Extended coverage endpoints (test_all_services.py:299-384): one GET per
# optional service so every microservice appears in the traffic at least once.
EXTENDED_ENDPOINTS: Tuple[Tuple[str, str], ...] = (
    ("POST", "/api/v1/auth/login"),
    ("GET", "/api/v1/avatarservice/avatar/{id}"),
    ("GET", "/api/v1/basicservice/basic/travel"),
    ("GET", "/api/v1/basicservice/basic/stations"),
    ("GET", "/api/v1/configservice/configs"),
    ("GET", "/api/v1/deliveryservice/delivery"),
    ("GET", "/api/v1/fooddeliveryservice/fooddelivery"),
    ("GET", "/api/v1/newsservice/news"),
    ("GET", "/api/v1/paymentservice/payment"),
    ("GET", "/api/v1/routeplanservice/routePlan"),
    ("GET", "/api/v1/stationfoodservice/stationfood"),
    ("GET", "/api/v1/ticketofficeservice/ticketoffice"),
    ("GET", "/api/v1/trainfoodservice/trainfood"),
    ("GET", "/api/v1/voucherservice/vouchers"),
    ("GET", "/api/v1/waitorderservice/waitorder"),
    ("GET", "/api/v1/consignpriceservice/consignprice"),
)


# ---------------------------------------------------------------------------
# Driver: the flow state machine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Order:
    order_id: str
    trip_id: str
    paid: bool = False


class ScenarioDriver:
    """Sequences the reference's five flows with real data dependencies.

    Orders move unpaid → paid → collected/used exactly as the chained
    primitives in test_all_services.py consume them (each step's output feeds
    the next: `_query_orders → _pay_one_order(orders[0])` :169-171).
    """

    def __init__(self, seed: int = 0) -> None:
        self._orders: List[_Order] = []
        self._n_created = 0
        self._seed = seed
        self._iteration = 0

    # -- order state machine ------------------------------------------------
    def _create_order(self) -> _Order:
        self._n_created += 1
        o = _Order(f"order-{self._seed}-{self._n_created}",
                   f"D{1000 + self._n_created % 500}")
        self._orders.append(o)
        return o

    def _first(self, paid: Optional[bool] = None) -> Optional[_Order]:
        for o in self._orders:
            if paid is None or o.paid == paid:
                return o
        return None

    # -- flows --------------------------------------------------------------
    def core_business_flow(self) -> List[RequestSpec]:
        """test_all_services.py:127-196."""
        out = [dataclasses.replace(login(), flow="core")]
        for _ in range(3):
            out.append(dataclasses.replace(query_high_speed_ticket(), flow="core"))
        for _ in range(2):
            out.append(dataclasses.replace(query_normal_ticket(), flow="core"))
        for plan in ("cheapest", "quickest", "minStation"):
            out.append(dataclasses.replace(query_advanced_ticket(plan), flow="core"))
        out.append(dataclasses.replace(query_orders(other=False), flow="core"))
        out.append(dataclasses.replace(query_orders(other=True), flow="core"))
        # booking: the reference leaves preserve as a placeholder; we book so
        # downstream pay/cancel/execute steps have orders to consume.
        out.append(dataclasses.replace(preserve(), flow="core"))
        self._create_order()
        out.append(dataclasses.replace(query_orders(), flow="core"))
        unpaid = self._first(paid=False)
        if unpaid is not None:
            out.append(dataclasses.replace(pay_one_order(unpaid.order_id), flow="core"))
            unpaid.paid = True
        victim = self._first()
        if victim is not None:
            out.append(dataclasses.replace(
                cancel_one_order(victim.order_id), flow="core"))
            self._orders.remove(victim)
        out.append(dataclasses.replace(preserve(), flow="core"))
        o = self._create_order()
        o.paid = True
        paid = self._first(paid=True)
        if paid is not None:
            out.append(dataclasses.replace(collect_one_order(paid.order_id), flow="core"))
            out.append(dataclasses.replace(enter_station(paid.order_id), flow="core"))
            out.append(dataclasses.replace(rebook_ticket(paid.order_id), flow="core"))
            self._orders.remove(paid)   # ticket used; keep state bounded
        return out

    def auxiliary_flow(self) -> List[RequestSpec]:
        """test_all_services.py:198-265 — contacts/assurance/food/consign/
        security/station/train/price/notification."""
        specs = [
            query_contacts(), query_assurances(), query_food(), put_consign(),
            query_route(),
            _spec("GET", "/api/v1/securityservice/securityConfigs"),
            _spec("GET", "/api/v1/stationservice/stations"),
            _spec("GET", "/api/v1/trainservice/trains"),
            _spec("POST", "/api/v1/notificationservice/notification/preserve_success"),
        ]
        return [dataclasses.replace(s, flow="auxiliary") for s in specs]

    def admin_flow(self) -> List[RequestSpec]:
        """test_all_services.py:267-297."""
        specs = [
            query_admin_basic_price(), query_admin_basic_config(),
            query_admin_travel(),
            _spec("GET", "/api/v1/adminorderservice/adminorder"),
            _spec("GET", "/api/v1/adminrouteservice/adminroute"),
            _spec("GET", "/api/v1/adminuserservice/users"),
        ]
        return [dataclasses.replace(s, flow="admin") for s in specs]

    def extended_flow(self) -> List[RequestSpec]:
        """test_all_services.py:299-384."""
        return [_spec(m, p.replace("{id}", "uid-0"), p, flow="extended")
                for m, p in EXTENDED_ENDPOINTS]

    def complete_business_flow(self) -> List[RequestSpec]:
        """The condensed booking journey (test_all_services.py:386-427):
        search → aux info → reserve → orders → pay → collect → enter."""
        out = [dataclasses.replace(query_high_speed_ticket(), flow="complete"),
               dataclasses.replace(query_contacts(), flow="complete"),
               dataclasses.replace(query_assurances(), flow="complete"),
               dataclasses.replace(query_food(), flow="complete"),
               dataclasses.replace(preserve(), flow="complete")]
        self._create_order()
        out.append(dataclasses.replace(query_orders(), flow="complete"))
        o = self._first(paid=False)
        if o is not None:
            out.append(dataclasses.replace(pay_one_order(o.order_id), flow="complete"))
            o.paid = True
            out.append(dataclasses.replace(collect_one_order(o.order_id), flow="complete"))
            out.append(dataclasses.replace(enter_station(o.order_id), flow="complete"))
            self._orders.remove(o)      # ticket used; keep state bounded
        return out

    def iteration(self) -> List[RequestSpec]:
        """One full pass over all five flows (run_all_services_test:429)."""
        specs: List[RequestSpec] = []
        if self._iteration % 10 == 0:  # token refresh cadence :436-441
            specs.append(dataclasses.replace(login(), flow="token_refresh"))
        self._iteration += 1
        specs += self.core_business_flow()
        specs += self.auxiliary_flow()
        specs += self.admin_flow()
        specs += self.extended_flow()
        specs += self.complete_business_flow()
        return specs

    def run(self, iterations: int = 1) -> List[RequestSpec]:
        out: List[RequestSpec] = []
        for _ in range(iterations):
            out += self.iteration()
        return out


# ---------------------------------------------------------------------------
# Gateway: execute a request program against the synthetic SUT
# ---------------------------------------------------------------------------

# Baseline latency model: gateway + service handling, lognormal-ish.
_BASE_LATENCY_MS = 18.0


class SyntheticGateway:
    """Deterministic executor: routes each spec, applies active chaos
    effects, and accumulates ApiBatch records (the synthetic analog of the
    live cluster behind the NodePort gateway)."""

    def __init__(self, seed: int = 0, controller=None,
                 base_time_s: float = 1.7e9) -> None:
        self._rng = np.random.default_rng(seed)
        self._controller = controller
        self._t = base_time_s
        self._rows: List[Tuple[str, float, int, float, int]] = []

    def execute(self, specs: Sequence[RequestSpec]) -> List[int]:
        statuses = []
        for s in specs:
            svc = s.service
            lat_mult, err_p = (1.0, 0.002)
            if self._controller is not None:
                lat_mult, err_p = self._controller.active_effects(svc)
            lat = float(_BASE_LATENCY_MS *
                        np.exp(self._rng.normal(0.0, 0.35)) * lat_mult)
            fail = bool(self._rng.random() < err_p)
            status = 200
            if fail:
                status = 503 if err_p >= 0.5 else 500
            self._t += lat / 1e3 + float(self._rng.exponential(0.05))
            # content_length records the dominant byte flow of the exchange:
            # the synthesized request body for POSTs that carry one (so the
            # artifact histogram reflects the wrk2 content model), else the
            # synthetic response payload.
            if fail:
                nbytes = 0
            elif s.body is not None:
                nbytes = len(s.body)
            else:
                nbytes = int(self._rng.integers(64, 2048))
            self._rows.append((s.endpoint, self._t, status, lat, nbytes))
            statuses.append(status)
        return statuses

    @property
    def rows(self) -> List[Tuple[str, float, int, float, int]]:
        """Accumulated (endpoint, t_s, status, latency_ms, bytes) records."""
        return list(self._rows)

    @property
    def last_row(self) -> Tuple[str, float, int, float, int]:
        return self._rows[-1]

    def to_api_batch(self) -> ApiBatch:
        endpoints = tuple(sorted({r[0] for r in self._rows}))
        idx = {e: i for i, e in enumerate(endpoints)}
        return ApiBatch(
            endpoint=np.array([idx[r[0]] for r in self._rows], np.int32),
            t_s=np.array([r[1] for r in self._rows], np.float64),
            status=np.array([r[2] for r in self._rows], np.int16),
            latency_ms=np.array([r[3] for r in self._rows], np.float32),
            content_length=np.array([r[4] for r in self._rows], np.int32),
            endpoints=endpoints)


def run_scenario(iterations: int = 1, seed: int = 0,
                 controller=None) -> ApiBatch:
    """Drive the full scenario suite and return the collected ApiBatch."""
    driver = ScenarioDriver(seed=seed)
    gw = SyntheticGateway(seed=seed, controller=controller)
    gw.execute(driver.run(iterations))
    return gw.to_api_batch()


def services_covered(specs: Sequence[RequestSpec]) -> List[str]:
    return sorted({s.service for s in specs})
