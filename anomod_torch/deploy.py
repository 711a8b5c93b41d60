"""Deployment planning — the analog of the reference's TT deploy scripts.

Counterpart of ``anomod/deploy.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_faultplanes.py``.

The reference deploys Train-Ticket with a three-step bash flow
(train-ticket/hack/deploy/{deploy.sh,utils.sh,gen-mysql-secret.sh}):

1. **Infrastructure** (utils.sh:30-46): helm-install the nacos MySQL cluster,
   nacos itself, and rabbitmq, each followed by a `kubectl rollout status`
   barrier.
2. **Databases** (utils.sh:59-88): either ONE shared `tsdb` MySQL release
   (default) or one release per service (`--independent-db`), then generate
   per-service DB secrets for the 27 `ts-*` services
   (gen-mysql-secret.sh:2,30-63) with `<SVC>_MYSQL_{HOST,PORT,DATABASE,USER,
   PASSWORD}` stringData keys.
3. **Services** (utils.sh:90-128): apply secrets + Services + Deployments —
   the SkyWalking variant when `--with-tracing` (plus the JaCoCo-injected
   manifest when present), then the skywalking stack; Prometheus/Grafana when
   `--with-monitoring` (deploy.sh:60-70).

Known reference quirks deliberately NOT replicated (SURVEY §5 quirks): the
`[ useOneHost == 0 ]` literal-string comparison in gen-mysql-secret.sh:58
makes the per-service-host branch unreachable — here shared vs per-service
hosts follow the *intended* semantics.

Everything is modeled as data: a :class:`DeployPlan` is an ordered tuple of
:class:`Action` (helm/kubectl argv + rollout barriers), renderable to a shell
script or executed against an in-process cluster model, so orchestration
logic is testable without helm or a cluster.  SN's analog is the compose
lifecycle (docker-compose -f docker-compose-gcov.yml down/up,
automated_multimodal_collection.sh:271-283) — modeled here too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# gen-mysql-secret.sh:2 — the 27 services (SURVEY §2.2 says 26; the list itself has 27) that get a DB secret
TT_DB_SERVICES: Tuple[str, ...] = (
    "assurance", "auth", "config", "consign-price", "consign", "contacts",
    "delivery", "food", "food-delivery", "inside-payment", "notification",
    "order-other", "order", "payment", "price", "route", "security",
    "station-food", "station", "ticket-office", "train-food", "train",
    "travel", "travel2", "user", "voucher", "wait-order",
)

# utils.sh:12-27 infra parameters
NACOS_DB = dict(release="nacosdb", user="nacos", password="Abcd1234#",
                database="nacos")
NACOS_RELEASE = "nacos"
RABBITMQ_RELEASE = "rabbitmq"
TS_DB = dict(user="ts", password="Ts_123456", database="ts")
_MYSQL_CHART = "deployment/kubernetes-manifests/quickstart-k8s/charts/mysql"
_NACOS_CHART = "deployment/kubernetes-manifests/quickstart-k8s/charts/nacos"
_RABBITMQ_CHART = "deployment/kubernetes-manifests/quickstart-k8s/charts/rabbitmq"


@dataclasses.dataclass(frozen=True)
class DeployFlags:
    """deploy.sh:70-95 argument surface."""
    all: bool = False
    independent_db: bool = False
    with_monitoring: bool = False
    with_tracing: bool = False

    @classmethod
    def parse(cls, args: Sequence[str]) -> "DeployFlags":
        known = {"--all": "all", "--independent-db": "independent_db",
                 "--with-monitoring": "with_monitoring",
                 "--with-tracing": "with_tracing"}
        vals = {}
        for a in args:
            key = known.get(a)
            if key is None:
                raise ValueError(f"unknown deploy arg: {a!r}")
            vals[key] = True
        return cls(**vals)


@dataclasses.dataclass(frozen=True)
class Action:
    """One step: an argv plus an optional readiness barrier."""
    kind: str                     # "helm" | "kubectl" | "compose" | "wait"
    argv: Tuple[str, ...]
    barrier: Optional[Tuple[str, ...]] = None   # rollout-status argv

    def render(self) -> str:
        lines = [" ".join(self.argv)]
        if self.barrier:
            lines.append(" ".join(self.barrier))
        return "\n".join(lines)


def _helm_mysql(release: str, user: str, password: str, database: str,
                namespace: str) -> Action:
    return Action("helm", (
        "helm", "install", release,
        "--set", f"mysql.mysqlUser={user}",
        "--set", f"mysql.mysqlPassword={password}",
        "--set", f"mysql.mysqlDatabase={database}",
        _MYSQL_CHART, "-n", namespace),
        barrier=("kubectl", "rollout", "status",
                 f"statefulset/{release}-mysql", "-n", namespace))


def mysql_secret_doc(service: str, host: str, user: str, password: str,
                     database: str) -> Dict:
    """One per-service Secret with the reference's env-prefix convention
    (gen-mysql-secret.sh:12-40: `<SVC>_MYSQL_` upper-snake keys)."""
    prefix = f"{service}-mysql-".replace("-", "_").upper()
    return {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": {"name": f"ts-{service}-mysql"},
        "type": "Opaque",
        "stringData": {
            f"{prefix}HOST": host,
            f"{prefix}PORT": "3306",
            f"{prefix}DATABASE": database,
            f"{prefix}USER": user,
            f"{prefix}PASSWORD": password,
        },
    }


def gen_mysql_secrets(shared_host: Optional[str] = None,
                      user: str = TS_DB["user"],
                      password: str = TS_DB["password"],
                      database: str = TS_DB["database"]) -> List[Dict]:
    """Secrets for all 27 DB-backed services.  ``shared_host`` set → the
    one-host layout (`tsdb-mysql-leader`); None → per-service hosts
    (`ts-<s>-mysql-leader`), the intended `--independent-db` semantics."""
    return [mysql_secret_doc(
        s, shared_host if shared_host else f"ts-{s}-mysql-leader",
        user, password, database) for s in TT_DB_SERVICES]


def tt_deploy_plan(flags: DeployFlags, namespace: str = "default",
                   with_jacoco: bool = True) -> List[Action]:
    """The full ordered action list deploy.sh would execute."""
    if flags.all:
        # deploy_all = per-service DBs + sw deploy + tracing + monitoring
        # (deploy.sh:27-35)
        flags = DeployFlags(independent_db=True, with_monitoring=True,
                            with_tracing=True)
    acts: List[Action] = []
    # step 1/3: infrastructure (utils.sh:30-46)
    acts.append(_helm_mysql(NACOS_DB["release"], NACOS_DB["user"],
                            NACOS_DB["password"], NACOS_DB["database"],
                            namespace))
    acts.append(Action("helm", (
        "helm", "install", NACOS_RELEASE,
        "--set", f"nacos.db.host={NACOS_DB['release']}-mysql-leader",
        "--set", f"nacos.db.username={NACOS_DB['user']}",
        "--set", f"nacos.db.name={NACOS_DB['database']}",
        "--set", f"nacos.db.password={NACOS_DB['password']}",
        _NACOS_CHART, "-n", namespace),
        barrier=("kubectl", "rollout", "status",
                 f"statefulset/{NACOS_RELEASE}", "-n", namespace)))
    acts.append(Action("helm", (
        "helm", "install", RABBITMQ_RELEASE, _RABBITMQ_CHART, "-n", namespace),
        barrier=("kubectl", "rollout", "status",
                 f"deployment/{RABBITMQ_RELEASE}", "-n", namespace)))
    # step 2/3: databases (utils.sh:59-88)
    if flags.independent_db:
        for s in TT_DB_SERVICES:
            acts.append(_helm_mysql(f"ts-{s}", TS_DB["user"],
                                    TS_DB["password"], TS_DB["database"],
                                    namespace))
    else:
        acts.append(_helm_mysql("tsdb", TS_DB["user"], TS_DB["password"],
                                TS_DB["database"], namespace))
    # step 3/3: secrets + services + deployments (utils.sh:90-128)
    acts.append(Action("kubectl", (
        "kubectl", "apply", "-f",
        "deployment/kubernetes-manifests/quickstart-k8s/yamls/secret.yaml",
        "-n", namespace)))
    acts.append(Action("kubectl", (
        "kubectl", "apply", "-f",
        "deployment/kubernetes-manifests/quickstart-k8s/yamls/svc.yaml",
        "-n", namespace)))
    if flags.with_tracing:
        acts.append(Action("kubectl", (
            "kubectl", "apply", "-f",
            "deployment/kubernetes-manifests/quickstart-k8s/yamls/sw_deploy.yaml",
            "-n", namespace)))
        if with_jacoco:
            acts.append(Action("kubectl", (
                "kubectl", "apply", "-f",
                "deployment/kubernetes-manifests/quickstart-k8s/yamls/"
                "sw_deploy.tcpserver.includes.yaml", "-n", namespace)))
        acts.append(Action("kubectl", (
            "kubectl", "apply", "-f",
            "deployment/kubernetes-manifests/skywalking", "-n", namespace)))
    else:
        acts.append(Action("kubectl", (
            "kubectl", "apply", "-f",
            "deployment/kubernetes-manifests/quickstart-k8s/yamls/deploy.yaml",
            "-n", namespace)))
    if flags.with_monitoring:
        acts.append(Action("kubectl", (
            "kubectl", "apply", "-f",
            "deployment/kubernetes-manifests/prometheus")))
    return acts


def sn_compose_plan(up: bool = True) -> List[Action]:
    """SN stack lifecycle (automated_multimodal_collection.sh:271-283)."""
    compose = ("docker-compose", "-f", "docker-compose-gcov.yml")
    if up:
        return [Action("compose", (*compose, "up", "-d"))]
    return [Action("compose", (*compose, "down", "--remove-orphans"))]


def render_plan(actions: Sequence[Action]) -> str:
    """The plan as the shell script the reference would have run."""
    return "\n".join(a.render() for a in actions) + "\n"


# ---------------------------------------------------------------------------
# Plan execution against the in-process cluster model
# ---------------------------------------------------------------------------

def execute_plan(actions: Sequence[Action], cluster=None) -> Dict[str, int]:
    """Apply a plan to a :class:`anomod_torch.recovery.SyntheticCluster`-style
    world: helm releases and manifests register as deployed objects; each
    barrier advances the virtual clock past the rollout.  Returns the
    deployed-object census (by kind) for assertions."""
    census: Dict[str, int] = {"helm": 0, "kubectl": 0, "compose": 0,
                              "barriers": 0}
    for a in actions:
        census[a.kind] = census.get(a.kind, 0) + 1
        if a.barrier is not None:
            census["barriers"] += 1
            if cluster is not None:
                cluster.advance(30.0)     # rollout wait
    return census
