"""Deploy topology models + coverage-agent manifest injection.

Counterpart of ``anomod/topology.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_faultplanes.py``.

The reference describes its two systems-under-test declaratively:

- **SN**: a Docker Compose file of 11 gcov-instrumented C++ services (image
  ``socialnetwork-gcov``, ``GCOV_PREFIX``/``GCOV_PREFIX_STRIP`` env, a shared
  ``/coverage-reports`` mount, explicit ``/usr/local/bin/<Service>``
  entrypoints) plus per-service Mongo/Redis/Memcached stores and the
  observability stack — Jaeger :16686, nginx gateway :8080, Prometheus
  :9090, cAdvisor, node-exporter (docker-compose-gcov.yml:2-424).
- **TT**: ~40 k8s Deployments, each with a SkyWalking agent initContainer +
  dual ``-javaagent`` ``JAVA_TOOL_OPTIONS``, nacos configMap env, resource
  requests/limits, and a TCP readiness probe
  (sw_deploy.tcpserver.includes.yaml:1-92).  The JaCoCo half of that
  manifest is produced by a deploy-time rewriter
  (coverage_tools/inject_jacoco_k8s.py:68-213).

This module regenerates both topologies from the framework's service tables
(single source of truth — the same lists the generator, graph builder, and
labels use) and re-implements the JaCoCo rewriter as pure dict→dict
functions, so manifests round-trip through PyYAML and the coverage wiring is
testable without a cluster.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from anomod_torch.synth import SN_SERVICES, TT_SERVICES

# ---------------------------------------------------------------------------
# SN compose model (docker-compose-gcov.yml)
# ---------------------------------------------------------------------------

#: service → backing stores, from the compose dependency wiring
#: (docker-compose-gcov.yml:227-322; redis containers are the chaos targets
#: of the DB_Redis_CacheLimit_* experiments).
SN_STORES: Dict[str, Tuple[str, ...]] = {
    "social-graph-service": ("social-graph-mongodb", "social-graph-redis"),
    "home-timeline-service": ("home-timeline-redis",),
    "user-timeline-service": ("user-timeline-mongodb", "user-timeline-redis"),
    "compose-post-service": ("compose-post-redis",),
    "post-storage-service": ("post-storage-mongodb", "post-storage-memcached"),
    "user-service": ("user-mongodb", "user-memcached"),
    "media-service": ("media-mongodb", "media-memcached"),
    "url-shorten-service": ("url-shorten-mongodb", "url-shorten-memcached"),
    "user-mention-service": (),
    "unique-id-service": (),
    "text-service": (),
}

SN_OBSERVABILITY: Tuple[str, ...] = (
    "jaeger-agent", "prometheus", "cadvisor", "node-exporter")


def _cpp_process_name(service: str) -> str:
    """compose entrypoint binary: CamelCase of the service name
    (docker-compose-gcov.yml:21 e.g. /usr/local/bin/SocialGraphService)."""
    return "".join(w.capitalize() for w in service.split("-"))


def sn_compose() -> Dict:
    """The SN testbed as a compose document (gcov instrumentation included)."""
    services: Dict[str, Dict] = {}
    port = 10000
    for svc in SN_SERVICES:
        if svc == "nginx-web-server":
            services[svc] = {
                "image": "yg397/openresty-thrift:xenial",
                "hostname": svc,
                "ports": ["8080:8080"],        # the HTTP gateway (:340-345)
                "depends_on": [s for s in SN_SERVICES if s != svc],
                "networks": ["socialnetwork"],
                "restart": "always",
            }
            continue
        services[svc] = {
            "image": "socialnetwork-gcov",
            "hostname": svc,
            "ports": [f"{port}:9090"],
            "volumes": ["./config:/social-network-microservices/config:ro",
                        "./coverage-reports:/coverage-reports"],
            "networks": ["socialnetwork"],
            "depends_on": ["jaeger-agent", *SN_STORES.get(svc, ())],
            "restart": "always",
            "environment": [
                "COVERALLS_DIRECTORY=/coverage-reports",
                "GCOV_PREFIX=/social-network-microservices/build",
                "GCOV_PREFIX_STRIP=2",
            ],
            "entrypoint": [f"/usr/local/bin/{_cpp_process_name(svc)}"],
        }
        port += 1
    for stores in SN_STORES.values():
        for store in stores:
            kind = store.rsplit("-", 1)[1]
            services[store] = {
                "image": {"mongodb": "mongo:4.4.6", "redis": "redis",
                          "memcached": "memcached"}[kind],
                "hostname": store,
                "networks": ["socialnetwork"],
                "restart": "always",
            }
    services["jaeger-agent"] = {
        "image": "jaegertracing/all-in-one:latest",
        "hostname": "jaeger-agent",
        "ports": ["16686:16686"],
        "networks": ["socialnetwork"],
        "restart": "always",
    }
    services["prometheus"] = {
        "image": "prom/prometheus:latest",
        "ports": ["9090:9090"],
        "networks": ["socialnetwork"],
        "restart": "always",
    }
    services["cadvisor"] = {
        "image": "gcr.io/cadvisor/cadvisor:latest",
        "ports": ["8081:8080"],
        "networks": ["socialnetwork"],
        "restart": "always",
    }
    services["node-exporter"] = {
        "image": "prom/node-exporter:latest",
        "ports": ["9100:9100"],
        "networks": ["socialnetwork"],
        "restart": "always",
    }
    return {"version": "3.9", "services": services,
            "networks": {"socialnetwork": {"driver": "bridge"}}}


def sn_container_name(service_or_store: str) -> str:
    """Compose container naming (docker stop targets,
    automated_multimodal_collection.sh:466)."""
    return f"socialnetwork_{service_or_store}_1"


# ---------------------------------------------------------------------------
# TT k8s manifest model (sw_deploy.tcpserver.includes.yaml)
# ---------------------------------------------------------------------------

#: JaCoCo excludes defaulted by the injector (inject_jacoco_k8s.py:223).
DEFAULT_EXCLUDES = ("org.springframework.*;ch.qos.logback.*;org.apache.*;"
                    "com.alibaba.*;javax.*;lombok.*;sun.*")

_JACOCO_AGENT_JAR = "/jacoco/jacocoagent.jar"
_SW_AGENT_OPT = "-javaagent:/skywalking/agent/skywalking-agent.jar"

_TT_BASE_PORT = 18000


def tt_service_port(service: str) -> int:
    """Stable per-service container port (manifests pin one port per service,
    e.g. ts-admin-basic-info-service :18767)."""
    return _TT_BASE_PORT + TT_SERVICES.index(service)


def service_package_prefix(service: str) -> str:
    """Dominant Java package prefix for a ts-* service, the quantity the
    reference infers by scanning sources (inject_jacoco_k8s.py:184-213:
    `package adminbasic.…` → `adminbasic.*`).  Without sources we derive it
    from the service name the same way the real packages are named: strip
    the ts- prefix / -service suffix and drop dashes."""
    stem = service
    if stem.startswith("ts-"):
        stem = stem[3:]
    if stem.endswith("-service"):
        stem = stem[: -len("-service")]
    return stem.replace("-", "") + ".*"


def tt_deployment(service: str, with_tracing: bool = True) -> Dict:
    """One TT service Deployment in the reference manifest shape (SkyWalking
    init container + agent env; JaCoCo is added separately by inject_jacoco,
    matching the reference's deploy-time rewrite flow)."""
    port = tt_service_port(service)
    container = {
        "name": service,
        "image": f"codewisdom/{service}:1.0.0",
        "imagePullPolicy": "IfNotPresent",
        "volumeMounts": [],
        "env": [
            {"name": "NODE_IP",
             "valueFrom": {"fieldRef": {"fieldPath": "status.hostIP"}}},
        ],
        "envFrom": [{"configMapRef": {"name": "nacos"}}],
        "ports": [{"containerPort": port}],
        "resources": {
            "requests": {"cpu": "100m", "memory": "300Mi"},
            "limits": {"cpu": "500m", "memory": "2000Mi"},
        },
        "readinessProbe": {
            "tcpSocket": {"port": port},
            "initialDelaySeconds": 60, "periodSeconds": 10,
            "timeoutSeconds": 5,
        },
    }
    pod_spec: Dict = {"volumes": [], "initContainers": [],
                      "containers": [container]}
    if with_tracing:
        pod_spec["volumes"].append({"name": "skywalking-agent", "emptyDir": {}})
        pod_spec["initContainers"].append({
            "name": "agent-container",
            "image": "apache/skywalking-java-agent:8.8.0-alpine",
            "volumeMounts": [{"name": "skywalking-agent",
                              "mountPath": "/agent"}],
            "command": ["/bin/sh"],
            "args": ["-c", "cp -R /skywalking/agent /agent/"],
        })
        container["volumeMounts"].append(
            {"name": "skywalking-agent", "mountPath": "/skywalking"})
        container["env"] += [
            {"name": "SW_AGENT_COLLECTOR_BACKEND_SERVICES",
             "value": "skywalking:11800"},
            {"name": "SW_AGENT_NAME",
             "valueFrom": {"fieldRef":
                           {"fieldPath": "metadata.labels['app']"}}},
            {"name": "JAVA_TOOL_OPTIONS", "value": _SW_AGENT_OPT},
        ]
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": service},
        "spec": {
            "selector": {"matchLabels": {"app": service}},
            "replicas": 1,
            "template": {
                "metadata": {"labels": {"app": service}},
                "spec": pod_spec,
            },
        },
    }


def tt_manifests(with_tracing: bool = True) -> List[Dict]:
    return [tt_deployment(s, with_tracing) for s in TT_SERVICES]


# ---------------------------------------------------------------------------
# JaCoCo injection (inject_jacoco_k8s.py:68-182 semantics, fresh impl)
# ---------------------------------------------------------------------------

def _jacoco_agent_opt(mode: str, tcp_port: int, includes: Optional[str],
                      excludes: Optional[str]) -> str:
    if mode == "file":
        opt = (f"-javaagent:{_JACOCO_AGENT_JAR}="
               "output=file,destfile=/coverage/jacoco-$(HOSTNAME).exec,"
               "append=true")
    else:
        opt = (f"-javaagent:{_JACOCO_AGENT_JAR}="
               f"output=tcpserver,address=*,port={tcp_port},"
               "sessionid=$(HOSTNAME),append=true")
    if includes:
        opt += f",includes={includes}"
    if excludes:
        opt += f",excludes={excludes}"
    return opt


def _ensure_named(items: List[Dict], entry: Dict) -> bool:
    """Append entry unless an item with the same name exists; return changed."""
    if any(it.get("name") == entry["name"] for it in items):
        return False
    items.append(entry)
    return True


def inject_jacoco_pod_spec(pod_spec: Dict, *, mode: str = "tcpserver",
                           tcp_port: int = 6300,
                           includes: Optional[str] = None,
                           excludes: Optional[str] = DEFAULT_EXCLUDES) -> bool:
    """Add the JaCoCo runtime to one pod spec in place; returns whether
    anything changed.  Idempotent; preserves an existing JAVA_TOOL_OPTIONS
    (the SkyWalking agent) by appending after it."""
    changed = False
    volumes = pod_spec.setdefault("volumes", [])
    changed |= _ensure_named(volumes, {"name": "jacoco-vol", "emptyDir": {}})
    changed |= _ensure_named(volumes, {"name": "coverage-vol", "emptyDir": {}})

    inits = pod_spec.setdefault("initContainers", [])
    changed |= _ensure_named(inits, {
        "name": "init-jacoco",
        "image": "curlimages/curl:7.88.1",
        "command": ["sh", "-c"],
        "args": ["set -e; mkdir -p /jacoco && "
                 "curl -sSL -o /jacoco/jacocoagent.jar "
                 "https://repo1.maven.org/maven2/org/jacoco/org.jacoco.agent/"
                 "0.8.10/org.jacoco.agent-0.8.10-runtime.jar && "
                 "curl -sSL -o /jacoco/jacococli.jar "
                 "https://repo1.maven.org/maven2/org/jacoco/org.jacoco.cli/"
                 "0.8.10/org.jacoco.cli-0.8.10-nodeps.jar"],
        "volumeMounts": [{"name": "jacoco-vol", "mountPath": "/jacoco"}],
        "imagePullPolicy": "IfNotPresent",
    })

    agent_opt = _jacoco_agent_opt(mode, tcp_port, includes, excludes)
    for container in pod_spec.get("containers") or []:
        env = container.setdefault("env", [])
        existing = next((e for e in env
                         if e.get("name") == "JAVA_TOOL_OPTIONS"), None)
        if existing is None:
            env.append({"name": "JAVA_TOOL_OPTIONS", "value": agent_opt})
            changed = True
        elif agent_opt not in (existing.get("value") or ""):
            existing["value"] = ((existing.get("value") or "") +
                                 " " + agent_opt).strip()
            changed = True
        mounts = container.setdefault("volumeMounts", [])
        changed |= _ensure_named(mounts, {"name": "jacoco-vol",
                                          "mountPath": "/jacoco"})
        changed |= _ensure_named(mounts, {"name": "coverage-vol",
                                          "mountPath": "/coverage"})
    return changed


def inject_jacoco(docs: Iterable[Dict], *, mode: str = "tcpserver",
                  tcp_port: int = 6300,
                  svc_includes: Optional[Dict[str, str]] = None,
                  excludes: Optional[str] = DEFAULT_EXCLUDES,
                  auto_includes: bool = True) -> Tuple[List[Dict], int]:
    """Rewrite a manifest stream: inject JaCoCo into every workload document
    (Deployment/StatefulSet/DaemonSet — inject_jacoco_k8s.py:160-166).
    Returns (new docs, number changed).  Input docs are not mutated."""
    out: List[Dict] = []
    n_changed = 0
    for doc in docs:
        doc = copy.deepcopy(doc)
        out.append(doc)
        if not isinstance(doc, dict) or doc.get("kind") not in (
                "Deployment", "StatefulSet", "DaemonSet"):
            continue
        pod_spec = doc.get("spec", {}).get("template", {}).get("spec")
        if not isinstance(pod_spec, dict):
            continue
        name = doc.get("metadata", {}).get("name") or ""
        includes = (svc_includes or {}).get(name)
        if includes is None and auto_includes and name.startswith("ts-"):
            includes = service_package_prefix(name)
        if inject_jacoco_pod_spec(pod_spec, mode=mode, tcp_port=tcp_port,
                                  includes=includes, excludes=excludes):
            n_changed += 1
    return out, n_changed


def infer_includes_from_packages(packages: Sequence[str]) -> Optional[str]:
    """Dominant top-level package → `<top>.*` (the source-scanning heuristic
    of inject_jacoco_k8s.py:184-213, over an already-extracted package
    list)."""
    counts: Dict[str, int] = {}
    for pkg in packages:
        top = pkg.split(".")[0].strip()
        if top:
            counts[top] = counts.get(top, 0) + 1
    if not counts:
        return None
    return max(counts.items(), key=lambda kv: kv[1])[0] + ".*"
