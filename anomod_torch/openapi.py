"""OpenAPI/Swagger spec ingestion → endpoint catalog → generated suites.

Counterpart of ``anomod/openapi.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

The reference regenerates its EvoMaster suites from a Swagger document
(run_experiment.sh:500-555 passes ``--bbSwaggerUrl file://$EVOMASTER_SPEC``
over ``specs/.../combined-all-v3.5.json``; Evomaster/README.md:74-90).  The
shipped spec is an LFS pointer stub, so ingestion is built against the
standard document shapes and tested on a committed fixture: this module
parses Swagger 2.0 and OpenAPI 3.x JSON into :class:`SpecEndpoint` entries,
instantiates path parameters and JSON bodies deterministically from their
schemas, and hands ``anomod_torch.suite.generate_suite`` a spec-derived endpoint
pool — completing the spec → suite → gateway flow without a JVM in the
loop.

Fresh design notes: EvoMaster explores the spec stochastically for a time
budget; here the budget→test-count calibration (anomod_torch.suite._CALIBRATION)
carries the same knob deterministically, and "exploration" is seeded
round-robin + random sampling over the parsed endpoint pool — the property
campaigns need (coverage of the spec surface, reproducible by seed) without
the genetic search.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from anomod_torch.scenario import RequestSpec

_METHODS = ("get", "post", "put", "delete", "patch", "head", "options")


@dataclasses.dataclass(frozen=True)
class SpecEndpoint:
    """One (method, path-template) operation parsed from a spec."""
    method: str                      # upper-case HTTP verb
    template: str                    # path template incl. basePath, {param}s
    path_params: Tuple[Tuple[str, str], ...] = ()   # (name, type)
    body_schema: Optional[dict] = None               # JSON request schema
    operation_id: str = ""


def load_spec(path) -> dict:
    """Read a spec JSON file; an LFS pointer stub is a clear error (the
    caller decides whether to fall back to the internal catalog)."""
    from anomod_torch.io.lfs import is_lfs_pointer
    path = Path(path)
    if is_lfs_pointer(path):
        raise ValueError(f"{path} is a git-LFS pointer stub, not a spec")
    with open(path) as f:
        return json.load(f)


def _resolve_ref(doc: dict, node):
    """Follow one local ``$ref`` (``#/a/b/c``); non-local refs pass through
    unresolved (the synthesizer falls back to a generic value)."""
    while isinstance(node, dict) and isinstance(node.get("$ref"), str) \
            and node["$ref"].startswith("#/"):
        cur = doc
        for part in node["$ref"][2:].split("/"):
            if not isinstance(cur, dict) or part not in cur:
                return node
            cur = cur[part]
        node = cur
    return node


def _param_type(doc: dict, param: dict) -> str:
    # v2 keeps `type` on the parameter; v3 nests it in `schema`
    if "type" in param:
        return str(param["type"])
    schema = _resolve_ref(doc, param.get("schema") or {})
    return str(schema.get("type", "string"))


def _body_schema(doc: dict, op: dict, shared_params: List[dict]) -> Optional[dict]:
    # v3: requestBody.content.application/json.schema
    body = _resolve_ref(doc, op.get("requestBody") or {})
    content = body.get("content") or {}
    for mime, media in content.items():
        if "json" in mime:
            return _resolve_ref(doc, media.get("schema") or {})
    # v2: parameters with in: body
    for p in list(op.get("parameters") or []) + shared_params:
        p = _resolve_ref(doc, p)
        if p.get("in") == "body":
            return _resolve_ref(doc, p.get("schema") or {})
    return None


def parse_spec(doc: dict) -> List[SpecEndpoint]:
    """Flatten a Swagger 2.0 / OpenAPI 3.x document into endpoint entries.

    ``basePath`` (v2) prefixes every path; v3 ``servers`` URLs are treated
    as host-level and ignored (the gateway owns the host).  Path-level
    shared parameters merge into each operation's."""
    base = str(doc.get("basePath", "")).rstrip("/")
    out: List[SpecEndpoint] = []
    for path, item in (doc.get("paths") or {}).items():
        item = _resolve_ref(doc, item)
        shared = [_resolve_ref(doc, p) for p in (item.get("parameters") or [])]
        for method in _METHODS:
            if method not in item:
                continue
            op = _resolve_ref(doc, item[method])
            params = [_resolve_ref(doc, p)
                      for p in (op.get("parameters") or [])] + shared
            path_params = tuple(
                (str(p.get("name", "")), _param_type(doc, p))
                for p in params if p.get("in") == "path")
            out.append(SpecEndpoint(
                method=method.upper(),
                template=f"{base}{path}",
                path_params=path_params,
                body_schema=_body_schema(doc, op, shared),
                operation_id=str(op.get("operationId", "")),
            ))
    return out


# ---------------------------------------------------------------------------
# Deterministic instantiation (the generated-suite request values)
# ---------------------------------------------------------------------------

def _value_for(doc: dict, schema, rng, depth: int = 0):
    schema = _resolve_ref(doc, schema if isinstance(schema, dict) else {})
    if "enum" in schema and schema["enum"]:
        return schema["enum"][int(rng.integers(len(schema["enum"])))]
    t = schema.get("type", "object" if schema.get("properties") else "string")
    if t == "integer":
        return int(rng.integers(1, 100))
    if t == "number":
        return round(float(rng.uniform(0, 100)), 2)
    if t == "boolean":
        return bool(rng.integers(2))
    if t == "array":
        if depth >= 3:
            return []
        return [_value_for(doc, schema.get("items") or {}, rng, depth + 1)]
    if t == "object":
        if depth >= 3:
            return {}
        props = schema.get("properties") or {}
        return {k: _value_for(doc, v, rng, depth + 1)
                for k, v in props.items()}
    # string (formats: keep it simple and deterministic)
    fmt = schema.get("format", "")
    if fmt == "date-time":
        return "2025-01-01T00:00:00Z"
    if fmt == "date":
        return "2025-01-01"
    if fmt == "uuid":
        return f"00000000-0000-0000-0000-{int(rng.integers(1 << 47)):012x}"
    return f"s{int(rng.integers(1 << 30)):x}"


def instantiate(doc: dict, ep: SpecEndpoint, rng) -> RequestSpec:
    """One concrete request for a spec endpoint: path params substituted,
    JSON body synthesized from its schema."""
    path = ep.template
    for name, t in ep.path_params:
        val = _value_for(doc, {"type": t}, rng)
        path = path.replace("{" + name + "}", str(val))
    body = None
    if ep.body_schema is not None:
        body = json.dumps(_value_for(doc, ep.body_schema, rng))
    return RequestSpec(ep.method, path, ep.template, flow="openapi",
                       body=body)


def endpoint_pool_from_spec(doc: dict, seed: int = 0) -> List[RequestSpec]:
    """The suite-generation pool: one instantiated RequestSpec per spec
    operation, ordered by (template, method) for determinism."""
    rng = np.random.default_rng(seed)
    eps = sorted(parse_spec(doc), key=lambda e: (e.template, e.method))
    if not eps:
        raise ValueError("spec has no paths/operations")
    return [instantiate(doc, e, rng) for e in eps]
