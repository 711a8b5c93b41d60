"""Live-transport collector clients (counterpart of ``anomod/io/live.py``):
HTTP clients for the four backends the reference's collection toolchain
talks to, each writing the artifact schema the offline loaders read.

- Prometheus ``query_range``
  (SN_collection-scripts/Dataset/metric_data/fetch_prometheus_metrics.py:9-80):
  per-query CSVs for SN, one long CSV for TT (``anomod_torch.io.metrics``);
- Jaeger REST, fanned out per service with trace-id dedup
  (SN_collection-scripts/Dataset/trace_data/collect_trace.sh:25-58):
  ``{"data": [...]}`` for ``anomod_torch.io.sn_traces``;
- SkyWalking GraphQL with paging and linear backoff
  (TT_collection-scripts/T-Dataset/trace_collector.py:261-396): the
  collector JSON for ``anomod_torch.io.tt_traces``;
- Elasticsearch ``sw_segment-*`` queries
  (TT_collection-scripts/T-Dataset/enhanced_trace_collector.py:56-100):
  the ``detailed_traces`` JSON for ``anomod_torch.io.tt_traces_es``.

One transport (:class:`HttpTransport`, urllib, with an injectable
``sleep``) carries the retry and backoff policy for all four: wait
``min(3 * attempt, 10)`` seconds between attempts; a 4xx is permanent.
Every artifact is written with the same bytes as the JAX package's
clients, and the live feed (``anomod_torch.serve.feed``) polls through
``PrometheusClient.query_range_since`` and ``JaegerClient.traces_since``.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class TransportError(RuntimeError):
    """A request failed permanently (retries exhausted or server-side
    error payload)."""


@dataclasses.dataclass
class HttpTransport:
    """Bounded-retry JSON-over-HTTP transport shared by all clients.

    ``sleep`` is injectable so tests assert the backoff schedule without
    waiting it out.  GET when ``payload is None``, POST (JSON body)
    otherwise."""
    timeout: float = 30.0
    max_retries: int = 3
    sleep: Callable[[float], None] = time.sleep

    def request_json(self, url: str, payload: Optional[dict] = None,
                     params: Optional[dict] = None):
        return self._request(url, payload, params,
                             lambda raw: json.loads(raw.decode()))

    def request_text(self, url: str, params: Optional[dict] = None) -> str:
        """GET -> decoded body text (the Prometheus exposition-format
        scrape path; same retry/backoff policy as the JSON surface)."""
        return self._request(url, None, params,
                             lambda raw: raw.decode(errors="replace"))

    def _request(self, url: str, payload: Optional[dict],
                 params: Optional[dict], decode: Callable[[bytes], object]):
        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        last: Optional[Exception] = None
        for attempt in range(1, self.max_retries + 1):
            try:
                if payload is None:
                    req = urllib.request.Request(url)
                else:
                    req = urllib.request.Request(
                        url, data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    # decode INSIDE the try: a truncated/garbled body is
                    # retried like any other transient wire fault
                    return decode(r.read())
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500:
                    # client errors (bad PromQL, malformed GraphQL) are
                    # permanent: retrying burns the whole backoff schedule
                    # and buries the real error class.  The body carries
                    # the server's actual diagnostic (e.g. the PromQL
                    # parse error) — surface it, truncated.
                    try:
                        body = e.read().decode(errors="replace")[:500]
                    except Exception:
                        body = ""
                    raise TransportError(
                        f"request to {url.split('?')[0]} rejected: "
                        f"HTTP {e.code} {e.reason}"
                        + (f": {body}" if body else "")) from e
                last = e          # 5xx: server-side, worth retrying
                if attempt < self.max_retries:
                    self.sleep(min(3.0 * attempt, 10.0))
            except Exception as e:  # timeouts, connection errors, bad JSON
                last = e
                if attempt < self.max_retries:
                    self.sleep(min(3.0 * attempt, 10.0))
        raise TransportError(
            f"request to {url.split('?')[0]} failed after "
            f"{self.max_retries} attempts: {last}") from last


@dataclasses.dataclass
class CollectReport:
    """What a ``collect*`` call produced — the validator-friendly summary
    (the reference's collectors log equivalent counts to stdout)."""
    kind: str
    files: Tuple[str, ...] = ()
    n_records: int = 0
    n_skipped: int = 0
    notes: Tuple[str, ...] = ()

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrometheusClient:
    """``/api/v1/query_range`` client emitting the SN per-query CSV shape
    (``timestamp,value,metric,<label cols>`` — fetch_prometheus_metrics.py:
    44-71) and the TT long-CSV shape (metric_collector.py:431-443), both of
    which ``anomod_torch.io.metrics`` loads."""
    base_url: str
    transport: HttpTransport = dataclasses.field(default_factory=HttpTransport)

    def query_range(self, query: str, start_s: float, end_s: float,
                    step: str = "15s") -> List[Tuple[float, float, Dict[str, str]]]:
        """Run one range query -> [(epoch_s, value, labels)] rows.

        Mirrors the reference's handling: a non-"success" status is an
        error; an empty result set is NOT (returns [])."""
        doc = self.transport.request_json(
            f"{self.base_url}/api/v1/query_range",
            params={"query": query, "start": start_s, "end": end_s,
                    "step": step})
        if doc.get("status") != "success":
            raise TransportError(
                f"prometheus error for {query!r}: "
                f"{doc.get('error', 'unknown error')}")
        rows: List[Tuple[float, float, Dict[str, str]]] = []
        for result in doc.get("data", {}).get("result", []):
            labels = dict(result.get("metric", {}))
            for ts, val in result.get("values", []):
                try:
                    rows.append((float(ts), float(val), labels))
                except (TypeError, ValueError):
                    continue
        return rows

    def query_range_since(
            self, query: str, since_s: float, until_s: float,
            step: str = "15s",
    ) -> Tuple[List[Tuple[float, float, Dict[str, str]]], float]:
        """Watermark-tailed incremental poll for the live feed
        (anomod_torch.serve.feed).

        Runs ``query_range(query, since_s, until_s)`` and keeps only the
        rows STRICTLY past the ``since_s`` watermark, so back-to-back
        polls never re-deliver a sample (query_range windows are
        inclusive on both ends).  Returns ``(fresh_rows,
        new_watermark)`` where the new watermark is the max delivered
        timestamp (or ``since_s`` unchanged on an empty poll) — always
        monotone."""
        rows = self.query_range(query, since_s, until_s, step)
        fresh = [(ts, val, labels) for ts, val, labels in rows
                 if ts > since_s]
        mark = max([since_s] + [ts for ts, _, _ in fresh])
        return fresh, mark

    def write_query_csv(self, query: str, metric_name: str, out_dir: Path,
                        start_s: float, end_s: float,
                        step: str = "15s") -> Optional[Tuple[Path, int]]:
        """One SN per-query artifact: ``<metric_name>.csv`` with columns
        ``timestamp,value,metric,<sorted label cols>``; no file when the
        query returned no data (the reference skips those with a
        warning).  Returns ``(path, n_rows)``."""
        rows = self.query_range(query, start_s, end_s, step)
        if not rows:
            return None
        label_cols = sorted({k for _, _, labels in rows for k in labels})
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{metric_name}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["timestamp", "value", "metric"] + label_cols)
            for ts, val, labels in rows:
                # UTC, not local: artifacts from collectors in different
                # timezones must be byte-comparable for the same data
                stamp = datetime.fromtimestamp(
                    ts, tz=timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
                lab = ",".join(f'{k}="{v}"'
                               for k, v in sorted(labels.items()))
                w.writerow([stamp, val, lab]
                           + [labels.get(k, "") for k in label_cols])
        return path, len(rows)

    def collect_sn(self, queries: Dict[str, str], out_dir: Path,
                   start_s: float, end_s: float,
                   step: str = "15s") -> CollectReport:
        """SN catalog sweep: one CSV per (name -> PromQL) entry into
        ``out_dir`` — collect_metric.sh's fan-out, with the catalog carried
        as data (``anomod_torch.metrics_catalog.SN_METRIC_FILES``)."""
        files, skipped, n = [], 0, 0
        for name, query in queries.items():
            wrote = self.write_query_csv(query, name, out_dir, start_s,
                                         end_s, step)
            if wrote is None:
                skipped += 1
                continue
            path, n_rows = wrote
            files.append(str(path))
            n += n_rows
        return CollectReport(kind="prometheus_sn", files=tuple(files),
                             n_records=n, n_skipped=skipped)

    def collect_tt(self, queries: Sequence[str], out_path: Path,
                   start_s: float, end_s: float,
                   step: str = "15s") -> CollectReport:
        """TT long-CSV sweep: every query appended into ONE CSV with the
        fixed columns ``metric_name,timestamp,datetime,value`` followed by
        the sorted union of label columns (``__name__`` excluded), with
        ``metric_name`` the raw query string — metric_collector.py:431-466
        row semantics; ``anomod_torch.io.metrics.load_tt_metric_csv`` reads it
        back."""
        all_rows: List[dict] = []
        skipped = 0
        for query in queries:
            rows = self.query_range(query, start_s, end_s, step)
            if not rows:
                skipped += 1
                continue
            for ts, val, labels in rows:
                row = {"metric_name": query, "timestamp": ts,
                       "datetime": datetime.fromtimestamp(
                           ts, tz=timezone.utc).isoformat(),
                       "value": val}
                row.update({k: v for k, v in labels.items()
                            if k != "__name__"})
                all_rows.append(row)
        fixed = ["metric_name", "timestamp", "datetime", "value"]
        label_cols = sorted({k for r in all_rows for k in r}
                            - set(fixed))
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fixed + label_cols,
                               restval="")
            w.writeheader()
            w.writerows(all_rows)
        return CollectReport(kind="prometheus_tt",
                             files=(str(out_path),), n_records=len(all_rows),
                             n_skipped=skipped)


# ---------------------------------------------------------------------------
# Jaeger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JaegerClient:
    """Jaeger query-service REST client (SN trace path).

    ``collect_all`` is collect_trace.sh:25-58 as a function: enumerate
    services, fetch each service's recent traces, merge unique-by-traceID,
    write one ``{"data": [...]}`` doc that ``anomod_torch.io.sn_traces.
    load_jaeger_json`` consumes."""
    base_url: str
    transport: HttpTransport = dataclasses.field(default_factory=HttpTransport)

    def services(self) -> List[str]:
        doc = self.transport.request_json(f"{self.base_url}/api/services")
        return list(doc.get("data") or [])

    def traces(self, service: str, limit: int = 2000,
               lookback_ms: int = 3_600_000,
               now_s: Optional[float] = None) -> List[dict]:
        # lookback matches the reference's request line
        # (collect_trace.sh:48); start/end in epoch µs are ALSO sent
        # because some query-service versions ignore lookback without an
        # explicit window — both derive from the same lookback_ms
        now = time.time() if now_s is None else now_s
        doc = self.transport.request_json(
            f"{self.base_url}/api/traces",
            params={"service": service, "limit": limit,
                    "lookback": lookback_ms,
                    "start": int((now - lookback_ms / 1000.0) * 1e6),
                    "end": int(now * 1e6)})
        return list(doc.get("data") or [])

    def traces_since(self, service: str, since_us: int, until_us: int,
                     limit: int = 2000) -> Tuple[List[dict], int]:
        """Watermark-tailed incremental poll for the live feed
        (anomod_torch.serve.feed).

        Queries the explicit ``[since_us, until_us]`` window (epoch µs)
        and keeps only traces whose LATEST span starts strictly past the
        watermark — a trace is delivered once, on the poll that first
        sees it complete up to that point.  Returns ``(fresh_traces,
        new_watermark_us)``; the watermark is the max span startTime
        delivered (unchanged on an empty poll) — always monotone."""
        doc = self.transport.request_json(
            f"{self.base_url}/api/traces",
            params={"service": service, "limit": limit,
                    "start": int(since_us), "end": int(until_us)})
        fresh: List[dict] = []
        mark = int(since_us)
        for tr in doc.get("data") or []:
            starts = [int(sp.get("startTime", 0))
                      for sp in (tr.get("spans") or [])]
            if not starts or max(starts) <= since_us:
                continue
            fresh.append(tr)
            mark = max(mark, max(starts))
        return fresh, mark

    def collect_all(self, out_path: Path, limit: int = 2000,
                    lookback_ms: int = 3_600_000) -> CollectReport:
        merged: Dict[str, dict] = {}
        n_dup = 0
        for svc in self.services():
            for tr in self.traces(svc, limit=limit, lookback_ms=lookback_ms):
                tid = tr.get("traceID", "")
                if tid in merged:
                    n_dup += 1
                else:
                    merged[tid] = tr
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"data": list(merged.values())}, f)
        return CollectReport(kind="jaeger", files=(str(out_path),),
                             n_records=len(merged), n_skipped=n_dup,
                             notes=(f"deduped {n_dup} cross-service "
                                    f"duplicates",))


# ---------------------------------------------------------------------------
# SkyWalking GraphQL
# ---------------------------------------------------------------------------

# The GraphQL query surface, reduced to exactly the fields the artifact
# schema needs (the public SkyWalking OAP API; trace_collector.py:139-178
# queries the same endpoints).
_SW_TRACE_LIST = """
query queryBasicTraces($condition: TraceQueryCondition!) {
  data: queryBasicTraces(condition: $condition) {
    total
    traces { traceIds duration start isError endpointNames }
  }
}
""".strip()

_SW_TRACE_DETAIL = """
query queryTrace($traceId: ID!) {
  trace: queryTrace(traceId: $traceId) {
    spans {
      traceId segmentId spanId parentSpanId serviceCode
      startTime endTime endpointName type peer component isError layer
      tags { key value }
      refs { traceId parentSegmentId parentSpanId type }
    }
  }
}
""".strip()


@dataclasses.dataclass
class SkyWalkingClient:
    """SkyWalking OAP GraphQL client (TT trace path): paginated summary
    listing with traceID dedup, per-trace span fetch, and
    :meth:`build_artifact`, which writes the collector JSON schema
    ``anomod_torch.io.tt_traces`` loads (behavioral parity:
    trace_collector.py:296-396 fetch, :552-584 artifact)."""
    graphql_url: str
    transport: HttpTransport = dataclasses.field(default_factory=HttpTransport)

    def _post(self, query: str, variables: dict) -> dict:
        doc = self.transport.request_json(
            self.graphql_url, payload={"query": query,
                                       "variables": variables})
        if doc.get("errors"):
            raise TransportError(f"graphql error: {doc['errors']}")
        return doc.get("data") or {}

    def trace_summaries(self, limit: int = 1000, hours_back: float = 1.0,
                        page_size: int = 200,
                        now_s: Optional[float] = None) -> List[dict]:
        """Paginated ``queryBasicTraces`` sweep -> summary dicts, deduped
        by first traceId; stops on a short page or at ``limit``.  The
        query window is minute-grained under 12 h lookback, hour-grained
        beyond (the reference's step selection).  ``limit`` must be >= 1:
        there is no unlimited mode (a server that always returns full
        pages would otherwise paginate forever)."""
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        page_size = max(1, min(page_size, limit))
        now = time.time() if now_s is None else now_s
        start = now - max(hours_back, 0.1) * 3600.0
        step = "MINUTE" if hours_back <= 12 else "HOUR"
        fmt = "%Y-%m-%d %H%M" if step == "MINUTE" else "%Y-%m-%d %H"
        condition_base = {
            # queryDuration strings are rendered in UTC: the OAP server
            # interprets them in its own timezone, so a deterministic
            # rendering (rather than the collector host's local TZ) is the
            # only choice that makes the same call reproducible everywhere
            "queryDuration": {
                "start": datetime.fromtimestamp(
                    start, tz=timezone.utc).strftime(fmt),
                "end": datetime.fromtimestamp(
                    now, tz=timezone.utc).strftime(fmt),
                "step": step,
            },
            "traceState": "ALL",
            "queryOrder": "BY_START_TIME",
            "paging": {"pageNum": 1, "pageSize": page_size},
        }
        out: List[dict] = []
        seen: set = set()
        page = 1
        while len(out) < limit:
            condition = dict(condition_base,
                             paging={"pageNum": page, "pageSize": page_size})
            data = self._post(_SW_TRACE_LIST, {"condition": condition})
            traces = (data.get("data") or {}).get("traces") or []
            if not traces:
                break
            new_here = 0
            for entry in traces:
                tids = entry.get("traceIds") or []
                if not tids or tids[0] in seen:
                    continue
                seen.add(tids[0])
                new_here += 1
                out.append(dict(entry, traceIds=tids))
                if len(out) >= limit:
                    break
            if len(traces) < page_size:
                break
            if new_here == 0:
                # a full page of already-seen traces means the server is
                # not honoring pageNum (or the window is being re-served);
                # without this break such a server paginates forever
                break
            page += 1
        return out[:limit]

    def trace_spans(self, trace_id: str) -> List[dict]:
        data = self._post(_SW_TRACE_DETAIL, {"traceId": trace_id})
        return list((data.get("trace") or {}).get("spans") or [])

    @staticmethod
    def build_artifact(experiment: str,
                       traces: List[Tuple[dict, List[dict]]],
                       collection_hours: float = 24) -> dict:
        """Raw GraphQL (summary, spans) pairs -> the collector JSON schema.

        Node identity is ``segment_id:span_id``; same-segment parents keep
        ``parent_span_id``, cross-segment parents ride ``refs`` — the
        loader (anomod_torch.io.tt_traces) resolves both vectorized."""
        out_traces: List[dict] = []
        all_services: set = set()
        n_spans = 0
        for summary, spans in traces:
            tids = summary.get("traceIds") or [""]
            tid = tids[0]
            arts: List[dict] = []
            roots: List[str] = []
            for sp in spans:
                seg = str(sp.get("segmentId", ""))
                sid = int(sp.get("spanId", 0))
                psid = int(sp.get("parentSpanId", -1))
                node = f"{seg}:{sid}"
                refs = [dict(r) for r in (sp.get("refs") or [])]
                parent_node = None
                if psid >= 0:
                    parent_node = f"{seg}:{psid}"
                elif refs:
                    parent_node = (f"{refs[0].get('parentSegmentId', '')}:"
                                   f"{refs[0].get('parentSpanId', -1)}")
                else:
                    roots.append(node)
                start_ms = int(sp.get("startTime", 0))
                end_ms = int(sp.get("endTime", start_ms))
                tags_map = {t.get("key", ""): t.get("value", "")
                            for t in (sp.get("tags") or [])}
                svc = str(sp.get("serviceCode", ""))
                all_services.add(svc)
                arts.append({
                    "node_id": node,
                    "trace_id": str(sp.get("traceId", tid)),
                    "segment_id": seg,
                    "span_id": sid,
                    "parent_span_id": psid,
                    "parent_node_id": parent_node,
                    "service_code": svc,
                    "start_timestamp_ms": start_ms,
                    "end_timestamp_ms": end_ms,
                    "duration_ms": max(0, end_ms - start_ms),
                    "endpoint_name": sp.get("endpointName") or "",
                    "type": sp.get("type") or "Local",
                    "peer": sp.get("peer"),
                    "component": sp.get("component"),
                    "layer": sp.get("layer"),
                    "is_error": bool(sp.get("isError", False)),
                    "tags": [{"key": k, "value": v}
                             for k, v in tags_map.items()],
                    "tags_map": tags_map,
                    "refs": refs,
                })
            n_spans += len(arts)
            out_traces.append({
                "summary": {"trace_ids": tids,
                            "duration": int(summary.get("duration", 0)),
                            "is_error": bool(summary.get("isError", False))},
                "trace_id": tid,
                "span_count": len(arts),
                "services_involved":
                    sorted({a["service_code"] for a in arts}),
                "root_span_node_ids": roots,
                "spans": arts,
            })
        return {
            "metadata": {
                "experiment": experiment,
                "collection_hours": collection_hours,
                "trace_count": len(out_traces),
                "span_count": n_spans,
                "services": sorted(all_services),
                # the schema's stamp, the JAX client's: both packages
                # write the same artifact bytes
                "generator": "anomod.io.live.SkyWalkingClient",
            },
            "traces": out_traces,
        }

    def collect(self, out_path: Path, experiment: str, limit: int = 1000,
                hours_back: float = 1.0, page_size: int = 200,
                now_s: Optional[float] = None) -> CollectReport:
        summaries = self.trace_summaries(limit=limit, hours_back=hours_back,
                                         page_size=page_size, now_s=now_s)
        pairs: List[Tuple[dict, List[dict]]] = []
        empty = 0
        for s in summaries:
            spans = self.trace_spans((s.get("traceIds") or [""])[0])
            if not spans:
                empty += 1
                continue
            pairs.append((s, spans))
        doc = self.build_artifact(experiment, pairs,
                                  collection_hours=hours_back)
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(doc, f)
        return CollectReport(
            kind="skywalking", files=(str(out_path),),
            n_records=doc["metadata"]["span_count"], n_skipped=empty,
            notes=(f"{len(pairs)} traces ({empty} empty-span summaries "
                   f"skipped)",))


# ---------------------------------------------------------------------------
# Elasticsearch (sw_segment-*)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticsearchClient:
    """Raw segment-index client (TT enhanced trace path): time-windowed
    ``sw_segment-*`` search, segment records in the ``detailed_traces``
    schema ``anomod_torch.io.tt_traces_es`` loads (service ids stay base64 —
    the LOADER owns decoding, one definition)."""
    base_url: str
    transport: HttpTransport = dataclasses.field(default_factory=HttpTransport)

    def segments(self, size: int = 1000, hours_back: float = 24.0,
                 now_s: Optional[float] = None) -> List[dict]:
        now = time.time() if now_s is None else now_s
        query = {
            "query": {"bool": {"must": [{"range": {"start_time": {
                "gte": int((now - hours_back * 3600.0) * 1000),
                "lte": int(now * 1000),
            }}}]}},
            "size": size,
            "sort": [{"start_time": {"order": "desc"}}],
        }
        doc = self.transport.request_json(
            f"{self.base_url}/sw_segment-*/_search", payload=query)
        hits = (doc or {}).get("hits", {}).get("hits", [])
        return [h.get("_source", {}) for h in hits]

    def collect(self, out_path: Path, size: int = 1000,
                hours_back: float = 24.0,
                now_s: Optional[float] = None) -> CollectReport:
        """Write the ``detailed_traces`` JSON artifact (records keep the
        raw ES fields: trace_id, segment_id, service_id, endpoint_name,
        start/end ms, latency, is_error)."""
        records = []
        for src in self.segments(size=size, hours_back=hours_back,
                                 now_s=now_s):
            records.append({
                "trace_id": src.get("trace_id", ""),
                "segment_id": src.get("segment_id", ""),
                "service_id": src.get("service_id", ""),
                "endpoint_name": src.get("endpoint_name", ""),
                "start_time": src.get("start_time", 0),
                "end_time": src.get("end_time", 0),
                "latency": src.get("latency", 0),
                "is_error": src.get("is_error", 0),
            })
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"metadata": {
                "hours_back": hours_back, "requested_size": size,
                # the JAX client's stamp (the same artifact bytes)
                "generator": "anomod.io.live.ElasticsearchClient",
            }, "traces": records}, f)
        return CollectReport(kind="elasticsearch",
                             files=(str(out_path),),
                             n_records=len(records))
