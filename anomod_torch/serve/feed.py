"""The live telemetry feed: observability endpoints polled into the serve
tick (counterpart of ``anomod/serve/feed.py``).

:class:`LiveFeed` is a traffic source for ``ServeEngine.run`` that polls
live interfaces (a Prometheus text-exposition endpoint, Prometheus
``query_range``, Jaeger REST) by watermark-tailed incremental polls, one
poll sweep a virtual tick.  Three rules keep a live run auditable:

- **Walls are measured, never consulted.**  The one wall-clock read is
  the anchor ``t0_wall_s``, taken at construction and recorded in the
  wire journal.  Every poll window is a function of the anchor, the
  virtual tick bounds and the watermarks of earlier responses, and every
  collected sample is re-stamped onto the virtual clock by the bridge
  ``t_virt = t_wall - t0_wall + lag`` (``ANOMOD_SERVE_FEED_LAG_S``); a
  straggler behind the current tick is clamped forward to the tick's
  open edge (gap-fill, counted on ``anomod_feed_gaps_total``).
- **Every response is journaled.**  :class:`RecordingTransport` records
  each HTTP response the feed consumes, in sequence, published
  atomically to ``ANOMOD_FEED_JOURNAL``; :class:`ReplayTransport`
  re-serves the journal, so a live run and its replay see the same
  responses and give the same states, alerts, SLO, shed and canonical
  flight journal.  The wire journal's format, keys and entry order are
  the JAX package's: a journal either package writes replays in the
  other.
- **Deterministic corpus windowing.**  The metric-to-span synthesis
  (:func:`anomod_torch.obs.selfscrape.spans_from_metrics`) is stateful
  across a corpus (first differences, early-sample scale), so each tick
  re-runs it over the whole accumulated row corpus and emits only the
  spans in the tick's window: what is emitted is a function of the
  response sequence, never of how the corpus was chunked.

Sources (any subset): ``scrape_url``, a text-exposition endpoint fetched
whole each tick and stamped at the tick's open edge (the port's own
``/metrics``, :mod:`anomod_torch.obs.http`, is the dogfood loop:
``python -m anomod_torch serve --from-live self``); ``prom_url`` with
``prom_queries``, polled through
:meth:`anomod_torch.io.live.PrometheusClient.query_range_since`; and
``jaeger_url``, per-service trace polls through
:meth:`anomod_torch.io.live.JaegerClient.traces_since`.

The feed is host work; the engine it drives runs its lane kernels on the
card unless ``run_live_feed`` is given ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anomod_torch.io.live import HttpTransport, TransportError
from anomod_torch.obs.registry import get_registry, render_labels
from anomod_torch.serve.queues import TenantSpec

#: wire-journal document format (bumped on schema change; load refuses
#: mismatches the way the flight journal does)
FEED_WIRE_FORMAT = 1

#: bounded trace-id table for synthesized feed spans (the PowerLaw idiom)
_TRACE_IDS = tuple(f"t{i:02x}" for i in range(64))


# ---------------------------------------------------------------------------
# Prometheus text-exposition parsing (the scrape read side)
# ---------------------------------------------------------------------------

def _unescape_label_value(raw: str) -> str:
    """Inverse of :func:`anomod_torch.obs.export.escape_label_value`: ``\\\\``,
    ``\\"`` and ``\\n`` back to their characters; an unknown escape
    keeps the backslash literally (the exposition grammar's behavior)."""
    out: List[str] = []
    i, n = 0, len(raw)
    while i < n:
        c = raw[i]
        if c == "\\" and i + 1 < n:
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_label_block(line: str, start: int) -> Tuple[Dict[str, str], int]:
    """Parse ``k="v",...}`` starting just past the ``{``; returns the
    label dict and the index just past the closing ``}``."""
    labels: Dict[str, str] = {}
    i, n = start, len(line)
    while i < n:
        while i < n and line[i] in ", \t":
            i += 1
        if i < n and line[i] == "}":
            return labels, i + 1
        eq = line.find("=", i)
        if eq < 0 or eq + 1 >= n or line[eq + 1] != '"':
            raise ValueError(f"malformed label block: {line!r}")
        key = line[i:eq].strip()
        j = eq + 2
        buf: List[str] = []
        while j < n:
            c = line[j]
            if c == "\\" and j + 1 < n:
                buf.append(c)
                buf.append(line[j + 1])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        if j >= n:
            raise ValueError(f"unterminated label value: {line!r}")
        labels[key] = _unescape_label_value("".join(buf))
        i = j + 1
    raise ValueError(f"unterminated label block: {line!r}")


def parse_prometheus_text(text: str) -> List[Tuple[str, str, float]]:
    """Exposition-format text -> ``(sample_name, labels_str, value)``
    rows, with ``labels_str`` the registry's canonical UNESCAPED
    rendering (:func:`anomod_torch.obs.registry.render_labels`), so a
    scrape of the port's own endpoint round-trips exactly to its
    registry's journal rows, adversarial labels included.

    Comment/blank lines and unparseable sample values are skipped (the
    reference collectors' tolerance); a structurally broken label block
    raises, because silently dropping half a scrape is how divergence
    hides."""
    rows: List[Tuple[str, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        sp = line.find(" ")
        if brace >= 0 and (sp < 0 or brace < sp):
            name = line[:brace]
            labels, end = _parse_label_block(line, brace + 1)
            rest = line[end:].strip()
        else:
            name, _, rest = line.partition(" ")
            labels = {}
        val_tok = rest.split()[0] if rest.split() else ""
        try:
            value = float(val_tok)
        except ValueError:
            continue
        rows.append((name, render_labels(labels), value))
    return rows


# ---------------------------------------------------------------------------
# The wire journal + its two transports
# ---------------------------------------------------------------------------

def _norm(doc) -> object:
    """JSON-normalize a params/payload value so live-recorded and
    journal-loaded copies compare equal (tuples->lists, int/float unify
    through the JSON number grammar)."""
    return json.loads(json.dumps(doc, sort_keys=True))


def _url_path(url: str) -> str:
    """Host/port-free request identity: replay must match a journal
    recorded against a different (ephemeral) port."""
    return urllib.parse.urlparse(url).path


class RecordingTransport:
    """Transport seam that records every successful response, in
    sequence, while delegating to a real :class:`HttpTransport` (whose
    retry/backoff policy is unchanged — only the FINAL response of a
    retried request is journaled, which is the one the feed consumed)."""

    def __init__(self, inner: Optional[HttpTransport] = None):
        self.inner = inner if inner is not None else HttpTransport()
        self.entries: List[dict] = []

    def _record(self, kind: str, url: str, payload, params, body) -> None:
        self.entries.append({
            "kind": kind, "path": _url_path(url),
            "params": _norm(params if params is not None else {}),
            "payload": _norm(payload) if payload is not None else None,
            "body": _norm(body) if kind == "json" else body,
        })

    def request_json(self, url: str, payload: Optional[dict] = None,
                     params: Optional[dict] = None):
        doc = self.inner.request_json(url, payload=payload, params=params)
        self._record("json", url, payload, params, doc)
        return doc

    def request_text(self, url: str, params: Optional[dict] = None) -> str:
        text = self.inner.request_text(url, params=params)
        self._record("text", url, None, params, text)
        return text


class ReplayTransport:
    """Re-serve a recorded wire journal, strictly in sequence.

    Every request must match the next journal entry on (kind, URL path,
    params, payload) — host and port are NOT part of the identity, so a
    journal recorded against an ephemeral dogfood port replays anywhere.
    A mismatch or an exhausted journal raises :class:`TransportError`:
    a replay that would silently serve the wrong response is worse than
    one that fails loudly."""

    def __init__(self, entries: Sequence[dict]):
        self.entries = list(entries)
        self._next = 0

    def _take(self, kind: str, url: str, payload, params):
        if self._next >= len(self.entries):
            raise TransportError(
                f"feed journal exhausted: no entry for {kind} "
                f"{_url_path(url)} (served {self._next})")
        entry = self.entries[self._next]
        want = {"kind": kind, "path": _url_path(url),
                "params": _norm(params if params is not None else {}),
                "payload": _norm(payload) if payload is not None else None}
        got = {k: entry.get(k) for k in want}
        if want != got:
            raise TransportError(
                f"feed journal divergence at entry {self._next}: "
                f"request {want} != recorded {got}")
        self._next += 1
        return entry["body"]

    def request_json(self, url: str, payload: Optional[dict] = None,
                     params: Optional[dict] = None):
        return self._take("json", url, payload, params)

    def request_text(self, url: str, params: Optional[dict] = None) -> str:
        return self._take("text", url, None, params)

    @property
    def n_served(self) -> int:
        return self._next


def dump_feed_journal(path, header: dict, entries: Sequence[dict]) -> Path:
    """Atomic publish (the flight journal's one writer) of the
    wire-journal document."""
    from anomod_torch.obs.flight import _atomic_write_json
    return _atomic_write_json(path, {
        "feed_format": FEED_WIRE_FORMAT, "header": dict(header),
        "entries": list(entries)})


def load_feed_journal(path) -> dict:
    """Load a wire journal; fails loud on a non-feed document."""
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict) or "entries" not in doc \
            or doc.get("feed_format") != FEED_WIRE_FORMAT:
        raise ValueError(f"not a feed wire journal (format "
                         f"{FEED_WIRE_FORMAT}): {path}")
    return doc


# ---------------------------------------------------------------------------
# The feed itself
# ---------------------------------------------------------------------------

class LiveFeed:
    """Engine traffic source polling live observability endpoints.

    Implements the engine's duck-typed surface (``arrivals(lo, hi)`` /
    ``modality_arrivals`` / ``specs``): each ``arrivals`` call runs one
    poll sweep over the configured sources, folds fresh data into the
    virtual-stamped corpus, and returns the per-tenant span batches
    whose virtual start times land in ``[lo, hi)``.

    Tenant/service identity: every collected stream carries a source
    token (the metric subsystem for scrape/Prometheus rows, the service
    name for Jaeger spans); tokens map to the fixed tenant/service slots
    in first-seen order, clipped to the declared fleet size — the
    selfscrape subsystem mapping, extended to live sources.  The fleet
    shape is declared up front (``n_tenants`` / ``n_services``) because
    the engine needs its spec table at construction, before the first
    poll can discover anything.
    """

    def __init__(self, scrape_url: Optional[str] = None,
                 prom_url: Optional[str] = None,
                 prom_queries: Sequence[str] = (),
                 jaeger_url: Optional[str] = None,
                 n_tenants: int = 8, n_services: int = 8,
                 lag_s: Optional[float] = None,
                 step: str = "15s",
                 transport=None,
                 t0_wall_s: Optional[float] = None):
        if not (scrape_url or prom_url or jaeger_url):
            raise ValueError("LiveFeed needs at least one source "
                             "(scrape_url, prom_url or jaeger_url)")
        if prom_url and not prom_queries:
            raise ValueError("prom_url needs prom_queries")
        if n_tenants < 1 or n_services < 1:
            raise ValueError("n_tenants and n_services must be >= 1")
        from anomod_torch.config import get_config
        cfg = get_config()
        self.scrape_url = scrape_url
        self.prom_url = prom_url
        self.prom_queries = tuple(prom_queries)
        self.jaeger_url = jaeger_url
        self.n_tenants = int(n_tenants)
        self.lag_s = float(cfg.serve_feed_lag_s if lag_s is None
                           else lag_s)
        self.step = str(step)
        self.transport = transport if transport is not None \
            else RecordingTransport()
        # THE one wall-clock read that feeds decisions — and only via
        # the journal: recorded in the header, reused verbatim on replay
        self.t0_wall_s = float(time.time() if t0_wall_s is None
                               else t0_wall_s)
        self.services: Tuple[str, ...] = tuple(
            f"live{i:02d}" for i in range(int(n_services)))
        self.specs: List[TenantSpec] = [
            TenantSpec(tenant_id=t, name=f"feed{t:04d}", priority=t % 3,
                       rate_spans_per_s=100.0)
            for t in range(self.n_tenants)]
        self.faults: Dict[int, object] = {}
        # source clients share the (recording or replay) transport
        self._prom = None
        if prom_url:
            from anomod_torch.io.live import PrometheusClient
            self._prom = PrometheusClient(prom_url,
                                          transport=self.transport)
        self._jaeger = None
        if jaeger_url:
            from anomod_torch.io.live import JaegerClient
            self._jaeger = JaegerClient(jaeger_url,
                                        transport=self.transport)
        # watermarks (virtual-bridge state; all derived from responses)
        self._prom_marks: Dict[str, float] = {
            q: self.t0_wall_s - self.lag_s for q in self.prom_queries}
        self._jaeger_services: Optional[List[str]] = None
        self._jaeger_marks: Dict[str, int] = {}
        # corpora (grow monotonically; re-windowed each tick)
        self._mrows: List[Tuple[float, str, str, float]] = []
        self._jspans: List[Tuple[int, str, str, int, bool]] = []
        self._emitted_us = -1      # high-water mark of emitted windows
        # token -> first-seen slot index (tenant AND service identity)
        self._tokens: Dict[str, int] = {}
        self._endpoints: Dict[str, int] = {}
        # feed telemetry (variant plane: measured, never decisive)
        reg = get_registry()
        self._obs_polls = reg.counter("anomod_feed_polls_total")
        self._obs_samples = reg.counter("anomod_feed_samples_total")
        self._obs_spans = reg.counter("anomod_feed_spans_total")
        self._obs_gaps = reg.counter("anomod_feed_gaps_total")
        self._obs_lag = reg.histogram("anomod_feed_lag_s")
        self.n_polls = 0
        self.n_samples = 0
        self.n_spans = 0
        self.n_gaps = 0

    # -- construction from a wire journal (replay mode) --------------------

    @classmethod
    def from_journal(cls, journal, n_tenants: Optional[int] = None,
                     n_services: Optional[int] = None,
                     lag_s: Optional[float] = None) -> "LiveFeed":
        """Rebuild the feed a journal records: same sources, same
        anchor, same lag — served by a :class:`ReplayTransport`, so the
        run needs no network and reproduces the live run's planes
        byte-for-byte."""
        doc = journal if isinstance(journal, dict) \
            else load_feed_journal(journal)
        h = doc.get("header", {})
        return cls(
            scrape_url=h.get("scrape_url") or None,
            prom_url=h.get("prom_url") or None,
            prom_queries=tuple(h.get("prom_queries") or ()),
            jaeger_url=h.get("jaeger_url") or None,
            n_tenants=int(h["n_tenants"] if n_tenants is None
                          else n_tenants),
            n_services=int(h["n_services"] if n_services is None
                           else n_services),
            lag_s=float(h["lag_s"] if lag_s is None else lag_s),
            step=str(h.get("step", "15s")),
            transport=ReplayTransport(doc.get("entries", ())),
            t0_wall_s=float(h["t0_wall_s"]))

    def header(self) -> dict:
        """The wire journal's header: everything replay needs to re-run
        this feed's exact request sequence."""
        return {"scrape_url": self.scrape_url or "",
                "prom_url": self.prom_url or "",
                "prom_queries": list(self.prom_queries),
                "jaeger_url": self.jaeger_url or "",
                "n_tenants": self.n_tenants,
                "n_services": len(self.services),
                "lag_s": self.lag_s, "step": self.step,
                "t0_wall_s": self.t0_wall_s}

    def journal_entries(self) -> List[dict]:
        return list(getattr(self.transport, "entries", ()))

    def dump_journal(self, path) -> Path:
        return dump_feed_journal(path, self.header(),
                                 self.journal_entries())

    # -- the poll sweep ----------------------------------------------------

    def _bridge(self, t_wall_s: float, lo: float) -> float:
        """Wall -> virtual: anchor-relative shift plus the lag budget;
        stragglers clamp forward to the tick's open edge (gap-fill)."""
        t_virt = t_wall_s - self.t0_wall_s + self.lag_s
        self._obs_lag.observe(max(self.lag_s, 0.0))
        if t_virt < lo:
            self.n_gaps += 1
            self._obs_gaps.inc()
            return lo
        return t_virt

    def _poll(self, lo: float, hi: float) -> None:
        # wall-side poll ceiling: a pure function of (anchor, virtual
        # tick edge, lag) — never the local clock, so replay issues the
        # byte-same request parameters
        w_hi = self.t0_wall_s + max(hi - self.lag_s, 0.0)
        if self.scrape_url is not None:
            text = self.transport.request_text(self.scrape_url)
            self.n_polls += 1
            self._obs_polls.inc()
            # scrape rows stamp at the tick's open edge under the same
            # lag budget the bridge applies, so the lag histogram sees
            # the effective ingest lag here too
            self._obs_lag.observe(max(self.lag_s, 0.0))
            rows = parse_prometheus_text(text)
            for name, labels_str, value in rows:
                # whole-endpoint scrapes are point-in-time: stamped at
                # the tick's open edge (pure virtual, no bridge)
                self._mrows.append((lo, name, labels_str, value))
            self.n_samples += len(rows)
            self._obs_samples.inc(len(rows))
        if self._prom is not None:
            for q in self.prom_queries:
                fresh, mark = self._prom.query_range_since(
                    q, self._prom_marks[q], w_hi, step=self.step)
                self._prom_marks[q] = mark
                self.n_polls += 1
                self._obs_polls.inc()
                for ts, val, labels in fresh:
                    name = labels.get("__name__") or q
                    lab = render_labels({k: v for k, v in labels.items()
                                         if k != "__name__"})
                    self._mrows.append(
                        (self._bridge(ts, lo), name, lab, val))
                self.n_samples += len(fresh)
                self._obs_samples.inc(len(fresh))
        if self._jaeger is not None:
            if self._jaeger_services is None:
                self._jaeger_services = sorted(self._jaeger.services())
                mark0 = int((self.t0_wall_s - self.lag_s) * 1e6)
                self._jaeger_marks = {s: mark0
                                      for s in self._jaeger_services}
            for svc in self._jaeger_services:
                fresh, mark = self._jaeger.traces_since(
                    svc, self._jaeger_marks[svc], int(w_hi * 1e6))
                self._jaeger_marks[svc] = mark
                self.n_polls += 1
                self._obs_polls.inc()
                n_here = 0
                for tr in fresh:
                    for sp in tr.get("spans") or []:
                        start_wall_s = float(sp.get("startTime", 0)) / 1e6
                        t_virt = self._bridge(start_wall_s, lo)
                        self._jspans.append((
                            int(round(t_virt * 1e6)), str(svc),
                            str(sp.get("operationName") or "op"),
                            max(int(sp.get("duration", 0)), 1),
                            bool(any(
                                t.get("key") == "error"
                                and str(t.get("value")).lower() == "true"
                                for t in sp.get("tags") or ()))))
                        n_here += 1
                self.n_samples += n_here
                self._obs_samples.inc(n_here)

    # -- window synthesis --------------------------------------------------

    def _token_slot(self, token: str) -> int:
        got = self._tokens.get(token)
        if got is None:
            got = len(self._tokens)
            self._tokens[token] = got
        return got

    def _metric_window(self, lo_us: int,
                       hi_us: int) -> List[Tuple[int, str, str, int, bool]]:
        """Re-synthesize spans over the whole metric corpus, keep the
        window — see the module docstring's determinism rule."""
        if not self._mrows:
            return []
        from anomod_torch.obs.export import rows_to_metric_batch
        from anomod_torch.obs.selfscrape import spans_from_metrics
        spans = spans_from_metrics(rows_to_metric_batch(self._mrows))
        if spans.n_spans == 0:
            return []
        m = (spans.start_us >= lo_us) & (spans.start_us < hi_us)
        out = []
        for i in np.nonzero(m)[0]:
            out.append((int(spans.start_us[i]),
                        spans.services[int(spans.service[i])],
                        spans.endpoints[int(spans.endpoint[i])],
                        max(int(spans.duration_us[i]), 1),
                        bool(spans.is_error[i])))
        return out

    def arrivals(self, t_lo_s: float,
                 t_hi_s: float) -> List[Tuple[int, "object"]]:
        from anomod_torch.schemas import KIND_LOCAL, SpanBatch
        self._poll(t_lo_s, t_hi_s)
        lo_us = int(round(t_lo_s * 1e6))
        hi_us = int(round(t_hi_s * 1e6))
        rows = self._metric_window(lo_us, hi_us)
        rows += [r for r in self._jspans
                 if lo_us <= r[0] < hi_us and r[0] > self._emitted_us]
        self._emitted_us = max(self._emitted_us, hi_us - 1)
        if not rows:
            return []
        n_svc = len(self.services)
        by_tenant: Dict[int, List[Tuple[int, int, int, int, bool]]] = {}
        for start_us, token, endpoint, dur_us, is_err in rows:
            slot = self._token_slot(token)
            ep = self._endpoints.setdefault(endpoint,
                                            len(self._endpoints))
            tenant = min(slot, self.n_tenants - 1)
            by_tenant.setdefault(tenant, []).append(
                (start_us, min(slot, n_svc - 1), ep, dur_us, is_err))
        endpoints = tuple(self._endpoints)
        out: List[Tuple[int, SpanBatch]] = []
        for tenant in sorted(by_tenant):
            rs = sorted(by_tenant[tenant])
            n = len(rs)
            batch = SpanBatch(
                trace=(np.arange(n) % len(_TRACE_IDS)).astype(np.int32),
                parent=np.full(n, -1, np.int32),
                service=np.asarray([r[1] for r in rs], np.int32),
                endpoint=np.asarray([r[2] for r in rs], np.int32),
                start_us=np.asarray([r[0] for r in rs], np.int64),
                duration_us=np.asarray([r[3] for r in rs], np.int64),
                is_error=np.asarray([r[4] for r in rs], np.bool_),
                status=np.where(np.asarray([r[4] for r in rs]), 500,
                                200).astype(np.int16),
                kind=np.full(n, KIND_LOCAL, np.int8),
                services=self.services, endpoints=endpoints,
                trace_ids=_TRACE_IDS).validate()
            out.append((tenant, batch))
            self.n_spans += n
            self._obs_spans.inc(n)
        return out

    def modality_arrivals(self, t_lo_s: float, t_hi_s: float) -> List[tuple]:
        """No live log/api planes yet — the surface exists so the engine's
        multimodal path can drive a feed without a hasattr special case."""
        return []


# ---------------------------------------------------------------------------
# The canonical feed run (the run_power_law twin for live sources)
# ---------------------------------------------------------------------------

def run_live_feed(scrape_url: Optional[str] = None,
                  prom_url: Optional[str] = None,
                  prom_queries: Sequence[str] = (),
                  jaeger_url: Optional[str] = None,
                  replay=None,
                  n_tenants: Optional[int] = None,
                  n_services: Optional[int] = None,
                  capacity_spans_per_s: float = 2000.0,
                  duration_s: float = 20.0, tick_s: float = 1.0,
                  lag_s: Optional[float] = None,
                  window_s: float = 5.0, baseline_windows: int = 4,
                  z_threshold: float = 4.0,
                  buckets: Optional[Tuple[int, ...]] = None,
                  lane_buckets: Optional[Tuple[int, ...]] = None,
                  max_backlog: Optional[int] = None,
                  score: bool = True, n_windows: int = 32,
                  fuse: Optional[bool] = None,
                  shards: Optional[int] = None,
                  pipeline: Optional[int] = None,
                  flight: Optional[bool] = None,
                  flight_digest_every: Optional[int] = None,
                  flight_max_ticks: Optional[int] = None,
                  journal=None, device=None):
    """Drive one live (or journal-replayed) feed run on ``device`` (the
    card unless ``"cpu"``).

    Builds the feed, runs the engine for ``duration_s`` virtual seconds,
    writes the flight header's replay contract (``traffic="live_feed"``
    and the wire journal's path, so ``audit replay`` rebuilds the run
    through :class:`ReplayTransport`) and, when ``journal`` (or
    ``ANOMOD_FEED_JOURNAL``) names a path on a live run, publishes the
    wire journal atomically at the end.  Returns ``(engine, report,
    feed)``.
    """
    from anomod_torch.config import get_config
    from anomod_torch.serve.engine import ServeEngine, serve_plane_cfg
    cfg = get_config()
    journal_path = cfg.feed_journal if journal is None else Path(journal)
    if replay is not None:
        # None passes through, so the wire journal's header sizes the
        # fleet: a replay plane sized unlike the live run's would diverge
        # at the fold digest (sw = n_services * n_windows), not error
        feed = LiveFeed.from_journal(replay, n_tenants=n_tenants,
                                     n_services=n_services, lag_s=lag_s)
        journal_path = None          # a replay never re-records itself
    else:
        feed = LiveFeed(scrape_url=scrape_url, prom_url=prom_url,
                        prom_queries=prom_queries, jaeger_url=jaeger_url,
                        n_tenants=8 if n_tenants is None else n_tenants,
                        n_services=8 if n_services is None else n_services,
                        lag_s=lag_s)
    plane_cfg = serve_plane_cfg(len(feed.services), window_s, n_windows)
    engine = ServeEngine(feed.specs, feed.services, plane_cfg,
                         capacity_spans_per_s=capacity_spans_per_s,
                         tick_s=tick_s, buckets=buckets,
                         lane_buckets=lane_buckets,
                         max_backlog=max_backlog, score=score,
                         baseline_windows=baseline_windows,
                         z_threshold=z_threshold,
                         fuse=True if fuse is None else fuse,
                         shards=shards, pipeline=pipeline, device=device,
                         flight=flight,
                         flight_digest_every=flight_digest_every,
                         flight_max_ticks=flight_max_ticks)
    if engine.flight_recorder is not None:
        # the feed run's replay contract, in the JAX engine's keys:
        # `audit replay` re-runs this invocation through the wire journal
        # (the response sequence a live run is reproduced from), so the
        # journal's path and the resolved feed knobs are what the header
        # carries
        engine.flight_recorder.header["run"] = dict(
            traffic="live_feed",
            feed_journal=str(journal_path) if journal_path else "",
            n_tenants=feed.n_tenants, n_services=len(feed.services),
            capacity_spans_per_s=capacity_spans_per_s,
            duration_s=duration_s, tick_s=tick_s,
            lag_s=feed.lag_s, window_s=window_s,
            baseline_windows=baseline_windows, z_threshold=z_threshold,
            buckets=list(engine.runner.buckets),
            lane_buckets=list(engine.runner.lane_buckets),
            max_backlog=engine.max_backlog, score=score,
            n_windows=n_windows, fuse=engine.fuse, shards=engine.shards,
            pipeline=engine.pipeline, flight=True,
            flight_digest_every=engine.flight_recorder.digest_every,
            flight_max_ticks=engine.flight_recorder.max_ticks)
    report = engine.run(feed, duration_s=duration_s)
    if journal_path is not None:
        feed.dump_journal(journal_path)
    return engine, report, feed
