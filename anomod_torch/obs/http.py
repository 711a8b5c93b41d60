"""Embedded ``/metrics`` endpoint plane: the port as a scrape TARGET
(counterpart of ``anomod/obs/http.py``).

- **Decision planes are untouchable.**  Every handler is a pure READ of
  the process registry, so every decision is byte-identical endpoint on
  or off.
- **Off by default, localhost-bound.**  Serving HTTP is opt-in
  (``ANOMOD_OBS_HTTP``); the bind address is always ``127.0.0.1``.
- **Stdlib only.**  ``http.server.ThreadingHTTPServer`` on a daemon
  thread.

Endpoints (GET and HEAD):

- ``/metrics``: Prometheus text exposition
  (:func:`anomod_torch.obs.export.to_prometheus_text`) with the
  ``text/plain; version=0.0.4`` Content-Type;
- ``/healthz``: JSON liveness, registry stats and, with an engine
  attached, its tick / virtual clock / backlog;
- ``/flight``: the attached flight recorder's ring
  (:mod:`anomod_torch.obs.flight`) as JSON; attaching an engine attaches
  its recorder.  Without one it answers 404 "no flight recorder
  attached", as the JAX server does.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from anomod_torch.obs.export import to_prometheus_text
from anomod_torch.obs.registry import Registry, get_registry

#: the exposition-format Content-Type the Prometheus scrape protocol
#: requires (version=0.0.4 is the text-format version, not ours)
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsHttpServer:
    """Localhost-bound endpoint plane over one registry.

    ``port=0`` (the test/dogfood mode) binds an OS-assigned ephemeral
    port; read it back off :attr:`port` after :meth:`start`.  ``engine``
    and ``recorder`` are attached lazily (:meth:`attach`) because the
    serve handler builds the server before the engine exists.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 port: Optional[int] = None):
        if port is None:
            from anomod_torch.config import get_config
            port = get_config().obs_http_port
        self._registry = registry
        self._want_port = int(port)
        self._engine = None
        self._recorder = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- wiring ------------------------------------------------------------

    def attach(self, engine=None, recorder=None) -> None:
        """Attach the live engine and/or flight recorder the read-only
        handlers summarize; either may be attached later or never."""
        if engine is not None:
            self._engine = engine
            rec = getattr(engine, "flight_recorder", None)
            if recorder is None and rec is not None:
                recorder = rec
        if recorder is not None:
            self._recorder = recorder

    def registry(self) -> Registry:
        # resolved per request when constructed registry-less, so a
        # set_registry() swap (the bench's per-leg idiom) is visible
        return self._registry if self._registry is not None \
            else get_registry()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ObsHttpServer":
        if self._httpd is not None:
            return self
        plane = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _respond(self, code: int, ctype: str, body: bytes,
                         head_only: bool) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head_only:
                    self.wfile.write(body)

            def _serve(self, head_only: bool) -> None:
                path = self.path.split("?", 1)[0]
                try:
                    route = plane._routes().get(path)
                    if route is None:
                        self._respond(
                            404, "application/json",
                            json.dumps({"error": f"no route {path}",
                                        "routes": sorted(
                                            plane._routes())}).encode(),
                            head_only)
                        return
                    code, ctype, body = route()
                    self._respond(code, ctype, body, head_only)
                except Exception as e:  # a broken scrape must not kill
                    self._respond(     # the server thread
                        500, "application/json",
                        json.dumps({"error": f"{type(e).__name__}: "
                                             f"{e}"}).encode(),
                        head_only)

            def do_GET(self):
                self._serve(head_only=False)

            def do_HEAD(self):
                # HEAD is part of the scrape protocol (probes/uptime
                # checks issue it); same headers, no body
                self._serve(head_only=True)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="anomod-obs-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("ObsHttpServer not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def __enter__(self) -> "ObsHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- handlers (pure reads) ---------------------------------------------

    def _routes(self):
        return {"/metrics": self._metrics, "/healthz": self._healthz,
                "/flight": self._flight}

    def _metrics(self):
        return 200, PROM_CONTENT_TYPE, \
            to_prometheus_text(self.registry()).encode()

    def _healthz(self):
        reg = self.registry()
        doc = {"status": "ok", "registry": {
            "enabled": reg.enabled, "n_metrics": len(reg.metrics()),
            "n_samples": reg.n_samples}}
        eng = self._engine
        if eng is not None:
            clock = getattr(eng, "clock", None)
            admission = getattr(eng, "admission", None)
            doc["engine"] = {
                "ticks": getattr(clock, "ticks", None),
                "now_s": getattr(clock, "now_s", None),
                "backlog_spans": getattr(admission, "backlog_spans", None),
            }
        return 200, "application/json", json.dumps(doc).encode()

    def _flight(self):
        rec = self._recorder
        if rec is None:
            return 404, "application/json", json.dumps(
                {"error": "no flight recorder attached"}).encode()
        doc = {"flight_format": rec.journal().get("flight_format"),
               "n_recorded": rec.n_recorded, "n_dropped": rec.n_dropped,
               "ticks": rec.records()}
        return 200, "application/json", json.dumps(doc).encode()


def maybe_serve(registry: Optional[Registry] = None
                ) -> Optional[ObsHttpServer]:
    """Start the endpoint plane iff ``ANOMOD_OBS_HTTP`` is on (the serve
    CLI's one-liner).  Returns the started server or None."""
    from anomod_torch.config import get_config
    cfg = get_config()
    if not cfg.obs_http:
        return None
    return ObsHttpServer(registry=registry, port=cfg.obs_http_port).start()
