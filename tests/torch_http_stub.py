"""In-process JSON-over-HTTP stub on ``127.0.0.1`` for the live-layer tests
of the port (the form of ``tests/test_live.py``'s ``JsonStub``): ``route(
method, path, params, body) -> (status, doc)``; every request is recorded.
A ``str`` doc is served as ``text/plain`` (a text-exposition scrape)."""

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class JsonStub:

    def __init__(self, route):
        stub = self
        stub.requests = []

        class Handler(BaseHTTPRequestHandler):
            def _serve(self, method):
                parsed = urllib.parse.urlparse(self.path)
                params = {k: v[0] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length)) if length \
                    else None
                stub.requests.append((method, parsed.path, params, body))
                status, doc = route(method, parsed.path, params, body)
                text = isinstance(doc, str)
                payload = (doc if text else json.dumps(doc)).encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/plain" if text
                                 else "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

            def log_message(self, *a):  # quiet
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base_url = f"http://127.0.0.1:{self.server.server_port}"

    def take(self):
        """The requests recorded so far, cleared."""
        got, self.requests = self.requests, []
        return got

    def close(self):
        self.server.shutdown()
        self.server.server_close()
