"""Prometheus scrape endpoint (Lighthouse's beacon_node/http_metrics): the
port's copy of ``lighthouse_tpu/http_metrics/__init__.py``.

Serves the process-global registry at ``/metrics``; ``/health`` reports
liveness (common/system_health's role at its smallest)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.metrics import REGISTRY


class MetricsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, registry=None,
                 datadir: str | None = None):
        self.registry = registry or REGISTRY
        self.datadir = datadir
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    body = server.registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                elif self.path == "/health":
                    import json

                    from ..utils.system_health import system_health

                    payload = {"status": "ok"}
                    payload.update(system_health(server.datadir))
                    body = json.dumps(payload).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
