"""Watch HTTP query API (ref watch/src/server) — the port's copy of
``lighthouse_tpu/watch/server.py``.

    GET /v1/slots/lowest | /v1/slots/highest | /v1/slots/{slot}
    GET /v1/blocks/{slot}
    GET /v1/validators/{index}/blocks
    GET /v1/participation?lo=..&hi=..
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class WatchServer:
    def __init__(self, db, host: str = "127.0.0.1", port: int = 0):
        self.db = db
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "WatchServer":
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


def _make_handler(api: WatchServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            u = urlparse(self.path)
            db = api.db
            try:
                m = re.match(r"^/v1/slots/(lowest|highest|\d+)$", u.path)
                if m:
                    which = m.group(1)
                    bounds = db.slot_bounds()
                    if which in ("lowest", "highest"):
                        if bounds is None:
                            self._reply(404, {"message": "no slots ingested"})
                            return
                        slot = bounds[0] if which == "lowest" else bounds[1]
                    else:
                        slot = int(which)
                    row = db.canonical_slot(slot)
                    if row is None:
                        self._reply(404, {"message": f"slot {slot} unknown"})
                    else:
                        self._reply(200, {"data": row})
                    return
                m = re.match(r"^/v1/blocks/(\d+)$", u.path)
                if m:
                    row = db.block(int(m.group(1)))
                    if row is None:
                        self._reply(404, {"message": "no block"})
                    else:
                        self._reply(200, {"data": row})
                    return
                m = re.match(r"^/v1/validators/(\d+)/blocks$", u.path)
                if m:
                    self._reply(
                        200,
                        {"data": db.blocks_by_proposer(int(m.group(1)))},
                    )
                    return
                if u.path == "/v1/participation":
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    self._reply(
                        200,
                        {
                            "data": db.participation(
                                int(q.get("lo", 0)), int(q.get("hi", 1 << 62))
                            )
                        },
                    )
                    return
                self._reply(404, {"message": f"no route {u.path}"})
            except Exception as e:  # noqa: BLE001 — API boundary
                self._reply(500, {"message": f"{type(e).__name__}: {e}"})

    return Handler
