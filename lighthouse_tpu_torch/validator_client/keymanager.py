"""Keymanager API: the standard key-management HTTP surface on the VC — the port's copy of
``lighthouse_tpu/validator_client/keymanager.py``.

Lighthouse's validator-client HTTP API (``validator_client/http_api``,
6,629 LoC — keystores + remotekeys CRUD with slashing-protection export on
delete). Routes follow the Eth keymanager-API paths:

  GET    /eth/v1/keystores            list local keys
  POST   /eth/v1/keystores            import EIP-2335 keystores
  DELETE /eth/v1/keystores            delete keys + export slashing history
  GET    /eth/v1/remotekeys           list Web3Signer-backed keys
  POST   /eth/v1/remotekeys           register remote keys
  DELETE /eth/v1/remotekeys           unregister remote keys
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..keys.keystore import Keystore
from ..utils.logging import get_logger
from .web3signer import Web3SignerMethod

log = get_logger("keymanager")


class KeymanagerServer:
    def __init__(self, store, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "KeymanagerServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        log.info("Keymanager API started", url=self.url)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # -- handlers ----------------------------------------------------------

    def list_keystores(self):
        out = []
        for pk, v in self.store.validators.items():
            if isinstance(v.method, Web3SignerMethod):
                continue
            out.append(
                {
                    "validating_pubkey": "0x" + pk.hex(),
                    "derivation_path": "",
                    "readonly": not v.enabled,
                }
            )
        return out

    def import_keystores(self, body: dict):
        keystores = body.get("keystores", [])
        passwords = body.get("passwords", [])
        statuses = []
        for ks_json, pw in zip(keystores, passwords):
            try:
                ks = Keystore.from_json(
                    ks_json if isinstance(ks_json, str) else json.dumps(ks_json)
                )
                self.store.add_validator_keystore(ks, pw)
                statuses.append({"status": "imported"})
            except Exception as e:  # noqa: BLE001 — per-key status
                statuses.append({"status": "error", "message": str(e)})
        if body.get("slashing_protection"):
            sp = body["slashing_protection"]
            self.store.slashing_db.import_interchange(
                sp if isinstance(sp, dict) else json.loads(sp)
            )
        return statuses

    def delete_keystores(self, body: dict):
        pubkeys = [bytes.fromhex(p[2:]) for p in body.get("pubkeys", [])]
        statuses = []
        for pk in pubkeys:
            v = self.store.validators.get(pk)
            if v is not None and isinstance(v.method, Web3SignerMethod):
                # keystores CRUD must not affect remotekeys (keymanager spec)
                statuses.append({"status": "not_found"})
                continue
            removed = self.store.remove_validator(pk)
            statuses.append(
                {"status": "deleted" if removed else "not_found"}
            )
        interchange = self.store.slashing_db.export_interchange(
            self.store.genesis_validators_root
        )
        return {"data": statuses, "slashing_protection": interchange}

    def list_remotekeys(self):
        return [
            {
                "pubkey": "0x" + pk.hex(),
                "url": v.method.base,
                "readonly": not v.enabled,
            }
            for pk, v in self.store.validators.items()
            if isinstance(v.method, Web3SignerMethod)
        ]

    def import_remotekeys(self, body: dict):
        statuses = []
        for item in body.get("remote_keys", []):
            try:
                self.store.add_validator_remote(
                    bytes.fromhex(item["pubkey"][2:]), item["url"]
                )
                statuses.append({"status": "imported"})
            except Exception as e:  # noqa: BLE001 — per-key status
                statuses.append({"status": "error", "message": str(e)})
        return statuses

    def delete_remotekeys(self, body: dict):
        statuses = []
        for p in body.get("pubkeys", []):
            pk = bytes.fromhex(p[2:])
            v = self.store.validators.get(pk)
            if v is None or not isinstance(v.method, Web3SignerMethod):
                statuses.append({"status": "not_found"})
                continue
            removed = self.store.remove_validator(pk)
            statuses.append({"status": "deleted" if removed else "not_found"})
        return statuses


def _make_handler(api: KeymanagerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, payload) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw.decode() or "{}")

        def _route(self, method: str):
            path = self.path.split("?")[0]
            if path == "/eth/v1/keystores":
                if method == "GET":
                    return {"data": api.list_keystores()}
                if method == "POST":
                    return {"data": api.import_keystores(self._body())}
                if method == "DELETE":
                    return api.delete_keystores(self._body())
            if path == "/eth/v1/remotekeys":
                if method == "GET":
                    return {"data": api.list_remotekeys()}
                if method == "POST":
                    return {"data": api.import_remotekeys(self._body())}
                if method == "DELETE":
                    return {"data": api.delete_remotekeys(self._body())}
            return None

        def _dispatch(self, method: str) -> None:
            try:
                out = self._route(method)
                if out is None:
                    self._reply(404, {"message": f"no route {self.path}"})
                else:
                    self._reply(200, out)
            except Exception as e:  # noqa: BLE001 — API boundary
                self._reply(500, {"message": f"{type(e).__name__}: {e}"})

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

    return Handler
