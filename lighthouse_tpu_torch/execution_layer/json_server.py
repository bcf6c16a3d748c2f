"""Serve an in-process ExecutionEngine (+ Eth1Provider) over HTTP JSON-RPC.

The socket-facing face of the mock EL: what ``MockExecutionLayer`` provides
in-process, this exposes as a real engine-API endpoint with JWT checking, so
the HTTP client stack (``http.py``, ``eth1/http_provider.py``) is exercised
against genuine sockets in tests — Lighthouse's mock EL serves HTTP the
same way (``execution_layer/src/test_utils/mod.rs`` + ``handle_rpc.rs``).
The port's copy of ``lighthouse_tpu/execution_layer/json_server.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .auth import JwtKey
from .http import (
    ENGINE_CAPABILITIES,
    attributes_from_json,
    data,
    payload_from_json,
    payload_to_json,
    qty,
    status_to_json,
    undata,
    unqty,
)


class ExecutionJsonRpcServer:
    """HTTP JSON-RPC server over an ExecutionEngine and/or Eth1Provider."""

    def __init__(self, engine=None, eth1=None, ns=None, jwt_key: JwtKey | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 deposit_contract_address: bytes = b"\x11" * 20):
        self.engine = engine
        self.eth1 = eth1
        self.jwt_key = jwt_key
        self.deposit_contract_address = deposit_contract_address
        # fork payload classes for decoding engine_newPayload bodies
        self._payload_classes = []
        if ns is not None:
            for name in (
                "ExecutionPayloadDeneb",
                "ExecutionPayloadCapella",
                "ExecutionPayloadBellatrix",
            ):
                cls = getattr(ns, name, None)
                if cls is not None:
                    self._payload_classes.append(cls)
        self.requests_served = 0
        self.auth_failures = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                outer._handle(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"el-rpc-{self.url}",
        )

    def start(self) -> "ExecutionJsonRpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # -- request handling ---------------------------------------------------

    def _handle(self, req) -> None:
        if self.jwt_key is not None:
            auth = req.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip()
            if not auth.startswith("Bearer ") or not self.jwt_key.validate_token(token):
                self.auth_failures += 1
                req.send_response(401)
                req.end_headers()
                return
        try:
            length = int(req.headers.get("Content-Length", 0))
            body = json.loads(req.rfile.read(length))
            result = self._dispatch(body["method"], body.get("params", []))
            reply = {"jsonrpc": "2.0", "id": body.get("id"), "result": result}
        except Exception as e:  # noqa: BLE001 — protocol boundary
            reply = {
                "jsonrpc": "2.0",
                "id": None,
                "error": {"code": -32000, "message": str(e)},
            }
        out = json.dumps(reply).encode()
        req.send_response(200)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(out)))
        req.end_headers()
        req.wfile.write(out)
        self.requests_served += 1

    def _payload_cls_for(self, obj: dict):
        has_blob = "blobGasUsed" in obj
        has_wd = "withdrawals" in obj
        for cls in self._payload_classes:
            names = {n for n, _ in cls.FIELDS}
            if ("blob_gas_used" in names) == has_blob and (
                "withdrawals" in names
            ) == has_wd:
                return cls
        raise ValueError("no payload class registered for this payload shape")

    def _dispatch(self, method: str, params: list):
        if method == "engine_exchangeCapabilities":
            return ENGINE_CAPABILITIES
        if method.startswith("engine_newPayload"):
            payload = payload_from_json(params[0], self._payload_cls_for(params[0]))
            return status_to_json(self.engine.notify_new_payload(payload))
        if method.startswith("engine_forkchoiceUpdated"):
            state, attrs = params[0], params[1] if len(params) > 1 else None
            status, payload_id = self.engine.forkchoice_updated(
                undata(state["headBlockHash"]),
                undata(state["finalizedBlockHash"]),
                attributes_from_json(attrs),
            )
            return {
                "payloadStatus": status_to_json(status),
                "payloadId": data(payload_id) if payload_id else None,
            }
        if method.startswith("engine_getPayload"):
            version = int(method[-1])
            payload_id = undata(params[0])
            cls = None
            for c in self._payload_classes:
                names = {n for n, _ in c.FIELDS}
                if version == 3 and "blob_gas_used" in names:
                    cls = c
                    break
                if version == 2 and "withdrawals" in names and "blob_gas_used" not in names:
                    cls = c
                    break
                if version == 1 and "withdrawals" not in names:
                    cls = c
                    break
            if cls is None:
                raise ValueError(f"no payload class for {method}")
            payload = self.engine.get_payload(payload_id, cls)
            obj = payload_to_json(payload)
            if version >= 2:
                return {"executionPayload": obj, "blockValue": qty(0)}
            return obj
        # -- eth1 namespace -------------------------------------------------
        if method == "eth_blockNumber":
            return qty(self.eth1.latest_block_number())
        if method == "eth_getBlockByNumber":
            tag = params[0]
            number = (
                self.eth1.latest_block_number()
                if tag == "latest"
                else unqty(tag)
            )
            blk = self.eth1.get_block(number)
            return {
                "number": qty(blk.number),
                "hash": data(blk.hash),
                "parentHash": data(blk.parent_hash),
                "timestamp": qty(blk.timestamp),
            }
        if method == "eth_getLogs":
            from ..eth1.http_provider import encode_deposit_log

            f = params[0]
            logs = self.eth1.get_deposit_logs(
                unqty(f["fromBlock"]), unqty(f["toBlock"])
            )
            return [
                encode_deposit_log(log, self.deposit_contract_address)
                for log in logs
            ]
        raise ValueError(f"unknown method {method}")
