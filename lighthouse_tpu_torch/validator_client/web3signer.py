"""Web3Signer remote signing: the HTTP SigningMethod — the port's copy of
``lighthouse_tpu/validator_client/web3signer.py``.

Lighthouse's ``validator_client/signing_method/src/web3signer.rs``:
the validator store signs via POST
``{base}/api/v1/eth2/sign/{0xpubkey}`` with the 32-byte signing root; the
secret key lives in the remote signer. Slashing protection stays local — the
store gates every remote signature exactly like a local one.

``MockWeb3Signer`` is the in-process test double (the reference tests against
a real Web3Signer jar, ``testing/web3signer_tests``).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import bls


class Web3SignerError(Exception):
    pass


class Web3SignerMethod:
    """SigningMethod implemented by a remote HTTP signer."""

    def __init__(self, pubkey: bytes, base_url: str, timeout: float = 10.0):
        self.pubkey = bytes(pubkey)
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def sign(self, signing_root: bytes) -> bls.Signature:
        url = f"{self.base}/api/v1/eth2/sign/0x{self.pubkey.hex()}"
        body = json.dumps({"signing_root": "0x" + bytes(signing_root).hex()})
        req = urllib.request.Request(
            url, data=body.encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                sig_hex = json.loads(resp.read().decode())["signature"]
        except Exception as e:  # noqa: BLE001 — surface as signer failure
            raise Web3SignerError(f"remote sign failed: {e}") from None
        return bls.Signature.from_bytes(bytes.fromhex(sig_hex[2:]))


class MockWeb3Signer:
    """Minimal Web3Signer-compatible HTTP server holding secret keys."""

    def __init__(self, secret_keys: list[bls.SecretKey], port: int = 0):
        self.keys = {
            sk.public_key().serialize(): sk for sk in secret_keys
        }
        signer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path != "/api/v1/eth2/publicKeys":
                    self.send_error(404)
                    return
                out = json.dumps(
                    ["0x" + pk.hex() for pk in signer.keys]
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_POST(self):
                prefix = "/api/v1/eth2/sign/"
                if not self.path.startswith(prefix):
                    self.send_error(404)
                    return
                pk = bytes.fromhex(self.path[len(prefix):].removeprefix("0x"))
                sk = signer.keys.get(pk)
                if sk is None:
                    self.send_error(404, "unknown key")
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n).decode())
                root = bytes.fromhex(body["signing_root"][2:])
                sig = sk.sign(root).serialize()
                out = json.dumps({"signature": "0x" + sig.hex()}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "MockWeb3Signer":
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
