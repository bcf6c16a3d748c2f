"""UDP boot node: the discovery rendezvous (ref ``boot_node/``, discv5 seam).

One datagram protocol, two messages:

    client -> boot : b"ANNOUNCE " + "host:port"   (the client's TCP listener)
    boot -> client : b"PEERS "    + comma-joined known addresses

The boot node remembers every announcer (bounded, LRU) and answers with the
rest — enough for nodes to find each other and dial TCP, the role discv5's
FINDNODE/NODES random-walk plays for the reference.
"""

from __future__ import annotations

import socket
import threading
from collections import OrderedDict

from ..utils.logging import get_logger

log = get_logger("boot_node")

_MAX_PEERS = 1024


class BootNode:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.local_addr = f"{host}:{self._sock.getsockname()[1]}"
        self._known: OrderedDict[str, None] = OrderedDict()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "BootNode":
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name="boot-node"
        )
        self._thread.start()
        log.info("Boot node listening", addr=self.local_addr)
        return self

    def stop(self) -> None:
        self._stop.set()
        # an empty datagram wakes the serve loop's recvfrom (closing the
        # socket from this thread does not), which then sees the stop flag
        host, port = self.local_addr.rsplit(":", 1)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                s.sendto(b"", (host, int(port)))
            except OSError:
                pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        try:
            self._sock.close()
        except OSError:
            pass

    def known_peers(self) -> list[str]:
        with self._lock:
            return list(self._known)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(4096)
            except OSError:
                return
            if not data.startswith(b"ANNOUNCE "):
                continue
            addr = data[len(b"ANNOUNCE "):].decode(errors="replace").strip()
            with self._lock:
                others = [a for a in self._known if a != addr]
                self._known[addr] = None
                self._known.move_to_end(addr)
                while len(self._known) > _MAX_PEERS:
                    self._known.popitem(last=False)
            reply = b"PEERS " + ",".join(others).encode()
            try:
                self._sock.sendto(reply, src)
            except OSError:
                pass


def client_announce(boot_addr: str, my_addr: str, timeout: float = 5.0) -> list[str]:
    """Announce ``my_addr`` to the boot node; returns the peer list."""
    host, port = boot_addr.rsplit(":", 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(b"ANNOUNCE " + my_addr.encode(), (host, int(port)))
        data, _ = s.recvfrom(65536)
    finally:
        s.close()
    if not data.startswith(b"PEERS "):
        return []
    rest = data[len(b"PEERS "):].decode(errors="replace")
    return [a for a in rest.split(",") if a]
