"""Wire codec: typed SSZ message encoding for the socket transport.

Twin of the reference's SSZ+snappy Req/Resp codec and gossip encoding
(``lighthouse_network/src/rpc/codec.rs``, ``types/pubsub.rs``): every gossip
topic and RPC method has a typed SSZ payload, compressed on the wire. The
stdlib provides zlib, not snappy — framing and semantics are the same, the
compressor differs (noted deviation).

Gossip payloads are fork-tagged with a leading fork byte so block containers
decode under the right fork variant without needing the slot first.

The port's copy of ``lighthouse_tpu/network/codec.py``: the same bytes for
every topic and method, so state crosses between the two packages on the
wire. The four light-client methods raise ``WireError`` until the port has
the light-client server (ROADMAP Queue 1 item 2.4).
"""

from __future__ import annotations

import struct
import zlib

from ..types.containers import ProposerSlashing, SignedVoluntaryExit, for_preset
from .transport import Status, Topic

_FORK_ORDER = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]


class WireError(Exception):
    pass


LIGHT_CLIENT_METHODS = (
    "light_client_bootstrap",
    "light_client_updates_by_range",
    "light_client_optimistic_update",
    "light_client_finality_update",
)


def light_client_unported(method: str) -> WireError:
    return WireError(
        f"{method}: the light-client server is not ported yet "
        "(ROADMAP Queue 1 item 2.4)"
    )


class MessageCodec:
    """Encodes/decodes gossip + RPC payloads for one node's preset."""

    def __init__(self, spec):
        self.spec = spec
        self.ns = for_preset(spec.preset.name)

    # -- fork-tagged signed blocks ----------------------------------------

    def _enc_block(self, signed_block) -> bytes:
        for name in reversed(_FORK_ORDER):
            cls = self.ns.block_types.get(name)
            if cls is not None and isinstance(signed_block, cls):
                return bytes([_FORK_ORDER.index(name)]) + cls.encode(
                    signed_block
                )
        raise WireError(f"unknown block container {type(signed_block)}")

    def _dec_block(self, data: bytes):
        fork = _FORK_ORDER[data[0]]
        cls = self.ns.block_types.get(fork)
        if cls is None:
            raise WireError(f"fork {fork} not in preset")
        return cls.decode(data[1:])

    # -- gossip ------------------------------------------------------------

    def encode_gossip(self, topic: str, message) -> bytes:
        ns = self.ns
        if topic == Topic.BEACON_BLOCK:
            raw = self._enc_block(message)
        elif topic == Topic.BEACON_ATTESTATION:
            raw = ns.Attestation.encode(message)
        elif topic == Topic.AGGREGATE_AND_PROOF:
            raw = ns.SignedAggregateAndProof.encode(message)
        elif topic == Topic.VOLUNTARY_EXIT:
            raw = SignedVoluntaryExit.encode(message)
        elif topic == Topic.PROPOSER_SLASHING:
            raw = ProposerSlashing.encode(message)
        elif topic == Topic.ATTESTER_SLASHING:
            raw = ns.AttesterSlashing.encode(message)
        elif topic == Topic.SYNC_COMMITTEE_MESSAGE:
            raw = ns.SyncCommitteeMessage.encode(message)
        elif topic == Topic.SYNC_CONTRIBUTION:
            raw = ns.SignedContributionAndProof.encode(message)
        elif topic == Topic.DATA_COLUMN_SIDECAR:
            raw = ns.DataColumnSidecar.encode(message)
        else:
            raise WireError(f"no codec for topic {topic}")
        return zlib.compress(raw)

    def decode_gossip(self, topic: str, data: bytes):
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise WireError(f"bad compression: {e}") from None
        ns = self.ns
        if topic == Topic.BEACON_BLOCK:
            return self._dec_block(raw)
        if topic == Topic.BEACON_ATTESTATION:
            return ns.Attestation.decode(raw)
        if topic == Topic.AGGREGATE_AND_PROOF:
            return ns.SignedAggregateAndProof.decode(raw)
        if topic == Topic.VOLUNTARY_EXIT:
            return SignedVoluntaryExit.decode(raw)
        if topic == Topic.PROPOSER_SLASHING:
            return ProposerSlashing.decode(raw)
        if topic == Topic.ATTESTER_SLASHING:
            return ns.AttesterSlashing.decode(raw)
        if topic == Topic.SYNC_COMMITTEE_MESSAGE:
            return ns.SyncCommitteeMessage.decode(raw)
        if topic == Topic.SYNC_CONTRIBUTION:
            return ns.SignedContributionAndProof.decode(raw)
        if topic == Topic.DATA_COLUMN_SIDECAR:
            return ns.DataColumnSidecar.decode(raw)
        raise WireError(f"no codec for topic {topic}")

    # -- rpc ---------------------------------------------------------------

    def encode_request(self, method: str, payload) -> bytes:
        if method == "status":
            s: Status = payload
            raw = (
                bytes(s.fork_digest)
                + bytes(s.finalized_root)
                + struct.pack(">Q", s.finalized_epoch)
                + bytes(s.head_root)
                + struct.pack(">Q", s.head_slot)
            )
        elif method == "blocks_by_range":
            start, count = payload
            raw = struct.pack(">QQ", start, count)
        elif method == "blocks_by_root":
            raw = b"".join(bytes(r) for r in payload)
        elif method == "data_column_sidecars_by_root":
            # DataColumnIdentifier stream: 32-byte root + u64 column index
            raw = b"".join(
                bytes(root) + struct.pack(">Q", int(idx))
                for root, idx in payload
            )
        elif method == "data_column_sidecars_by_range":
            start, count, columns = payload
            cols = list(columns) if columns is not None else []
            # column-count 0xFFFF is the "no filter" sentinel (None)
            n = 0xFFFF if columns is None else len(cols)
            raw = struct.pack(">QQH", start, count, n) + b"".join(
                struct.pack(">H", int(c)) for c in cols
            )
        elif method in LIGHT_CLIENT_METHODS:
            raise light_client_unported(method)
        else:
            raise WireError(f"no codec for rpc {method}")
        return zlib.compress(raw)

    def decode_request(self, method: str, data: bytes):
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise WireError(f"bad compression: {e}") from None
        if method == "status":
            return Status(
                fork_digest=raw[0:4],
                finalized_root=raw[4:36],
                finalized_epoch=struct.unpack(">Q", raw[36:44])[0],
                head_root=raw[44:76],
                head_slot=struct.unpack(">Q", raw[76:84])[0],
            )
        if method == "blocks_by_range":
            return struct.unpack(">QQ", raw)
        if method == "blocks_by_root":
            return [raw[i : i + 32] for i in range(0, len(raw), 32)]
        if method == "data_column_sidecars_by_root":
            return [
                (raw[i : i + 32], struct.unpack(">Q", raw[i + 32 : i + 40])[0])
                for i in range(0, len(raw), 40)
            ]
        if method == "data_column_sidecars_by_range":
            start, count, n = struct.unpack(">QQH", raw[:18])
            if n == 0xFFFF:
                return start, count, None
            cols = [
                struct.unpack(">H", raw[18 + 2 * i : 20 + 2 * i])[0]
                for i in range(n)
            ]
            return start, count, cols
        if method in LIGHT_CLIENT_METHODS:
            raise light_client_unported(method)
        raise WireError(f"no codec for rpc {method}")

    def encode_response(self, method: str, payload) -> bytes:
        if method == "status":
            return self.encode_request("status", payload)
        if method in ("blocks_by_range", "blocks_by_root"):
            parts = [self._enc_block(b) for b in payload]
            raw = b"".join(struct.pack(">I", len(p)) + p for p in parts)
            return zlib.compress(raw)
        if method in (
            "data_column_sidecars_by_root", "data_column_sidecars_by_range"
        ):
            parts = [self.ns.DataColumnSidecar.encode(sc) for sc in payload]
            raw = b"".join(struct.pack(">I", len(p)) + p for p in parts)
            return zlib.compress(raw)
        if method in LIGHT_CLIENT_METHODS:
            raise light_client_unported(method)
        raise WireError(f"no codec for rpc response {method}")

    def decode_response(self, method: str, data: bytes):
        if method == "status":
            return self.decode_request("status", data)
        if method in ("blocks_by_range", "blocks_by_root"):
            raw = zlib.decompress(data)
            out, off = [], 0
            while off < len(raw):
                (n,) = struct.unpack(">I", raw[off : off + 4])
                out.append(self._dec_block(raw[off + 4 : off + 4 + n]))
                off += 4 + n
            return out
        if method in (
            "data_column_sidecars_by_root", "data_column_sidecars_by_range"
        ):
            raw = zlib.decompress(data)
            out, off = [], 0
            while off < len(raw):
                (n,) = struct.unpack(">I", raw[off : off + 4])
                out.append(
                    self.ns.DataColumnSidecar.decode(raw[off + 4 : off + 4 + n])
                )
                off += 4 + n
            return out
        if method in LIGHT_CLIENT_METHODS:
            raise light_client_unported(method)
        raise WireError(f"no codec for rpc response {method}")
