"""HTTP JSON-RPC eth1 provider + DepositEvent ABI codec.

The port's copy of ``lighthouse_tpu/eth1/http_provider.py`` (Lighthouse's eth1
HTTP client, ``beacon_node/eth1/src/service.rs``
JSON-RPC calls + ``deposit_log`` ABI decoding): ``HttpEth1Provider`` speaks
``eth_blockNumber`` / ``eth_getBlockByNumber`` / ``eth_getLogs`` to any
execution client and decodes the deposit contract's ``DepositEvent`` logs —
five dynamic ``bytes`` fields ABI-encoded as head offsets + padded tails,
with amount and index as 8-byte little-endian gwei/counter values.
"""

from __future__ import annotations

from ..execution_layer.http import JsonRpcClient, data, qty, undata, unqty
from ..types.containers import DepositData
from .deposit_cache import DepositLog
from .provider import Eth1Block, Eth1Provider

# keccak-free stand-in topic: Lighthouse matches on the DepositEvent
# topic hash; we use a fixed 32-byte tag (no keccak in the stdlib)
DEPOSIT_EVENT_TOPIC = b"\xde\xb0\x51\x7e" + b"\x00" * 28


def _abi_tail(b: bytes) -> bytes:
    """ABI dynamic-bytes tail: u256 length + right-padded data."""
    pad = (-len(b)) % 32
    return len(b).to_bytes(32, "big") + b + b"\x00" * pad


def encode_deposit_event_data(log: DepositLog) -> bytes:
    """ABI-encode DepositEvent(bytes,bytes,bytes,bytes,bytes) data."""
    fields = [
        bytes(log.data.pubkey),
        bytes(log.data.withdrawal_credentials),
        int(log.data.amount).to_bytes(8, "little"),
        bytes(log.data.signature),
        int(log.index).to_bytes(8, "little"),
    ]
    tails = [_abi_tail(f) for f in fields]
    head_len = 32 * len(fields)
    offsets, off = [], head_len
    for t in tails:
        offsets.append(off.to_bytes(32, "big"))
        off += len(t)
    return b"".join(offsets) + b"".join(tails)


def decode_deposit_event_data(blob: bytes) -> tuple[list[bytes], int]:
    """Inverse of ``encode_deposit_event_data``: the five byte fields."""
    fields = []
    for i in range(5):
        off = int.from_bytes(blob[32 * i : 32 * (i + 1)], "big")
        n = int.from_bytes(blob[off : off + 32], "big")
        fields.append(blob[off + 32 : off + 32 + n])
    return fields


def encode_deposit_log(log: DepositLog, contract_address: bytes) -> dict:
    """DepositLog -> eth_getLogs JSON entry."""
    return {
        "address": data(contract_address),
        "topics": [data(DEPOSIT_EVENT_TOPIC)],
        "data": data(encode_deposit_event_data(log)),
        "blockNumber": qty(log.block_number),
    }


def decode_deposit_log(obj: dict) -> DepositLog:
    pubkey, creds, amount, sig, index = decode_deposit_event_data(
        undata(obj["data"])
    )
    return DepositLog(
        data=DepositData(
            pubkey=pubkey,
            withdrawal_credentials=creds,
            amount=int.from_bytes(amount, "little"),
            signature=sig,
        ),
        block_number=unqty(obj["blockNumber"]),
        index=int.from_bytes(index, "little"),
    )


class HttpEth1Provider(Eth1Provider):
    """Eth1Provider over JSON-RPC HTTP (no auth: public eth namespace)."""

    def __init__(self, url: str, deposit_contract_address: bytes = b"\x11" * 20,
                 timeout: float = 8.0):
        self.rpc = JsonRpcClient(url, jwt_key=None, timeout=timeout)
        self.deposit_contract_address = deposit_contract_address

    def latest_block_number(self) -> int:
        return unqty(self.rpc.call("eth_blockNumber", []))

    def get_block(self, number: int) -> Eth1Block:
        obj = self.rpc.call("eth_getBlockByNumber", [qty(number), False])
        return Eth1Block(
            number=unqty(obj["number"]),
            hash=undata(obj["hash"]),
            parent_hash=undata(obj["parentHash"]),
            timestamp=unqty(obj["timestamp"]),
        )

    def get_deposit_logs(self, from_block: int, to_block: int) -> list[DepositLog]:
        logs = self.rpc.call(
            "eth_getLogs",
            [
                {
                    "fromBlock": qty(from_block),
                    "toBlock": qty(to_block),
                    "address": data(self.deposit_contract_address),
                }
            ],
        )
        return [decode_deposit_log(o) for o in logs]
