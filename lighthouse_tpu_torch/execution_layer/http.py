"""Engine-API over HTTP JSON-RPC with JWT auth.

The port's copy of ``lighthouse_tpu/execution_layer/http.py`` (Lighthouse's
``execution_layer/src/engine_api/http.rs``): a JSON-RPC 2.0 client
speaking ``engine_newPayloadV1..V3``, ``engine_forkchoiceUpdatedV1..V3``,
``engine_getPayloadV1..V3`` and ``engine_exchangeCapabilities`` to a real
(or mock-served) execution client, authenticated per request with a fresh
HS256 JWT (``auth.rs``). ``HttpExecutionEngine`` adapts the wire protocol to
the in-process ``ExecutionEngine`` seam, so the beacon chain is transport-
blind: the same chain code runs against ``MockExecutionLayer`` in-process or
any EL over a socket.

Engine-API JSON conventions: QUANTITY = minimal 0x-hex integers, DATA =
0x-hex byte strings, field names camelCase.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from .auth import JwtKey
from .engine import (
    ExecutionEngine,
    PayloadAttributes,
    PayloadStatus,
    PayloadStatusV1,
)

ENGINE_CAPABILITIES = [
    "engine_newPayloadV1",
    "engine_newPayloadV2",
    "engine_newPayloadV3",
    "engine_forkchoiceUpdatedV1",
    "engine_forkchoiceUpdatedV2",
    "engine_forkchoiceUpdatedV3",
    "engine_getPayloadV1",
    "engine_getPayloadV2",
    "engine_getPayloadV3",
    "engine_exchangeCapabilities",
]


class EngineApiError(Exception):
    """JSON-RPC error from the EL (or transport failure)."""

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


def qty(v: int) -> str:
    """Engine-API QUANTITY: minimal big-endian hex, 0x-prefixed."""
    return hex(int(v))


def data(b: bytes) -> str:
    """Engine-API DATA: 0x-hex bytes."""
    return "0x" + bytes(b).hex()


def unqty(s: str) -> int:
    return int(s, 16)


def undata(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


# -- payload <-> engine-API JSON codecs -------------------------------------

def payload_to_json(payload) -> dict:
    """ExecutionPayload container -> engine-API ExecutionPayloadV1/2/3 JSON."""
    out = {
        "parentHash": data(payload.parent_hash),
        "feeRecipient": data(payload.fee_recipient),
        "stateRoot": data(payload.state_root),
        "receiptsRoot": data(payload.receipts_root),
        "logsBloom": data(payload.logs_bloom),
        "prevRandao": data(payload.prev_randao),
        "blockNumber": qty(payload.block_number),
        "gasLimit": qty(payload.gas_limit),
        "gasUsed": qty(payload.gas_used),
        "timestamp": qty(payload.timestamp),
        "extraData": data(payload.extra_data),
        "baseFeePerGas": qty(payload.base_fee_per_gas),
        "blockHash": data(payload.block_hash),
        "transactions": [data(tx) for tx in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [
            {
                "index": qty(w.index),
                "validatorIndex": qty(w.validator_index),
                "address": data(w.address),
                "amount": qty(w.amount),
            }
            for w in payload.withdrawals
        ]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = qty(payload.blob_gas_used)
        out["excessBlobGas"] = qty(payload.excess_blob_gas)
    return out


def payload_from_json(obj: dict, payload_cls):
    """Engine-API ExecutionPayload JSON -> the fork's container class."""
    kwargs = dict(
        parent_hash=undata(obj["parentHash"]),
        fee_recipient=undata(obj["feeRecipient"]),
        state_root=undata(obj["stateRoot"]),
        receipts_root=undata(obj["receiptsRoot"]),
        logs_bloom=undata(obj["logsBloom"]),
        prev_randao=undata(obj["prevRandao"]),
        block_number=unqty(obj["blockNumber"]),
        gas_limit=unqty(obj["gasLimit"]),
        gas_used=unqty(obj["gasUsed"]),
        timestamp=unqty(obj["timestamp"]),
        extra_data=undata(obj["extraData"]),
        base_fee_per_gas=unqty(obj["baseFeePerGas"]),
        block_hash=undata(obj["blockHash"]),
        transactions=[undata(tx) for tx in obj["transactions"]],
    )
    payload = payload_cls(**kwargs)
    field_names = {n for n, _ in payload_cls.FIELDS}
    if "withdrawals" in obj and "withdrawals" in field_names:
        from ..types.containers import Withdrawal

        payload.withdrawals = [
            Withdrawal(
                index=unqty(w["index"]),
                validator_index=unqty(w["validatorIndex"]),
                address=undata(w["address"]),
                amount=unqty(w["amount"]),
            )
            for w in obj["withdrawals"]
        ]
    if "blobGasUsed" in obj and "blob_gas_used" in field_names:
        payload.blob_gas_used = unqty(obj["blobGasUsed"])
        payload.excess_blob_gas = unqty(obj["excessBlobGas"])
    return payload


def status_from_json(obj: dict) -> PayloadStatusV1:
    return PayloadStatusV1(
        status=PayloadStatus(obj["status"]),
        latest_valid_hash=(
            undata(obj["latestValidHash"])
            if obj.get("latestValidHash")
            else None
        ),
        validation_error=obj.get("validationError"),
    )


def status_to_json(st: PayloadStatusV1) -> dict:
    return {
        "status": st.status.value,
        "latestValidHash": (
            data(st.latest_valid_hash) if st.latest_valid_hash else None
        ),
        "validationError": st.validation_error,
    }


def attributes_to_json(attrs: PayloadAttributes) -> dict:
    out = {
        "timestamp": qty(attrs.timestamp),
        "prevRandao": data(attrs.prev_randao),
        "suggestedFeeRecipient": data(attrs.suggested_fee_recipient),
    }
    if attrs.withdrawals is not None:
        out["withdrawals"] = [
            {
                "index": qty(w.index),
                "validatorIndex": qty(w.validator_index),
                "address": data(w.address),
                "amount": qty(w.amount),
            }
            for w in attrs.withdrawals
        ]
    if attrs.parent_beacon_block_root is not None:
        out["parentBeaconBlockRoot"] = data(attrs.parent_beacon_block_root)
    return out


def attributes_from_json(obj: dict | None) -> PayloadAttributes | None:
    if obj is None:
        return None
    withdrawals = None
    if "withdrawals" in obj:
        from ..types.containers import Withdrawal

        withdrawals = [
            Withdrawal(
                index=unqty(w["index"]),
                validator_index=unqty(w["validatorIndex"]),
                address=undata(w["address"]),
                amount=unqty(w["amount"]),
            )
            for w in obj["withdrawals"]
        ]
    return PayloadAttributes(
        timestamp=unqty(obj["timestamp"]),
        prev_randao=undata(obj["prevRandao"]),
        suggested_fee_recipient=undata(obj["suggestedFeeRecipient"]),
        withdrawals=withdrawals,
    )


# -- the JSON-RPC client -----------------------------------------------------

class JsonRpcClient:
    """Minimal JSON-RPC 2.0 over HTTP with per-request JWT (http.rs)."""

    def __init__(self, url: str, jwt_key: JwtKey | None = None,
                 timeout: float = 8.0):
        self.url = url
        self.jwt_key = jwt_key
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {
                "jsonrpc": "2.0",
                "method": method,
                "params": params,
                "id": self._id,
            }
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self.jwt_key is not None:
            headers["Authorization"] = "Bearer " + self.jwt_key.generate_token()
        req = urllib.request.Request(self.url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                reply = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise EngineApiError(
                f"{method}: HTTP {e.code} {e.reason}", code=e.code
            ) from e
        except (urllib.error.URLError, TimeoutError, json.JSONDecodeError) as e:
            raise EngineApiError(f"{method}: {e}") from e
        if "error" in reply and reply["error"] is not None:
            err = reply["error"]
            raise EngineApiError(
                f"{method}: {err.get('message')}", code=err.get("code")
            )
        return reply.get("result")


class HttpExecutionEngine(ExecutionEngine):
    """The ExecutionEngine seam over engine-API HTTP JSON-RPC.

    Chooses the engine method version from the payload/attributes shape
    (withdrawals -> V2, blob gas -> V3), mirroring http.rs's fork-aware
    dispatch. Capability negotiation happens on first use and is cached.
    """

    def __init__(self, url: str, jwt_key: JwtKey | str | None = None,
                 timeout: float = 8.0):
        if isinstance(jwt_key, str):
            jwt_key = JwtKey.from_file(jwt_key)
        self.rpc = JsonRpcClient(url, jwt_key, timeout=timeout)
        self._capabilities: set[str] | None = None

    # -- capability negotiation (http.rs exchange_capabilities) ------------

    def exchange_capabilities(self) -> set[str]:
        if self._capabilities is None:
            result = self.rpc.call(
                "engine_exchangeCapabilities", [ENGINE_CAPABILITIES]
            )
            self._capabilities = set(result or [])
        return self._capabilities

    def _pick(self, base: str, version: int) -> str:
        """Highest supported method version <= the fork's preferred one."""
        caps = self.exchange_capabilities()
        for v in range(version, 0, -1):
            name = f"{base}V{v}"
            if name in caps:
                return name
        # ELs predating exchangeCapabilities: assume the preferred version
        return f"{base}V{version}"

    @staticmethod
    def _payload_version(payload) -> int:
        if hasattr(payload, "blob_gas_used"):
            return 3
        if hasattr(payload, "withdrawals"):
            return 2
        return 1

    # -- ExecutionEngine seam ----------------------------------------------

    def notify_new_payload(self, payload) -> PayloadStatusV1:
        version = self._payload_version(payload)
        method = self._pick("engine_newPayload", version)
        params = [payload_to_json(payload)]
        if method.endswith("V3"):
            # versioned hashes + parent beacon block root (Deneb): supplied
            # by the caller's DA layer; default to empty/zero here
            params += [[], data(b"\x00" * 32)]
        result = self.rpc.call(method, params)
        return status_from_json(result)

    def forkchoice_updated(
        self,
        head_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: PayloadAttributes | None = None,
    ) -> tuple[PayloadStatusV1, bytes | None]:
        version = 1
        if payload_attributes is not None:
            if payload_attributes.parent_beacon_block_root is not None:
                version = 3  # Cancun: V3 required post-deneb (-38005 on V2)
            elif payload_attributes.withdrawals is not None:
                version = 2
        method = self._pick("engine_forkchoiceUpdated", version)
        state = {
            "headBlockHash": data(head_block_hash),
            "safeBlockHash": data(head_block_hash),
            "finalizedBlockHash": data(finalized_block_hash),
        }
        attrs = (
            attributes_to_json(payload_attributes)
            if payload_attributes is not None
            else None
        )
        result = self.rpc.call(method, [state, attrs])
        status = status_from_json(result["payloadStatus"])
        payload_id = (
            undata(result["payloadId"]) if result.get("payloadId") else None
        )
        return status, payload_id

    def get_payload(self, payload_id: bytes, payload_cls):
        version = 1
        names = {n for n, _ in payload_cls.FIELDS}
        if "blob_gas_used" in names:
            version = 3
        elif "withdrawals" in names:
            version = 2
        method = self._pick("engine_getPayload", version)
        result = self.rpc.call(method, [data(payload_id)])
        obj = result["executionPayload"] if version >= 2 else result
        return payload_from_json(obj, payload_cls)
