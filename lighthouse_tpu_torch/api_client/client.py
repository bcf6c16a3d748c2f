"""BeaconNodeHttpClient: stdlib-urllib typed client for the Beacon API."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass

ID_CHUNK = 256  # pubkeys per ``id=`` query: 256 x 99 characters ~ 25 KB


class ApiClientError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


@dataclass
class ProposerDuty:
    pubkey: bytes
    validator_index: int
    slot: int


@dataclass
class AttesterDuty:
    pubkey: bytes
    validator_index: int
    committee_index: int
    committee_length: int
    committees_at_slot: int
    validator_committee_index: int
    slot: int


@dataclass
class GenesisInfo:
    genesis_time: int
    genesis_validators_root: bytes
    genesis_fork_version: bytes


class BeaconNodeHttpClient:
    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing ----------------------------------------------------------

    def _req(self, method: str, path: str, body=None):
        url = self.base + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read().decode()).get("message", "")
            except Exception:
                msg = str(e)
            raise ApiClientError(e.code, msg) from None

    def _get(self, path: str):
        return self._req("GET", path)

    def _post(self, path: str, body):
        return self._req("POST", path, body)

    # -- endpoints ---------------------------------------------------------

    def get_genesis(self) -> GenesisInfo:
        d = self._get("/eth/v1/beacon/genesis")["data"]
        return GenesisInfo(
            genesis_time=int(d["genesis_time"]),
            genesis_validators_root=_unhex(d["genesis_validators_root"]),
            genesis_fork_version=_unhex(d["genesis_fork_version"]),
        )

    def get_fork(self, state_id: str = "head"):
        d = self._get(f"/eth/v1/beacon/states/{state_id}/fork")["data"]
        return {
            "previous_version": _unhex(d["previous_version"]),
            "current_version": _unhex(d["current_version"]),
            "epoch": int(d["epoch"]),
        }

    def get_finality_checkpoints(self, state_id: str = "head"):
        d = self._get(
            f"/eth/v1/beacon/states/{state_id}/finality_checkpoints"
        )["data"]
        return {
            k: {"epoch": int(v["epoch"]), "root": _unhex(v["root"])}
            for k, v in d.items()
        }

    def get_validator_indices(self, pubkeys=None) -> dict[bytes, int]:
        """pubkey -> index. With no ``pubkeys``, the whole registry (one GET
        of every validator); with ``pubkeys``, only those the head state
        holds, asked for through the ``id=`` filter in chunks of
        ``ID_CHUNK`` that keep each request line well under the servers'
        64 KiB limit."""
        if pubkeys is None:
            d = self._get("/eth/v1/beacon/states/head/validators")["data"]
        else:
            keys, d = [_hex(pk) for pk in pubkeys], []
            for i in range(0, len(keys), ID_CHUNK):
                d += self._get("/eth/v1/beacon/states/head/validators?id="
                               + ",".join(keys[i:i + ID_CHUNK]))["data"]
        return {
            _unhex(v["validator"]["pubkey"]): int(v["index"]) for v in d
        }

    def get_syncing(self):
        return self._get("/eth/v1/node/syncing")["data"]

    def get_proposer_duties(self, epoch: int) -> list[ProposerDuty]:
        d = self._get(f"/eth/v1/validator/duties/proposer/{epoch}")["data"]
        return [
            ProposerDuty(
                pubkey=_unhex(x["pubkey"]),
                validator_index=int(x["validator_index"]),
                slot=int(x["slot"]),
            )
            for x in d
        ]

    def get_attester_duties(
        self, epoch: int, indices: list[int]
    ) -> list[AttesterDuty]:
        d = self._post(f"/eth/v1/validator/duties/attester/{epoch}", indices)[
            "data"
        ]
        return [
            AttesterDuty(
                pubkey=_unhex(x["pubkey"]),
                validator_index=int(x["validator_index"]),
                committee_index=int(x["committee_index"]),
                committee_length=int(x["committee_length"]),
                committees_at_slot=int(x["committees_at_slot"]),
                validator_committee_index=int(x["validator_committee_index"]),
                slot=int(x["slot"]),
            )
            for x in d
        ]

    def get_attestation_data(self, slot: int, committee_index: int) -> bytes:
        d = self._get(
            f"/eth/v1/validator/attestation_data?slot={slot}"
            f"&committee_index={committee_index}"
        )["data"]
        return _unhex(d["data"])  # SSZ-encoded AttestationData

    def produce_block(self, slot: int, randao_reveal: bytes) -> tuple[str, bytes]:
        d = self._get(
            f"/eth/v2/validator/blocks/{slot}?randao_reveal={_hex(randao_reveal)}"
        )
        return d["version"], _unhex(d["data"])  # SSZ-encoded BeaconBlock

    def publish_block(self, version: str, signed_block_ssz: bytes) -> None:
        self._post(
            "/eth/v1/beacon/blocks",
            {"version": version, "data": _hex(signed_block_ssz)},
        )

    def publish_attestations(self, atts_ssz: list[bytes]) -> None:
        self._post(
            "/eth/v1/beacon/pool/attestations",
            [{"data": _hex(a)} for a in atts_ssz],
        )

    def get_head_header(self):
        d = self._get("/eth/v1/beacon/headers/head")["data"]
        return {
            "root": _unhex(d["root"]),
            "slot": int(d["header"]["message"]["slot"]),
        }

    def get_validator_liveness(self, epoch: int, indices: list[int]):
        return self._post(f"/eth/v1/validator/liveness/{epoch}", indices)["data"]

    def get_aggregate_attestation(self, data_root: bytes) -> bytes:
        d = self._get(
            "/eth/v1/validator/aggregate_attestation"
            f"?attestation_data_root={_hex(data_root)}"
        )["data"]
        return _unhex(d)

    def publish_aggregate_and_proofs(self, saps_ssz: list[bytes]) -> None:
        self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            [{"data": _hex(s)} for s in saps_ssz],
        )

    def get_sync_duties(self, epoch: int, indices: list[int]):
        return self._post(f"/eth/v1/validator/duties/sync/{epoch}", indices)[
            "data"
        ]

    def publish_sync_messages(self, msgs_ssz: list[bytes]) -> None:
        self._post(
            "/eth/v1/beacon/pool/sync_committees",
            [{"data": _hex(m)} for m in msgs_ssz],
        )

    def get_block_ssz(self, block_id) -> tuple[str, bytes]:
        """Signed block by slot/root/'head' (fork-versioned SSZ)."""
        d = self._get(f"/eth/v2/beacon/blocks/{block_id}")["data"]
        return d["version"], _unhex(d["data"])

    def get_state_ssz(self, state_id: str = "finalized") -> tuple[str, bytes]:
        """Full BeaconState SSZ (the checkpoint-sync fetch; debug API)."""
        d = self._get(f"/eth/v2/debug/beacon/states/{state_id}")["data"]
        return d["version"], _unhex(d["data"])
