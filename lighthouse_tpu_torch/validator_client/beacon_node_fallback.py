"""Multi-beacon-node failover with health scoring — the port's copy of
``lighthouse_tpu/validator_client/beacon_node_fallback.py``.

Lighthouse's ``validator_client/beacon_node_fallback`` (1,317 LoC):
the VC holds N candidate beacon nodes, health-checks them (syncing status +
genesis agreement), orders candidates Synced > Syncing > Offline, and routes
every API call to the first candidate that succeeds — demoting a candidate on
error and retrying the next (``first_success`` semantics,
``beacon_node_fallback/src/lib.rs``).
"""

from __future__ import annotations

import enum
import threading

from ..api_client import BeaconNodeHttpClient
from ..utils.logging import get_logger

log = get_logger("beacon_node_fallback")


class Health(enum.IntEnum):
    # ordering = routing preference (lower value tried first)
    Synced = 0
    Syncing = 1
    Offline = 2


class CandidateBeaconNode:
    def __init__(self, client: BeaconNodeHttpClient):
        self.client = client
        self.health = Health.Offline
        self.last_error: str | None = None

    def refresh_health(self, expected_genesis_root: bytes | None) -> Health:
        try:
            if expected_genesis_root is not None:
                g = self.client.get_genesis()
                if g.genesis_validators_root != expected_genesis_root:
                    raise RuntimeError("genesis mismatch (wrong network)")
            sync = self.client.get_syncing()
            self.health = (
                Health.Syncing if sync.get("is_syncing") else Health.Synced
            )
            self.last_error = None
        except Exception as e:  # noqa: BLE001 — any failure = offline
            self.health = Health.Offline
            self.last_error = str(e)
        return self.health


class AllErrored(Exception):
    def __init__(self, errors: list[tuple[str, str]]):
        super().__init__(
            "all beacon nodes errored: "
            + "; ".join(f"{u}: {e}" for u, e in errors)
        )
        self.errors = errors


class BeaconNodeFallback:
    """Drop-in for ``BeaconNodeHttpClient``: exposes the same method surface,
    dispatching each call through ``first_success``."""

    def __init__(self, clients_or_urls):
        self.candidates = [
            CandidateBeaconNode(
                c if isinstance(c, BeaconNodeHttpClient)
                else BeaconNodeHttpClient(c)
            )
            for c in clients_or_urls
        ]
        if not self.candidates:
            raise ValueError("at least one beacon node required")
        self._lock = threading.Lock()
        self._genesis_root: bytes | None = None

    # -- health ------------------------------------------------------------

    def update_all_candidates(self) -> None:
        """Re-score every candidate (the reference's periodic poll)."""
        for c in self.candidates:
            c.refresh_health(self._genesis_root)

    def pin_genesis(self, genesis_validators_root: bytes) -> None:
        """Candidates on a different network are scored Offline."""
        self._genesis_root = bytes(genesis_validators_root)

    def num_available(self) -> int:
        return sum(1 for c in self.candidates if c.health != Health.Offline)

    # -- dispatch ----------------------------------------------------------

    def first_success(self, method: str, *args, **kwargs):
        with self._lock:
            ordered = sorted(self.candidates, key=lambda c: c.health)
        errors = []
        for cand in ordered:
            try:
                out = getattr(cand.client, method)(*args, **kwargs)
                if cand.health is Health.Offline:
                    cand.health = Health.Syncing  # give it a chance to rescore
                return out
            except Exception as e:  # noqa: BLE001 — try the next node
                cand.health = Health.Offline
                cand.last_error = str(e)
                errors.append((cand.client.base, str(e)))
                log.warn(
                    "Beacon node failed, trying fallback",
                    node=cand.client.base, method=method, error=str(e),
                )
        raise AllErrored(errors)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        # every public client method becomes a fallback dispatch
        if not hasattr(BeaconNodeHttpClient, name):
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self.first_success(name, *args, **kwargs)

        return call
