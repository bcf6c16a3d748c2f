"""Production validator client runner (Lighthouse's validator_client/src/lib.rs:77-107
ProductionValidatorClient): the port's copy of
``lighthouse_tpu/validator_client/runner.py``.

Loads keys (interop range or EIP-2335 keystore directory), connects to a
beacon node over HTTP only, and drives the duties/attestation/block services
slot by slot.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .. import bls
from ..state_transition.genesis import interop_secret_keys
from ..utils.logging import get_logger
from .services import (
    AggregationService,
    AttestationService,
    BlockService,
    DutiesService,
    SyncCommitteeService,
    ValidatorClientContext,
)
from .validator_store import ValidatorStore

log = get_logger("validator_client")


class ProductionValidatorClient:
    def __init__(self, spec, beacon_url, enable_doppelganger: bool = False,
                 keymanager_port: int | None = None):
        from .beacon_node_fallback import BeaconNodeFallback

        self.spec = spec
        urls = (
            [u.strip() for u in beacon_url.split(",") if u.strip()]
            if isinstance(beacon_url, str)
            else list(beacon_url)
        )
        # single node still goes through the fallback shell so health scoring
        # and retry semantics are uniform (beacon_node_fallback.rs)
        self.client = BeaconNodeFallback(urls)
        self.store = ValidatorStore(spec)
        self.doppelganger = None
        if enable_doppelganger:
            from .doppelganger import DoppelgangerService

            self.doppelganger = DoppelgangerService(self.store, self.client)
        self.keymanager = None
        if keymanager_port is not None:
            from .keymanager import KeymanagerServer

            self.keymanager = KeymanagerServer(self.store, port=keymanager_port)
        self._stop = threading.Event()
        self._last_slot = -1
        self._last_duties_epoch = -1

    # -- key loading --------------------------------------------------------

    def load_interop_keys(self, count: int) -> int:
        for sk in interop_secret_keys(count):
            self.store.add_validator_sk(
                bls.SecretKey.from_bytes(sk.to_bytes(32, "big"))
            )
        return count

    def load_web3signer(self, signer_url: str) -> int:
        """Register every key the remote signer serves
        (/api/v1/eth2/publicKeys — Web3Signer's key-listing endpoint).
        An unreachable signer is a startup error, not a silent zero-key run;
        individual keys can also be registered later via the keymanager
        remotekeys API."""
        import json
        import urllib.request

        try:
            with urllib.request.urlopen(
                signer_url.rstrip("/") + "/api/v1/eth2/publicKeys", timeout=10
            ) as resp:
                pubkeys = json.loads(resp.read().decode())
        except Exception as e:
            log.error("Web3Signer unreachable", signer=signer_url, error=str(e))
            raise RuntimeError(
                f"web3signer key listing failed at {signer_url}: {e}"
            ) from None
        for p in pubkeys:
            self.store.add_validator_remote(bytes.fromhex(p[2:]), signer_url)
        log.info("Registered remote keys", count=len(pubkeys), signer=signer_url)
        return len(pubkeys)

    def load_keystore_dir(self, directory: str, password: str) -> int:
        """EIP-2335 keystores named ``keystore-*.json`` (account_manager's
        validator directory layout)."""
        from ..keys.keystore import Keystore

        n = 0
        for name in sorted(os.listdir(directory)):
            if not name.startswith("keystore") or not name.endswith(".json"):
                continue
            with open(os.path.join(directory, name)) as fh:
                ks = Keystore.from_json(fh.read())
            self.store.add_validator_keystore(ks, password)
            n += 1
        log.info("Loaded keystores", count=n, directory=directory)
        return n

    # -- duty loop ----------------------------------------------------------

    def connect(self) -> "ProductionValidatorClient":
        self.ctx = ValidatorClientContext(self.client, self.store)
        self.duties = DutiesService(self.client, self.store)
        self.attestations = AttestationService(self.ctx, self.duties)
        self.blocks = BlockService(self.ctx, self.duties)
        self.sync_committee = SyncCommitteeService(self.ctx, self.duties)
        self.aggregation = AggregationService(
            self.ctx, self.duties, self.attestations
        )
        g = self.ctx.genesis
        self.client.pin_genesis(g.genesis_validators_root)
        self.client.update_all_candidates()
        if self.keymanager is not None:
            self.keymanager.start()
        return self

    def run_slot(self, slot: int) -> dict:
        """One slot's duties: poll (per epoch), doppelganger gate, propose,
        attest."""
        spe = self.spec.preset.SLOTS_PER_EPOCH
        epoch = slot // spe
        if epoch != self._last_duties_epoch:
            # re-score the fallback candidates once per epoch (the
            # reference's periodic health poll)
            self.client.update_all_candidates()
            self.duties.poll(epoch)
            # poll one epoch ahead like the reference's lookahead
            self.duties.poll(epoch + 1)
            if self.doppelganger is not None:
                if self._last_duties_epoch < 0:
                    self.doppelganger.register_all(epoch)
                else:
                    self.doppelganger.check(
                        epoch, self.duties.validator_indices()
                    )
            # prune slashing-protection history below finality once per
            # epoch (slashing_database.rs prune; the max entry per
            # validator always survives as the signing lower bound)
            try:
                fin = self.client.get_finality_checkpoints()
                fin_epoch = int(fin["finalized"]["epoch"])
                if fin_epoch > 0:
                    self.store.slashing_db.prune(fin_epoch, spe)
            except Exception:  # noqa: BLE001 — pruning is best-effort
                pass
            self._last_duties_epoch = epoch
        proposed = self.blocks.propose(slot)
        attested = self.attestations.attest(slot)
        aggregated = self.aggregation.aggregate(slot)
        synced = self.sync_committee.sign_and_publish(slot)
        return {
            "slot": slot, "proposed": proposed, "attested": attested,
            "aggregated": aggregated, "sync_signed": synced,
        }

    def run(self, genesis_time: int | None = None) -> None:
        """Wall-clock duty loop until stop() (the tokio interval loop)."""
        g = self.ctx.genesis
        if genesis_time is None:
            genesis_time = int(g.genesis_time)
        sps = self.spec.preset.SECONDS_PER_SLOT
        while not self._stop.is_set():
            now = time.time()
            slot = max(0, int(now - genesis_time) // sps)
            if slot > self._last_slot:
                self._last_slot = slot
                try:
                    stats = self.run_slot(slot)
                    log.info("Slot duties", **stats)
                except Exception as e:  # noqa: BLE001 — keep the loop alive
                    log.error("Duty failure", slot=slot, error=str(e))
            self._stop.wait(0.25)

    def stop(self) -> None:
        self._stop.set()
