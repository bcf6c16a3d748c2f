"""Doppelganger protection: refuse to sign until the network shows no other
instance of our keys is live. The port's copy of
``lighthouse_tpu/validator_client/doppelganger.py``.

Lighthouse's ``validator_client/doppelganger_service`` (1,471 LoC):
newly-started validators are held back from signing while the service watches
``/eth/v1/validator/liveness/{epoch}`` for their indices over the previous
epoch(s). Any observed liveness for a held-back key is treated as a duplicate
instance: the key stays disabled and the operator is alerted. After
``detection_epochs`` clean epochs the key is released for signing.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.logging import get_logger

log = get_logger("doppelganger")

DEFAULT_DETECTION_EPOCHS = 2  # current remainder + 1 full epoch (ref default)


@dataclass
class _WatchState:
    start_epoch: int
    next_epoch: int  # next epoch whose liveness has NOT been examined yet
    epochs_checked: int = 0
    doppelganger_detected: bool = False


class DoppelgangerService:
    def __init__(self, store, client, detection_epochs: int = DEFAULT_DETECTION_EPOCHS):
        self.store = store
        self.client = client  # BeaconNodeHttpClient | BeaconNodeFallback
        self.detection_epochs = detection_epochs
        self._watch: dict[bytes, _WatchState] = {}

    # -- lifecycle ---------------------------------------------------------

    def register_all(self, current_epoch: int) -> int:
        """Hold back every enabled key and start watching (VC startup)."""
        n = 0
        for pk in list(self.store.validators):
            self._watch[pk] = _WatchState(
                start_epoch=current_epoch, next_epoch=current_epoch
            )
            self.store.doppelganger_suspect.add(pk)
            n += 1
        if n:
            log.info(
                "Doppelganger detection started",
                validators=n, epochs=self.detection_epochs,
            )
        return n

    def detected(self) -> list[bytes]:
        return [
            pk for pk, w in self._watch.items() if w.doppelganger_detected
        ]

    # -- per-epoch check ---------------------------------------------------

    def check(self, current_epoch: int, indices_by_pubkey: dict[bytes, int]) -> None:
        """Examine liveness for EVERY not-yet-checked completed epoch (so a
        process suspended across epochs never skips one) and release/flag keys.

        Mirrors the reference's decision table: liveness seen while held back
        => permanent disable + alert; ``detection_epochs`` clean epoch checks
        => release for signing.
        """
        if current_epoch < 1:
            return
        watched = [
            (pk, w) for pk, w in self._watch.items()
            if not w.doppelganger_detected and pk in self.store.doppelganger_suspect
        ]
        if not watched:
            return
        indices = [
            indices_by_pubkey[pk] for pk, _ in watched if pk in indices_by_pubkey
        ]
        # every completed epoch any watched key hasn't examined yet
        lo = min(w.next_epoch for _, w in watched)
        live: dict[int, dict[int, bool]] = {}  # epoch -> index -> live
        for epoch in range(lo, current_epoch):
            if indices:
                live[epoch] = {
                    int(r["index"]): bool(r["is_live"])
                    for r in self.client.get_validator_liveness(epoch, indices)
                }
            else:
                live[epoch] = {}
        for pk, w in watched:
            idx = indices_by_pubkey.get(pk)
            for epoch in range(w.next_epoch, current_epoch):
                if idx is not None and live[epoch].get(idx, False):
                    w.doppelganger_detected = True
                    log.error(
                        "DOPPELGANGER DETECTED — validator stays disabled",
                        pubkey=pk.hex()[:16], index=idx, epoch=epoch,
                    )
                    break
                w.next_epoch = epoch + 1
                w.epochs_checked += 1
            if (
                not w.doppelganger_detected
                and w.epochs_checked >= self.detection_epochs
            ):
                self.store.doppelganger_suspect.discard(pk)
                log.info(
                    "Doppelganger check clean — validator enabled",
                    pubkey=pk.hex()[:16],
                )
