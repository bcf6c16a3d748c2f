"""Light-client update verification (spec process_light_client_update core).

The port's copy of ``lighthouse_tpu/light_client/verify.py``, over the port's
``bls`` seam and ``state_transition.per_block.is_valid_merkle_branch``.

A light client holding a trusted sync committee checks an update by (1)
verifying the merkle branches against the attested header's state root and
(2) verifying the sync aggregate over the attested header root with the
committee's pubkeys — the backend-blind ``bls`` seam does the pairing.
"""

from __future__ import annotations

import numpy as np

from .. import bls
from ..state_transition.per_block import is_valid_merkle_branch
from ..types.containers import SigningData, for_preset
from ..types.helpers import compute_domain

# altair..deneb 32-field state tree; electra+ recomputed per fork below
FINALIZED_ROOT_GINDEX = 105
CURRENT_SYNC_COMMITTEE_GINDEX = 54
NEXT_SYNC_COMMITTEE_GINDEX = 55


def _gindex_depth_index(gindex: int) -> tuple[int, int]:
    depth = gindex.bit_length() - 1
    return depth, gindex - (1 << depth)


def _state_gindex(spec, slot: int, path: list[str]) -> int:
    from .proofs import leaf_gindex

    fork = spec.fork_name_at_slot(int(slot))
    state_cls = for_preset(spec.preset.name).state_types[fork]
    return leaf_gindex(state_cls, path)


def verify_bootstrap(spec, bootstrap, trusted_block_root: bytes) -> bool:
    """header matches the trusted root and the committee branch proves
    membership in the header's state."""
    header_root = type(bootstrap.header.beacon).hash_tree_root(
        bootstrap.header.beacon
    )
    if header_root != bytes(trusted_block_root):
        return False
    depth, index = _gindex_depth_index(
        _state_gindex(
            spec, int(bootstrap.header.beacon.slot), ["current_sync_committee"]
        )
    )
    cls = type(bootstrap.current_sync_committee)
    return is_valid_merkle_branch(
        cls.hash_tree_root(bootstrap.current_sync_committee),
        list(bootstrap.current_sync_committee_branch),
        depth,
        index,
        bytes(bootstrap.header.beacon.state_root),
    )


def sync_signing_root(spec, update, genesis_validators_root: bytes) -> bytes:
    """The root the sync committee signs: the attested header root under
    the sync domain of the epoch before ``signature_slot``. Shared by the
    host oracle below and the device engine's marshalling."""
    prev_slot = max(int(update.signature_slot), 1) - 1
    fork_version = spec.fork_version(spec.fork_name_at_slot(prev_slot))
    domain = compute_domain(
        spec.DOMAIN_SYNC_COMMITTEE, fork_version, bytes(genesis_validators_root)
    )
    attested_root = type(update.attested_header.beacon).hash_tree_root(
        update.attested_header.beacon
    )
    return SigningData(object_root=attested_root, domain=domain).tree_root()


def precheck_update(spec, update, finality_required: bool = False) -> bool:
    """Everything BUT the signature: participation floor + the merkle
    branches present on the update (finality and, for full
    ``LightClientUpdate`` objects, the next-sync-committee branch). The
    device engine applies the same prechecks on the host before batching
    signatures, so host/device verdicts agree session-for-session."""
    agg = update.sync_aggregate
    bits = np.asarray(agg.sync_committee_bits, dtype=bool)
    if bits.sum() < spec.preset.MIN_SYNC_COMMITTEE_PARTICIPANTS:
        return False
    attested_slot = int(update.attested_header.beacon.slot)
    if hasattr(update, "finality_branch"):
        branch = [bytes(b) for b in update.finality_branch]
        # spec: a full LightClientUpdate may carry an EMPTY finality proof
        # (zeroed header + zero branch) when the signed period had no
        # finalized ancestor yet — skip the branch check, it proves nothing
        empty = int(update.finalized_header.beacon.slot) == 0 and all(
            b == b"\x00" * 32 for b in branch
        )
        if empty:
            if finality_required:
                return False
        else:
            depth, index = _gindex_depth_index(
                _state_gindex(
                    spec, attested_slot, ["finalized_checkpoint", "root"]
                )
            )
            fin_root = type(update.finalized_header.beacon).hash_tree_root(
                update.finalized_header.beacon
            )
            if not is_valid_merkle_branch(
                fin_root,
                branch,
                depth,
                index,
                bytes(update.attested_header.beacon.state_root),
            ):
                return False
    elif finality_required:
        return False
    if hasattr(update, "next_sync_committee_branch"):
        depth, index = _gindex_depth_index(
            _state_gindex(spec, attested_slot, ["next_sync_committee"])
        )
        cls = type(update.next_sync_committee)
        if not is_valid_merkle_branch(
            cls.hash_tree_root(update.next_sync_committee),
            list(update.next_sync_committee_branch),
            depth,
            index,
            bytes(update.attested_header.beacon.state_root),
        ):
            return False
    return True


def verify_light_client_update(
    spec, update, sync_committee, genesis_validators_root: bytes,
    finality_required: bool = False,
) -> bool:
    """Verify an optimistic/finality update against a trusted committee."""
    if not precheck_update(spec, update, finality_required):
        return False
    agg = update.sync_aggregate
    bits = np.asarray(agg.sync_committee_bits, dtype=bool)
    root = sync_signing_root(spec, update, genesis_validators_root)
    try:
        keys = [
            bls.PublicKey.from_bytes(bytes(sync_committee.pubkeys[i]))
            for i, b in enumerate(bits)
            if b
        ]
        sig = bls.Signature.from_bytes(bytes(agg.sync_committee_signature))
    except bls.BlsError:
        return False  # malformed encoding is a verdict, not an error
    return bls.verify_signature_sets(
        [bls.SignatureSet.multiple_pubkeys(sig, keys, root)]
    )
