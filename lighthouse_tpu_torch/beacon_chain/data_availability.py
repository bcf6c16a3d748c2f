"""Blob sidecar verification + data availability tracking (deneb).

Twin of ``beacon_node/beacon_chain/src/{blob_verification.rs,
data_availability_checker.rs}``: gossip sidecars are checked structurally
(index bound, header signature, commitment inclusion proof against the body
root) then cryptographically (KZG proof batch); blocks with commitments wait
in the availability cache until every blob index has arrived, and only then
import (``Availability::Available`` vs ``MissingComponents``).

The KZG batch check rides the same RLC pairing path as signature
verification — one 2-pairing check per gossip batch of sidecars.

The port's copy of ``lighthouse_tpu/beacon_chain/data_availability.py``.
"""

from __future__ import annotations

import threading

from ..ssz.merkle import fold_merkle_branch, merkle_branch_from_chunks
from ..types.containers import BeaconBlockHeader, SignedBeaconBlockHeader


class BlobError(Exception):
    pass


class AvailabilityCheckError(BlobError):
    pass


def _commitments_field_index(body_cls) -> int:
    return [n for n, _ in body_cls.FIELDS].index("blob_kzg_commitments")


def body_field_branch(body, field_index: int) -> list[bytes]:
    """Sibling branch for one top-level field under the body root."""
    import numpy as np

    from ..ssz.merkle import next_pow2

    body_cls = type(body)
    field_roots = np.stack(
        [
            np.frombuffer(t.hash_tree_root(getattr(body, n)), dtype=np.uint8)
            for n, t in body_cls.FIELDS
        ]
    )
    return merkle_branch_from_chunks(
        field_roots, next_pow2(len(body_cls.FIELDS)), field_index
    )


def commitment_inclusion_proof(ns, body, index: int) -> list[bytes]:
    """Branch proving body.blob_kzg_commitments[index] under the body root."""
    import numpy as np

    p = ns.preset
    body_cls = type(body)
    comm_t = dict(body_cls.FIELDS)["blob_kzg_commitments"]
    elem_t = comm_t.elem
    roots = np.stack(
        [
            np.frombuffer(elem_t.hash_tree_root(c), dtype=np.uint8)
            for c in body.blob_kzg_commitments
        ]
    )
    branch = merkle_branch_from_chunks(
        roots, p.MAX_BLOB_COMMITMENTS_PER_BLOCK, index
    )
    # length mix-in level: sibling is the little-endian length chunk
    length_chunk = len(body.blob_kzg_commitments).to_bytes(8, "little") + b"\x00" * 24
    branch.append(length_chunk)
    # body-fields level
    branch.extend(body_field_branch(body, _commitments_field_index(body_cls)))
    return branch


def _inclusion_proof_index(ns, body_cls, blob_index: int) -> int:
    """Direction bits for folding the inclusion branch: blob index bits,
    then the mix-in level (left child = 0), then the body field index."""
    p = ns.preset
    comm_depth = (p.MAX_BLOB_COMMITMENTS_PER_BLOCK - 1).bit_length()
    fi = _commitments_field_index(body_cls)
    return blob_index | (fi << (comm_depth + 1))


def verify_commitment_inclusion(ns, sidecar, body_cls=None) -> bool:
    """Check sidecar.kzg_commitment_inclusion_proof against the header's
    body_root (blob_verification.rs verify_blob_sidecar_inclusion_proof)."""
    from ..types.containers import KZGCommitment

    body_cls = body_cls or ns.BeaconBlockBodyDeneb
    leaf = KZGCommitment.hash_tree_root(bytes(sidecar.kzg_commitment))
    idx = _inclusion_proof_index(ns, body_cls, int(sidecar.index))
    root = fold_merkle_branch(
        leaf,
        [bytes(h) for h in sidecar.kzg_commitment_inclusion_proof],
        idx,
    )
    return root == bytes(sidecar.signed_block_header.message.body_root)


def make_blob_sidecars(ns, signed_block, blobs, proofs, kzg=None):
    """Produce gossip sidecars for a block's blobs (the production path:
    blob_sidecar.rs BlobSidecar::new)."""
    blk = signed_block.message
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(
            slot=blk.slot,
            proposer_index=blk.proposer_index,
            parent_root=bytes(blk.parent_root),
            state_root=bytes(blk.state_root),
            body_root=type(blk.body).hash_tree_root(blk.body),
        ),
        signature=bytes(signed_block.signature),
    )
    out = []
    for i, (blob, proof) in enumerate(zip(blobs, proofs)):
        out.append(
            ns.BlobSidecar(
                index=i,
                blob=blob,
                kzg_commitment=bytes(blk.body.blob_kzg_commitments[i]),
                kzg_proof=proof,
                signed_block_header=header,
                kzg_commitment_inclusion_proof=commitment_inclusion_proof(
                    ns, blk.body, i
                ),
            )
        )
    return out


class DataAvailabilityChecker:
    """Pending-components cache gating block import on blob arrival
    (data_availability_checker.rs / overflow_lru_cache.rs semantics,
    memory-resident)."""

    MAX_PENDING = 64  # LRU bound (the reference's OverflowLRUCache capacity role)

    def __init__(self, spec, kzg=None, is_known=None):
        self.spec = spec
        self.kzg = kzg
        # chain callback: roots already imported must not be resurrected by
        # late/duplicate gossip sidecars
        self.is_known = is_known or (lambda root: False)
        self._lock = threading.Lock()
        # block_root -> {"block": signed_block | None, "blobs": {index: sidecar}}
        # insertion-ordered: oldest entries evicted past MAX_PENDING
        self._pending: dict[bytes, dict] = {}
        # PeerDAS mode: when set, availability for blob-carrying blocks is
        # decided by the sampling gate (custody + sampled columns verified)
        # instead of per-blob sidecar arrival. fn(block_root) -> bool.
        self.column_gate = None

    def set_column_gate(self, gate) -> None:
        """Switch this checker to column sampling (PeerDAS): ``gate`` is
        called under the cache lock and must be non-blocking — it reads the
        sampler's verified-column state, it never verifies in-line."""
        self.column_gate = gate

    def _touch(self, root: bytes) -> dict:
        entry = self._pending.pop(root, None)
        if entry is None:
            entry = {"block": None, "blobs": {}}
        self._pending[root] = entry
        while len(self._pending) > self.MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))
        return entry

    # -- gossip verification ------------------------------------------------

    def verify_blob_sidecar(self, ns, sidecar) -> None:
        """Structural + KZG checks; raises BlobError (gossip path;
        blob_verification.rs GossipVerifiedBlob). Header signature is the
        caller's job (it needs the proposer pubkey from the chain)."""
        p = self.spec.preset
        if int(sidecar.index) >= p.MAX_BLOBS_PER_BLOCK:
            raise BlobError(f"blob index {int(sidecar.index)} out of range")
        if not verify_commitment_inclusion(ns, sidecar):
            raise BlobError("invalid commitment inclusion proof")
        if self.kzg is not None:
            ok = self.kzg.verify_blob_kzg_proof_batch(
                [bytes(sidecar.blob)],
                [bytes(sidecar.kzg_commitment)],
                [bytes(sidecar.kzg_proof)],
            )
            if not ok:
                raise BlobError("kzg proof verification failed")

    def verify_blob_sidecar_batch(self, ns, sidecars) -> None:
        """Batch variant: one RLC pairing check across all sidecars."""
        for sc in sidecars:
            p = self.spec.preset
            if int(sc.index) >= p.MAX_BLOBS_PER_BLOCK:
                raise BlobError(f"blob index {int(sc.index)} out of range")
            if not verify_commitment_inclusion(ns, sc):
                raise BlobError("invalid commitment inclusion proof")
        if self.kzg is not None and sidecars:
            ok = self.kzg.verify_blob_kzg_proof_batch(
                [bytes(sc.blob) for sc in sidecars],
                [bytes(sc.kzg_commitment) for sc in sidecars],
                [bytes(sc.kzg_proof) for sc in sidecars],
            )
            if not ok:
                raise BlobError("kzg batch proof verification failed")

    # -- availability tracking ----------------------------------------------

    @staticmethod
    def _required(signed_block) -> int:
        comms = getattr(signed_block.message.body, "blob_kzg_commitments", None)
        return 0 if comms is None else len(comms)

    def put_block(self, block_root: bytes, signed_block):
        """Returns the available (block, blobs-in-order) or None if blobs
        are still missing."""
        required = self._required(signed_block)
        if required == 0:
            return signed_block, []
        with self._lock:
            entry = self._touch(block_root)
            entry["block"] = signed_block
            return self._check_available(block_root, entry)

    def put_blob(self, sidecar):
        """Returns the now-available (block, blobs) or None."""
        root = BeaconBlockHeader.hash_tree_root(
            sidecar.signed_block_header.message
        )
        if self.is_known(root):
            return None  # already imported; don't resurrect the entry
        with self._lock:
            entry = self._touch(root)
            entry["blobs"][int(sidecar.index)] = sidecar
            return self._check_available(root, entry)

    def notify_columns(self, block_root: bytes):
        """Column-sampling progress signal: re-evaluate a pending block
        against the column gate. Returns the now-available (block, [])
        or None (no pending block / gate still unsatisfied)."""
        if self.is_known(block_root):
            return None
        with self._lock:
            entry = self._pending.get(block_root)
            if entry is None:
                return None
            return self._check_available(block_root, entry)

    def _check_available(self, root, entry):
        blk = entry["block"]
        if blk is None:
            return None
        if self.column_gate is not None:
            # PeerDAS: the sampling state machine owns the verdict; blobs
            # are reconstructed from columns, never waited on individually
            if self.column_gate(root):
                self._pending.pop(root, None)
                return blk, []
            return None
        required = self._required(blk)
        comms = blk.message.body.blob_kzg_commitments
        if any(i not in entry["blobs"] for i in range(required)):
            return None
        # commitments must line up sidecar-by-sidecar
        for i in range(required):
            if bytes(entry["blobs"][i].kzg_commitment) != bytes(comms[i]):
                raise AvailabilityCheckError(
                    f"sidecar {i} commitment does not match the block"
                )
        self._pending.pop(root, None)
        return blk, [entry["blobs"][i] for i in range(required)]

    def missing_blob_ids(self, block_root: bytes) -> list[int]:
        with self._lock:
            entry = self._pending.get(block_root)
            if entry is None or entry["block"] is None:
                return []
            required = self._required(entry["block"])
            return [i for i in range(required) if i not in entry["blobs"]]

    def prune(self, keep_roots) -> None:
        with self._lock:
            for root in list(self._pending):
                if root not in keep_roots:
                    del self._pending[root]
