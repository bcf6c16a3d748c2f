"""Data-column sidecars: PeerDAS construction + verification groundwork.

Twin of ``consensus/types/src/data_column_sidecar.rs`` (construction from a
block's blobs: build the cell matrix with ``compute_cells_and_kzg_proofs``
then transpose — column j carries cell j of every blob) and the column half
of ``beacon_chain/src/data_column_verification.rs`` (inclusion proof of the
whole commitments list under the body root, then a cell KZG proof batch).
Sampling (``network/src/sync/peer_sampling.rs``) consumes these through the
``CUSTODY_REQUIREMENT`` subset helper.

The port's copy of ``lighthouse_tpu/beacon_chain/data_columns.py``; the cell
proof batch goes to the port's ``kzg.engine`` (the device engine by
default).
"""

from __future__ import annotations

import hashlib

from ..ssz.merkle import fold_merkle_branch
from ..types.containers import BeaconBlockHeader, SignedBeaconBlockHeader
from .data_availability import (
    BlobError,
    _commitments_field_index,
    body_field_branch,
)

CUSTODY_REQUIREMENT = 4  # columns every node custodies (spec minimum)


class DataColumnError(BlobError):
    pass


def commitments_list_inclusion_proof(body) -> list[bytes]:
    """Branch proving the WHOLE blob_kzg_commitments list under body root."""
    return body_field_branch(body, _commitments_field_index(type(body)))


def verify_commitments_inclusion(ns, sidecar, body_cls=None) -> bool:
    """data_column_sidecar.rs verify_inclusion_proof."""
    body_cls = body_cls or ns.BeaconBlockBodyDeneb
    comm_t = dict(body_cls.FIELDS)["blob_kzg_commitments"]
    leaf = comm_t.hash_tree_root(list(sidecar.kzg_commitments))
    fi = _commitments_field_index(body_cls)
    root = fold_merkle_branch(
        leaf,
        [bytes(h) for h in sidecar.kzg_commitments_inclusion_proof],
        fi,
    )
    return root == bytes(sidecar.signed_block_header.message.body_root)


def make_data_column_sidecars(ns, signed_block, blobs, cell_ctx):
    """Build every column sidecar for a block's blobs
    (DataColumnSidecar construction, data_column_sidecar.rs:66+)."""
    blk = signed_block.message
    commitments = [bytes(c) for c in blk.body.blob_kzg_commitments]
    if len(commitments) != len(blobs):
        raise DataColumnError("blob count != commitment count")
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(
            slot=blk.slot,
            proposer_index=blk.proposer_index,
            parent_root=blk.parent_root,
            state_root=blk.state_root,
            body_root=blk.body.tree_root(),
        ),
        signature=signed_block.signature,
    )
    proof = commitments_list_inclusion_proof(blk.body)
    # cell matrix: row = blob, column = cell index
    cell_rows, proof_rows = [], []
    for blob in blobs:
        cells, proofs = cell_ctx.compute_cells_and_kzg_proofs(blob)
        cell_rows.append(cells)
        proof_rows.append(proofs)
    # container cells are spec-sized (BYTES_PER_CELL); smaller test
    # geometries zero-pad on the wire and slice back at verification
    width = getattr(ns, "BYTES_PER_CELL", cell_ctx.bytes_per_cell)
    pad = width - cell_ctx.bytes_per_cell

    sidecars = []
    for col in range(cell_ctx.cells):
        sidecars.append(
            ns.DataColumnSidecar(
                index=col,
                column=[row[col] + b"\x00" * pad for row in cell_rows],
                kzg_commitments=commitments,
                kzg_proofs=[row[col] for row in proof_rows],
                signed_block_header=header,
                kzg_commitments_inclusion_proof=proof,
            )
        )
    return sidecars


def verify_data_column_sidecar(ns, sidecar, cell_ctx) -> None:
    """Structural + cryptographic column verification
    (data_column_verification.rs verify_kzg_for_data_column)."""
    n_cols = getattr(ns, "NUMBER_OF_COLUMNS", cell_ctx.cells)
    if not 0 <= int(sidecar.index) < min(n_cols, cell_ctx.cells):
        raise DataColumnError(f"column index {int(sidecar.index)} out of range")
    if len(sidecar.column) != len(sidecar.kzg_commitments) or len(
        sidecar.column
    ) != len(sidecar.kzg_proofs):
        raise DataColumnError("column/commitments/proofs length mismatch")
    if len(sidecar.column) == 0:
        raise DataColumnError("empty column")
    if not verify_commitments_inclusion(ns, sidecar):
        raise DataColumnError("commitments inclusion proof invalid")
    cells = []
    for c in sidecar.column:
        raw = bytes(c)
        if any(raw[cell_ctx.bytes_per_cell :]):
            # the sidecar's identity (tree root) covers the pad region, so
            # non-zero padding must fail — not be silently sliced away
            raise DataColumnError("cell padding not zero")
        cells.append(raw[: cell_ctx.bytes_per_cell])
    from ..kzg.engine import verify_cell_proof_batch

    # backend-dispatched (kzg.engine.set_kzg_backend): the device engine
    # under the kzg_device ladder, or the host per-cell loop when selected —
    # fails CLOSED either way
    ok = verify_cell_proof_batch(
        cell_ctx,
        [bytes(c) for c in sidecar.kzg_commitments],
        [int(sidecar.index)] * len(sidecar.column),
        cells,
        [bytes(p) for p in sidecar.kzg_proofs],
    )
    if not ok:
        raise DataColumnError("cell KZG proof batch failed")


def custody_columns(node_id: bytes, custody_count: int = CUSTODY_REQUIREMENT,
                    n_columns: int = 128) -> list[int]:
    """Deterministic custody column subset for a node id (spec
    get_custody_columns: hash-derived, uniform, stable)."""
    out, i = set(), 0
    while len(out) < min(custody_count, n_columns):
        h = hashlib.sha256(node_id + i.to_bytes(8, "little")).digest()
        out.add(int.from_bytes(h[:8], "little") % n_columns)
        i += 1
    return sorted(out)
