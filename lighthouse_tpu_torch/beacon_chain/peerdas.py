"""PeerDAS per-slot column sampling: the port's copy of
``lighthouse_tpu/beacon_chain/peerdas.py``.

Twin of Lighthouse's ``network/src/sync/peer_sampling.rs`` +
``beacon_chain/src/data_column_verification.rs`` availability semantics,
scaled to this stack: every node custodies a deterministic
``custody_columns`` subset and samples ``SAMPLES_PER_SLOT`` additional
columns per block (hash-derived from node id + block root, so the set is
stable across retries and reproducible in tests). A block with blob
commitments becomes available ONLY when every custody + sampled column has
been cryptographically verified (the fail-closed gate wired into
``DataAvailabilityChecker.column_gate``); when at least half the columns
are held, ``recover_cells_and_kzg_proofs`` rebuilds the missing ones so a
supermajority-seeded network converges without every column ever riding
gossip.

The sampler holds no sidecars itself — verified columns live in
``chain.data_column_cache`` (chain-lock guarded, availability-horizon
pruned); this class tracks only the verified-index sets and the
availability verdict, so the gate callback is non-blocking.
"""

from __future__ import annotations

import hashlib
import threading

from .data_columns import CUSTODY_REQUIREMENT, custody_columns

SAMPLES_PER_SLOT = 8  # spec get_extended_sample_count baseline


class PeerDasSampler:
    def __init__(self, chain, cell_ctx, node_id: bytes,
                 custody_count: int = CUSTODY_REQUIREMENT,
                 samples_per_slot: int = SAMPLES_PER_SLOT):
        self.chain = chain
        self.ctx = cell_ctx
        self.node_id = bytes(node_id)
        self.n_columns = min(
            getattr(chain.ns, "NUMBER_OF_COLUMNS", cell_ctx.cells),
            cell_ctx.cells,
        )
        self.custody = custody_columns(
            self.node_id, custody_count, self.n_columns
        )
        self.samples_per_slot = min(samples_per_slot, self.n_columns)
        self._lock = threading.Lock()
        # block_root -> verified column indices (insertion-ordered LRU,
        # bounded alongside the chain's column cache)
        self._verified: dict[bytes, set[int]] = {}
        self._max_tracked = chain.da_checker.MAX_PENDING

    # -- column selection ---------------------------------------------------

    def sample_columns(self, block_root: bytes) -> list[int]:
        """The per-block sampling set: deterministic in (node id, root)."""
        out: set[int] = set()
        i = 0
        while len(out) < self.samples_per_slot:
            h = hashlib.sha256(
                self.node_id + bytes(block_root) + i.to_bytes(8, "little")
            ).digest()
            out.add(int.from_bytes(h[:8], "little") % self.n_columns)
            i += 1
        return sorted(out)

    def required_columns(self, block_root: bytes) -> list[int]:
        return sorted(set(self.custody) | set(self.sample_columns(block_root)))

    # -- verification tracking ----------------------------------------------

    def on_verified_column(self, block_root: bytes, index: int) -> None:
        """Record a column that passed ``verify_data_column_sidecar``.
        Callers verify BEFORE calling this — the sampler trusts nothing."""
        root = bytes(block_root)
        with self._lock:
            have = self._verified.pop(root, None) or set()
            have.add(int(index))
            self._verified[root] = have
            while len(self._verified) > self._max_tracked:
                self._verified.pop(next(iter(self._verified)))

    def verified_columns(self, block_root: bytes) -> set[int]:
        with self._lock:
            return set(self._verified.get(bytes(block_root), ()))

    def missing_columns(self, block_root: bytes) -> list[int]:
        have = self.verified_columns(block_root)
        return [c for c in self.required_columns(block_root) if c not in have]

    def is_available(self, block_root: bytes) -> bool:
        """The availability gate: every custody + sampled column verified.
        Non-blocking — safe under the DA checker's cache lock."""
        return not self.missing_columns(block_root)

    # -- reconstruction -----------------------------------------------------

    def can_reconstruct(self, block_root: bytes) -> bool:
        held = self.chain.data_columns_for(bytes(block_root))
        return 2 * len(held) >= self.ctx.cells

    def reconstruct(self, block_root: bytes):
        """Rebuild ALL column sidecars from the >= 50% held set
        (``recover_cells_and_kzg_proofs`` per blob row), or None when too
        few columns are held. Raises ``KzgError`` when held data is
        inconsistent — callers keep the block unavailable in that case."""
        root = bytes(block_root)
        held = self.chain.data_columns_for(root)
        if 2 * len(held) < self.ctx.cells:
            return None
        indices = sorted(held)
        template = held[indices[0]]
        n_blobs = len(template.column)
        bpc = self.ctx.bytes_per_cell
        # recover row-by-row: blob b's cells across the held columns
        cell_rows, proof_rows = [], []
        for b in range(n_blobs):
            rec_cells, rec_proofs = self.ctx.recover_cells_and_kzg_proofs(
                indices, [bytes(held[i].column[b])[:bpc] for i in indices]
            )
            cell_rows.append(rec_cells)
            proof_rows.append(rec_proofs)
        ns = self.chain.ns
        width = getattr(ns, "BYTES_PER_CELL", bpc)
        pad = b"\x00" * (width - bpc)
        return [
            ns.DataColumnSidecar(
                index=col,
                column=[cell_rows[b][col] + pad for b in range(n_blobs)],
                kzg_commitments=[bytes(c) for c in template.kzg_commitments],
                kzg_proofs=[proof_rows[b][col] for b in range(n_blobs)],
                signed_block_header=template.signed_block_header,
                kzg_commitments_inclusion_proof=[
                    bytes(h)
                    for h in template.kzg_commitments_inclusion_proof
                ],
            )
            for col in range(self.ctx.cells)
        ]
