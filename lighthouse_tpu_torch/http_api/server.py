"""Beacon-API server implementation.

The port's copy of ``lighthouse_tpu/http_api/server.py``. Work items
arriving over HTTP correspond to Lighthouse's ApiRequestP0/P1
beacon-processor queues (``beacon_processor/src/lib.rs:629-630``); here the
handler calls the chain directly (the stdlib threading server provides the
concurrency seam). Endpoints follow the Eth Beacon API paths served by
``http_api/src/lib.rs`` with SSZ-hex payload envelopes.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..loadshed import AdmissionLevel, is_p0_route
from ..state_transition import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    process_slots,
)
from ..types.containers import AttestationData, Checkpoint
from ..types.helpers import compute_fork_digest
from ..utils.metrics import SHED_REQUESTS


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class BeaconApiServer:
    """Wraps a BeaconChain (and optionally its op pool / gossip publisher —
    a BeaconNodeService provides both) behind the Beacon API."""

    def __init__(self, chain, op_pool=None, network_service=None,
                 host: str = "127.0.0.1", port: int = 0,
                 load_monitor=None):
        self.chain = chain
        self.op_pool = op_pool
        self.network = network_service
        # admission control: when the node is SATURATED, P1 (non-duty)
        # routes are refused with 503 + Retry-After; P0 duty routes are
        # always admitted (shedding a proposal costs more than any queue)
        self.load_monitor = load_monitor
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        # blinded flow: payloads produced here, awaited by publication
        # (execution_layer payload cache parity), keyed by block_hash;
        # bounded — publication pops, unclaimed entries age out FIFO
        from collections import OrderedDict

        self._payload_cache: "OrderedDict[bytes, object]" = OrderedDict()
        self._payload_cache_size = 8
        # insert+evict / pop interleave across ThreadingHTTPServer handler
        # threads; the GIL makes single dict ops atomic but not the
        # size-trim loop, so guard the cache with its own small lock
        self._payload_cache_lock = threading.Lock()
        # Share the CHAIN's mutation lock so handler threads serialize
        # against every other caller that mutates this chain (network router,
        # simulator loops), not just each other.
        self._chain_lock = chain.lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BeaconApiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- state resolution --------------------------------------------------

    def _state(self, state_id: str):
        if state_id == "head":
            return self.chain.head.state
        if state_id in ("justified", "finalized"):
            head = self.chain.head.state
            cp = (
                head.current_justified_checkpoint
                if state_id == "justified"
                else head.finalized_checkpoint
            )
            root = bytes(cp.root)
            if root == b"\x00" * 32:  # pre-genesis-justification alias
                root = self.chain.genesis_block_root
            st = self.chain.state_by_root(root)
            if st is None:
                raise ApiError(404, f"{state_id} state not held: {root.hex()}")
            # the checkpoint block can predate its epoch start (skipped
            # slots); the checkpoint STATE is advanced to the boundary
            boundary = self.chain.spec.start_slot(int(cp.epoch))
            if st.slot < boundary:
                st = st.copy()
                process_slots(self.chain.spec, st, boundary)
            return st
        raise ApiError(400, f"unsupported state id {state_id!r}")

    # -- endpoint handlers -------------------------------------------------

    def get_genesis(self):
        st = self.chain.genesis_state
        return {
            "genesis_time": str(int(st.genesis_time)),
            "genesis_validators_root": _hex(st.genesis_validators_root),
            "genesis_fork_version": _hex(self.chain.spec.genesis_fork_version),
        }

    def get_fork(self, state_id: str):
        st = self._state(state_id)
        return {
            "previous_version": _hex(st.fork.previous_version),
            "current_version": _hex(st.fork.current_version),
            "epoch": str(int(st.fork.epoch)),
        }

    def get_finality_checkpoints(self, state_id: str):
        st = self._state(state_id)

        def cp(c):
            return {"epoch": str(int(c.epoch)), "root": _hex(c.root)}

        return {
            "previous_justified": cp(st.previous_justified_checkpoint),
            "current_justified": cp(st.current_justified_checkpoint),
            "finalized": cp(st.finalized_checkpoint),
        }

    @staticmethod
    def _validator_status(v, epoch: int, far: int) -> str:
        """Beacon-API validator status taxonomy (validator/mod.rs
        ValidatorStatus)."""
        if int(v.activation_epoch) > epoch:
            return (
                "pending_queued"
                if int(v.activation_eligibility_epoch) <= epoch
                else "pending_initialized"
            )
        if epoch < int(v.exit_epoch):
            if int(v.exit_epoch) != far:
                return "active_exiting"
            return "active_slashed" if v.slashed else "active_ongoing"
        if epoch < int(v.withdrawable_epoch):
            return "exited_slashed" if v.slashed else "exited_unslashed"
        return "withdrawal_possible"

    def _validator_entry(self, st, i: int, epoch: int, far: int) -> dict:
        v = st.validators[i]
        return {
            "index": str(i),
            "balance": str(int(st.balances[i])),
            "status": self._validator_status(v, epoch, far),
            "validator": {
                "pubkey": _hex(v.pubkey),
                "withdrawal_credentials": _hex(v.withdrawal_credentials),
                "effective_balance": str(int(v.effective_balance)),
                "slashed": bool(v.slashed),
                "activation_eligibility_epoch": str(
                    int(v.activation_eligibility_epoch)
                ),
                "activation_epoch": str(int(v.activation_epoch)),
                "exit_epoch": str(int(v.exit_epoch)),
                "withdrawable_epoch": str(int(v.withdrawable_epoch)),
            },
        }

    def _resolve_validator_index(self, st, vid: str) -> int:
        if vid.startswith("0x"):
            pk = _unhex(vid)
            # O(1) via the chain's pubkey index; linear fallback only for
            # keys the cache hasn't imported yet
            idx = self.chain.pubkey_cache.get_index(pk)
            if idx is not None and idx < len(st.validators):
                return idx
            for i, v in enumerate(st.validators):
                if bytes(v.pubkey) == pk:
                    return i
            raise ApiError(404, f"no validator with pubkey {vid[:18]}…")
        if not vid.isdigit():
            raise ApiError(400, f"bad validator id {vid!r}")
        i = int(vid)
        if i >= len(st.validators):
            raise ApiError(404, f"validator index {i} out of range")
        return i

    def _resolve_validator_indices(self, st, ids: str) -> list[int]:
        """Batch-query id resolution: unknown pubkeys / out-of-range indices
        are OMITTED (Lighthouse filters by set membership — VCs routinely
        query keys whose deposits are not yet processed); malformed ids are
        still a 400. 404 is reserved for the single-validator endpoint."""
        out = []
        for x in ids.split(","):
            if not x:
                continue
            try:
                out.append(self._resolve_validator_index(st, x))
            except ApiError as e:
                if e.code != 404:
                    raise
        return out

    def get_validators(self, state_id: str, ids: str | None = None):
        from ..types.spec import FAR_FUTURE_EPOCH

        st = self._state(state_id)
        spec = self.chain.spec
        epoch = int(st.slot) // spec.preset.SLOTS_PER_EPOCH
        if ids:
            indices = self._resolve_validator_indices(st, ids)
        else:
            indices = range(len(st.validators))
        return [
            self._validator_entry(st, i, epoch, FAR_FUTURE_EPOCH)
            for i in indices
        ]

    def get_validator(self, state_id: str, vid: str):
        from ..types.spec import FAR_FUTURE_EPOCH

        st = self._state(state_id)
        spec = self.chain.spec
        epoch = int(st.slot) // spec.preset.SLOTS_PER_EPOCH
        i = self._resolve_validator_index(st, vid)
        return self._validator_entry(st, i, epoch, FAR_FUTURE_EPOCH)

    def get_validator_balances(self, state_id: str, ids: str | None = None):
        st = self._state(state_id)
        if ids:
            indices = self._resolve_validator_indices(st, ids)
        else:
            indices = range(len(st.validators))
        return [
            {"index": str(i), "balance": str(int(st.balances[i]))}
            for i in indices
        ]

    def get_committees(self, state_id: str, q: dict):
        """GET /eth/v1/beacon/states/{id}/committees with epoch/index/slot
        filters (http_api committees endpoint)."""
        st = self._state(state_id)
        spec = self.chain.spec
        state_epoch = int(st.slot) // spec.preset.SLOTS_PER_EPOCH
        epoch = int(q.get("epoch", state_epoch))
        # the state can answer exactly [previous, current, next] epochs
        # (shuffling seeds beyond the lookahead are not yet decided; older
        # epochs would silently compute WRONG committees) — match
        # Lighthouse bounds with a 400, and never process_slots over an
        # unbounded attacker-chosen range
        if epoch > state_epoch + 1 or epoch + 1 < state_epoch:
            raise ApiError(
                400,
                f"epoch {epoch} outside the computable range "
                f"[{max(state_epoch - 1, 0)}, {state_epoch + 1}] "
                f"of state {state_id}",
            )
        state = st
        start = spec.start_slot(epoch)
        if state.slot < start:
            state = state.copy()
            process_slots(spec, state, start)
        want_slot = int(q["slot"]) if "slot" in q else None
        want_index = int(q["index"]) if "index" in q else None
        out = []
        per_slot = get_committee_count_per_slot(spec, state, epoch)
        for slot in range(start, start + spec.preset.SLOTS_PER_EPOCH):
            if want_slot is not None and slot != want_slot:
                continue
            for index in range(per_slot):
                if want_index is not None and index != want_index:
                    continue
                committee = get_beacon_committee(spec, state, slot, index)
                out.append(
                    {
                        "index": str(index),
                        "slot": str(slot),
                        "validators": [str(int(v)) for v in committee],
                    }
                )
        return out

    def get_randao(self, state_id: str, q: dict):
        from ..state_transition import get_randao_mix

        st = self._state(state_id)
        spec = self.chain.spec
        epoch = int(
            q.get("epoch", int(st.slot) // spec.preset.SLOTS_PER_EPOCH)
        )
        return {"randao": _hex(get_randao_mix(spec, st, epoch))}

    def get_blob_sidecars(self, block_id: str, q: dict):
        """GET /eth/v1/beacon/blob_sidecars/{block_id} from the blobs
        column (hot_cold_store.rs get_blobs)."""
        root = self._block_root_of(block_id)
        raws = self.chain.store.get_blob_sidecars(root)
        if raws is None:
            return []
        indices = (
            {int(x) for x in q["indices"].split(",")} if "indices" in q else None
        )
        cls = self.chain.ns.BlobSidecar
        out = []
        for raw in raws:
            sc = cls.decode(raw)
            if indices is None or int(sc.index) in indices:
                out.append(_hex(raw))
        return out

    def get_syncing(self):
        head = self.chain.head.slot
        current = self.chain.current_slot()
        return {
            "head_slot": str(head),
            "sync_distance": str(max(0, current - head)),
            "is_syncing": current > head + 1,
            "is_optimistic": False,
            "el_offline": self.chain.execution_layer is None,
        }

    def get_proposer_duties(self, epoch: int):
        spec = self.chain.spec
        state = self.chain.head.state.copy()
        start = spec.start_slot(epoch)
        if state.slot < start:
            process_slots(spec, state, start)
        duties = []
        for slot in range(start, start + spec.preset.SLOTS_PER_EPOCH):
            idx = get_beacon_proposer_index(spec, state, slot=slot)
            duties.append(
                {
                    "pubkey": _hex(state.validators[idx].pubkey),
                    "validator_index": str(idx),
                    "slot": str(slot),
                }
            )
        return duties

    def get_attester_duties(self, epoch: int, indices: list[int]):
        spec = self.chain.spec
        state = self.chain.head.state.copy()
        start = spec.start_slot(epoch)
        if state.slot < start:
            process_slots(spec, state, start)
        wanted = set(indices)
        duties = []
        committees_per_slot = get_committee_count_per_slot(spec, state, epoch)
        for slot in range(start, start + spec.preset.SLOTS_PER_EPOCH):
            for index in range(committees_per_slot):
                committee = get_beacon_committee(spec, state, slot, index)
                for pos, v in enumerate(committee):
                    if int(v) in wanted:
                        duties.append(
                            {
                                "pubkey": _hex(state.validators[int(v)].pubkey),
                                "validator_index": str(int(v)),
                                "committee_index": str(index),
                                "committee_length": str(committee.size),
                                "committees_at_slot": str(committees_per_slot),
                                "validator_committee_index": str(pos),
                                "slot": str(slot),
                            }
                        )
        return duties

    def get_sync_duties(self, epoch: int, indices: list[int]):
        """Sync-committee duties (duties/sync/{epoch}): committee positions
        per requested validator, computed on a state advanced to the
        requested epoch (period boundaries rotate the committee)."""
        spec = self.chain.spec
        state = self.chain.head.state
        if not hasattr(state, "current_sync_committee"):
            return []
        start = spec.start_slot(epoch)
        if state.slot < start:
            state = state.copy()
            process_slots(spec, state, start)
        out = []
        for idx in indices:
            positions = self.chain.sync_committee_positions(state, idx)
            if positions:
                out.append(
                    {
                        "pubkey": _hex(state.validators[idx].pubkey),
                        "validator_index": str(idx),
                        "validator_sync_committee_indices": [
                            str(p) for p in positions
                        ],
                    }
                )
        return out

    def publish_sync_messages(self, body: list):
        """POST /eth/v1/beacon/pool/sync_committees: verify + pool."""
        ns = self.chain.ns
        msgs = [
            ns.SyncCommitteeMessage.decode(_unhex(item["data"]))
            for item in body
        ]
        results = self.chain.verify_sync_committee_messages(msgs)
        failures = [
            {"index": i, "message": str(v)}
            for i, (_, v) in enumerate(results)
            if isinstance(v, Exception)
        ]
        if failures:
            raise ApiError(400, f"sync messages rejected: {failures}")
        if self.network is not None:
            publish = getattr(self.network, "publish_sync_message", None)
            if publish is not None:
                for m in msgs:
                    publish(m)
        return {"accepted": len(msgs)}

    def get_aggregate_attestation(self, data_root: bytes):
        """GET /eth/v1/validator/aggregate_attestation: the naive pool's best
        aggregate for an AttestationData root."""
        agg = self.chain.naive_aggregation_pool.get_by_root(data_root)
        if agg is None:
            raise ApiError(404, "no aggregate for data root")
        cls = self.chain.ns.Attestation
        return _hex(cls.encode(agg))

    def publish_aggregates(self, body: list):
        """POST /eth/v1/validator/aggregate_and_proofs: the 3-sets-per-
        aggregate batch verification path + op pool insert."""
        ns = self.chain.ns
        saps = [
            ns.SignedAggregateAndProof.decode(_unhex(item["data"]))
            for item in body
        ]
        results = self.chain.verify_aggregated_attestations(saps)
        failures = []
        accepted = 0
        for i, (sap, verdict) in enumerate(results):
            if isinstance(verdict, Exception):
                failures.append({"index": i, "message": str(verdict)})
                continue
            accepted += 1
            if self.op_pool is not None:
                self.op_pool.insert_attestation(sap.message.aggregate)
            if self.network is not None:
                self.network.publish_aggregate(sap)
        if failures:
            # valid aggregates are already applied; report the rest
            raise ApiError(400, f"aggregates rejected: {failures}")
        return {"accepted": accepted}

    def publish_contributions(self, body: list):
        """POST /eth/v1/validator/contribution_and_proofs."""
        ns = self.chain.ns
        scs = [
            ns.SignedContributionAndProof.decode(_unhex(item["data"]))
            for item in body
        ]
        results = self.chain.verify_sync_contributions(scs)
        failures = [
            {"index": i, "message": str(v)}
            for i, (_, v) in enumerate(results)
            if isinstance(v, Exception)
        ]
        if failures:
            raise ApiError(400, f"contributions rejected: {failures}")
        return {"accepted": len(scs)}

    def get_attestation_data(self, slot: int, committee_index: int):
        spec = self.chain.spec
        # one snapshot: a concurrent import swaps chain.head atomically, so
        # every field here must come from the SAME head view
        head = self.chain.head
        # early-attester cache (early_attester_cache.rs): same-epoch
        # attestations to the current head never touch (or slot-advance) a
        # state — the validator-client stampede at the attestation deadline
        # is served from six cached fields
        cached = self.chain.early_attester_cache.try_attestation_data(
            spec, slot, committee_index, head.root
        )
        if cached is not None:
            return {"data": _hex(AttestationData.encode(cached))}
        state = head.state
        if state.slot < slot:
            state = state.copy()
            process_slots(spec, state, slot)
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        head_root = head.root
        if slot == spec.start_slot(epoch) and head.slot <= slot:
            target_root = head_root
        else:
            from ..state_transition import get_block_root_at_slot

            target_root = get_block_root_at_slot(
                spec, state, spec.start_slot(epoch)
            )
        data = AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=Checkpoint(epoch=epoch, root=target_root),
        )
        return {"data": _hex(AttestationData.encode(data))}

    def produce_block(self, slot: int, randao_reveal: bytes, graffiti: bytes):
        chain = self.chain
        state = _advanced(chain, slot)  # advance once; shared by pool + production
        atts = self.op_pool.get_attestations(state) if self.op_pool else []
        block, _post = chain.produce_block_on_state(
            state, slot, randao_reveal, attestations=atts,
            graffiti=graffiti or b"\x00" * 32, op_pool=self.op_pool,
        )
        fork = chain.spec.fork_name_at_epoch(
            slot // chain.spec.preset.SLOTS_PER_EPOCH
        )
        inner_cls = dict(chain.ns.block_types[fork].FIELDS)["message"]
        return {
            "version": fork,
            "data": _hex(inner_cls.encode(block)),
        }

    def produce_blinded_block(
        self, slot: int, randao_reveal: bytes, graffiti: bytes
    ):
        """GET /eth/v1/validator/blinded_blocks/{slot}: full production,
        payload swapped for its header; the payload is cached for
        publication (execution_layer blinded flow — the builder seam)."""
        from ..types.blinded import blind_signed_block

        full = self.produce_block(slot, randao_reveal, graffiti)
        fork = full["version"]
        if fork not in self.chain.ns.payload_header_types:
            raise ApiError(400, f"no blinded flow before bellatrix ({fork})")
        chain = self.chain
        inner_cls = dict(chain.ns.block_types[fork].FIELDS)["message"]
        block = inner_cls.decode(_unhex(full["data"]))
        payload = block.body.execution_payload
        with self._payload_cache_lock:
            self._payload_cache[bytes(payload.block_hash)] = payload
            while len(self._payload_cache) > self._payload_cache_size:
                self._payload_cache.popitem(last=False)
        signed_shell = chain.ns.block_types[fork](
            message=block, signature=b"\x00" * 96
        )
        blinded = blind_signed_block(chain.ns, fork, signed_shell)
        inner_blinded = blinded.message
        return {
            "version": fork,
            "data": _hex(type(inner_blinded).encode(inner_blinded)),
        }

    def publish_blinded_block(self, body: dict):
        """POST /eth/v1/beacon/blinded_blocks: reconstruct the full block
        from the cached payload (publish_blocks.rs blinded path) and import."""
        from ..types.blinded import blinded_types, unblind_signed_block

        chain = self.chain
        fork = body.get("version") or chain.spec.fork_name_at_slot(
            chain.current_slot()
        )
        ns = blinded_types(chain.ns)
        if fork not in ns.blinded_block_types:
            raise ApiError(400, f"no blinded flow before bellatrix ({fork})")
        signed_blinded = ns.blinded_block_types[fork].decode(
            _unhex(body["data"])
        )
        hdr = signed_blinded.message.body.execution_payload_header
        with self._payload_cache_lock:
            payload = self._payload_cache.pop(bytes(hdr.block_hash), None)
        if payload is None:
            raise ApiError(400, "unknown payload for blinded block")
        try:
            full = unblind_signed_block(ns, fork, signed_blinded, payload)
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return self.publish_block(
            {"version": fork, "data": _hex(type(full).encode(full))}
        )

    def publish_block(self, body: dict):
        version = body.get("version", None)
        fork = version or self.chain.spec.fork_name_at_slot(
            self.chain.current_slot()
        )
        block_cls = self.chain.ns.block_types[fork]
        signed = block_cls.decode(_unhex(body["data"]))
        from ..beacon_chain.chain import BlockError, BlockPendingAvailability

        # deneb BlockContents: blobs + proofs ride alongside the block
        sidecars = []
        if body.get("blobs"):
            from ..beacon_chain.data_availability import make_blob_sidecars

            sidecars = make_blob_sidecars(
                self.chain.ns,
                signed,
                [_unhex(x) for x in body["blobs"]],
                [_unhex(x) for x in body.get("kzg_proofs", [])],
            )
        try:
            self.chain.process_block(signed)
        except BlockPendingAvailability:
            from ..beacon_chain.data_availability import BlobError

            imported = None
            try:
                for sc in sidecars:
                    imported = self.chain.process_gossip_blob(sc)
            except (BlobError, BlockError) as e:
                raise ApiError(400, str(e)) from None
            if imported is None:
                raise ApiError(
                    400, "block pending blob availability"
                ) from None
        except BlockError as e:
            raise ApiError(400, str(e)) from None
        if self.network is not None:
            self.network.publish_block(signed)
            publish_blob = getattr(self.network, "publish_blob", None)
            if publish_blob is not None:
                for sc in sidecars:
                    publish_blob(sc)
        return {}

    def publish_attestations(self, body: list):
        att_cls = self.chain.ns.Attestation
        atts = [att_cls.decode(_unhex(item["data"])) for item in body]
        results = self.chain.verify_unaggregated_attestations(atts)
        failures = []
        for i, (att, verdict) in enumerate(results):
            if isinstance(verdict, Exception):
                failures.append({"index": i, "message": str(verdict)})
                continue
            if self.op_pool is not None:
                self.op_pool.insert_attestation(att)
            if self.network is not None:
                self.network.publish_attestation(att)
        if failures:
            raise ApiError(400, json.dumps(failures))
        return {}

    def _signed_block(self, root: bytes):
        """Decoded signed block by root: memory cache first, then the store
        (finalized blocks are migrated out of memory but stay on disk)."""
        chain = self.chain
        sb = chain._blocks.get(root)
        if sb is not None:
            return sb
        raw = chain.store.get_block(root)
        if raw is None:
            return None
        for fork in reversed(list(chain.ns.block_types)):
            try:
                return chain.ns.block_types[fork].decode(raw)
            except Exception:
                continue
        return None

    def _block_root_of(self, block_id: str) -> bytes:
        """Resolve 'head'/'finalized'/slot/0x-root to a canonical block
        root."""
        chain = self.chain
        if block_id == "head":
            return chain.head.root
        if block_id == "finalized":
            root = bytes(
                chain.head.state.finalized_checkpoint.root
            )
            return root if root != b"\x00" * 32 else chain.genesis_block_root
        if block_id == "genesis":
            return chain.genesis_block_root
        if block_id.startswith("0x"):
            return _unhex(block_id)
        if block_id.isdigit():
            # canonical walk from head, bounded by the head slot; store
            # fallback covers migrated (finalized) history
            want = int(block_id)
            if want > chain.head.slot:
                raise ApiError(404, f"no canonical block at slot {want}")
            root = chain.head.root
            while root is not None:
                sb = self._signed_block(root)
                if sb is None:
                    break
                s = int(sb.message.slot)
                if s == want:
                    return root
                if s < want or root == chain.genesis_block_root:
                    break
                root = bytes(sb.message.parent_root)
            raise ApiError(404, f"no canonical block at slot {want}")
        raise ApiError(400, f"unsupported block id {block_id!r}")

    def get_block(self, block_id: str):
        """Signed block by id (fork-versioned SSZ envelope;
        /eth/v2/beacon/blocks/{block_id})."""
        chain = self.chain
        root = self._block_root_of(block_id)
        sb = self._signed_block(root)
        if sb is None:
            raise ApiError(404, f"block {root.hex()[:16]} not held")
        fork = chain.spec.fork_name_at_slot(int(sb.message.slot))
        cls = chain.ns.block_types[fork]
        return {"version": fork, "data": _hex(cls.encode(sb))}

    def get_block_root(self, block_id: str):
        root = self._block_root_of(block_id)
        if block_id.startswith("0x") and self._signed_block(root) is None:
            raise ApiError(404, f"block {block_id[:18]}… not held")
        return {"root": _hex(root)}

    def _is_canonical(self, root: bytes, slot: int) -> bool:
        """True iff `root` is the canonical block at its slot (explicit
        0x-root lookups may name blocks off the canonical chain)."""
        try:
            return self._block_root_of(str(int(slot))) == root
        except ApiError:
            return False

    def get_header(self, block_id: str = "head"):
        root = self._block_root_of(block_id)
        sb = self._signed_block(root)
        if sb is not None:
            msg = sb.message
            fields = {
                "slot": str(int(msg.slot)),
                "proposer_index": str(int(msg.proposer_index)),
                "parent_root": _hex(msg.parent_root),
                "state_root": _hex(msg.state_root),
                "body_root": _hex(type(msg.body).hash_tree_root(msg.body)),
            }
            sig = _hex(sb.signature)
        else:
            # anchor-state head (checkpoint sync): the block body is not
            # held; the state's latest header carries the message fields
            head = self.chain.head
            if root != head.root:
                raise ApiError(404, f"block {root.hex()[:16]} not held")
            hdr = head.state.latest_block_header.copy()
            if bytes(hdr.state_root) == b"\x00" * 32:
                hdr.state_root = head.state.tree_root()
            fields = {
                "slot": str(int(hdr.slot)),
                "proposer_index": str(int(hdr.proposer_index)),
                "parent_root": _hex(hdr.parent_root),
                "state_root": _hex(hdr.state_root),
                "body_root": _hex(hdr.body_root),
            }
            sig = _hex(b"\x00" * 96)
        canonical = (
            True
            if not block_id.startswith("0x")
            else self._is_canonical(root, int(fields["slot"]))
        )
        return {
            "root": _hex(root),
            "canonical": canonical,
            "header": {"message": fields, "signature": sig},
        }

    # -- pool endpoints ----------------------------------------------------

    def get_pool_attester_slashings(self):
        pool = self.op_pool
        items = list(pool._attester_slashings) if pool else []
        return [_hex(type(s).encode(s)) for s in items]

    def get_pool_proposer_slashings(self):
        pool = self.op_pool
        items = list(pool._proposer_slashings.values()) if pool else []
        return [_hex(type(s).encode(s)) for s in items]

    def get_pool_voluntary_exits(self):
        pool = self.op_pool
        items = list(pool._voluntary_exits.values()) if pool else []
        return [_hex(type(s).encode(s)) for s in items]

    def get_pool_bls_changes(self):
        pool = self.op_pool
        items = list(pool._bls_changes.values()) if pool else []
        return [_hex(type(s).encode(s)) for s in items]

    def _verify_op_on_head(self, apply_fn, *args):
        """Run an operation's full verification against a head-state copy
        (verify_operation.rs SigVerifiedOp semantics: pool admission re-runs
        the state checks + signature)."""
        from ..state_transition.per_block import BlockProcessingError

        state = self.chain.head.state.copy()
        try:
            apply_fn(state, *args)
        except BlockProcessingError as e:
            raise ApiError(400, str(e)) from None

    def post_pool_attester_slashing(self, body: dict):
        from ..state_transition.per_block import process_attester_slashing

        ns = self.chain.ns
        fork = self.chain.spec.fork_name_at_slot(self.chain.current_slot())
        cls = ns.attester_slashing_types[fork]
        sl = cls.decode(_unhex(body["data"]))
        self._verify_op_on_head(
            lambda st: process_attester_slashing(
                self.chain.spec, st, sl, verify=True
            )
        )
        if self.op_pool is not None:
            self.op_pool.insert_attester_slashing(sl)
        return {}

    def post_pool_proposer_slashing(self, body: dict):
        from ..state_transition.per_block import (
            ConsensusContext,
            process_proposer_slashing,
        )

        from ..types.containers import ProposerSlashing

        sl = ProposerSlashing.decode(_unhex(body["data"]))
        self._verify_op_on_head(
            lambda st: process_proposer_slashing(
                self.chain.spec, st, sl, ConsensusContext(), verify=True
            )
        )
        if self.op_pool is not None:
            self.op_pool.insert_proposer_slashing(sl)
        return {}

    def post_pool_voluntary_exit(self, body: dict):
        from ..state_transition.per_block import process_exit

        from ..types.containers import SignedVoluntaryExit

        ex = SignedVoluntaryExit.decode(_unhex(body["data"]))
        self._verify_op_on_head(
            lambda st: process_exit(self.chain.spec, st, ex, verify=True)
        )
        if self.op_pool is not None:
            self.op_pool.insert_voluntary_exit(ex)
        return {}

    def post_pool_bls_change(self, body: dict):
        from ..state_transition.per_block import (
            process_bls_to_execution_change,
        )
        from ..types.containers import SignedBLSToExecutionChange

        ch = SignedBLSToExecutionChange.decode(_unhex(body["data"]))
        self._verify_op_on_head(
            lambda st: process_bls_to_execution_change(
                self.chain.spec, st, ch, verify=True
            )
        )
        if self.op_pool is not None:
            self.op_pool.insert_bls_to_execution_change(ch)
        return {}

    # -- node / config -----------------------------------------------------

    def get_node_identity(self):
        net = self.network
        peer_id = ""
        addrs = []
        if net is not None:
            transport = getattr(net, "transport", None)
            if transport is not None:
                peer_id = str(getattr(transport, "node_id", ""))
                addr = getattr(transport, "address", None)
                if addr:
                    addrs = [f"/ip4/{addr[0]}/tcp/{addr[1]}"]
        return {
            "peer_id": peer_id,
            "enr": "",
            "p2p_addresses": addrs,
            "discovery_addresses": [],
            "metadata": {"seq_number": "0", "attnets": "0x00"},
        }

    def get_node_peers(self):
        net = self.network
        out = []
        if net is not None:
            transport = getattr(net, "transport", None)
            if transport is not None:
                for p in transport.peers():
                    out.append(
                        {
                            "peer_id": str(p),
                            "state": "connected",
                            "direction": "outbound",
                        }
                    )
        return out

    def node_health_code(self) -> int:
        head = self.chain.head.slot
        current = self.chain.current_slot()
        return 206 if current > head + 1 else 200

    def get_config_spec(self):
        spec = self.chain.spec
        p = spec.preset
        out = {
            "PRESET_BASE": p.name,
            "SECONDS_PER_SLOT": str(p.SECONDS_PER_SLOT),
            "SLOTS_PER_EPOCH": str(p.SLOTS_PER_EPOCH),
            "MAX_COMMITTEES_PER_SLOT": str(p.MAX_COMMITTEES_PER_SLOT),
            "MAX_EFFECTIVE_BALANCE": str(spec.max_effective_balance),
            "MIN_ATTESTATION_INCLUSION_DELAY": str(
                spec.min_attestation_inclusion_delay
            ),
            "SHARD_COMMITTEE_PERIOD": str(spec.shard_committee_period),
            "GENESIS_FORK_VERSION": _hex(spec.genesis_fork_version),
        }
        for fork in ("altair", "bellatrix", "capella", "deneb", "electra"):
            out[f"{fork.upper()}_FORK_EPOCH"] = str(spec.fork_epoch(fork))
            out[f"{fork.upper()}_FORK_VERSION"] = _hex(
                spec.fork_version(fork)
            )
        return out

    def get_fork_schedule(self):
        spec = self.chain.spec
        out = []
        prev = spec.genesis_fork_version
        for fork in ("phase0", "altair", "bellatrix", "capella", "deneb",
                     "electra"):
            epoch = 0 if fork == "phase0" else spec.fork_epoch(fork)
            version = spec.fork_version(fork)
            out.append(
                {
                    "previous_version": _hex(prev),
                    "current_version": _hex(version),
                    "epoch": str(epoch),
                }
            )
            prev = version
        return out

    def get_deposit_contract(self):
        spec = self.chain.spec
        return {
            "chain_id": str(getattr(spec, "deposit_chain_id", 0)),
            "address": _hex(getattr(spec, "deposit_contract_address",
                                    b"\x00" * 20)),
        }


def _advanced(chain, slot):
    # one head snapshot: a concurrent import swaps chain.head atomically and
    # mixing two views would mistake the swap for a re-org decision
    head = chain.head
    # proposer re-org heuristic: a weak, late head may be orphaned by
    # building on its parent (fork_choice get_proposer_head)
    base_root = chain.fork_choice.get_proposer_head(slot, head.root)
    if base_root != head.root:
        parent_state = chain.state_by_root(bytes(base_root))
        state = parent_state if parent_state is not None else head.state
    else:
        state = head.state
    if state.slot < slot:
        state = state.copy()
        process_slots(chain.spec, state, slot)
    return state


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/eth/v1/beacon/genesis$"), "genesis"),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/fork$"), "fork"),
    (
        "GET",
        re.compile(r"^/eth/v1/beacon/states/(\w+)/finality_checkpoints$"),
        "finality",
    ),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/validators$"), "validators"),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/validators/([0-9a-zA-Zx]+)$"), "validator"),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/validator_balances$"), "validator_balances"),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/committees$"), "committees"),
    ("GET", re.compile(r"^/eth/v1/beacon/states/(\w+)/randao$"), "randao"),
    ("GET", re.compile(r"^/eth/v1/beacon/blob_sidecars/(\w+|0x[0-9a-fA-F]{64})$"), "blob_sidecars"),
    ("GET", re.compile(r"^/eth/v1/node/syncing$"), "syncing"),
    ("GET", re.compile(r"^/eth/v1/node/version$"), "version"),
    ("GET", re.compile(r"^/eth/v1/node/health$"), "health"),
    ("GET", re.compile(r"^/eth/v1/node/identity$"), "identity"),
    ("GET", re.compile(r"^/eth/v1/node/peers$"), "peers"),
    ("GET", re.compile(r"^/eth/v1/config/spec$"), "config_spec"),
    ("GET", re.compile(r"^/eth/v1/config/fork_schedule$"), "fork_schedule"),
    ("GET", re.compile(r"^/eth/v1/config/deposit_contract$"), "deposit_contract"),
    ("GET", re.compile(r"^/eth/v1/validator/duties/proposer/(\d+)$"), "proposer"),
    ("POST", re.compile(r"^/eth/v1/validator/duties/attester/(\d+)$"), "attester"),
    ("GET", re.compile(r"^/eth/v1/validator/attestation_data$"), "att_data"),
    ("GET", re.compile(r"^/eth/v2/validator/blocks/(\d+)$"), "produce_block"),
    ("GET", re.compile(r"^/eth/v1/validator/blinded_blocks/(\d+)$"), "produce_blinded"),
    ("POST", re.compile(r"^/eth/v1/beacon/blocks$"), "publish_block"),
    ("POST", re.compile(r"^/eth/v1/beacon/blinded_blocks$"), "publish_blinded"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/attestations$"), "publish_atts"),
    ("GET", re.compile(r"^/eth/v1/beacon/pool/attester_slashings$"), "pool_att_slashings"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/attester_slashings$"), "post_att_slashing"),
    ("GET", re.compile(r"^/eth/v1/beacon/pool/proposer_slashings$"), "pool_prop_slashings"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/proposer_slashings$"), "post_prop_slashing"),
    ("GET", re.compile(r"^/eth/v1/beacon/pool/voluntary_exits$"), "pool_exits"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/voluntary_exits$"), "post_exit"),
    ("GET", re.compile(r"^/eth/v1/beacon/pool/bls_to_execution_changes$"), "pool_bls_changes"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/bls_to_execution_changes$"), "post_bls_change"),
    ("GET", re.compile(r"^/eth/v1/beacon/headers/(\w+|0x[0-9a-fA-F]{64})$"), "header"),
    ("GET", re.compile(r"^/eth/v1/beacon/blocks/(\w+|0x[0-9a-fA-F]{64})/root$"), "block_root"),
    ("GET", re.compile(r"^/eth/v1/events$"), "events"),
    ("POST", re.compile(r"^/eth/v1/validator/liveness/(\d+)$"), "liveness"),
    ("POST", re.compile(r"^/eth/v1/validator/duties/sync/(\d+)$"), "sync_duties"),
    ("POST", re.compile(r"^/eth/v1/beacon/pool/sync_committees$"), "publish_sync"),
    ("POST", re.compile(r"^/eth/v1/validator/contribution_and_proofs$"), "publish_contributions"),
    ("GET", re.compile(r"^/eth/v1/validator/aggregate_attestation$"), "aggregate_att"),
    ("POST", re.compile(r"^/eth/v1/validator/aggregate_and_proofs$"), "publish_aggregates"),
    ("GET", re.compile(r"^/eth/v2/debug/beacon/states/(head|justified|finalized)$"), "debug_state"),
    ("GET", re.compile(r"^/eth/v2/beacon/blocks/(\w+|0x[0-9a-fA-F]{64})$"), "block"),
    ("GET", re.compile(r"^/eth/v1/beacon/light_client/bootstrap/(0x[0-9a-fA-F]{64})$"), "lc_bootstrap"),
    ("GET", re.compile(r"^/eth/v1/beacon/light_client/updates$"), "lc_updates"),
    ("GET", re.compile(r"^/eth/v1/beacon/light_client/optimistic_update$"), "lc_optimistic"),
    ("GET", re.compile(r"^/eth/v1/beacon/light_client/finality_update$"), "lc_finality"),
]

# Routes that mutate chain state and therefore serialize on the chain's
# mutation lock. Everything else reads immutable snapshots.
_MUTATING = {"publish_block", "publish_blinded", "publish_atts", "publish_sync", "publish_contributions", "publish_aggregates"}


def _make_handler(api: BeaconApiServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload, retry_after=None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if retry_after is not None:
                self.send_header("Retry-After", str(int(retry_after)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw.decode() or "{}")

        def _block_body(self):
            """Block publication body: JSON envelope, or raw SSZ when
            Content-Type is application/octet-stream with the fork named by
            Eth-Consensus-Version (the Beacon API's SSZ request flow)."""
            ctype = self.headers.get("Content-Type", "")
            if "octet-stream" in ctype:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                version = self.headers.get("Eth-Consensus-Version")
                body = {"data": "0x" + raw.hex()}
                if version:
                    body["version"] = version.lower()
                return body
            return self._body()

        def _stream_events(self, topics) -> None:
            """SSE stream (events.rs + eventsource): holds the connection
            and relays the chain's event bus until the client goes away."""
            import queue as _q

            sub = api.chain.subscribe_events(topics)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                while True:
                    try:
                        topic, payload = sub.get(timeout=1.0)
                    except _q.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    chunk = (
                        f"event: {topic}\ndata: {json.dumps(payload)}\n\n"
                    ).encode()
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                api.chain.unsubscribe_events(sub)

        def _dispatch(self, method: str) -> None:
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            try:
                for m, pat, name in _ROUTES:
                    if m != method:
                        continue
                    match = pat.match(u.path)
                    if not match:
                        continue
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    mon = api.load_monitor
                    if (
                        mon is not None
                        and not is_p0_route(name)
                        and mon.level() is AdmissionLevel.SATURATED
                    ):
                        # P1 load is refused while saturated so duty-path
                        # (P0) requests keep their latency budget
                        SHED_REQUESTS.inc(surface="http_api", priority="p1")
                        self._reply(
                            503,
                            {"message": "node overloaded, retry later"},
                            retry_after=mon.retry_after_s(),
                        )
                        return
                    if name == "events":
                        topics = [
                            t for t in q.get("topics", "head").split(",") if t
                        ]
                        self._stream_events(topics)
                        return
                    if name == "health":
                        self._reply(api.node_health_code(), {})
                        return
                    if name in _MUTATING:
                        # Only mutation routes serialize on the chain lock;
                        # reads work from the atomically-swapped head snapshot
                        # (Lighthouse's cached head view, canonical_head.rs
                        # :474-497), so duties stay responsive while a block
                        # import runs BLS verification.
                        with api._chain_lock:
                            out = self._route(name, match, q)
                    else:
                        out = self._route(name, match, q)
                    enveloped = name not in ("produce_block", "produce_blinded")
                    self._reply(200, {"data": out} if enveloped else out)
                    return
                self._reply(404, {"message": f"no route {u.path}"})
            except ApiError as e:
                self._reply(e.code, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 — API boundary
                self._reply(500, {"message": f"{type(e).__name__}: {e}"})

        def _route(self, name: str, match, q):
            if name == "genesis":
                return api.get_genesis()
            if name == "fork":
                return api.get_fork(match.group(1))
            if name == "finality":
                return api.get_finality_checkpoints(match.group(1))
            if name == "validators":
                return api.get_validators(match.group(1), q.get("id"))
            if name == "syncing":
                return api.get_syncing()
            if name == "version":
                from .. import __version__

                return {"version": f"lighthouse_tpu_torch/{__version__}"}
            if name == "proposer":
                return api.get_proposer_duties(int(match.group(1)))
            if name == "attester":
                return api.get_attester_duties(
                    int(match.group(1)), [int(x) for x in self._body()]
                )
            if name == "att_data":
                return api.get_attestation_data(
                    int(q["slot"]), int(q.get("committee_index", 0))
                )
            if name == "produce_block":
                return api.produce_block(
                    int(match.group(1)),
                    _unhex(q["randao_reveal"]),
                    _unhex(q["graffiti"]) if "graffiti" in q else b"",
                )
            if name == "publish_block":
                return api.publish_block(self._block_body())
            if name == "publish_blinded":
                return api.publish_blinded_block(self._block_body())
            if name == "produce_blinded":
                return api.produce_blinded_block(
                    int(match.group(1)),
                    _unhex(q["randao_reveal"]),
                    _unhex(q["graffiti"]) if "graffiti" in q else b"",
                )
            if name == "publish_atts":
                return api.publish_attestations(self._body())
            if name == "header":
                return api.get_header(match.group(1))
            if name == "block_root":
                return api.get_block_root(match.group(1))
            if name == "validator":
                return api.get_validator(match.group(1), match.group(2))
            if name == "validator_balances":
                return api.get_validator_balances(match.group(1), q.get("id"))
            if name == "committees":
                return api.get_committees(match.group(1), q)
            if name == "randao":
                return api.get_randao(match.group(1), q)
            if name == "blob_sidecars":
                return api.get_blob_sidecars(match.group(1), q)
            if name == "identity":
                return api.get_node_identity()
            if name == "peers":
                return api.get_node_peers()
            if name == "config_spec":
                return api.get_config_spec()
            if name == "fork_schedule":
                return api.get_fork_schedule()
            if name == "deposit_contract":
                return api.get_deposit_contract()
            if name == "pool_att_slashings":
                return api.get_pool_attester_slashings()
            if name == "post_att_slashing":
                return api.post_pool_attester_slashing(self._body())
            if name == "pool_prop_slashings":
                return api.get_pool_proposer_slashings()
            if name == "post_prop_slashing":
                return api.post_pool_proposer_slashing(self._body())
            if name == "pool_exits":
                return api.get_pool_voluntary_exits()
            if name == "post_exit":
                return api.post_pool_voluntary_exit(self._body())
            if name == "pool_bls_changes":
                return api.get_pool_bls_changes()
            if name == "post_bls_change":
                return api.post_pool_bls_change(self._body())
            if name == "lc_bootstrap":
                b = api.chain.light_client_cache.bootstrap(
                    _unhex(match.group(1))
                )
                if b is None:
                    raise ApiError(404, "bootstrap unavailable for root")
                return _hex(type(b).encode(b))
            if name == "lc_updates":
                start = int(q.get("start_period", 0))
                count = max(0, min(int(q.get("count", 1)), 128))
                ups = api.chain.light_client_cache.updates_by_range(
                    start, count
                )
                return [_hex(type(u).encode(u)) for u in ups]
            if name == "lc_optimistic":
                u = api.chain.light_client_cache.latest_optimistic
                if u is None:
                    raise ApiError(404, "no optimistic update yet")
                return _hex(type(u).encode(u))
            if name == "lc_finality":
                u = api.chain.light_client_cache.latest_finality
                if u is None:
                    raise ApiError(404, "no finality update yet")
                return _hex(type(u).encode(u))
            if name == "sync_duties":
                indices = [int(x) for x in self._body()]
                return api.get_sync_duties(int(match.group(1)), indices)
            if name == "publish_sync":
                return api.publish_sync_messages(self._body())
            if name == "publish_contributions":
                return api.publish_contributions(self._body())
            if name == "aggregate_att":
                return api.get_aggregate_attestation(
                    _unhex(q["attestation_data_root"])
                )
            if name == "publish_aggregates":
                return api.publish_aggregates(self._body())
            if name == "block":
                return api.get_block(match.group(1))
            if name == "debug_state":
                st = api._state(match.group(1))
                spec = api.chain.spec
                fork = spec.fork_name_at_slot(int(st.slot))
                state_cls = api.chain.ns.state_types[fork]
                return {"version": fork, "data": _hex(state_cls.encode(st))}
            if name == "liveness":
                epoch = int(match.group(1))
                indices = [int(x) for x in self._body()]
                live = api.chain.validator_liveness(epoch, indices)
                return [
                    {"index": str(i), "is_live": bool(l)}
                    for i, l in zip(indices, live)
                ]
            raise ApiError(500, f"unwired route {name}")

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    return Handler
