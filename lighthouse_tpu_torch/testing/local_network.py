"""LocalNetwork: N in-process beacon nodes over the loopback transport.

The port's copy of ``lighthouse_tpu/testing/local_network.py``, the twin of
Lighthouse's ``testing/simulator/src/local_network.rs:128`` + ``checks.rs``:
validators are partitioned across nodes, every slot the owning node proposes
and publishes the block over gossip, every node's validators attest over
gossip (feeding each node's op pool through the batched verification path),
and the checks assert finalization advances on ALL nodes.

Every node runs on the caller's ``device`` (None: CUDA, raising without
it) and verifies through the ``bls`` backend the caller selected; the
network picks neither. The slasher's window comes from ``slasher_config``
(the reference's 16-validator chunks and 64-epoch window when None).

Chaos harness: ``crash_node``/``restart_node`` plus the loopback
transport's seeded gossip loss and the device fault injector (plans
installed through ``resilience.inject.injector.install``) make a
deterministic multi-node churn scenario: N slots under injected device
faults, dropped gossip, and a node crash/restart, with liveness, zero
false verifies and the drop-rate SLO to assert.

Crash-point harness: with ``datadir=`` every node persists into
its own WAL-backed store, the ``mode=kill``/``mode=tear`` injection plans
can kill a node at any persistence barrier mid-slot (``run_slot`` plays the
OS: it catches ``InjectedCrash``, attributes it via the store's owner tag,
and hard-crashes exactly that node), and ``restart_node(i, from_disk=True)``
recovers chain + fork choice + op pool + slasher checkpoint from disk.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..beacon_chain.pubkey_cache import ValidatorPubkeyCache
from ..device import resolve_device
from ..network import BeaconNodeService, LoopbackTransport, Topic
from ..state_transition import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    get_current_epoch,
    process_slots,
)
from ..types.containers import AttestationData, Checkpoint, SigningData
from ..types.helpers import compute_signing_root, get_domain
from ..types.spec import ChainSpec
from ..ssz import uint64
from ..utils.slot_clock import ManualSlotClock
from .harness import StateHarness


class LocalNetwork:
    def __init__(self, spec: ChainSpec, n_nodes: int, n_validators: int,
                 transport: str = "loopback", slasher: bool = False,
                 datadir: str | None = None, sync_committee: bool = False,
                 *, device=None, slasher_config=None, batch_gossip: bool = False):
        assert n_validators % n_nodes == 0
        self.spec = spec
        self.device = resolve_device(device)
        self.slasher_config = slasher_config
        # each node's processor holds the gossip a duty phase delivers and
        # drains it after the phase, in batches of up to 64 (a busy node's
        # queue), instead of verifying every message as it arrives
        if batch_gossip and transport != "loopback":
            raise ValueError("batch_gossip holds the loopback bus's inline processors")
        self.batch_gossip = batch_gossip
        self.mode = transport
        self.slasher_enabled = slasher
        # opt-in sync-committee duties: each slot every node's
        # owned committee members sign the head root over gossip, so altair+
        # blocks carry REAL sync aggregates and the light-client server
        # caches produce updates. Off by default: it adds one aggregate
        # pairing per imported block to every scenario that doesn't need it.
        self.sync_committee = sync_committee
        # per-node datadirs (loopback mode): each node persists into its
        # own WAL-backed hot/cold store, making restart_node(from_disk=True)
        # — and the crash-point sweep killing nodes at persistence barriers
        # — possible. None keeps the seed's in-memory stores.
        self.datadir = datadir
        self.recovery_reports: list[dict] = []  # one per from-disk restart
        self.dead: set[int] = set()   # crashed node indices (chaos harness)
        self.missed_proposals = 0     # invalid-on-own-chain proposals skipped
        self._chaos_seen = False      # any crash/loss ever armed this run
        self.clock = ManualSlotClock(0)
        # one harness supplies genesis + deterministic keys; each node only
        # "owns" (signs with) its shard of the validator set
        self.harness = StateHarness(spec, n_validators)
        self.nodes: list[BeaconNodeService] = []
        self.boot = None
        per = n_validators // n_nodes
        self.owned: list[range] = []
        if transport == "loopback":
            self.transport = LoopbackTransport()
            # a recipient's barrier firing mid-delivery kills THAT node
            # only; the publisher's fan-out continues (kill -9 semantics)
            self.transport.on_injected_crash = self._on_injected_crash
            for i in range(n_nodes):
                svc = BeaconNodeService(
                    f"node_{i}",
                    spec,
                    self.harness.state.copy(),
                    self.transport,
                    slot_clock=self.clock,
                    execution_layer=self.harness.el,
                    chain=self._make_chain(i),
                    device=self.device,
                )
                self.nodes.append(svc)
                self.owned.append(range(i * per, (i + 1) * per))
            for svc in self.nodes:
                for peer in self.transport.peers(exclude=svc.node_id):
                    svc.connect(peer)
        elif transport == "sockets":
            # real TCP gossip/RPC + UDP boot-node discovery: the same node
            # stack over network.socket_transport
            import time as _time

            from ..network.boot_node import BootNode
            from ..network.gossipsub import GossipsubTransport

            self.boot = BootNode().start()
            for i in range(n_nodes):
                t = GossipsubTransport(spec)
                svc = BeaconNodeService(
                    t.local_addr,
                    spec,
                    self.harness.state.copy(),
                    t,
                    slot_clock=self.clock,
                    execution_layer=self.harness.el,
                    device=self.device,
                )
                t.discover(self.boot.local_addr)
                self.nodes.append(svc)
                self.owned.append(range(i * per, (i + 1) * per))
            # wait for the mesh to fully connect under CANONICAL addresses
            # (HELLO rekeys accept-side ephemeral entries), then handshake
            addrs = {n.node_id for n in self.nodes}
            deadline = _time.monotonic() + 10
            while _time.monotonic() < deadline:
                if all(
                    set(n.transport.peers()) == addrs - {n.node_id}
                    for n in self.nodes
                ):
                    break
                _time.sleep(0.01)
            for svc in self.nodes:
                for peer in svc.transport.peers():
                    svc.connect(peer)
        else:
            raise ValueError(f"unknown transport mode {transport!r}")
        if slasher:
            for svc in self.nodes:
                self._attach_slasher(svc)
        self._msg_total = 0  # messages published so far (settle accounting)
        # PeerDAS: armed by enable_peerdas(); slot -> blob plan
        self.cell_ctx = None
        self._peerdas_cfg = None
        self._blob_plan: dict[int, tuple[list, set[int]]] = {}

    def _make_store(self, i: int):
        """Per-node WAL-backed hot/cold store under ``datadir`` (or None).
        fsync stays off — the chaos harness tears writes at the WAL frame
        layer deterministically; it does not simulate power loss — and the
        ``owner`` tag lets ``InjectedCrash`` name the node that died."""
        if self.datadir is None:
            return None
        import os

        from ..store.hot_cold import HotColdDB, StoreConfig
        from ..store.kv import LevelStore

        d = os.path.join(self.datadir, f"node_{i}")
        return HotColdDB(
            hot=LevelStore(
                os.path.join(d, "chain.db"), fsync=False, owner=f"node_{i}"
            ),
            cold=LevelStore(
                os.path.join(d, "freezer.db"), fsync=False, owner=f"node_{i}"
            ),
            config=StoreConfig(),
        )

    def _make_chain(self, i: int):
        """A chain over the node's durable store, or None (the service
        builds its own in-memory chain — the seed behavior)."""
        store = self._make_store(i)
        if store is None:
            return None
        from ..beacon_chain.chain import BeaconChain

        return BeaconChain(
            self.spec,
            self.harness.state.copy(),
            store=store,
            slot_clock=self.clock,
            execution_layer=self.harness.el,
            pubkey_cache=ValidatorPubkeyCache(self.device),
        )

    def _attach_slasher(self, svc) -> None:
        """Per-node slasher service on the chain's ingest seams: every
        gossip-verified attestation and every imported block (gossip AND
        range sync) flows into the engine; ``run_slot`` ticks it so found
        slashings drain into the node's op pool and ride the next proposal
        (the full gossip -> slasher -> op_pool -> block-inclusion loop).
        With per-node datadirs the engine checkpoints into the node's hot
        store each tick and ``make_slasher`` restores the checkpoint on a
        from-disk restart — pre-restart votes still convict."""
        from ..slasher import SlasherConfig, SlasherService, make_slasher

        sl = make_slasher(
            svc.chain.store.hot if self.datadir is not None else None,
            svc.chain.ns,
            self.slasher_config
            or SlasherConfig(validator_chunk_size=16, history_length=64),
        )
        svc.slasher_service = SlasherService(svc.chain, sl, svc.op_pool)
        svc.chain.block_observers.append(svc.slasher_service.block_observed)
        svc.chain.attestation_observers.append(
            svc.slasher_service.attestation_observed
        )

    def settle(self, timeout: float = 5.0) -> None:
        """Wait until every node has RECEIVED and PROCESSED every message
        published so far (socket mode; loopback is synchronous). Exact
        accounting: each node's gossip dedup cache must hold all published
        message ids, and its processor must be idle."""
        if self.mode == "loopback":
            return
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if all(
                n.transport.delivered + n.transport.published
                >= self._msg_total
                for n in self.nodes
            ):
                return
            _time.sleep(0.005)
        raise TimeoutError(
            f"gossip did not settle: want {self._msg_total}, have "
            f"{[(n.transport.delivered, n.transport.published) for n in self.nodes]}"
        )

    def stop(self) -> None:
        if self.mode == "sockets":
            for n in self.nodes:
                n.stop()
            if self.boot is not None:
                self.boot.stop()

    def _owner_of(self, validator_index: int) -> BeaconNodeService:
        return self.nodes[self._owner_index(validator_index)]

    def _owner_index(self, validator_index: int) -> int:
        for i, rng in enumerate(self.owned):
            if validator_index in rng:
                return i
        raise ValueError(validator_index)

    def _chaos_active(self) -> bool:
        """Has any chaos mechanism ever been armed (crash or gossip loss)?
        Non-chaos runs keep strict semantics: a proposal its own node
        rejects is a test failure, never a silently missed slot."""
        # sockets mode has per-node transports and no shared self.transport
        shared = getattr(self, "transport", None)
        return (
            self._chaos_seen
            or bool(self.dead)
            or getattr(shared, "_loss_rate", 0.0) > 0
        )

    def _alive_ref(self) -> BeaconNodeService:
        for i, node in enumerate(self.nodes):
            if i not in self.dead:
                return node
        raise RuntimeError("every node is crashed")

    # -- chaos harness (crash / restart; loopback mode) --------------------

    def crash_node(self, i: int) -> None:
        """Hard-crash node ``i``: unregister it from the transport (no more
        gossip/RPC in either direction). Its validators stop attesting and
        its proposal slots are simply missed — the liveness the chaos
        scenario asserts must survive that."""
        assert self.mode == "loopback", "crash/restart drives the loopback sim"
        node = self.nodes[i]
        self.transport.unregister(node.node_id)
        self.dead.add(i)
        self._chaos_seen = True

    def reconnect_all(self) -> None:
        """Status-handshake every live pair (the chaos epilogue): a
        straggler that missed tip blocks under gossip loss range-syncs
        back to the canonical head."""
        for i, svc in enumerate(self.nodes):
            if i in self.dead:
                continue
            for peer in self.transport.peers(exclude=svc.node_id):
                try:
                    svc.connect(peer)
                except ConnectionError:
                    pass

    def restart_node(self, i: int, from_disk: bool = False) -> None:
        """Restart node ``i`` under the same id and status-handshake every
        live peer.

        ``from_disk=False``: restart from genesis state (the datadir-wiped
        worst case) — range sync walks it back to the head, exactly the
        partitioned-node recovery path.

        ``from_disk=True`` (needs ``datadir``): reopen the node's stores —
        WAL replay truncates any torn tail — and rebuild chain + fork
        choice + op pool (+ the slasher checkpoint via ``_attach_slasher``)
        through ``beacon_chain.recovery``: the node comes back AT its last
        persisted head, no range sync from genesis. The recovery report is
        appended to ``self.recovery_reports``."""
        assert i in self.dead, f"node {i} is not crashed"
        if from_disk:
            assert self.datadir is not None, "from_disk needs datadirs"
            old_store = self.nodes[i].chain.store
            for kv in (old_store.hot, old_store.cold):
                try:
                    kv.close()  # release the dead process's file handles
                except Exception:  # noqa: BLE001 — already torn/closed
                    pass
            from ..beacon_chain.recovery import recover_node_state

            chain, op_pool, report = recover_node_state(
                self.spec,
                self.harness.state.copy(),
                self._make_store(i),
                slot_clock=self.clock,
                execution_layer=self.harness.el,
                pubkey_cache=ValidatorPubkeyCache(self.device),
            )
            self.recovery_reports.append(report)
            svc = BeaconNodeService(
                f"node_{i}",
                self.spec,
                transport=self.transport,
                chain=chain,
                op_pool=op_pool,
                device=self.device,
            )
        else:
            # genesis restart deliberately ignores any datadir (it models
            # the wiped-disk case): in-memory stores, range sync rebuilds
            svc = BeaconNodeService(
                f"node_{i}",
                self.spec,
                self.harness.state.copy(),
                self.transport,
                slot_clock=self.clock,
                execution_layer=self.harness.el,
                device=self.device,
            )
        self.nodes[i] = svc
        self.dead.discard(i)
        if self.slasher_enabled:
            self._attach_slasher(svc)
        if self._peerdas_cfg is not None:
            # same node id digest => same custody set as before the crash
            self._enable_peerdas_on(svc)
        for peer in self.transport.peers(exclude=svc.node_id):
            try:
                svc.connect(peer)
            except ConnectionError:
                pass

    # -- PeerDAS -----------------------------------------------------------

    def enable_peerdas(self, cell_ctx, custody_count: int | None = None,
                       samples_per_slot: int | None = None) -> None:
        """Arm column sampling on every node: each gets a deterministic
        node-id digest (so custody sets differ per node but are stable
        across restarts) and blob-carrying proposals gate availability on
        the sampler's custody + sampled columns."""
        assert self.mode == "loopback", "peerdas churn drives the loopback sim"
        self.cell_ctx = cell_ctx
        self._peerdas_cfg = (cell_ctx, custody_count, samples_per_slot)
        for svc in self.nodes:
            self._enable_peerdas_on(svc)

    def _enable_peerdas_on(self, svc) -> None:
        ctx, custody, samples = self._peerdas_cfg
        svc.chain.enable_peerdas(
            ctx,
            hashlib.sha256(svc.node_id.encode()).digest(),
            custody_count=custody,
            samples_per_slot=samples,
        )

    def schedule_blobs(self, slot: int, blobs: list,
                       withhold: set[int] | None = None) -> None:
        """The proposal at ``slot`` carries ``blobs`` as KZG commitments;
        columns whose index is in ``withhold`` are never built onto the
        wire (the withholding-attack scenario — the block must stay
        unavailable everywhere unless reconstruction can cover them)."""
        self._blob_plan[int(slot)] = (list(blobs), set(withhold or ()))

    def retry_columns(self, block_root: bytes) -> None:
        """Sampler retry tick: every live node with missing required
        columns re-fetches them over by-root RPC from each live peer (the
        gossip-loss repair path; reconstruction kicks in inside the
        availability check once >= 50% of columns are held)."""
        for i, svc in enumerate(self.nodes):
            if i in self.dead or svc.chain.peerdas is None:
                continue
            if not svc.chain.peerdas.missing_columns(block_root):
                self._guarded(svc._try_column_availability, block_root)
                continue
            for j, peer in enumerate(self.nodes):
                if j == i or j in self.dead:
                    continue
                self._guarded(
                    svc._fetch_missing_columns, block_root, peer.node_id
                )
                if not svc.chain.peerdas.missing_columns(block_root):
                    break

    # -- per-slot duties ---------------------------------------------------

    def _propose(self, slot: int) -> None:
        spec = self.spec
        # duty lookup on any live node's head (all agree or sync catches up)
        ref = self._alive_ref().chain
        state = ref.head.state.copy()
        if state.slot < slot:
            process_slots(spec, state, slot)
        proposer = get_beacon_proposer_index(spec, state)
        if self._owner_index(proposer) in self.dead:
            return  # a crashed node misses its proposal slot
        node = self._owner_of(proposer)

        chain = node.chain
        epoch = get_current_epoch(spec, state)
        domain_r = get_domain(spec, state, spec.DOMAIN_RANDAO, epoch=epoch)
        randao_root = SigningData(
            object_root=uint64.hash_tree_root(epoch), domain=domain_r
        ).tree_root()
        reveal = self.harness._sign(proposer, randao_root)
        atts = node.op_pool.get_attestations(state)
        # op_pool rides along so pooled slashing evidence (the slasher
        # service drains into it each slot) is included in the block
        block, _post = chain.produce_block_on_state(
            chain.head.state, slot, reveal, attestations=atts,
            op_pool=node.op_pool,
        )
        plan = self._blob_plan.get(slot)
        if plan is not None and self.cell_ctx is not None:
            # blob-carrying proposal: graft the commitments onto the
            # produced body, then recompute state_root against the SAME
            # pre-state the block was built on (the harness's genesis-based
            # resign recipe would miss every imported block)
            blobs, _withhold = plan
            block.body.blob_kzg_commitments = [
                self.cell_ctx.kzg.blob_to_kzg_commitment(b) for b in blobs
            ]
            from ..state_transition import (
                BlockSignatureStrategy,
                per_block_processing,
            )

            fork = spec.fork_name_at_epoch(epoch)
            block_cls = node.chain.ns.block_types[fork]
            trial = chain.head.state.copy()
            if trial.slot < slot:
                process_slots(spec, trial, slot)
            block.state_root = b"\x00" * 32
            per_block_processing(
                spec, trial, block_cls(message=block, signature=b"\x00" * 96),
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
                verify_block_root=False,
            )
            block.state_root = trial.tree_root()
        fork = spec.fork_name_at_epoch(epoch)
        block_cls = node.chain.ns.block_types[fork]
        domain_b = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
        sig = self.harness._sign(proposer, compute_signing_root(block, domain_b))
        signed = block_cls(message=block, signature=sig)
        from ..beacon_chain.chain import BlockPendingAvailability

        try:
            node.chain.process_block(signed)
        except BlockPendingAvailability:
            pass  # parked: imports once the proposer's own columns land
        except Exception:  # noqa: BLE001 — chaos realism: a proposer
            # whose head/pool diverged under gossip loss builds a block
            # its own chain rejects; a real network misses that slot
            if not self._chaos_active():
                raise
            self.missed_proposals += 1
            return
        node.publish_block(signed)
        self._msg_total += 1
        if plan is not None and self.cell_ctx is not None:
            self._publish_columns(node, signed, plan)

    def _publish_columns(self, node, signed, plan) -> None:
        """Build the proposal's column sidecars and fan them out. The
        loopback bus excludes the publisher, so the proposer self-ingests
        each column through the same verified gossip path; withheld
        indices never reach the wire at all."""
        from ..beacon_chain.data_columns import make_data_column_sidecars

        blobs, withhold = plan
        columns = make_data_column_sidecars(
            node.chain.ns, signed, blobs, self.cell_ctx
        )
        for sc in columns:
            if int(sc.index) in withhold:
                continue
            self._guarded(node.process_gossip_data_column, sc)
            node.publish_data_column(sc)
            self._msg_total += 1
        # straggler repair + availability re-check on every live node
        self.retry_columns(signed.message.tree_root())

    def _attest(self, slot: int) -> None:
        # per-node guard: one attester dying at its own barrier must not
        # cost the OTHER nodes their attestations for the slot
        for i, (node, owned) in enumerate(zip(self.nodes, self.owned)):
            if i in self.dead:
                continue
            self._guarded(self._attest_node, node, owned, slot)

    def _attest_node(self, node, owned, slot: int) -> None:
        spec = self.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        state = node.chain.head.state
        if state.slot < slot:
            state = state.copy()
            process_slots(spec, state, slot)
        head_root = node.chain.head.root
        target_root = (
            head_root
            if slot == spec.start_slot(epoch)
            else _block_root_at(spec, state, spec.start_slot(epoch))
        )
        domain = get_domain(
            spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch
        )
        for index in range(get_committee_count_per_slot(spec, state, epoch)):
            committee = get_beacon_committee(spec, state, slot, index)
            data = AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            root = compute_signing_root(data, domain)
            for pos, v in enumerate(committee):
                if int(v) not in owned:
                    continue
                bits = np.zeros(committee.size, dtype=bool)
                bits[pos] = True
                att = node.chain.ns.Attestation(
                    aggregation_bits=bits,
                    data=data,
                    signature=self.harness._sign(int(v), root),
                )
                node.op_pool.insert_attestation(att)
                node.publish_attestation(att)
                self._msg_total += 1

    def _sync_sign(self, slot: int) -> None:
        # per-node guard, like _attest: one signer dying at its own barrier
        # must not cost the other nodes their sync messages for the slot
        for i, (node, owned) in enumerate(zip(self.nodes, self.owned)):
            if i in self.dead:
                continue
            self._guarded(self._sync_sign_node, node, owned, slot)

    def _sync_sign_node(self, node, owned, slot: int) -> None:
        """Sync-committee duties for ``node``'s owned validators: one
        SyncCommitteeMessage per owned committee member over the node's own
        head root, self-ingested (the loopback bus excludes the publisher)
        and published. The NEXT slot's proposer pools them into its block's
        sync aggregate (``produce_block_on_state`` reads slot-1)."""
        from ..types.helpers import sync_committee_signing_root

        state = node.chain.head.state
        if not hasattr(state, "current_sync_committee"):
            return  # pre-altair: no sync committees yet
        head_root = node.chain.head.root
        root = sync_committee_signing_root(self.spec, state, slot, head_root)
        pk_to_idx = {
            bytes(v.pubkey): i for i, v in enumerate(state.validators)
        }
        msgs, seen = [], set()
        for pk in state.current_sync_committee.pubkeys:
            v = pk_to_idx[bytes(pk)]
            # one message per validator: the pool expands every committee
            # position a duplicated member occupies from the single message
            if v not in owned or v in seen:
                continue
            seen.add(v)
            msgs.append(
                node.chain.ns.SyncCommitteeMessage(
                    slot=slot,
                    beacon_block_root=head_root,
                    validator_index=v,
                    signature=self.harness._sign(v, root),
                )
            )
        if not msgs:
            return
        if self.batch_gossip:
            # through the node's held processor: its own messages join the
            # batch its peers' messages form
            for m in msgs:
                node.on_gossip(Topic.SYNC_COMMITTEE_MESSAGE, m, node.node_id)
        else:
            node.process_gossip_sync_message_batch(msgs)
        for m in msgs:
            node.publish_sync_message(m)
            self._msg_total += 1

    # -- crash-point attribution -------------------------------------------

    def _on_injected_crash(self, exc) -> int:
        """An ``InjectedCrash`` surfaced mid-slot: the "operating system"
        half of the harness. The owner tag (set on each node's WAL stores)
        names the node whose persistence barrier fired; that node is
        hard-crashed and the slot continues for everyone else."""
        owner = getattr(exc, "owner", None)
        if not owner or not owner.startswith("node_"):
            raise exc  # unattributable: not a per-node store barrier
        i = int(owner.split("_", 1)[1])
        if i not in self.dead:
            self.crash_node(i)
        return i

    def _guarded(self, fn, *args) -> None:
        from ..resilience.crashpoints import InjectedCrash

        try:
            fn(*args)
        except InjectedCrash as e:
            self._on_injected_crash(e)

    def _persist_pools(self) -> None:
        """Durable-datadir cadence: each live node checkpoints its op pool
        once per slot (the ``persist.op_pool`` barrier; fork choice and the
        block/state batch persist inside the import path itself)."""
        from ..op_pool import persistence as pool_persist

        for i, node in enumerate(self.nodes):
            if i not in self.dead:
                # per-node guard: node i dying at its op-pool barrier must
                # not skip the checkpoint of the nodes after it
                self._guarded(
                    pool_persist.persist, node.chain.store, node.op_pool
                )

    def _duty_phase(self, duty, slot: int) -> None:
        """Run ``_attest`` or ``_sync_sign`` for ``slot``; under
        ``batch_gossip`` with every live node's processor held until the
        phase ends, then drained (one device verify call a batch)."""
        if not self.batch_gossip:
            duty(slot)
            return
        held = [i for i in range(len(self.nodes)) if i not in self.dead]
        for i in held:
            self.nodes[i].processor.synchronous = False
        try:
            duty(slot)
        finally:
            for i in held:
                self.nodes[i].processor.synchronous = True
        for i in held:
            if i not in self.dead:
                self._guarded(self.nodes[i].processor.run_until_idle)

    def run_slot(self, slot: int) -> None:
        self.clock.set_slot(slot)
        self._guarded(self._propose, slot)
        self.settle()
        if self.sync_committee:
            self._duty_phase(self._sync_sign, slot)  # guards per node internally
            self.settle()
        self._duty_phase(self._attest, slot)  # guards per node internally
        self.settle()
        if self.slasher_enabled:
            epoch = slot // self.spec.preset.SLOTS_PER_EPOCH
            for i, node in enumerate(self.nodes):
                svc = getattr(node, "slasher_service", None)
                if i not in self.dead and svc is not None:
                    self._guarded(svc.tick, epoch)
        if self.datadir is not None:
            self._persist_pools()  # guards per node internally

    def run_until(self, last_slot: int, start: int = 1) -> None:
        for slot in range(start, last_slot + 1):
            self.run_slot(slot)

    # -- checks (simulator/src/checks.rs) ----------------------------------

    def head_slots(self) -> list[int]:
        return [n.chain.head.slot for n in self.nodes]

    def finalized_epochs(self) -> list[int]:
        return [
            int(n.chain.head.state.finalized_checkpoint.epoch)
            for n in self.nodes
        ]

    def heads_agree(self) -> bool:
        # crashed nodes are excluded: their head is frozen by definition
        roots = {
            n.chain.head.root
            for i, n in enumerate(self.nodes)
            if i not in self.dead
        }
        return len(roots) == 1


def _block_root_at(spec, state, slot: int) -> bytes:
    from ..state_transition import get_block_root_at_slot

    return get_block_root_at_slot(spec, state, slot)
