"""Beacon-node client assembly (Lighthouse's beacon_node/client/src/builder.rs
and beacon_node/src/lib.rs ProductionBeaconNode): the port's copy of
``lighthouse_tpu/client/__init__.py``.

``ClientBuilder`` chains the same construction steps the reference does —
chain, processor, network service, HTTP API, metrics, slasher, notifier —
and ``Client`` owns their lifecycles. ``ClientConfig.device`` places the
node: the builder puts the ``bls``, ``epoch_engine``, ``kzg`` and
``slasher`` backends, the chain's pubkey cache and the network service on
it (None means CUDA, raising without it — a node never drops to the CPU on
its own). Discovery by ENR (``boot_enrs``) is not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..device import resolve_device
from ..store.hot_cold import HotColdDB, StoreConfig
from ..store.kv import LevelStore
from ..types.spec import ChainSpec
from ..utils.logging import get_logger, init_logging
from ..utils.slot_clock import ManualSlotClock, SystemTimeSlotClock
from .notifier import Notifier

log = get_logger("client")


@dataclass
class ClientConfig:
    datadir: str | None = None  # None = in-memory stores
    http_enabled: bool = True
    http_port: int = 0  # 0 = ephemeral
    metrics_enabled: bool = False
    metrics_port: int = 0
    slasher_enabled: bool = False
    validator_monitor_auto: bool = False
    validator_monitor_indices: tuple = ()
    interop_validators: int = 16
    genesis_time: int | None = None  # None = now
    debug_level: str = "info"
    use_system_clock: bool = True
    listen_port: int | None = None  # TCP gossip/RPC listener (None = no p2p)
    boot_nodes: str = ""  # comma-separated UDP boot-node addresses
    boot_enrs: str = ""   # comma-separated hex ENRs (discv5-style discovery)
    device: str | None = None  # where the node runs; None = CUDA
    # the BLS serving mesh (bls.set_backend(mesh_devices=)); None = no mesh
    mesh_devices: tuple | list | None = None


class Client:
    def __init__(self, chain, op_pool, http_server, metrics_server,
                 slasher_service, notifier, network_service=None):
        self.chain = chain
        self.op_pool = op_pool
        self.http_server = http_server
        self.metrics_server = metrics_server
        self.slasher_service = slasher_service
        self.notifier = notifier
        self.network_service = network_service
        self._shutdown = threading.Event()
        self._threads: list[threading.Thread] = []
        self.warmup_thread: threading.Thread | None = None
        # {"backend", "healthy", "seconds"} once the warm-up has run
        self.warmup_result: dict | None = None

    def start(self) -> "Client":
        if self.http_server is not None:
            self.http_server.start()
            log.info("Beacon API started", url=self.http_server.url)
        if self.metrics_server is not None:
            self.metrics_server.start()
            log.info("Metrics server started", url=self.metrics_server.url)
        if self.notifier is not None:
            self.notifier.start()
        if self.slasher_service is not None:
            self._slasher_ticker = threading.Thread(
                target=self._run_slasher_ticks, daemon=True,
                name="slasher-tick",
            )
            self._slasher_ticker.start()
            self._threads.append(self._slasher_ticker)
        if self.chain.eth1_service is not None:
            th = threading.Thread(
                target=self._run_eth1_polls, daemon=True, name="eth1-poll"
            )
            th.start()
            self._threads.append(th)
        # stop() does not join the warm-up (one best-effort kernel build and
        # batch); a caller that needs it finished calls wait_for_warmup()
        self.warmup_thread = threading.Thread(
            target=self._warmup_bls, daemon=True, name="bls-warmup"
        )
        self.warmup_thread.start()
        return self

    def wait_for_warmup(self, timeout: float | None = None) -> dict | None:
        """Join the warm-up thread; its result (None if it has not ended)."""
        if self.warmup_thread is not None:
            self.warmup_thread.join(timeout)
        return self.warmup_result

    def _run_slasher_ticks(self) -> None:
        """Per-slot slasher batch processing (the reference's timer task at
        slot_offset into each slot, slasher/service/src/service.rs)."""
        sps = self.chain.spec.preset.SECONDS_PER_SLOT
        while not self._shutdown.wait(sps):
            try:
                self.slasher_service.tick()
            except Exception as e:  # noqa: BLE001 — keep the timer alive
                log.warning("Slasher tick failed", error=str(e))

    def _run_eth1_polls(self) -> None:
        """Periodic eth1 follow poll (eth1/src/service.rs update interval)."""
        sps = self.chain.spec.preset.SECONDS_PER_SLOT
        while not self._shutdown.wait(sps):
            try:
                self.chain.eth1_service.update()
            except Exception as e:  # noqa: BLE001 — keep polling
                log.warn("Eth1 poll failed", error=str(e))

    def _warmup_bls(self) -> None:
        """Build the verification kernels and derive their schedules off the
        serving path, so the first block publish doesn't pay for them inside
        an HTTP request: ``bls.warmup`` plus one indexed batch against the
        chain's resident pubkey cache (its verdict is not the point)."""
        from .. import bls

        try:
            t0 = time.monotonic()
            dev = bls.get_device()
            ok = bls.warmup(device=dev)
            if bls.get_backend() == "device":
                import hashlib

                from ..bls import backend

                root = hashlib.sha256(b"lighthouse-tpu-warmup").digest()
                sk = bls.SecretKey.from_bytes((7).to_bytes(32, "big"))
                sig = sk.sign(root).serialize()
                cache = self.chain.pubkey_cache.device_array()
                backend.verify_indexed_sets_device(
                    cache, [([0], root, sig)], device=cache.device
                )
            self.warmup_result = {
                "backend": bls.get_backend(),
                "healthy": ok,
                "seconds": round(time.monotonic() - t0, 1),
            }
            log.info("BLS backend warm", **self.warmup_result)
        except Exception as e:  # noqa: BLE001 — warmup is best-effort
            self.warmup_result = {"backend": bls.get_backend(),
                                  "healthy": False, "error": str(e)}
            log.warning("BLS warmup failed", error=str(e))

    def stop(self) -> None:
        self._shutdown.set()
        for th in self._threads:
            # the periodic loops wake from their interval wait the moment
            # the shutdown event sets, so these joins return in ms
            th.join(timeout=2.0)
        if self.notifier is not None:
            self.notifier.stop()
        if self.http_server is not None:
            self.http_server.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if self.network_service is not None:
            self.network_service.stop()
        # persist fork choice + op pool + slasher for the next boot
        # (persisted_fork_choice.rs / operation_pool persistence.rs) —
        # through the same crash-point barriers the import path uses
        try:
            from ..op_pool import persistence as pool_persist

            self.chain.persist_fork_choice()
            pool_persist.persist(self.chain.store, self.op_pool)
            if self.slasher_service is not None:
                persist = getattr(self.slasher_service.slasher, "persist", None)
                if persist is not None:
                    persist()
        except Exception as e:  # noqa: BLE001 — shutdown must not fail
            log.warn("Persistence on shutdown failed", error=str(e))

    def wait_for_shutdown(self) -> None:
        """Block until stop() or KeyboardInterrupt (Environment's shutdown
        channel, common/task_executor/src/lib.rs:205)."""
        try:
            while not self._shutdown.wait(0.5):
                pass
        except KeyboardInterrupt:
            log.info("Shutting down", reason="interrupt")
            self.stop()


class ClientBuilder:
    def __init__(self, spec: ChainSpec, config: ClientConfig | None = None):
        self.spec = spec
        self.config = config or ClientConfig()
        self._genesis_state = None
        self._slot_clock = None
        self._eth1 = None

    def interop_genesis(self) -> "ClientBuilder":
        from ..state_transition.genesis import interop_genesis_state

        genesis_time = (
            int(time.time())
            if self.config.genesis_time is None
            else self.config.genesis_time
        )
        self._genesis_state = interop_genesis_state(
            self.spec, self.config.interop_validators, genesis_time
        )
        return self

    def genesis_state(self, state) -> "ClientBuilder":
        """Boot from a provided state (the checkpoint-sync seam:
        client/src/builder.rs genesis-state branch)."""
        self._genesis_state = state
        return self

    def checkpoint_sync(self, url: str, state_id: str = "finalized") -> "ClientBuilder":
        """Fetch a trusted finalized state over HTTP and anchor the chain on
        it (client/src/builder.rs checkpoint-sync genesis branch; history is
        filled backwards by sync, not required to serve)."""
        from ..api_client import BeaconNodeHttpClient
        from ..types.containers import for_preset

        version, raw = BeaconNodeHttpClient(url).get_state_ssz(state_id)
        ns = for_preset(self.spec.preset.name)
        state = ns.state_types[version].decode(raw)
        log.info(
            "Checkpoint state fetched",
            url=url, slot=int(state.slot), fork=version,
        )
        self._genesis_state = state
        return self

    def eth1_service(self, service) -> "ClientBuilder":
        """Attach a deposit/eth1-data bridge (eth1/Eth1Service)."""
        self._eth1 = service
        return self

    def slot_clock(self, clock) -> "ClientBuilder":
        self._slot_clock = clock
        return self

    GENESIS_TIME_KEY = b"genesis_time_v1"

    def build(self) -> Client:
        cfg = self.config
        init_logging(cfg.debug_level)
        dev = resolve_device(cfg.device)
        _place_backends(dev, cfg.mesh_devices)

        if cfg.datadir:
            import os

            os.makedirs(cfg.datadir, exist_ok=True)
            # the production node fsyncs every WAL commit (power-loss
            # durability); the test/simulation tier leaves fsync off
            store = HotColdDB(
                hot=LevelStore(
                    os.path.join(cfg.datadir, "chain.db"), fsync=True
                ),
                cold=LevelStore(
                    os.path.join(cfg.datadir, "freezer.db"), fsync=True
                ),
                config=StoreConfig(),
            )
        else:
            store = HotColdDB()

        if self._genesis_state is None:
            # an interop genesis must be the SAME one across restarts —
            # time.time() at each boot makes the datadir's whole chain
            # foreign to the new anchor and recovery silently degrades to
            # genesis. The first boot records its genesis time; later
            # boots re-derive the identical deterministic genesis from it.
            stored = store.get_meta(self.GENESIS_TIME_KEY)
            if stored is not None and self.config.genesis_time is None:
                self.config.genesis_time = int(stored.decode())
            self.interop_genesis()
            if cfg.datadir and stored is None:
                store.put_meta(
                    self.GENESIS_TIME_KEY,
                    str(int(self._genesis_state.genesis_time)).encode(),
                )
        state = self._genesis_state

        clock = self._slot_clock
        if clock is None:
            clock = (
                SystemTimeSlotClock(
                    int(state.genesis_time), self.spec.preset.SECONDS_PER_SLOT
                )
                if cfg.use_system_clock
                else ManualSlotClock(0)
            )
        # the restart-from-disk path (beacon_chain/recovery.py): WAL replay
        # already ran inside the LevelStore opens; recovery adopts the
        # persisted fork choice (head + weights + finality) and rehydrates
        # the op pool — a fresh in-memory boot degrades to the same call
        # with empty stores
        from ..beacon_chain import ValidatorPubkeyCache
        from ..beacon_chain.recovery import recover_node_state

        # interop nodes have no real engine-API endpoint; once bellatrix is
        # scheduled, block production needs SOME execution layer or every
        # post-merge proposal dies on "payload parent hash mismatch" (the
        # default payload stands in pre-merge only). The reference's interop
        # mode runs its mock_execution_layer for the same reason — the mock's
        # genesis block hash is what interop_genesis_state anchors the
        # payload-header chain on.
        execution_layer = None
        from ..types.spec import FAR_FUTURE_EPOCH

        if self.spec.bellatrix_fork_epoch != FAR_FUTURE_EPOCH:
            from ..execution_layer.mock import MockExecutionLayer

            execution_layer = MockExecutionLayer()
        chain, op_pool, recovered = recover_node_state(
            self.spec, state, store, slot_clock=clock,
            execution_layer=execution_layer,
            pubkey_cache=ValidatorPubkeyCache(dev),
        )
        if self._eth1 is not None:
            chain.eth1_service = self._eth1
        if recovered["fork_choice_restored"]:
            log.info(
                "Fork choice restored",
                nodes=recovered["fc_nodes"],
                head=chain.head.root.hex()[:10],
            )
        if recovered["pool_restored"]:
            log.info("Op pool restored", attestations=recovered["pool_restored"])

        network_service = None
        if cfg.listen_port is not None:
            from ..network import BeaconNodeService, GossipsubTransport

            discovery = None
            boot_enrs = [b.strip() for b in cfg.boot_enrs.split(",") if b.strip()]
            if boot_enrs:
                from ..network.discovery import DiscoveryService
                from ..types.helpers import compute_fork_digest

                st = chain.head.state
                digest = compute_fork_digest(
                    bytes(st.fork.current_version),
                    bytes(st.genesis_validators_root),
                )
                discovery = DiscoveryService(fork_digest=digest).start()
            transport = GossipsubTransport(
                self.spec, port=cfg.listen_port, discovery=discovery
            )
            network_service = BeaconNodeService(
                transport.local_addr, self.spec, transport=transport,
                chain=chain, op_pool=op_pool, device=dev,
            )
            if discovery is not None:
                from ..network.discovery import ENR

                for hexenr in boot_enrs:
                    try:
                        enr, _ = ENR.decode(bytes.fromhex(hexenr))
                        discovery.bootstrap(enr)
                    except (ValueError, OSError) as e:
                        log.warn("Bad boot ENR", error=str(e))
                transport.discover_enr()
                log.info(
                    "ENR discovery active",
                    enr=discovery.enr.encode().hex(),
                    known=len(discovery.table),
                )
            for boot in [b.strip() for b in cfg.boot_nodes.split(",") if b.strip()]:
                try:
                    transport.discover(boot)
                except OSError as e:
                    log.warn("Boot node unreachable", addr=boot, error=str(e))
            for peer in transport.peers():
                try:
                    network_service.connect(peer)
                except ConnectionError as e:
                    log.warn("Peer handshake failed", peer=peer, error=str(e))
            log.info(
                "P2P listening", addr=transport.local_addr,
                peers=len(transport.peers()),
            )

        http_server = None
        if cfg.http_enabled:
            from ..http_api import BeaconApiServer

            http_server = BeaconApiServer(
                chain, op_pool=op_pool, port=cfg.http_port,
                network_service=network_service,
                load_monitor=getattr(
                    network_service, "load_monitor", None
                ),
            )

        metrics_server = None
        if cfg.metrics_enabled:
            from ..http_metrics import MetricsServer

            metrics_server = MetricsServer(
                port=cfg.metrics_port, datadir=cfg.datadir
            )

        slasher_service = None
        if cfg.slasher_enabled:
            from ..slasher import SlasherService, make_slasher

            # the engine-backed slasher behind ``slasher.set_backend``
            # (the span store on the node's device, or the numpy twin).
            # The checkpoint store only rides a durable (WAL) datadir —
            # compressing the full span planes into a MemoryStore every
            # tick is wasted work that dies with the process (same gate as
            # the chain's per-import fork-choice persist)
            ckpt_store = store.hot if cfg.datadir else None
            slasher = make_slasher(ckpt_store, chain.ns)
            slasher_service = SlasherService(chain, slasher, op_pool)
            # subscribe to the chain's ingest seams (service.rs gossip taps)
            chain.block_observers.append(slasher_service.block_observed)
            chain.attestation_observers.append(
                slasher_service.attestation_observed
            )

        if cfg.validator_monitor_auto or cfg.validator_monitor_indices:
            from ..beacon_chain.validator_monitor import ValidatorMonitor

            chain.validator_monitor = ValidatorMonitor(
                chain, indices=cfg.validator_monitor_indices,
                auto=cfg.validator_monitor_auto,
            )

        notifier = Notifier(chain)
        return Client(
            chain, op_pool, http_server, metrics_server, slasher_service,
            notifier, network_service=network_service,
        )


def _place_backends(dev, mesh_devices=None) -> None:
    """Put every device backend on ``dev``, keeping each one's name (the
    CLI's ``--bls-backend`` / ``--epoch-backend`` choose those); the bls
    backend takes the node's serving mesh (None: no mesh)."""
    from .. import bls, epoch_engine, slasher
    from ..kzg import engine as kzg_engine

    bls.set_backend(bls.get_backend(), device=dev, mesh_devices=list(mesh_devices or ()))
    epoch_engine.set_backend(epoch_engine.get_backend(), device=dev)
    kzg_engine.set_kzg_backend(kzg_engine.get_kzg_backend(), device=dev)
    slasher.set_backend(slasher.get_backend(), device=dev)
