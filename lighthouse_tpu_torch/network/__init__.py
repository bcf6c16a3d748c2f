"""Networking layer: transport seam, router, sync, node service.

Twin of the reference's L5 stack (``beacon_node/network`` +
``lighthouse_network``), built seam-first: the ``Transport`` interface carries
gossip topics and req/resp RPC; ``LoopbackTransport`` is the in-process
message bus (the multi-node-without-sockets pattern of
``testing/simulator/src/local_network.rs:128`` and the sync tests at
``network/src/sync/tests/lookups.rs``); ``SocketTransport`` is the
real-peer implementation — TCP flood-gossip with message-id dedup plus
Req/Resp framing — with ``BootNode`` as the UDP discovery rendezvous
(``boot_node/``, the discv5 seam). ``Router`` dispatches
pubsub messages into the beacon processor's prioritized queues
(``network/src/router.rs:381-535``); ``SyncManager`` does status-driven range
sync with batched epochs (``network/src/sync/manager.rs``,
``range_sync/batch.rs``); ``BeaconNodeService`` wires one node together.

The port's copy of ``lighthouse_tpu/network`` (host Python; the device work
is the chain's). ``discovery`` (discv5 ENR lookups over the native bls
backend) is not ported yet, and the four light-client Req/Resp methods raise
``WireError`` until the port has the light-client server.
"""

from .boot_node import BootNode  # noqa: F401
from .codec import MessageCodec, WireError  # noqa: F401
from .gossipsub import GossipsubParams, GossipsubTransport  # noqa: F401
from .router import Router  # noqa: F401
from .service import BeaconNodeService  # noqa: F401
from .socket_transport import SocketTransport  # noqa: F401
from .sync import SyncManager  # noqa: F401
from .transport import LoopbackTransport, Topic  # noqa: F401
