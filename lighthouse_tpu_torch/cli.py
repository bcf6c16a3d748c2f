"""Umbrella CLI (Lighthouse's lighthouse/src/main.rs and beacon_node/src/cli.rs):
the port's copy of ``lighthouse_tpu/cli.py``.

``python -m lighthouse_tpu_torch <subcommand>``:

  bn         run a beacon node (HTTP API + metrics + optional slasher)
  boot-node  UDP discovery rendezvous
  version    print the version

Global flags select the spec preset, the debug level, the device and the
``bls`` and epoch backends. ``--device`` (default ``cuda``) is where the
node runs; ``cpu`` must be named — nothing drops to the CPU on its own.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__


def _spec(args):
    from .types.spec import mainnet_spec, minimal_spec

    backend = getattr(args, "bls_backend", None)
    if backend:
        from . import bls

        bls.set_backend(backend)  # the client builder places it on --device
    epoch_backend = getattr(args, "epoch_backend", None)
    if epoch_backend:
        from . import epoch_engine

        epoch_engine.set_backend(epoch_backend)

    kwargs = {}
    for fork in ("altair", "bellatrix", "capella", "deneb", "electra"):
        v = getattr(args, f"{fork}_fork_epoch", None)
        if v is not None:
            kwargs[f"{fork}_fork_epoch"] = v
    if args.preset == "minimal":
        return minimal_spec(**kwargs)
    return mainnet_spec(**kwargs) if kwargs else mainnet_spec()


def _add_spec_flags(p):
    p.add_argument(
        "--preset", choices=("mainnet", "minimal"), default="mainnet",
        help="compile-time preset analog (EthSpec selection)",
    )
    p.add_argument("--debug-level", default="info",
                   choices=("debug", "info", "warning", "error"))
    p.add_argument(
        "--bls-backend", default=None, choices=("device", "oracle"),
        help="BLS backend: device = the hand-written CUDA kernels on "
             "--device (the default), oracle = pure Python. Unset = keep the "
             "process's current backend.",
    )
    p.add_argument(
        "--epoch-backend", default=None, choices=("device", "numpy"),
        help="epoch-processing backend: device = the PyTorch sweep over the "
             "registry mirror on --device (the default), numpy = the "
             "columnar host path. Unset = keep the process's current backend.",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device the node runs on (cuda, cuda:N or cpu); without "
             "CUDA the default refuses to start",
    )
    for fork in ("altair", "bellatrix", "capella", "deneb", "electra"):
        p.add_argument(f"--{fork}-fork-epoch", type=int, default=None)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lighthouse_tpu_torch",
        description="consensus client on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    bn = sub.add_parser("bn", help="beacon node")
    _add_spec_flags(bn)
    bn.add_argument("--datadir", default=None)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--disable-http", action="store_true")
    bn.add_argument("--metrics", action="store_true")
    bn.add_argument("--metrics-port", type=int, default=5054)
    bn.add_argument("--slasher", action="store_true")
    bn.add_argument("--interop-validators", type=int, default=64)
    bn.add_argument("--genesis-time", type=int, default=None)
    bn.add_argument(
        "--listen-port", type=int, default=None,
        help="TCP gossip/RPC listener port (0 = ephemeral; unset = no p2p)",
    )
    bn.add_argument(
        "--boot-nodes", default="",
        help="comma-separated UDP boot-node addresses for peer discovery",
    )
    bn.add_argument(
        "--validator-monitor-auto", action="store_true",
        help="monitor every validator (validator_monitor.rs auto mode)",
    )
    bn.add_argument(
        "--validator-monitor-indices", default="",
        help="comma-separated validator indices to monitor",
    )
    bn.add_argument(
        "--checkpoint-sync-url", default=None,
        help="boot from another node's finalized state over HTTP instead of "
             "genesis (client/src/builder.rs checkpoint-sync branch)",
    )

    boot = sub.add_parser(
        "boot-node", help="UDP discovery rendezvous (Lighthouse's boot_node/)"
    )
    boot.add_argument("--port", type=int, default=4242)
    boot.add_argument("--host", default="0.0.0.0")

    sub.add_parser("version", help="print version")
    return parser


def run_bn(args) -> "object":
    """Build and start a beacon node from parsed ``bn`` arguments."""
    from .client import ClientBuilder, ClientConfig

    spec = _spec(args)
    cfg = ClientConfig(
        datadir=args.datadir,
        http_enabled=not args.disable_http,
        http_port=args.http_port,
        metrics_enabled=args.metrics,
        metrics_port=args.metrics_port,
        slasher_enabled=args.slasher,
        interop_validators=args.interop_validators,
        genesis_time=args.genesis_time,
        debug_level=args.debug_level,
        listen_port=args.listen_port,
        boot_nodes=args.boot_nodes,
        validator_monitor_auto=args.validator_monitor_auto,
        validator_monitor_indices=tuple(
            int(x) for x in args.validator_monitor_indices.split(",") if x
        ),
        device=args.device,
    )
    builder = ClientBuilder(spec, cfg)
    if args.checkpoint_sync_url:
        builder.checkpoint_sync(args.checkpoint_sync_url)
    return builder.build().start()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(f"lighthouse_tpu_torch/{__version__}")
        return 0
    if args.command == "bn":
        client = run_bn(args)
        client.wait_for_shutdown()
        return 0
    if args.command == "boot-node":
        import time

        from .network.boot_node import BootNode
        from .utils.logging import init_logging

        init_logging("info")
        node = BootNode(host=args.host, port=args.port).start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            node.stop()
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
