"""Umbrella CLI (Lighthouse's lighthouse/src/main.rs and beacon_node/src/cli.rs):
the port's copy of ``lighthouse_tpu/cli.py``.

``python -m lighthouse_tpu_torch <subcommand>``:

  bn                     run a beacon node (HTTP API + metrics + optional slasher)
  boot-node              UDP discovery rendezvous, or an ENR discovery node
  database-manager (dm)  inspect / version / migrate / compact the stores
  lcli                   skip-slots, transition-blocks, pretty-ssz
  version                print the version

Global flags select the spec preset, the debug level, the device and the
``bls`` and epoch backends. ``--device`` (default ``cuda``) is where the
node runs; ``cpu`` must be named — nothing drops to the CPU on its own.
"""

from __future__ import annotations

import argparse
import json
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
        "--bls-backend", default=None, choices=("device", "native", "oracle"),
        help="BLS backend: device = the hand-written CUDA kernels on "
             "--device (the default), native = the C++ CPU backend, oracle = "
             "pure Python. Unset = keep the process's current backend.",
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
        "--boot-enrs", default="",
        help="comma-separated hex ENRs for discv5-style discovery",
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
    boot.add_argument(
        "--enr", action="store_true",
        help="serve discv5-style ENR discovery (prints this node's ENR hex)",
    )
    boot.add_argument(
        "--fork-digest", default="00000000",
        help="hex fork digest the ENR advertises (--enr mode)",
    )

    dm = sub.add_parser(
        "database-manager", aliases=["dm"],
        help="inspect/migrate/compact the on-disk stores (Lighthouse's database_manager/)",
    )
    _add_spec_flags(dm)
    dm.add_argument("command_db", choices=("inspect", "version", "migrate", "compact"))
    dm.add_argument("--datadir", required=True)

    lcli = sub.add_parser(
        "lcli", help="dev utilities: skip-slots, transition-blocks, pretty-ssz"
    )
    _add_spec_flags(lcli)
    lcli.add_argument(
        "command_lcli", choices=("skip-slots", "transition-blocks", "pretty-ssz")
    )
    lcli.add_argument("--pre-state", help="input state SSZ file")
    lcli.add_argument("--output", help="output file (state SSZ / JSON)")
    lcli.add_argument("--slots", type=int, default=1)
    lcli.add_argument("--blocks", nargs="*", default=[], help="block SSZ files")
    lcli.add_argument("--type", dest="ssz_type", help="container name")
    lcli.add_argument("--ssz-file", help="SSZ input for pretty-ssz")

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
        boot_enrs=args.boot_enrs,
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


def run_lcli(args) -> int:
    """The ``lcli`` subcommands over ``tools.db`` (file in, file or JSON out).
    The state transition runs on the backends the spec flags select."""
    from .tools import db

    need = {
        "skip-slots": ("pre_state", "output"),
        "transition-blocks": ("pre_state", "output"),
        "pretty-ssz": ("ssz_file", "ssz_type"),
    }[args.command_lcli]
    missing = [n for n in need if not getattr(args, n)]
    if missing:
        build_parser().error(
            f"lcli {args.command_lcli} requires "
            + ", ".join("--" + n.replace("_", "-") for n in missing)
        )
    spec = _spec(args)
    if args.command_lcli == "pretty-ssz":
        with open(args.ssz_file, "rb") as fh:
            print(json.dumps(db.pretty_ssz(spec, args.ssz_type, fh.read()), indent=2))
        return 0
    from .client import _place_backends
    from .device import resolve_device

    _place_backends(resolve_device(args.device))  # as bn does; the default CUDA raises without it
    with open(args.pre_state, "rb") as fh:
        pre = fh.read()
    if args.command_lcli == "skip-slots":
        out = db.skip_slots(spec, pre, args.slots)
    else:
        blocks = []
        for b in args.blocks:
            with open(b, "rb") as fh:
                blocks.append(fh.read())
        out = db.transition_blocks(spec, pre, blocks)
    with open(args.output, "wb") as fh:
        fh.write(out)
    print(json.dumps({"wrote": args.output, "bytes": len(out)}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(f"lighthouse_tpu_torch/{__version__}")
        return 0
    if args.command == "bn":
        client = run_bn(args)
        client.wait_for_shutdown()
        return 0
    if args.command in ("database-manager", "dm"):
        from .tools import db

        fn = {
            "inspect": db.db_inspect, "version": db.db_version,
            "migrate": db.db_migrate, "compact": db.db_compact,
        }[args.command_db]
        print(json.dumps(fn(args.datadir), indent=2))
        return 0
    if args.command == "lcli":
        return run_lcli(args)
    if args.command == "boot-node":
        import time

        from .utils.logging import init_logging

        init_logging("info")
        if args.enr:
            from .network.discovery import DiscoveryService

            node = DiscoveryService(
                fork_digest=bytes.fromhex(args.fork_digest),
                ip=args.host, udp_port=args.port,
            ).start()
            print(json.dumps({"enr": node.enr.encode().hex()}), flush=True)
        else:
            from .network.boot_node import BootNode

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
