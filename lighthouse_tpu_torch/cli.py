"""Umbrella CLI (Lighthouse's lighthouse/src/main.rs and beacon_node/src/cli.rs):
the port's copy of ``lighthouse_tpu/cli.py``.

``python -m lighthouse_tpu_torch <subcommand>``:

  bn                      run a beacon node (HTTP API + metrics + optional slasher)
  vc                      run a validator client against a beacon node
  account-manager (am)    create EIP-2335 validator keystores
  validator-manager (vm)  bulk create / import / list validators
  boot-node               UDP discovery rendezvous, or an ENR discovery node
  database-manager (dm)   inspect / version / migrate / compact the stores
  lcli                    skip-slots, transition-blocks, pretty-ssz
  version                 print the version

Global flags select the spec preset, the debug level, the device and the
``bls`` and epoch backends. ``--device`` (default ``cuda``) is where the
node runs; ``cpu`` must be named — nothing drops to the CPU on its own.
``vc``, ``account-manager`` and ``validator-manager`` do no device work and
take no ``--device``: a validator client signs on the host and its beacon
node verifies.
"""

from __future__ import annotations

import argparse
import json
import os
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


def _add_spec_flags(p, device: bool = True):
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
    if device:
        p.add_argument(
            "--device", default="cuda",
            help="torch device the node runs on (cuda, cuda:N or cpu); "
                 "without CUDA the default refuses to start",
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

    vc = sub.add_parser("vc", help="validator client")
    _add_spec_flags(vc, device=False)
    vc.add_argument(
        "--beacon-node", default="http://127.0.0.1:5052",
        help="beacon node URL(s), comma-separated for health-scored failover "
             "(beacon_node_fallback)",
    )
    vc.add_argument("--validators-dir", default=None)
    vc.add_argument("--password", default="")
    vc.add_argument("--interop-validators", type=int, default=0)
    vc.add_argument(
        "--enable-doppelganger-protection", action="store_true",
        help="hold back signing until liveness checks show no duplicate "
             "instance of our keys (doppelganger_service)",
    )
    vc.add_argument(
        "--keymanager-port", type=int, default=None,
        help="serve the keymanager API (keystores/remotekeys CRUD) on this "
             "port (0 = ephemeral)",
    )
    vc.add_argument(
        "--web3signer-url", default=None,
        help="register all keys served by this remote signer "
             "(signing_method/web3signer)",
    )

    am = sub.add_parser("account-manager", aliases=["am"],
                        help="create validator keystores")
    _add_spec_flags(am, device=False)
    am.add_argument("--output-dir", required=True)
    am.add_argument("--count", type=int, default=1)
    am.add_argument("--password", required=True)
    am.add_argument("--mnemonic-seed", default=None,
                    help="hex seed for EIP-2333 derivation (random if unset)")

    vm = sub.add_parser(
        "validator-manager", aliases=["vm"],
        help="bulk create/import validators (Lighthouse's validator_manager/)",
    )
    _add_spec_flags(vm, device=False)
    vm.add_argument("command_vm", choices=("create", "import", "list"))
    vm.add_argument("--output-dir")
    vm.add_argument("--keystores-dir")
    vm.add_argument("--count", type=int, default=1)
    vm.add_argument("--first-index", type=int, default=0)
    vm.add_argument("--password", default="")
    vm.add_argument("--mnemonic-seed", default=None)
    vm.add_argument("--vc-url", help="running VC keymanager API url")

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


def run_vc(args):
    """Build a validator client from parsed ``vc`` arguments, load its keys
    (keystores, interop, Web3Signer) and connect it to its beacon node(s)."""
    from .utils.logging import init_logging
    from .validator_client.runner import ProductionValidatorClient

    init_logging(args.debug_level)
    spec = _spec(args)
    vc = ProductionValidatorClient(
        spec, args.beacon_node,
        enable_doppelganger=args.enable_doppelganger_protection,
        keymanager_port=args.keymanager_port,
    )
    if args.validators_dir:
        vc.load_keystore_dir(args.validators_dir, args.password)
    if args.interop_validators:
        vc.load_interop_keys(args.interop_validators)
    if args.web3signer_url:
        vc.load_web3signer(args.web3signer_url)
    return vc.connect()


def run_account_manager(args) -> list[str]:
    """Derive EIP-2333 keys and write EIP-2335 keystores
    (account_manager validator create)."""
    from .keys.derivation import derive_sk_from_path
    from .keys.keystore import Keystore

    os.makedirs(args.output_dir, exist_ok=True)
    seed = (
        bytes.fromhex(args.mnemonic_seed)
        if args.mnemonic_seed
        else os.urandom(32)
    )
    written = []
    for i in range(args.count):
        path = f"m/12381/3600/{i}/0/0"
        sk = derive_sk_from_path(seed, path)
        ks = Keystore.encrypt(
            sk.to_bytes(32, "big"),
            args.password,
            path=path,
        )
        name = f"keystore-{i}.json"
        with open(os.path.join(args.output_dir, name), "w") as fh:
            fh.write(ks.to_json())
        written.append(name)
    print(json.dumps({"wrote": written, "dir": args.output_dir}))
    return written


def run_validator_manager(args) -> int:
    """The ``validator-manager`` subcommands over ``tools.vm``."""
    from .tools import vm

    need = {
        "create": ("output_dir",),
        "import": ("keystores_dir", "vc_url"),
        "list": ("vc_url",),
    }[args.command_vm]
    missing = [n for n in need if not getattr(args, n)]
    if missing:
        build_parser().error(
            f"validator-manager {args.command_vm} requires "
            + ", ".join("--" + n.replace("_", "-") for n in missing)
        )
    if args.command_vm == "create":
        written = vm.vm_create(
            args.output_dir, args.count, args.password,
            args.mnemonic_seed, args.first_index,
        )
        print(json.dumps({"wrote": written, "dir": args.output_dir}))
    elif args.command_vm == "import":
        print(json.dumps(
            vm.vm_import(args.keystores_dir, args.password, args.vc_url)
        ))
    else:
        print(json.dumps(vm.vm_list(args.vc_url)))
    return 0


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
    if args.command == "vc":
        vc = run_vc(args)
        try:
            vc.run()
        except KeyboardInterrupt:
            vc.stop()
        return 0
    if args.command in ("account-manager", "am"):
        run_account_manager(args)
        return 0
    if args.command in ("validator-manager", "vm"):
        return run_validator_manager(args)
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
