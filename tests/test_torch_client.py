"""The port's client, CLI, notifier and validator monitor against the
reference's.

``lighthouse_tpu_torch.{client,cli}`` and ``beacon_chain.validator_monitor``
are the port's copies of the reference's modules. The parser offers ``bn``
(with ``--boot-enrs``), ``boot-node`` (with ``--enr``), ``database-manager``,
``lcli`` and ``version`` with ``--device`` in place of ``--platform`` and
the port's backend names, and ``vc``, ``account-manager`` and
``validator-manager`` with the reference's arguments but ``--platform``; a node built with ``boot_enrs`` finds a reference
node through an ENR boot node; ``ClientBuilder`` builds the reference's node
in memory and on a datadir across a restart (the interop genesis reused,
head and fork choice restored, equal to the reference client's on the same
blocks); it checkpoint-syncs from a reference server to an equal anchor; a
``bn`` with no ``--device`` refuses to start where CUDA is absent, and
``python -m lighthouse_tpu_torch bn --device cpu`` boots and answers
``/eth/v1/node/health``; the notifier's status line and the validator
monitor's counts equal the reference's.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.beacon_chain.validator_monitor import MONITOR_ATTESTATIONS as R_MON_ATTS
from lighthouse_tpu.beacon_chain.validator_monitor import ValidatorMonitor as RMonitor
from lighthouse_tpu.cli import build_parser as r_parser
from lighthouse_tpu.client import ClientBuilder as RBuilder
from lighthouse_tpu.client import ClientConfig as RConfig
from lighthouse_tpu.client.notifier import Notifier as RNotifier
from lighthouse_tpu.http_api import BeaconApiServer as RServer
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain.validator_monitor import MONITOR_ATTESTATIONS as P_MON_ATTS
from lighthouse_tpu_torch.beacon_chain.validator_monitor import ValidatorMonitor as PMonitor
from lighthouse_tpu_torch.cli import build_parser, run_bn
from lighthouse_tpu_torch.client import ClientBuilder as PBuilder
from lighthouse_tpu_torch.client import ClientConfig as PConfig
from lighthouse_tpu_torch.client.notifier import Notifier as PNotifier
from lighthouse_tpu_torch.http_api import BeaconApiServer as PServer
from lighthouse_tpu_torch.kzg import engine as p_kzg
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

N = 16
PHASE0 = dict(altair_fork_epoch=2**64 - 1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device(),
             p_kzg.get_kzg_backend(), p_kzg.get_kzg_device(), p_slasher.get_backend(),
             p_slasher.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    p_kzg.set_kzg_backend(saved[6], device=saved[7])
    p_slasher.set_backend(saved[8], device=saved[9])


def _port_block(spec, rb):
    return convert.block_from_ssz(spec, spec.fork_name_at_slot(int(rb.message.slot)),
                                  rb.serialize())


def _fc_view(chain):
    fc = chain.fork_choice
    return ([(n.root, n.parent, int(n.weight)) for n in fc.proto.nodes],
            fc.store.justified_checkpoint, fc.store.finalized_checkpoint)


def _total(counter) -> float:
    return sum(v for _, _, v in counter.collect())


def _close(client):
    for kv in (client.chain.store.hot, client.chain.store.cold):
        kv.close()


# -- the parser --------------------------------------------------------------


def test_parser_surface():
    p = build_parser()
    args = p.parse_args(["bn", "--preset", "minimal", "--metrics", "--slasher",
                         "--http-port", "0", "--metrics-port", "0"])
    assert args.command == "bn" and args.slasher and args.device == "cuda"
    assert args.bls_backend is None and args.epoch_backend is None
    ref = vars(r_parser().parse_args(["bn", "--preset", "minimal", "--metrics", "--slasher",
                                      "--http-port", "0", "--metrics-port", "0"]))
    assert set(vars(args)) == (set(ref) - {"platform"}) | {"device"}
    assert {k: v for k, v in vars(args).items() if k in ref} == {
        k: v for k, v in ref.items() if k in vars(args)}
    args = p.parse_args(["bn", "--device", "cpu", "--bls-backend", "oracle",
                         "--epoch-backend", "numpy", "--electra-fork-epoch", "0"])
    assert (args.device, args.bls_backend, args.epoch_backend, args.electra_fork_epoch) == (
        "cpu", "oracle", "numpy", 0)
    assert p.parse_args(["bn", "--bls-backend", "device"]).bls_backend == "device"
    assert p.parse_args(["bn", "--bls-backend", "native"]).bls_backend == "native"
    assert p.parse_args(["bn", "--boot-enrs", "ab,cd"]).boot_enrs == "ab,cd"
    assert p.parse_args(["boot-node", "--port", "0"]).port == 0
    boot = p.parse_args(["boot-node", "--enr", "--fork-digest", "01020304"])
    assert (boot.enr, boot.fork_digest) == (True, "01020304")
    assert vars(boot) == vars(r_parser().parse_args(["boot-node", "--enr", "--fork-digest", "01020304"]))
    for argv in (["database-manager", "inspect", "--datadir", "d"],
                 ["dm", "migrate", "--datadir", "d"],
                 ["lcli", "skip-slots", "--pre-state", "a", "--output", "b", "--slots", "3"],
                 ["lcli", "transition-blocks", "--pre-state", "a", "--output", "b",
                  "--blocks", "x", "y"],
                 ["lcli", "pretty-ssz", "--type", "Checkpoint", "--ssz-file", "c"]):
        got, want = vars(p.parse_args(argv)), vars(r_parser().parse_args(argv))
        assert set(got) == (set(want) - {"platform"}) | {"device"}
        assert {k: v for k, v in got.items() if k != "device"} == {
            k: v for k, v in want.items() if k != "platform"}
    # the validator client and its tools: the reference's arguments, no --platform and,
    # as they do no device work, no --device
    for argv in (["vc"],
                 ["vc", "--beacon-node", "http://a:1,http://b:2", "--validators-dir", "v",
                  "--password", "pw", "--interop-validators", "56", "--keymanager-port", "0",
                  "--web3signer-url", "http://s:3", "--enable-doppelganger-protection",
                  "--preset", "minimal", "--electra-fork-epoch", "0"],
                 ["account-manager", "--output-dir", "o", "--password", "pw"],
                 ["am", "--output-dir", "o", "--count", "2", "--password", "pw",
                  "--mnemonic-seed", "ab"],
                 ["validator-manager", "create", "--output-dir", "o", "--count", "2",
                  "--first-index", "3", "--password", "pw", "--mnemonic-seed", "ab"],
                 ["vm", "import", "--keystores-dir", "k", "--vc-url", "http://vc:1"],
                 ["vm", "list", "--vc-url", "http://vc:1"]):
        got, want = vars(p.parse_args(argv)), vars(r_parser().parse_args(argv))
        assert "device" not in got and set(got) == set(want) - {"platform"}
        assert got == {k: v for k, v in want.items() if k != "platform"}
    assert p.parse_args(["vc", "--bls-backend", "native"]).bls_backend == "native"
    assert p.parse_args(["version"]).command == "version"
    for argv in (["bn", "--platform", "cpu"], ["bn", "--bls-backend", "tpu"],
                 ["bn", "--epoch-backend", "auto"], ["database-manager"],
                 ["database-manager", "prune", "--datadir", "d"], ["lcli"],
                 ["vc", "--device", "cpu"], ["vc", "--platform", "cpu"], ["account-manager"],
                 ["am", "--output-dir", "o"], ["validator-manager"], ["vm", "delete"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)


def test_version_command(capsys):
    from lighthouse_tpu_torch.cli import main

    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "lighthouse_tpu_torch/" + lighthouse_tpu.__version__


# -- the builder --------------------------------------------------------------


def test_builder_in_memory_equals_the_reference():
    cfg = dict(interop_validators=N, genesis_time=0, use_system_clock=False, http_port=0,
               metrics_enabled=True, validator_monitor_indices=(1, 2))
    rc = RBuilder(r_minimal(**PHASE0), RConfig(**cfg)).build().start()
    pc = PBuilder(p_minimal(**PHASE0), PConfig(device="cpu", **cfg)).build().start()
    try:
        assert pc.chain.genesis_block_root == rc.chain.genesis_block_root
        assert pc.chain.pubkey_cache.device_array().device.type == "cpu"
        assert (p_bls.get_backend(), p_bls.get_device().type) == ("oracle", "cpu")
        assert p_epoch.get_device().type == p_kzg.get_kzg_device().type == "cpu"
        assert p_slasher.get_device().type == "cpu"
        assert pc.chain.execution_layer is None and pc.slasher_service is None
        assert sorted(pc.chain.validator_monitor.indices) == [1, 2]
        for path in ("/eth/v1/beacon/genesis", "/eth/v1/beacon/headers/head",
                     "/eth/v1/config/spec"):
            with urllib.request.urlopen(rc.http_server.url + path) as r:
                want = json.loads(r.read())
            with urllib.request.urlopen(pc.http_server.url + path) as r:
                assert json.loads(r.read()) == want
        with urllib.request.urlopen(pc.metrics_server.url + "/metrics") as r:
            assert b"validator_monitor_attestations_total" in r.read()
        with urllib.request.urlopen(pc.metrics_server.url + "/health") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and "fault_domains" in health
        warm = pc.wait_for_warmup(120)
        assert warm == {"backend": "oracle", "healthy": True, "seconds": warm["seconds"]}
    finally:
        rc.stop()
        pc.stop()


def test_builder_discovers_a_peer_through_boot_enrs():
    """A reference node and a port node, each built with ``boot_enrs`` naming
    one ENR boot node and no ``boot_nodes``: the port node's startup lookup
    finds the reference node's listener and peers with it."""
    from lighthouse_tpu.network.discovery import DiscoveryService as RDiscovery
    from lighthouse_tpu.types.helpers import compute_fork_digest

    genesis = StateHarness(r_minimal(**PHASE0), N).state
    digest = compute_fork_digest(bytes(genesis.fork.current_version),
                                 bytes(genesis.genesis_validators_root))
    boot = RDiscovery(fork_digest=digest).start()
    cfg = dict(interop_validators=N, genesis_time=0, use_system_clock=False, http_enabled=False,
               listen_port=0, boot_enrs=boot.enr.encode().hex())
    r_bls.set_backend("native")
    p_bls.set_backend("native")
    rc = RBuilder(r_minimal(**PHASE0), RConfig(**cfg)).build()
    pc = None
    try:
        pc = PBuilder(p_minimal(**PHASE0), PConfig(device="cpu", **cfg)).build()
        rt, pt = rc.network_service.transport, pc.network_service.transport
        assert pt.discovery.enr.fork_digest == digest
        assert rt.local_addr in pt.discovery.known_tcp_addrs()
        assert rt.local_addr in pt.peers()
    finally:
        if pc is not None:
            pc.stop()
        rc.stop()
        rc.network_service.transport.discovery.stop()
        boot.stop()


def test_restart_on_a_datadir_equals_the_reference(tmp_path):
    """Both clients boot an interop genesis on a datadir, import the same
    harness blocks and stop (fork choice and pool persisted); rebooted on
    the same datadir with another genesis time asked for, each re-derives
    its stored genesis and restores head and fork choice — the port's equal
    to the reference's."""
    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, N, genesis_time=7)
    blocks = []
    for slot in range(1, 6):
        b = h.produce_block(slot)
        h.apply_block(b)
        blocks.append(b)

    def boot(builder, config, who, genesis_time):
        cfg = config(datadir=str(tmp_path / who), interop_validators=N, http_enabled=False,
                     genesis_time=genesis_time, use_system_clock=False,
                     **({"device": "cpu"} if who == "p" else {}))
        return builder(rspec if who == "r" else pspec, cfg).build()

    views = {}
    for builder, config, who in ((RBuilder, RConfig, "r"), (PBuilder, PConfig, "p")):
        c = boot(builder, config, who, 7)
        for b in blocks:
            c.chain.slot_clock.set_slot(int(b.message.slot))
            c.chain.process_block(b if who == "r" else _port_block(pspec, b))
        before = (c.chain.head.root, int(c.chain.head.slot), _fc_view(c.chain))
        c.start().stop()
        _close(c)
        c2 = boot(builder, config, who, None)
        after = (c2.chain.head.root, int(c2.chain.head.slot), _fc_view(c2.chain))
        assert int(c2.chain.head.state.genesis_time) == 7 and after == before
        _close(c2)
        views[who] = after
    assert views["p"] == views["r"]
    assert views["p"][0] == blocks[-1].message.tree_root()


def test_checkpoint_sync_from_a_reference_server():
    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, N)
    chain = RChain(rspec, h.state.copy(), slot_clock=RClock(0))
    for slot in range(1, 3):
        b = h.produce_block(slot)
        h.apply_block(b)
        chain.slot_clock.set_slot(slot)
        chain.process_block(b)
    server = RServer(chain).start()
    try:
        cfg = dict(use_system_clock=False, http_enabled=False)
        pc = PBuilder(pspec, PConfig(device="cpu", **cfg)).checkpoint_sync(server.url).build()
        rc = RBuilder(rspec, RConfig(**cfg)).checkpoint_sync(server.url).build()
    finally:
        server.stop()
    assert pc.chain.genesis_state.tree_root() == rc.chain.genesis_state.tree_root()
    assert pc.chain.genesis_block_root == rc.chain.genesis_block_root
    # and the reference's builder from the port's server
    pserver = PServer(pc.chain).start()
    try:
        rc2 = RBuilder(rspec, RConfig(**cfg)).checkpoint_sync(pserver.url).build()
    finally:
        pserver.stop()
    assert rc2.chain.genesis_state.tree_root() == pc.chain.genesis_state.tree_root()


# -- the bn command ------------------------------------------------------------


def test_bn_without_a_device_refuses_to_start(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device boots where CUDA is present")
    args = build_parser().parse_args(["bn", "--preset", "minimal", "--interop-validators", "16",
                                      "--http-port", "0", "--datadir", str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_bn(args)
    assert not (tmp_path / "d").exists()


def test_python_m_bn_on_the_cpu_answers_health(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch", "bn", "--device", "cpu", "--bls-backend",
         "oracle", "--epoch-backend", "numpy", "--preset", "minimal", "--interop-validators",
         "16", "--http-port", "0", "--datadir", str(tmp_path / "d")],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True)
    try:
        url, t0 = None, time.time()
        while url is None and time.time() - t0 < 120:
            line = proc.stderr.readline()
            if not line:
                break
            if "Beacon API started" in line:
                url = line.split("url: ")[1].split(",")[0].strip()
        assert url is not None, "the node did not start its API"
        with urllib.request.urlopen(url + "/eth/v1/node/health") as r:
            assert r.status in (200, 206)
        with urllib.request.urlopen(url + "/eth/v1/node/version") as r:
            assert json.loads(r.read())["data"]["version"].startswith("lighthouse_tpu_torch/")
    finally:
        proc.terminate()
        proc.wait(30)
        proc.stderr.close()


# -- the notifier and the validator monitor -----------------------------------


def test_notifier_and_validator_monitor_equal_the_reference():
    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, N)
    rclock, pclock = RClock(0), PClock(0)
    rchain = RChain(rspec, h.state.copy(), slot_clock=rclock)
    pchain = PChain(pspec, convert.state_from_ssz(pspec, "phase0", h.state.serialize()),
                    slot_clock=pclock)
    watch = list(range(0, N, 2))
    rmon, pmon = RMonitor(rchain, indices=watch), PMonitor(pchain, indices=watch)
    r0, p0 = _total(R_MON_ATTS), _total(P_MON_ATTS)
    lines = []
    for slot in range(1, 4):
        rclock.set_slot(slot)
        pclock.set_slot(slot)
        b = h.produce_block(slot)
        h.apply_block(b)
        root = rchain.process_block(b)
        assert pchain.process_block(_port_block(pspec, b)) == root
        atts = h.unaggregated_attestations_for_slot(h.state, slot, root)
        rchain.verify_unaggregated_attestations(atts)
        pchain.verify_unaggregated_attestations(
            [pchain.ns.Attestation.decode(a.serialize()) for a in atts])
        rclock.set_slot(slot + 2)
        pclock.set_slot(slot + 2)
        lines.append((RNotifier(rchain).status_line(), PNotifier(pchain).status_line()))
    for r, p in lines:
        assert p == r
    assert lines[-1][1]["sync"] == "behind (2)"
    for epoch in (0, 1):
        assert pmon.epoch_summary(epoch) == rmon.epoch_summary(epoch)
        for i in range(N):
            assert pmon.validator_record(epoch, i) == rmon.validator_record(epoch, i)
    assert pmon.epoch_summary(0)["attestations"] > 0
    assert _total(P_MON_ATTS) - p0 == _total(R_MON_ATTS) - r0 == pmon.epoch_summary(0)[
        "attestations"]
