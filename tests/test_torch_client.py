"""The port's client, CLI, notifier and validator monitor against the
reference's.

``lighthouse_tpu_torch.{client,cli}`` and ``beacon_chain.validator_monitor``
are the port's copies of the reference's modules. The parser offers ``bn``,
``boot-node`` and ``version`` with ``--device`` in place of ``--platform``
and the port's backend names; ``ClientBuilder`` builds the reference's node
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
    assert set(vars(args)) == (set(ref) - {"platform", "boot_enrs"}) | {"device"}
    assert {k: v for k, v in vars(args).items() if k in ref} == {
        k: v for k, v in ref.items() if k in vars(args)}
    args = p.parse_args(["bn", "--device", "cpu", "--bls-backend", "oracle",
                         "--epoch-backend", "numpy", "--electra-fork-epoch", "0"])
    assert (args.device, args.bls_backend, args.epoch_backend, args.electra_fork_epoch) == (
        "cpu", "oracle", "numpy", 0)
    assert p.parse_args(["bn", "--bls-backend", "device"]).bls_backend == "device"
    assert p.parse_args(["boot-node", "--port", "0"]).port == 0
    assert p.parse_args(["version"]).command == "version"
    for argv in (["bn", "--platform", "cpu"], ["bn", "--bls-backend", "tpu"],
                 ["bn", "--bls-backend", "native"], ["bn", "--epoch-backend", "auto"],
                 ["bn", "--boot-enrs", "ab"], ["boot-node", "--enr"],
                 ["vc"], ["account-manager"], ["database-manager"], ["lcli"],
                 ["validator-manager"]):
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


def test_builder_refuses_enr_discovery():
    with pytest.raises(ValueError, match="ENR discovery is not ported"):
        PBuilder(p_minimal(**PHASE0), PConfig(device="cpu", boot_enrs="abcd")).build()


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
