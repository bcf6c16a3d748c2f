"""The port's simulator under chaos and crash points, against the reference.

Both packages' ``LocalNetwork`` run the same scenario on their ``native``
bls backends (the port's nodes on ``device="cpu"``, its epoch sweep on the
CPU), from the same interop keys; fault plans go in through each package's
``resilience.inject.injector.install``. Exact equality:

* the crash/recover cycle of ``tests/test_crash_recovery.py:120-180``: two
  durable nodes (16 validators, per-node WAL stores), one killed at the 9th
  WAL frame barrier, restarted ``from_disk=True``; the node killed, its
  recovery report (head, fork-choice nodes, finality, replayed records)
  and the heads after recovery equal the reference's;
* the chaos liveness case of ``tests/test_resilience.py:715-760``: 4 nodes
  x 24 validators, 2% seeded gossip loss, every 5th ``bls.batch_verify``
  faulting transiently and one OOM, a node crashed and restarted from
  genesis, a tampered attestation every epoch: liveness, no tampered
  attestation verified, and the reference's finalized epochs, heads and
  gossip counts.
"""

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import resilience as r_res
from lighthouse_tpu.resilience import injector as r_injector
from lighthouse_tpu.testing.local_network import LocalNetwork as RNet
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import resilience as p_res
from lighthouse_tpu_torch.resilience.inject import injector as p_injector
from lighthouse_tpu_torch.testing.local_network import LocalNetwork as PNet
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

REF = dict(Net=RNet, spec=r_minimal, injector=r_injector, res=r_res, kw={})
PORT = dict(Net=PNet, spec=p_minimal, injector=p_injector, res=p_res, kw={"device": "cpu"})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("native")
    p_epoch.set_backend("device", device="cpu")
    r_injector.clear()
    p_injector.clear()
    yield
    r_injector.clear()
    p_injector.clear()
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])


def _heads(net):
    return [(int(n.chain.head.slot), bytes(n.chain.head.root)) for n in net.nodes]


def _crash_recover(pkg, datadir):
    """The reference's representative crash/recover cycle on ``pkg``."""
    spec = pkg["spec"]()
    net = pkg["Net"](spec, n_nodes=2, n_validators=16, datadir=str(datadir), **pkg["kw"])
    spe = spec.preset.SLOTS_PER_EPOCH
    for slot in range(1, 2 * spe + 1):
        net.run_slot(slot)
    pre = (net.nodes[1].chain.head.slot, bytes(net.nodes[1].chain.head.root),
           net.finalized_epochs())
    pkg["injector"].install("stage=store.commit;mode=kill;at=9")
    crashed = None
    try:
        for slot in range(2 * spe + 1, 2 * spe + 4):
            net.run_slot(slot)
            if net.dead and crashed is None:
                crashed = next(iter(net.dead))
    finally:
        pkg["injector"].clear()
    assert crashed is not None, "the barrier kill never fired"
    live_fin = max(f for i, f in enumerate(net.finalized_epochs()) if i not in net.dead)
    net.restart_node(crashed, from_disk=True)
    report = {k: v for k, v in net.recovery_reports[-1].items() if not k.endswith("_s")}
    at_restart = net.nodes[crashed].chain.head.slot
    net.reconnect_all()
    for slot in range(2 * spe + 4, 3 * spe + 1):
        net.run_slot(slot)
    return dict(pre=pre, crashed=crashed, live_fin=live_fin, report=report,
                at_restart=at_restart, heads=_heads(net), agree=net.heads_agree(),
                fins=net.finalized_epochs())


def test_crash_recover_cycle_equals_reference(tmp_path):
    want = _crash_recover(REF, tmp_path / "ref")
    got = _crash_recover(PORT, tmp_path / "port")
    report = got["report"]
    pre_head, pre_root, pre_fin = got["pre"]
    # the reference's invariants, on the port
    assert report["truncated_bytes"] == 0, report
    assert 0 <= report["finalized_epoch"] <= got["live_fin"] + 1, report
    assert report["fork_choice_restored"] and report["fc_nodes"] > 0, report
    assert report["head_slot"] >= pre_head - 1 and got["at_restart"] >= pre_head - 1
    if report["head_slot"] == pre_head:
        assert bytes(report["head_root"]) == pre_root
    assert got["agree"], got["heads"]
    assert all(f >= pre_fin[1] for f in got["fins"])
    # and the reference's outcome, exactly
    assert got == want


def _chaos(pkg):
    """The reference's tier-1 chaos liveness scenario on ``pkg``."""
    res = pkg["res"]
    sup = res.bls_supervisor()
    saved_cfg = sup.config
    sup.config = res.SupervisorConfig(
        deadline_s=5.0, max_retries=2, backoff_base_s=0.001, backoff_max_s=0.005,
        promote_after=1, probe_every=1, probation_s=0.05,
    )
    sup.reset()
    spec = pkg["spec"]()
    net = pkg["Net"](spec, n_nodes=4, n_validators=24, **pkg["kw"])
    net.transport.set_gossip_loss(0.02, seed=1234)
    pkg["injector"].install(
        "stage=bls.batch_verify;mode=raise;kind=transient;every=5|"
        "stage=bls.batch_verify;mode=raise;kind=oom;at=30;times=1"
    )
    spe = spec.preset.SLOTS_PER_EPOCH
    tampered = []
    fins = []
    try:
        for slot in range(1, 4 * spe + 1):
            net.run_slot(slot)
            if slot == 10:
                net.crash_node(3)
            if slot == 18:
                net.restart_node(3)
            if slot % spe == 4:
                node = net.nodes[0]
                atts = net.harness.unaggregated_attestations_for_slot(
                    node.chain.head.state, slot, node.chain.head.root
                )
                if len(atts) >= 2:
                    bad = atts[0]
                    bad.signature = atts[1].signature
                    res_ = node.chain.verify_unaggregated_attestations([bad])
                    tampered.append(isinstance(res_[0][1], Exception))
            fins.append(net.finalized_epochs())
        snap = sup.snapshot()
    finally:
        pkg["injector"].clear()
        sup.config = saved_cfg
        sup.reset()
    return dict(tampered=tampered, fins=fins, heads=_heads(net), agree=net.heads_agree(),
                delivered=net.transport.gossip_delivered, dropped=net.transport.gossip_dropped,
                missed=net.missed_proposals), snap


def test_chaos_liveness_equals_reference():
    want, _ = _chaos(REF)
    got, snap = _chaos(PORT)
    assert len(got["tampered"]) >= 3 and all(got["tampered"]), got["tampered"]
    assert got["agree"], got["heads"]
    assert all(f >= 2 for f in got["fins"][-1]), got["fins"][-1]
    assert got["heads"][3] == got["heads"][0]
    drop_rate = got["dropped"] / (got["delivered"] + got["dropped"])
    assert got["delivered"] > 0 and drop_rate <= 0.05
    assert snap["faults"] >= 5 and snap["demotions"] >= 1, snap
    assert snap["promotions"] >= 1 and snap["exhausted"] == 0, snap
    assert snap["state"] == "HEALTHY", snap
    assert got["fins"] == want["fins"]
    assert got == want
