"""The port's multi-node simulator against the reference's, slot for slot.

``lighthouse_tpu_torch.testing.LocalNetwork`` is the port's copy of
``lighthouse_tpu/testing/local_network.py``: N in-process beacon nodes over
the loopback bus, proposing, gossiping and attesting. Both networks run on
their ``native`` bls backends (as ``tests/test_local_network.py`` runs the
reference's), the port's nodes on ``device="cpu"`` with its torch epoch
sweep and span store on the CPU, from the same interop keys. Exact
equality:

* 4 nodes x 32 validators, minimal phase0, 4 epochs: after every slot each
  node's head root, justified and finalized checkpoints equal the
  reference node's, and every node finalizes at >= 2; the same holds for
  the port's network with ``batch_gossip=True`` (the mode the card runs:
  each duty phase's gossip held and drained in batches);
* a partitioned node falls behind and range-syncs back, as in the
  reference, to the same head;
* the slasher loop (2 x 16): an equivocating attester is caught over
  gossip, its slashing rides a proposal, and it ends slashed on every node
  of both networks, no one else.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
import lighthouse_tpu.state_transition as r_st
import lighthouse_tpu.types.containers as r_containers
import lighthouse_tpu.types.helpers as r_helpers
import lighthouse_tpu_torch.state_transition as p_st
import lighthouse_tpu_torch.types.containers as p_containers
import lighthouse_tpu_torch.types.helpers as p_helpers
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.testing import local_network as r_ln
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.testing import local_network as p_ln
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

EPOCHS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device(),
             p_slasher.get_backend(), p_slasher.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("native")
    p_epoch.set_backend("device", device="cpu")
    p_slasher.set_backend("device", device="cpu")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    p_slasher.set_backend(saved[6], device=saved[7])


def _view(net):
    """Per node: head root, justified and finalized epoch and root."""
    out = []
    for n in net.nodes:
        state = n.chain.head.state
        just, fin = state.current_justified_checkpoint, state.finalized_checkpoint
        out.append((bytes(n.chain.head.root), int(just.epoch), bytes(just.root),
                    int(fin.epoch), bytes(fin.root)))
    return out


@pytest.fixture(scope="module")
def nets():
    """Both 4-node networks through EPOCHS epochs in lockstep, with each
    slot's views recorded."""
    ref = r_ln.LocalNetwork(r_minimal(), n_nodes=4, n_validators=32)
    port = p_ln.LocalNetwork(p_minimal(), n_nodes=4, n_validators=32, device="cpu")
    spe = ref.spec.preset.SLOTS_PER_EPOCH
    views = []
    for slot in range(1, EPOCHS * spe + 1):
        ref.run_slot(slot)
        port.run_slot(slot)
        views.append((slot, _view(ref), _view(port)))
    return ref, port, views


def test_four_nodes_finalize_slot_for_slot(nets):
    ref, port, views = nets
    for slot, r, p in views:
        assert p == r, f"slot {slot}: port {p} != reference {r}"
    assert port.heads_agree() and ref.heads_agree()
    assert port.head_slots() == ref.head_slots() == [EPOCHS * 8] * 4
    assert port.finalized_epochs() == ref.finalized_epochs()
    assert all(f >= 2 for f in port.finalized_epochs()), port.finalized_epochs()
    assert port.missed_proposals == ref.missed_proposals == 0


def _partition_and_heal(net):
    spe = net.spec.preset.SLOTS_PER_EPOCH
    start = net.nodes[0].chain.head.slot + 1
    for other in ("node_0", "node_1", "node_2"):
        net.transport.partition("node_3", other)
    net.run_until(start + spe - 1, start=start)
    behind = (net.nodes[3].chain.head.slot, bytes(net.nodes[3].chain.head.root))
    ahead = (net.nodes[0].chain.head.slot, bytes(net.nodes[0].chain.head.root))
    net.transport.heal()
    net.nodes[3].connect("node_0")
    caught_up = (net.nodes[3].chain.head.slot, bytes(net.nodes[3].chain.head.root))
    return behind, ahead, caught_up, _view(net)


def test_partitioned_node_catches_up_via_range_sync(nets):
    ref, port, _ = nets
    want = _partition_and_heal(ref)
    got = _partition_and_heal(port)
    behind, ahead, caught_up, _ = got
    assert behind[0] < ahead[0], "the partitioned node should have fallen behind"
    assert caught_up == ahead
    assert got == want


class _Pkg:
    """One package's state-transition helpers and containers."""

    def __init__(self, st, containers, helpers, ln):
        self.st, self.c, self.h, self.ln = st, containers, helpers, ln


REF = _Pkg(r_st, r_containers, r_helpers, r_ln)
PORT = _Pkg(p_st, p_containers, p_helpers, p_ln)


def _equivocation(pkg, net):
    """The reference's test_slasher_gossip_to_block_inclusion, on ``net``:
    a node-0 validator double-votes over gossip at slot 5; returns the
    peer's tick stats, the slot by which every node holds the equivocator
    slashed, the equivocator and every node's slashed set."""
    spec = net.spec
    net.run_until(4)
    assert net.heads_agree()
    node = net.nodes[0]
    slot = 5
    net.clock.set_slot(slot)
    state = node.chain.head.state.copy()
    if state.slot < slot:
        pkg.st.process_slots(spec, state, slot)
    epoch = pkg.st.get_current_epoch(spec, state)
    domain = pkg.h.get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch)
    target_root = (
        node.chain.head.root
        if slot == spec.start_slot(epoch)
        else pkg.ln._block_root_at(spec, state, spec.start_slot(epoch))
    )
    found = None
    for index in range(pkg.st.get_committee_count_per_slot(spec, state, epoch)):
        committee = pkg.st.get_beacon_committee(spec, state, slot, index)
        for pos, v in enumerate(committee):
            if int(v) in net.owned[0]:
                found = (index, committee, pos, int(v))
                break
        if found:
            break
    index, committee, pos, v = found

    def crafted(root):
        data = pkg.c.AttestationData(
            slot=slot, index=index, beacon_block_root=root,
            source=state.current_justified_checkpoint,
            target=pkg.c.Checkpoint(epoch=epoch, root=target_root),
        )
        bits = np.zeros(committee.size, dtype=bool)
        bits[pos] = True
        return node.chain.ns.Attestation(
            aggregation_bits=bits, data=data,
            signature=net.harness._sign(v, pkg.h.compute_signing_root(data, domain)),
        )

    for att in (crafted(node.chain.head.root), crafted(node.chain.genesis_block_root)):
        node.publish_attestation(att)
        net._msg_total += 1
    net.settle()
    stats = net.nodes[1].slasher_service.tick(current_epoch=epoch)
    pooled = len(net.nodes[1].op_pool._attester_slashings)
    done_at = None
    for s in range(slot, slot + 8):
        net.run_slot(s)
        if all(bool(n.chain.head.state.validators[v].slashed) for n in net.nodes):
            done_at = s
            break
    slashed = [
        [i for i, val in enumerate(n.chain.head.state.validators) if val.slashed]
        for n in net.nodes
    ]
    return ({k: stats[k] for k in ("double_vote_slashings",)}, pooled, done_at, v, slashed,
            _view(net))


def test_slasher_gossip_to_block_inclusion():
    """The equivocator slashed on every node of both networks at the same
    slot, nobody else (no false positive), the heads equal."""
    want = _equivocation(REF, r_ln.LocalNetwork(r_minimal(), n_nodes=2, n_validators=16,
                                                slasher=True))
    got = _equivocation(PORT, p_ln.LocalNetwork(p_minimal(), n_nodes=2, n_validators=16,
                                                 slasher=True, device="cpu"))
    stats, pooled, done_at, v, slashed, _ = got
    assert stats["double_vote_slashings"] >= 1 and pooled >= 1
    assert done_at is not None, "equivocator never slashed on all nodes"
    assert slashed == [[v], [v]]
    assert got == want


def test_batched_gossip_finalizes_with_a_batch_a_duty_phase(nets, monkeypatch):
    """``batch_gossip=True`` (the port's option: each duty phase's gossip
    held in every node's processor and drained in batches): after every
    slot each node's head root, justified and finalized checkpoints equal
    the reference network's (holding the gossip changes when a message is
    verified, not which messages a node pools, so its blocks pack the
    same attestations), and a node makes at most its block's and one
    attestation batch's verify calls a slot."""
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain

    with pytest.raises(ValueError):
        p_ln.LocalNetwork(p_minimal(), 2, 16, transport="sockets", device="cpu",
                          batch_gossip=True)
    calls = []
    inner = BeaconChain._batch_verify_items
    monkeypatch.setattr(BeaconChain, "_batch_verify_items",
                        lambda self, items, *a, **k: calls.append(len(items))
                        or inner(self, items, *a, **k))
    net = p_ln.LocalNetwork(p_minimal(), n_nodes=4, n_validators=32, device="cpu",
                            batch_gossip=True)
    _, _, views = nets
    for slot, r, _ in views:
        net.run_slot(slot)
        assert _view(net) == r, f"slot {slot}: batched {_view(net)} != reference {r}"
    slots = EPOCHS * net.spec.preset.SLOTS_PER_EPOCH
    assert net.heads_agree() and net.head_slots() == [slots] * 4
    assert all(f >= 2 for f in net.finalized_epochs()), net.finalized_epochs()
    assert len(calls) <= 2 * slots * 4, len(calls)
    assert max(calls) > 1  # attestations from three peers in one batch
