"""The port's state transition against the reference's.

``lighthouse_tpu_torch.state_transition`` is the port's copy of
``lighthouse_tpu.state_transition``, whose bulk block-signature batch goes to
the port's ``bls`` device arm (here on ``device="cpu"``, so the plan and
chain kernels' plain versions run). Interop genesis, ``process_slots``
across epoch boundaries (the port's numpy epoch path and its torch sweep on
the CPU) and ``per_block_processing`` of a signed electra block under
``VERIFY_BULK`` must give the reference's post-state, byte for byte and by
``tree_root``; the block's signatures go to the port's ``bls`` as exactly
one batch; the same block with a poisoned attestation signature raises in
both packages. Blocks and states cross as SSZ bytes; the blocks come from
the reference's ``StateHarness`` (signed with its native backend).
Tolerance: exact equality everywhere.
"""

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as R
from lighthouse_tpu import state_transition as r_st
from lighthouse_tpu.state_transition.genesis import interop_genesis_state as r_genesis
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types import spec as r_spec
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as P
from lighthouse_tpu_torch import state_transition as p_st
from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state as p_genesis
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types import spec as p_spec

N = 64
FORKS = ("altair", "bellatrix", "capella", "deneb", "electra")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    saved = (R.get_backend(), P.get_backend(), P.get_device(), r_bls.get_backend(),
             p_bls.get_backend(), p_bls.get_device())
    r_bls.set_backend("native")
    p_bls.set_backend("device", device="cpu")
    yield
    R.set_backend(saved[0])
    P.set_backend(saved[1], device=saved[2])
    r_bls.set_backend(saved[3])
    p_bls.set_backend(saved[4], device=saved[5])


def _specs(upto: str | None):
    """(reference spec, port spec) of the minimal preset with every fork up
    to ``upto`` at epoch 0 (None: phase0)."""
    kw = {} if upto is None else {f"{f}_fork_epoch": 0 for f in FORKS[: FORKS.index(upto) + 1]}
    return r_spec.minimal_spec(**kw), p_spec.minimal_spec(**kw)


def _port_state(pspec, state):
    return convert.state_from_ssz(pspec, state.fork_name, state.serialize())


@pytest.mark.parametrize("upto", [None, "altair", "electra"])
def test_interop_genesis_matches_reference(upto):
    rspec, pspec = _specs(upto)
    r, p = r_genesis(rspec, N), p_genesis(pspec, N)
    assert p.serialize() == r.serialize()
    assert p.tree_root() == r.tree_root()


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("upto", [None, "electra"])
def test_process_slots_across_epoch_boundaries(upto, backend):
    """Empty slots through two boundaries: per-slot roots, the epoch
    transition (the port's numpy path, or its torch sweep on the CPU) and
    the per-epoch resets all agree with the reference's numpy path."""
    rspec, pspec = _specs(upto)
    r = r_genesis(rspec, N)
    p = _port_state(pspec, r)
    target = 2 * rspec.preset.SLOTS_PER_EPOCH + 3
    R.set_backend("numpy")
    r_st.process_slots(rspec, r, target)
    P.set_backend(backend, device="cpu" if backend == "device" else None)
    p_st.process_slots(pspec, p, target)
    assert p.serialize() == r.serialize()
    assert p.tree_root() == r.tree_root()


@pytest.fixture(scope="module")
def electra_block():
    """(reference spec, pre-state, signed block, poisoned block): an electra
    block at slot 10 with the previous slot's attestations and a full sync
    aggregate, on a chain of 9 blocks."""
    saved = (R.get_backend(), r_bls.get_backend())
    R.set_backend("numpy")
    r_bls.set_backend("native")
    try:
        rspec, _ = _specs("electra")
        h = StateHarness(rspec, N)
        h.extend_chain(9)
        pre = h.state.copy()
        att_slot = pre.slot
        atts = h.attestations_for_slot(pre, att_slot, h.head_root(pre))
        block = h.produce_block(pre.slot + 1, attestations=atts)
        bad = type(block).decode(block.serialize())
        att = bad.message.body.attestations[0]
        att.signature = bytes(block.message.body.randao_reveal)  # a valid point, wrong signer
        r_st.process_slots(rspec, pre, block.message.slot)
        return rspec, pre, block, bad
    finally:
        R.set_backend(saved[0])
        r_bls.set_backend(saved[1])


def test_block_verify_bulk_matches_reference(electra_block, monkeypatch):
    rspec, pre, block, _ = electra_block
    _, pspec = _specs("electra")
    ref = pre.copy()
    r_st.per_block_processing(rspec, ref, block, strategy=r_st.BlockSignatureStrategy.VERIFY_BULK)

    p = _port_state(pspec, pre)
    pblock = p_con.for_preset("minimal").block_types["electra"].decode(block.serialize())
    batches = []
    real = p_bls.verify_signature_sets

    def counting(sets, **kw):
        batches.append(len(list(sets)))
        return real(sets, **kw)

    monkeypatch.setattr(p_bls, "verify_signature_sets", counting)
    P.set_backend("device", device="cpu")
    p_st.per_block_processing(pspec, p, pblock, strategy=p_st.BlockSignatureStrategy.VERIFY_BULK)
    assert len(batches) == 1 and batches[0] >= 4, batches  # proposer, randao, att(s), sync
    assert p.serialize() == ref.serialize()
    assert p.tree_root() == ref.tree_root() == bytes(block.message.state_root)


def test_poisoned_block_raises_in_both(electra_block):
    rspec, pre, _, bad = electra_block
    _, pspec = _specs("electra")
    with pytest.raises(r_st.BlockProcessingError):
        r_st.per_block_processing(rspec, pre.copy(), bad,
                                  strategy=r_st.BlockSignatureStrategy.VERIFY_BULK)
    p = _port_state(pspec, pre)
    before = p.serialize()
    pbad = p_con.for_preset("minimal").block_types["electra"].decode(bad.serialize())
    with pytest.raises(p_st.BlockProcessingError, match="bulk signature"):
        p_st.per_block_processing(pspec, p, pbad, strategy=p_st.BlockSignatureStrategy.VERIFY_BULK)
    assert p.serialize() == before  # the batch fails before any state change


def test_block_without_cuda_raises(electra_block):
    """The port's bls defaults to CUDA: with no card, the block's batch
    raises instead of running on the CPU, before any state change."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, pre, block, _ = electra_block
    _, pspec = _specs("electra")
    p = _port_state(pspec, pre)
    before = p.serialize()
    pblock = p_con.for_preset("minimal").block_types["electra"].decode(block.serialize())
    p_bls.set_backend("device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_st.per_block_processing(pspec, p, pblock, strategy=p_st.BlockSignatureStrategy.VERIFY_BULK)
    assert p.serialize() == before
