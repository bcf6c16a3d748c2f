"""The port's epoch engine (PyTorch sweep on ``device="cpu"``) against the
port's numpy twin and the reference's numpy ``per_epoch``.

``lighthouse_tpu_torch.epoch_engine`` ports ``lighthouse_tpu/epoch_engine``:
the sweep (``kernels.py``) is eager torch code on an explicit device, the
registry mirror holds int64/bool tensors. The states are the reference
suite's own randomized states (``tests/test_epoch_engine.py``: every
edge population, electra queues with churn-straddling deposits and
chained consolidations); each crosses to the port as SSZ bytes. Three runs
of one boundary must give the same SSZ bytes (every field) and the same
``tree_root``: the reference's numpy path, the port's numpy path, the port's
torch sweep. One state per family also goes through the reference's JAX
sweep (CPU). The int64 number format is pinned at its edges: the far-future
sentinel, the 2^21 headroom case and ``_isqrt`` near 2^62. Tolerance: exact
equality everywhere.
"""

import math

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
import test_epoch_engine as ref_states  # the reference suite's state constructors
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as R
from lighthouse_tpu.state_transition.per_epoch import process_epoch as r_process_epoch
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as P
from lighthouse_tpu_torch import resilience
from lighthouse_tpu_torch.epoch_engine import kernels
from lighthouse_tpu_torch.resilience.inject import injector
from lighthouse_tpu_torch.state_transition import common as p_common
from lighthouse_tpu_torch.state_transition import electra as p_electra
from lighthouse_tpu_torch.state_transition.per_epoch import process_epoch as p_process_epoch
from lighthouse_tpu_torch.types import spec as p_spec
from lighthouse_tpu_torch.types.containers import Validator as PValidator

FAR_FUTURE = 2**64 - 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    """Each test leaves both packages' epoch and bls backends as it found them."""
    saved = (R.get_backend(), P.get_backend(), P.get_device(), r_bls.get_backend(),
             p_bls.get_backend(), p_bls.get_device())
    yield
    R.set_backend(saved[0])
    P.set_backend(saved[1], device=saved[2])
    r_bls.set_backend(saved[3])
    p_bls.set_backend(saved[4], device=saved[5])


def _pspec(fork: str):
    if fork == "phase0":
        return p_spec.minimal_spec()
    if fork == "electra":
        return p_spec.minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                                   capella_fork_epoch=0, deneb_fork_epoch=0,
                                   electra_fork_epoch=0)
    if fork == "deneb":
        return p_spec.minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                                   capella_fork_epoch=0, deneb_fork_epoch=0)
    return p_spec.minimal_spec(altair_fork_epoch=0)


def _port(state, fork):
    return convert.state_from_ssz(_pspec(fork), state.fork_name, state.serialize())


def _device(fork, pstate):
    P.set_backend("device", device="cpu")
    assert P.maybe_process_epoch_on_device(_pspec(fork), pstate), "the sweep refused the state"


def _numpy(fork, pstate):
    P.set_backend("numpy")
    p_process_epoch(_pspec(fork), pstate)


def _three(rspec, state, fork):
    """One boundary three ways; returns the reference's post-state."""
    ref = state.copy()
    R.set_backend("numpy")
    r_process_epoch(rspec, ref)
    twin, dev = _port(state, fork), _port(state, fork)
    _numpy(fork, twin)
    _device(fork, dev)
    assert twin.serialize() == ref.serialize()
    assert dev.serialize() == ref.serialize()
    assert dev.tree_root() == twin.tree_root() == ref.tree_root()
    return ref


def _random(fork, seed, **kw):
    return ref_states._random_state(ref_states._spec(fork), fork, seed, **kw)


@pytest.mark.parametrize("fork", ["phase0", "altair", "electra"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_parity(fork, seed):
    rspec = ref_states._spec(fork)
    state = (ref_states._electra_state(rspec, seed) if fork == "electra"
             else _random(fork, seed))
    _three(rspec, state, fork)


@pytest.mark.parametrize("fork", ["phase0", "altair", "electra"])
def test_inactivity_leak_parity(fork):
    rspec = ref_states._spec(fork)
    state = (ref_states._electra_state(rspec, 19, cur_epoch=7) if fork == "electra"
             else _random(fork, 7, cur_epoch=7))
    state.finalized_checkpoint = type(state.finalized_checkpoint)(epoch=0, root=b"\x11" * 32)
    _three(rspec, state, fork)


@pytest.mark.parametrize("fork", ["altair", "electra"])
def test_genesis_epoch_boundary_parity(fork):
    rspec = ref_states._spec(fork)
    state = (ref_states._electra_state(rspec, 23, cur_epoch=1) if fork == "electra"
             else _random(fork, 3, cur_epoch=1))
    _three(rspec, state, fork)


def test_deneb_family_parity():
    from lighthouse_tpu.types.spec import minimal_spec

    rspec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                         capella_fork_epoch=0, deneb_fork_epoch=0)
    state = ref_states._random_state(rspec, "altair", 42)
    assert state.fork_name == "deneb"
    _three(rspec, state, "deneb")


@pytest.mark.parametrize("overshoot", [0, 1])
def test_electra_churn_boundary_parity(overshoot):
    """A deposit exactly at the remaining budget fits (strict ``>``); one
    gwei over breaks the sweep, and the carry-out must match."""
    from lighthouse_tpu.state_transition.electra import get_activation_exit_churn_limit
    from lighthouse_tpu.types.containers import for_preset

    rspec = ref_states._spec("electra")
    state = ref_states._electra_state(rspec, seed=11, deposits=False, consolidations=False)
    budget = int(state.deposit_balance_to_consume) + get_activation_exit_churn_limit(rspec, state)
    v = state.validators[5]
    v.slashed = False
    v.exit_epoch = FAR_FUTURE
    v.withdrawable_epoch = FAR_FUTURE
    state.pending_deposits = [for_preset("minimal").PendingDeposit(
        pubkey=bytes(v.pubkey), withdrawal_credentials=bytes(v.withdrawal_credentials),
        amount=budget + overshoot, signature=ref_states._SIG96, slot=0,
    )]
    _three(rspec, state, "electra")


@pytest.mark.parametrize("gate", ["finality", "bridge"])
def test_electra_deposit_gates_parity(gate):
    from lighthouse_tpu.types.containers import for_preset

    rspec = ref_states._spec("electra")
    if gate == "finality":
        state = ref_states._electra_state(rspec, seed=13, consolidations=False)
        q = list(state.pending_deposits)
        v = state.validators[9]
        q.insert(2, for_preset("minimal").PendingDeposit(
            pubkey=bytes(v.pubkey), withdrawal_credentials=bytes(v.withdrawal_credentials),
            amount=3 * 10**9, signature=ref_states._SIG96, slot=rspec.start_slot(20),
        ))
    else:
        state = ref_states._electra_state(rspec, seed=14, consolidations=False)
        state.deposit_requests_start_index = int(state.eth1_deposit_index) + 100
        q = list(state.pending_deposits)
        for d in q[3:]:
            d.slot = 1
    state.pending_deposits = q
    _three(rspec, state, "electra")


def test_electra_unknown_pubkey_deposits_parity():
    """Unknown-pubkey deposits are the host's half: a valid proof of
    possession appends a validator (checked through the port's bls on the
    CPU), a second deposit for the new pubkey tops it up, an invalid one is
    dropped, and each consumes churn."""
    from lighthouse_tpu.state_transition.genesis import interop_secret_keys
    from lighthouse_tpu.types.containers import DepositMessage, for_preset
    from lighthouse_tpu.types.helpers import compute_domain, compute_signing_root

    r_bls.set_backend("native")
    p_bls.set_backend("device", device="cpu")
    rspec = ref_states._spec("electra")
    ns = for_preset("minimal")
    state = ref_states._electra_state(rspec, seed=17, deposits=False, consolidations=False)
    sks = [r_bls.SecretKey.from_bytes(x.to_bytes(32, "big"))
           for x in interop_secret_keys(ref_states.N_VALIDATORS + 2)][-2:]
    domain = compute_domain(rspec.DOMAIN_DEPOSIT, rspec.genesis_fork_version, b"\x00" * 32)

    def signed(sk, amount, prefix, valid=True):
        pk = sk.public_key().serialize()
        wc = prefix + b"\x00" * 31
        msg = DepositMessage(pubkey=pk, withdrawal_credentials=wc, amount=amount)
        sig = sk.sign(compute_signing_root(msg, domain) if valid else b"\x99" * 32)
        return ns.PendingDeposit(pubkey=pk, withdrawal_credentials=wc, amount=amount,
                                 signature=sig.serialize(), slot=0)

    v = state.validators[3]
    state.pending_deposits = [
        signed(sks[0], 40 * 10**9, b"\x02"),
        signed(sks[0], 12 * 10**9, b"\x02"),
        signed(sks[1], 32 * 10**9, b"\x00", valid=False),
        ns.PendingDeposit(pubkey=bytes(v.pubkey),
                          withdrawal_credentials=bytes(v.withdrawal_credentials),
                          amount=2 * 10**9, signature=ref_states._SIG96, slot=0),
    ]
    ref = _three(rspec, state, "electra")
    assert len(ref.validators) == ref_states.N_VALIDATORS + 1


def test_electra_multi_epoch_roll_parity():
    """Three boundaries in a row: the churn carries, the postponed deposits
    and the trimmed consolidation queue round-trip through the outputs, and
    the mirror stays bound (one full gather, then deltas)."""
    rspec = ref_states._spec("electra")
    state = ref_states._electra_state(rspec, seed=5)
    spe = rspec.preset.SLOTS_PER_EPOCH
    ref, dev = state.copy(), _port(state, "electra")
    R.set_backend("numpy")
    for _ in range(3):
        r_process_epoch(rspec, ref)
        ref.slot += spe
        _device("electra", dev)
        dev.slot += spe
    assert dev.serialize() == ref.serialize()
    stats = P.engine_stats(dev)
    assert stats["full_syncs"] == 1 and stats["delta_syncs"] == 2, stats


def test_mirror_delta_journal_across_epochs():
    """Block-level mutations between boundaries reach the resident mirror as
    journal deltas (an exit; a switch to compounding credentials, which
    flips the derived column): no re-gather, same result as numpy."""
    rspec = ref_states._spec("electra")
    state = ref_states._electra_state(rspec, seed=37)
    v = state.validators[8]
    v.withdrawal_credentials = b"\x01" + bytes(v.withdrawal_credentials)[1:]
    v.slashed = False
    v.exit_epoch = FAR_FUTURE
    state.balances[8] = 40 * 10**9
    pspec = _pspec("electra")
    twin, dev = _port(state, "electra"), _port(state, "electra")
    for s, run in ((twin, _numpy), (dev, _device)):
        run("electra", s)
        s.slot += rspec.preset.SLOTS_PER_EPOCH
        p_electra.switch_to_compounding_validator(pspec, s, 8)
        p_common.initiate_validator_exit(pspec, s, 17)
        run("electra", s)
    stats = P.engine_stats(dev)
    assert stats["full_syncs"] == 1 and stats["delta_syncs"] == 1, stats
    assert stats["dirty_rows"] >= 2, stats
    assert dev.serialize() == twin.serialize()


def test_numpy_epoch_invalidates_the_journal():
    """A numpy boundary on a mirrored state mutates validators without
    journaling: the next device sync re-gathers."""
    state = _port(_random("altair", 13), "altair")
    spe = 8
    _device("altair", state)
    state.slot += spe
    _numpy("altair", state)
    state.slot += spe
    _device("altair", state)
    assert P.engine_stats(state)["full_syncs"] == 2


def test_registry_growth_regrows_the_mirror():
    """Appending past the shape bucket (256) between boundaries extends the
    mirror without a rebind; the result equals numpy's."""
    state = _random("altair", 17)
    twin, dev = _port(state, "altair"), _port(state, "altair")

    def deposit(s, k):
        n0 = len(s.validators)
        for j in range(k):
            s.validators = list(s.validators) + [PValidator(
                pubkey=(n0 + j).to_bytes(48, "little"), withdrawal_credentials=b"\x00" * 32,
                effective_balance=32 * 10**9, slashed=False,
                activation_eligibility_epoch=FAR_FUTURE, activation_epoch=FAR_FUTURE,
                exit_epoch=FAR_FUTURE, withdrawable_epoch=FAR_FUTURE,
            )]
            P.mark_registry_delta(s, len(s.validators) - 1)
        s.balances = np.concatenate([np.asarray(s.balances, np.uint64),
                                     np.full(k, 32 * 10**9, np.uint64)])
        for f in ("previous_epoch_participation", "current_epoch_participation"):
            setattr(s, f, np.concatenate([np.asarray(getattr(s, f), np.uint8),
                                          np.zeros(k, np.uint8)]))
        s.inactivity_scores = np.concatenate([np.asarray(s.inactivity_scores, np.uint64),
                                              np.zeros(k, np.uint64)])

    for s, run in ((twin, _numpy), (dev, _device)):
        run("altair", s)
        s.slot += 8
        deposit(s, 200)  # 96 + 200 > 256
        run("altair", s)
    stats = P.engine_stats(dev)
    assert stats["full_syncs"] == 1 and stats["delta_syncs"] == 1, stats
    assert P.engine.mirror_of(dev).n_pad == 512
    assert dev.serialize() == twin.serialize()


def test_lossless_demotion_under_injected_fault():
    """A faulted sweep leaves the state byte-identical and counts a
    fallback; the numpy path then owns the boundary."""
    rspec = ref_states._spec("electra")
    state = ref_states._electra_state(rspec, seed=31)
    dev, twin = _port(state, "electra"), _port(state, "electra")
    sup = resilience.epoch_supervisor()
    sup.reset()
    before = dev.serialize()
    injector.install("stage=epoch.sweep;mode=raise;kind=oom;at=1")
    try:
        P.set_backend("device", device="cpu")
        assert not P.maybe_process_epoch_on_device(_pspec("electra"), dev)
        assert dev.serialize() == before
        assert sup.snapshot()["fallback_calls"] == 1
    finally:
        injector.clear()
        sup.reset()
    _numpy("electra", dev)
    _numpy("electra", twin)
    assert dev.serialize() == twin.serialize()


def test_default_device_raises_without_cuda():
    """The default backend is the device on CUDA: with no card the boundary
    raises — it is not demoted to numpy and leaves the state untouched."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    state = _port(_random("altair", 1), "altair")
    before = state.serialize()
    sup = resilience.epoch_supervisor()
    sup.reset()
    P.set_backend("device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_process_epoch(_pspec("altair"), state)
    assert state.serialize() == before
    assert sup.snapshot()["fallback_calls"] == 0


@pytest.mark.parametrize("fork", ["phase0", "altair", "electra"])
def test_torch_sweep_matches_reference_jax_sweep(fork):
    """One state per family through the reference's JAX sweep (CPU) and the
    port's torch sweep (CPU)."""
    rspec = ref_states._spec(fork)
    state = ref_states._electra_state(rspec, 3) if fork == "electra" else _random(fork, 4)
    dev = _port(state, fork)
    R.set_backend("device")
    assert R.maybe_process_epoch_on_device(rspec, state)
    _device(fork, dev)
    assert dev.serialize() == state.serialize()
    assert dev.tree_root() == state.tree_root()


# ---------------------------------------------------------------------------
# the int64 number format at its edges
# ---------------------------------------------------------------------------


def test_far_future_sentinel_round_trip():
    edge = np.array([0, 1, 2**63 - 2, FAR_FUTURE], np.uint64)
    t = kernels.to_device(edge, "cpu", epochs=True)
    assert t.tolist() == [0, 1, 2**63 - 2, kernels.FAR]
    assert int(t.argsort(stable=True)[-1]) == 3  # the sentinel sorts last
    assert np.array_equal(kernels.from_device(t, epochs=True), edge)
    for bad in (2**63 - 1, 2**63, FAR_FUTURE - 1):
        with pytest.raises(ValueError):
            kernels.to_device(np.array([bad], np.uint64), "cpu", epochs=True)
    bal = np.array([0, 2**63 - 1], np.uint64)
    assert np.array_equal(kernels.from_device(kernels.to_device(bal, "cpu")), bal)
    with pytest.raises(ValueError):
        kernels.to_device(np.array([2**63], np.uint64), "cpu")


def test_far_future_epochs_through_a_boundary():
    """Validators whose epochs sit one below the int64 sentinel and at the
    far future go through a device boundary and come back unchanged where
    numpy leaves them unchanged."""
    state = _random("altair", 21)
    for i in (3, 4):
        v = state.validators[i]
        v.activation_eligibility_epoch = 2**63 - 2
        v.activation_epoch = FAR_FUTURE
        v.exit_epoch = FAR_FUTURE
        v.withdrawable_epoch = 2**63 - 2
    _three(ref_states._spec("altair"), state, "altair")


def test_headroom_at_the_2_21_bucket():
    """n_pad = 2^21 (today's mainnet registry, ~1.1M indices): the
    reference's static u64 bound does not hold against int64, the
    per-sweep bound from a realistic registry does, and a registry that
    would overflow int64 fails the obligation."""
    C = kernels.consts_for(_pspec("electra"), "electra")
    n_pad, n = 2**21, 1_100_000
    static = n_pad * C.max_effective_balance_electra * C.proportional_slashing_multiplier
    assert 2**63 - 1 < static <= 2**64 - 1
    eff = np.zeros(n_pad, np.uint64)
    eff[:n] = 32 * 10**9
    eff[: n // 16] = 64 * 10**9  # compounding validators above 32 ETH
    active = np.zeros(n_pad, bool)
    active[:n] = True
    bal = eff + np.uint64(10**9)
    inact = np.zeros(n_pad, np.uint64)
    ok = kernels.sweep_headroom(C, eff, active, bal, inact, slash_sum=10**15, cur_ep=400_000,
                                dep_amount=np.full(16, 32 * 10**9, np.uint64))
    assert ok <= 2**63 - 1
    eff[:] = C.max_effective_balance_electra  # 2^21 validators at 2048 ETH: the static case
    active[:] = True
    bad = kernels.sweep_headroom(C, eff, active, eff, inact, slash_sum=0, cur_ep=1)
    assert bad > 2**63 - 1


def test_headroom_failure_demotes_the_boundary_losslessly():
    """A state whose sums would overflow int64 fails the per-sweep
    obligation inside the fault domain: the boundary goes to numpy with
    the state untouched."""
    state = _random("altair", 2)
    state.slashings[0] = 2**62  # x the bellatrix-era multiplier: past 2^63
    dev = _port(state, "altair")
    before = dev.serialize()
    sup = resilience.epoch_supervisor()
    sup.reset()
    P.set_backend("device", device="cpu")
    try:
        assert not P.maybe_process_epoch_on_device(_pspec("altair"), dev)
        assert dev.serialize() == before
        assert "epoch_churn_cumsum_headroom" in resilience.recent_faults(1)[0]["error"]
    finally:
        sup.reset()


@pytest.mark.parametrize("t", [
    2**62 - 1, 2**62, 2**62 + 1, (2**31 - 1) ** 2 - 1, (2**31 - 1) ** 2,
    (2**31 - 1) ** 2 + 1, 2**62 - 2**32, 3 * 2**60 + 12345, 10**18, 2**53 + 1,
])
def test_isqrt_near_2_62(t):
    """float64 cannot hold these exactly: the correction steps must."""
    assert int(kernels._isqrt(torch.tensor(t, dtype=torch.int64))) == math.isqrt(t)
