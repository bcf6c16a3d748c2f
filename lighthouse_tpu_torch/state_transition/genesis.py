"""Genesis construction: interop/deterministic validators.

Parity: ``beacon_node/genesis/src/interop.rs`` (deterministic
keypairs + quick-start genesis) and the spec's
``initialize_beacon_state_from_eth1``. Interop secret keys follow the
eth2-interop convention: sk_i = int_LE(sha256(uint_LE_32(i))) mod r.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..oracle import ciphersuite as cs
from ..oracle import curves as oc
from ..oracle.fields import R as CURVE_ORDER
from ..ssz.sha256 import sha256
from ..types.containers import Eth1Data, Fork, Validator, for_preset
from ..types.spec import ChainSpec, FAR_FUTURE_EPOCH

# The mock execution layer's genesis block hash (``lighthouse_tpu/execution_layer/
# mock.py``): post-merge interop genesis starts the execution chain there.
GENESIS_BLOCK_HASH = hashlib.sha256(b"lighthouse_tpu mock execution genesis").digest()

ETH1_BLOCK_HASH = b"\x42" * 32
GENESIS_SLOT = 0
GENESIS_EPOCH = 0


def interop_secret_keys(n: int) -> list[int]:
    return [
        int.from_bytes(sha256(i.to_bytes(32, "little")), "little") % CURVE_ORDER
        for i in range(n)
    ]


def interop_keypairs(n: int):
    sks = interop_secret_keys(n)
    return [(sk, oc.g1_compress(cs.sk_to_pk(sk))) for sk in sks]


def interop_genesis_state(
    spec: ChainSpec, n_validators: int, genesis_time: int = 0
):
    """Build a post-activation genesis state with n deterministic validators,
    at the fork active at epoch 0 (phase0 or altair)."""
    ns = for_preset(spec.preset.name)
    fork_name = spec.fork_name_at_epoch(GENESIS_EPOCH)
    state_cls = ns.state_types.get(fork_name)
    if state_cls is None:
        raise ValueError(f"genesis fork {fork_name} not yet supported")
    state = state_cls()

    keypairs = interop_keypairs(n_validators)
    validators = []
    for _, pk in keypairs:
        wc = b"\x00" + sha256(pk)[1:]
        validators.append(
            Validator(
                pubkey=pk,
                withdrawal_credentials=wc,
                effective_balance=spec.max_effective_balance,
                slashed=False,
                activation_eligibility_epoch=GENESIS_EPOCH,
                activation_epoch=GENESIS_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
    state.genesis_time = genesis_time
    state.validators = validators
    state.balances = np.full(
        n_validators, spec.max_effective_balance, dtype=np.uint64
    )
    version = spec.fork_version(fork_name)
    state.fork = Fork(
        previous_version=version, current_version=version, epoch=GENESIS_EPOCH
    )
    state.eth1_data = Eth1Data(
        deposit_root=b"\x00" * 32,
        deposit_count=n_validators,
        block_hash=ETH1_BLOCK_HASH,
    )
    state.eth1_deposit_index = n_validators
    state.randao_mixes = [
        ETH1_BLOCK_HASH for _ in range(spec.preset.EPOCHS_PER_HISTORICAL_VECTOR)
    ]
    from ..types.containers import BeaconBlockHeader

    body_cls = ns.body_types[fork_name]
    state.latest_block_header = BeaconBlockHeader(
        body_root=body_cls.hash_tree_root(body_cls())
    )
    state.genesis_validators_root = _validators_root(spec, validators)

    if fork_name != "phase0":
        state.previous_epoch_participation = np.zeros(n_validators, np.uint8)
        state.current_epoch_participation = np.zeros(n_validators, np.uint8)
        state.inactivity_scores = np.zeros(n_validators, np.uint64)
        from .per_epoch import get_next_sync_committee

        sc = get_next_sync_committee(spec, state)
        state.current_sync_committee = sc
        state.next_sync_committee = get_next_sync_committee(spec, state)
    from ..types.spec import fork_at_least

    if fork_at_least(fork_name, "bellatrix"):
        # post-merge interop genesis: the execution chain starts at the mock
        # EL's genesis block so payload parent hashes link up
        # (interop.rs + mock_execution_layer genesis wiring)
        hdr_cls = ns.payload_header_types[fork_name]
        state.latest_execution_payload_header = hdr_cls(
            block_hash=GENESIS_BLOCK_HASH,
            timestamp=genesis_time,
            prev_randao=ETH1_BLOCK_HASH,
        )
    if fork_at_least(fork_name, "electra"):
        from .common import compute_activation_exit_epoch
        from .electra import UNSET_DEPOSIT_REQUESTS_START_INDEX

        state.deposit_requests_start_index = UNSET_DEPOSIT_REQUESTS_START_INDEX
        state.earliest_exit_epoch = compute_activation_exit_epoch(
            spec, GENESIS_EPOCH
        )
        state.earliest_consolidation_epoch = compute_activation_exit_epoch(
            spec, GENESIS_EPOCH
        )
        # interop validators carry 32 ETH with 0x00 credentials: effective
        # balance ceiling is min_activation_balance, already satisfied
    return state


def _validators_root(spec: ChainSpec, validators) -> bytes:
    from ..ssz import List
    from ..types.containers import Validator

    t = List(Validator, spec.preset.VALIDATOR_REGISTRY_LIMIT)
    return t.hash_tree_root(validators)
