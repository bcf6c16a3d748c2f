"""The port's ssz, types and shuffle against the reference's.

``lighthouse_tpu_torch.{ssz,types,ops.shuffle}`` are the port's own copies
of ``lighthouse_tpu.{ssz,types,ops.shuffle}`` (the port imports nothing of
the reference). Every container of both presets and every fork — the
module-level ones, each ``for_preset`` namespace's, the blinded blocks —
gets seeded random values built in the reference's types; their SSZ bytes
decode in the port, encode back to the same bytes, and the port's
``tree_root`` equals the reference's. The shuffle, the hash primitives and
the spec constants are held equal too. Tolerance: exact equality
everywhere.
"""

import dataclasses
import zlib

import numpy as np
import pytest

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import ssz as r_ssz
from lighthouse_tpu.ops import shuffle as r_shuffle
from lighthouse_tpu.ssz import sha256 as r_sha
from lighthouse_tpu.types import blinded as r_blinded
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types import spec as r_spec
from lighthouse_tpu_torch import ssz as p_ssz
from lighthouse_tpu_torch.ops import shuffle as p_shuffle
from lighthouse_tpu_torch.ssz import sha256 as p_sha
from lighthouse_tpu_torch.types import blinded as p_blinded
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types import spec as p_spec

core = r_ssz.core
MAX_LIST = 3  # random list lengths 0..3: every element path, small states


def _rand(typ, rng):
    """A seeded random value of the reference SSZ type ``typ``."""
    if isinstance(typ, type) and issubclass(typ, core.Container):
        return typ(**{n: _rand(t, rng) for n, t in typ.FIELDS})
    if isinstance(typ, core.UInt):
        return int.from_bytes(rng.bytes(typ.byte_len), "little")
    if isinstance(typ, core.Boolean):
        return bool(rng.integers(2))
    if isinstance(typ, core.ByteVector):
        return rng.bytes(typ.length)
    if isinstance(typ, core.ByteList):
        return rng.bytes(int(rng.integers(0, min(typ.limit, 40) + 1)))
    if isinstance(typ, core.Bitvector):
        return rng.random(typ.length) < 0.5
    if isinstance(typ, core.Bitlist):
        return rng.random(int(rng.integers(0, min(typ.limit, 20) + 1))) < 0.5
    if isinstance(typ, core.Vector):
        return [_rand(typ.elem, rng) for _ in range(typ.length)]
    if isinstance(typ, core.List):
        return [_rand(typ.elem, rng) for _ in range(int(rng.integers(0, min(typ.limit, MAX_LIST) + 1)))]
    if isinstance(typ, core.Union):
        sel = int(rng.integers(len(typ.options)))
        t = typ.options[sel]
        return (sel, None if t is None else _rand(t, rng))
    raise TypeError(typ)


def _containers():
    """(label, reference class, port class) for every container."""
    out = []
    for name in dir(r_con):
        rc = getattr(r_con, name)
        if isinstance(rc, type) and issubclass(rc, core.Container) and rc is not core.Container:
            out.append((name, rc, getattr(p_con, name)))
    for preset in ("minimal", "mainnet"):
        rns = r_blinded.blinded_types(r_con.for_preset(preset))
        pns = p_blinded.blinded_types(p_con.for_preset(preset))
        for name, rc in vars(rns).items():
            if isinstance(rc, type) and issubclass(rc, core.Container):
                out.append((f"{preset}.{name}", rc, getattr(pns, name)))
        for fork, rc in rns.blinded_block_types.items():
            out.append((f"{preset}.blinded.{fork}", rc, pns.blinded_block_types[fork]))
    return out


CONTAINERS = _containers()


@pytest.mark.parametrize("label,rc,pc", CONTAINERS, ids=[c[0] for c in CONTAINERS])
def test_container_bytes_and_root_match_reference(label, rc, pc):
    assert [n for n, _ in rc.FIELDS] == [n for n, _ in pc.FIELDS]
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    value = _rand(rc, rng)
    data = rc.encode(value)
    got = pc.decode(data)
    assert pc.encode(got) == data
    assert got.tree_root() == value.tree_root()
    assert pc.decode(pc.encode(pc())).tree_root() == rc().tree_root()  # defaults


def test_registry_roots_after_mutation_match_reference():
    """The port hashes a list of validators in batches and memoises each
    element's root against its field values: a mutated field, a replaced
    element and an appended one must all show in the root."""
    rng = np.random.default_rng(5)
    rv = [_rand(r_con.Validator, rng) for _ in range(300)]
    typ_r = r_ssz.List(r_con.Validator, 1 << 40)
    typ_p = p_ssz.List(p_con.Validator, 1 << 40)
    pv = typ_p.decode(typ_r.encode(rv))
    assert typ_p.hash_tree_root(pv) == typ_r.hash_tree_root(rv)
    assert typ_p.hash_tree_root(pv) == typ_r.hash_tree_root(rv)  # memoised
    for i, (f, v) in enumerate([("exit_epoch", 2**64 - 1), ("slashed", True),
                                ("withdrawal_credentials", b"\x02" * 32),
                                ("effective_balance", 0)]):
        setattr(rv[7 * i], f, v)
        setattr(pv[7 * i], f, v)
        assert typ_p.hash_tree_root(pv) == typ_r.hash_tree_root(rv), f
    rv[11] = _rand(r_con.Validator, rng)
    pv[11] = p_con.Validator.decode(r_con.Validator.encode(rv[11]))
    rv.append(_rand(r_con.Validator, rng))
    pv.append(p_con.Validator.decode(r_con.Validator.encode(rv[-1])))
    assert typ_p.hash_tree_root(pv) == typ_r.hash_tree_root(rv)


@pytest.mark.parametrize("change", ["none", "in_place", "replaced", "resized", "root_list",
                                    "copy_then_mutate", "validator", "validator_replaced",
                                    "validator_appended"])
def test_state_field_roots_follow_every_change(change):
    """A container keeps the roots of its large fields against private
    copies of what decides them (basic fields: the values; the registry:
    its elements' roots, each element's memo dropped by any field set):
    in-place edits, replaced and resized arrays, edited lists of roots, a
    validator's field set, a validator replaced or appended all show in the
    root, equal to the reference's, and a copy mutated after its original
    was hashed does not reuse the original's roots."""
    rng = np.random.default_rng(11)
    n = 5000  # above the memo's size floor
    pstate = p_con.for_preset("mainnet").state_types["altair"]()
    rstate = r_con.for_preset("mainnet").state_types["altair"]()
    rstate.validators = [_rand(r_con.Validator, rng) for _ in range(n)]
    typ_r = r_ssz.List(r_con.Validator, 1 << 40)
    pstate.validators = p_ssz.List(p_con.Validator, 1 << 40).decode(typ_r.encode(rstate.validators))
    pstate.balances = rng.integers(0, 2**40, n, dtype=np.uint64)
    rstate.balances = pstate.balances.copy()
    for name in ("previous_epoch_participation", "current_epoch_participation"):
        arr = rng.integers(0, 8, n, dtype=np.uint8)
        setattr(pstate, name, arr)
        setattr(rstate, name, arr.copy())
    pstate.inactivity_scores = rng.integers(0, 100, n, dtype=np.uint64)
    rstate.inactivity_scores = pstate.inactivity_scores.copy()
    assert pstate.tree_root() == rstate.tree_root()
    assert pstate.tree_root() == rstate.tree_root()  # from the kept roots
    target = pstate
    if change == "copy_then_mutate":
        target = pstate.copy()
        change = "in_place"
    if change == "in_place":
        target.balances[17] += 1
        rstate.balances[17] += 1
        target.inactivity_scores[n - 1] = 7
        rstate.inactivity_scores[n - 1] = 7
    elif change == "replaced":
        target.balances = target.balances[::-1].copy()
        rstate.balances = rstate.balances[::-1].copy()
    elif change == "resized":
        target.balances = np.append(target.balances, np.uint64(5))
        rstate.balances = np.append(rstate.balances, np.uint64(5))
    elif change == "validator":
        target.validators[123].effective_balance = 7
        rstate.validators[123].effective_balance = 7
        target.validators[n - 1].slashed = not target.validators[n - 1].slashed
        rstate.validators[n - 1].slashed = not rstate.validators[n - 1].slashed
    elif change == "validator_replaced":
        v = _rand(r_con.Validator, rng)
        rstate.validators[42] = v
        target.validators[42] = p_con.Validator.decode(r_con.Validator.encode(v))
    elif change == "validator_appended":
        v = _rand(r_con.Validator, rng)
        rstate.validators.append(v)
        target.validators.append(p_con.Validator.decode(r_con.Validator.encode(v)))
    elif change == "root_list":
        target.block_roots[3] = b"\x09" * 32
        rstate.block_roots[3] = b"\x09" * 32
        target.randao_mixes[5000] = b"\x01" * 32
        rstate.randao_mixes[5000] = b"\x01" * 32
    assert target.tree_root() == rstate.tree_root(), change
    if target is not pstate:
        assert pstate.tree_root() != target.tree_root()


def test_registry_encode_matches_reference():
    """Lists of fixed-size containers encode column by column in the port:
    the same bytes as the reference's per-element encode, at the field
    extremes; an out-of-range value raises as the per-element encode does."""
    rng = np.random.default_rng(6)
    rv = [_rand(r_con.Validator, rng) for _ in range(200)]
    for i, (f, v) in enumerate([("exit_epoch", 2**64 - 1), ("slashed", True),
                                ("slashed", False), ("effective_balance", 0),
                                ("activation_epoch", 2**63)]):
        setattr(rv[5 * i], f, v)
    typ_r = r_ssz.List(r_con.Validator, 1 << 40)
    typ_p = p_ssz.List(p_con.Validator, 1 << 40)
    pv = typ_p.decode(typ_r.encode(rv))
    assert typ_p.encode(pv) == typ_r.encode(rv)
    assert typ_p.encode([]) == typ_r.encode([])
    pv[3].effective_balance = 2**64
    with pytest.raises(OverflowError):
        typ_p.encode(pv)
    pv[3].effective_balance = 1
    pv[4].pubkey = b"\x01" * 47
    with pytest.raises(p_ssz.SSZError):
        typ_p.encode(pv)


@pytest.mark.parametrize("n", [1, 7, 300, 5000])
def test_hash_primitives_match_reference(n):
    rng = np.random.default_rng(n)
    blocks = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    assert np.array_equal(p_sha.sha256_pairs(blocks), r_sha.sha256_pairs(blocks))
    assert np.array_equal(p_sha.sha256_short(blocks[:, :37], 37),
                          r_sha.sha256_short(blocks[:, :37], 37))
    chunks = blocks.reshape(-1, 32)
    for limit in (None, 2 * n + 5):
        assert p_ssz.merkleize_chunks(chunks, limit) == r_ssz.merkleize_chunks(chunks, limit)


@pytest.mark.parametrize("n,rounds", [(1, 10), (100, 10), (1000, 90), (4099, 90)])
def test_shuffle_matches_reference(n, rounds):
    seed = np.random.default_rng(n).bytes(32)
    idx = np.arange(n, dtype=np.uint64)
    got = p_shuffle.shuffle_list(idx.copy(), seed, rounds)
    assert np.array_equal(np.asarray(got), np.asarray(r_shuffle.shuffle_list(idx.copy(), seed, rounds)))
    for i in range(0, n, max(1, n // 9)):
        assert (p_shuffle.compute_shuffled_index(i, n, seed, rounds)
                == r_shuffle.compute_shuffled_index(i, n, seed, rounds))


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_spec_constants_match_reference(preset):
    assert dataclasses.asdict(p_spec.PRESETS[preset]) == dataclasses.asdict(r_spec.PRESETS[preset])
    make = {"minimal": (p_spec.minimal_spec, r_spec.minimal_spec),
            "mainnet": (p_spec.mainnet_spec, r_spec.mainnet_spec)}[preset]
    kw = dict(altair_fork_epoch=1, electra_fork_epoch=9)
    assert dataclasses.asdict(make[0](**kw)) == dataclasses.asdict(make[1](**kw))
    assert p_spec.FAR_FUTURE_EPOCH == r_spec.FAR_FUTURE_EPOCH
