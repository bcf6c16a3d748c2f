"""Carry the reference's limb arrays and states across to the port, and back.

The reference holds field elements as uint64 limb planes ``[..., 25]`` (and
points as ``[..., 3k, 25]``, the pubkey cache as ``[N, 3, 25]``). The port
holds the same planes as int64 tensors: torch has no uint64 arithmetic. Every
limb the reference produces is far below 2^63, which ``to_torch`` checks.
This system has no weights; these arrays take their place in the tests, so
that both sides compute on the same values. Beacon states and signed blocks
cross as SSZ bytes (``state_from_ssz`` / ``state_to_ssz``,
``block_from_ssz`` / ``block_to_ssz``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def to_torch(arr, device=None) -> torch.Tensor:
    """numpy / JAX uint64 (or any integer) array -> int64 tensor on ``device``
    (default CUDA; see ``device.resolve_device``). Booleans stay boolean."""
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(dev)
    if a.dtype.kind not in "iu":
        raise TypeError(f"expected an integer array, got {a.dtype}")
    if a.dtype == np.uint64 and a.size and int(a.max()) >= 1 << 63:
        raise ValueError("limb value >= 2^63 does not fit the port's int64 limbs")
    return torch.from_numpy(a.astype(np.int64)).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 (or bool) tensor -> numpy uint64 (bool) array on the host, the
    reference's dtype. Negative values cannot be limbs and raise."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.bool_:
        return a
    if a.size and int(a.min()) < 0:
        raise ValueError("negative value cannot be a limb")
    return a.astype(np.uint64)


def state_from_ssz(spec, fork: str, data: bytes):
    """SSZ bytes of a ``fork`` BeaconState (the reference's
    ``state.serialize()``) -> the port's typed state, so that both packages
    compute on the same state."""
    from .types.containers import for_preset

    return for_preset(spec.preset.name).state_types[fork].decode(bytes(data))


def state_to_ssz(state) -> bytes:
    """The port's state -> SSZ bytes, which the reference's state type decodes."""
    return state.serialize()


def block_from_ssz(spec, fork: str, data: bytes):
    """SSZ bytes of a ``fork`` SignedBeaconBlock (the reference's
    ``signed_block.serialize()``) -> the port's typed signed block."""
    from .types.containers import for_preset

    return for_preset(spec.preset.name).block_types[fork].decode(bytes(data))


def block_to_ssz(signed_block) -> bytes:
    """The port's signed block -> SSZ bytes, which the reference's block
    type of the same fork decodes."""
    return signed_block.serialize()


def _g1_affine(p):
    """A G1 affine point as (x, y) ints, or None for infinity. Takes the
    reference's tuples or any two-int sequence (a numpy row included)."""
    if p is None:
        return None
    return (int(p[0]), int(p[1]))


def _g2_affine(p):
    """A G2 affine point as the port's (Fq2, Fq2), or None for infinity.
    Takes the reference's (Fq2, Fq2) (anything with ``c0``/``c1``) or four
    ints x.c0, x.c1, y.c0, y.c1 (a numpy row included)."""
    from .oracle.fields import Fq2

    if p is None:
        return None
    if hasattr(p[0], "c0"):
        return (Fq2(int(p[0].c0), int(p[0].c1)), Fq2(int(p[1].c0), int(p[1].c1)))
    c = [int(v) for v in p]
    return (Fq2(c[0], c[1]), Fq2(c[2], c[3]))


def trusted_setup_from_ref(setup):
    """The reference's ``TrustedSetup`` (its oracle's affine points; rows of
    ints or numpy arrays also do) -> the port's ``kzg.TrustedSetup`` on the
    same points, the Lagrange points kept in their bit-reversed order."""
    from .kzg.setup import TrustedSetup

    return TrustedSetup(
        [_g1_affine(p) for p in setup.g1_lagrange_brp],
        [_g1_affine(p) for p in setup.g1_monomial],
        [_g2_affine(p) for p in setup.g2_monomial],
    )


def verify_tables_from_ref(tables, device=None):
    """The reference's ``ops.kzg.verify.VerifyTables`` (uint64 limb arrays,
    an int32 permutation) -> the port's ``VerifyTables`` of int64 tensors on
    ``device`` (default CUDA)."""
    from .ops.kzg.verify import VerifyTables

    return VerifyTables(*(to_torch(np.asarray(a), device) for a in tables))
