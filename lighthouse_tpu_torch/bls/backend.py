"""Batched random-linear-combination signature-set verification on one GPU.

Port of the single-device path of ``lighthouse_tpu/bls/tpu_backend.py``:
``verify_indexed_sets_device`` and its three stages (the firehose's entry),
and ``aggregate_pubkeys_device``, ``verify_signature_sets_device_h2c`` and
``verify_signature_sets_device`` with the aggregation and prologue stages
(the entry of ``lighthouse_tpu_torch.bls.verify_signature_sets``). The
check is blst's ``verify_multiple_aggregate_signatures``:

    prod_i e(r_i * agg_pk_i, H(m_i)) * e(-g1, sum_i r_i * sig_i) == 1

Host: SHA-256 hash_to_field and signature byte parsing. Device, in three
stages: (1) ``h2c_stage`` maps messages to G2; (2) ``prep_stage`` decompresses
signatures, gathers and aggregates pubkeys from the device cache, runs the
subgroup checks fused with the 64-bit RLC scaling and sums the signatures;
(3) ``pair_stage`` runs one shared Miller product and one final
exponentiation: one verdict per batch. Batches are padded to powers of two
(floor 4) exactly as the reference pads them, so stage outputs compare.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bls import curve, fq, g1, g2, h2c, pairing
from ..oracle import curves as _oc
from ..oracle.ciphersuite import DST
from ..oracle.fields import BLS_X
from .serde import parse_g2_bytes, raw_to_mont

RAND_BITS = 64  # blst.rs:16

_MINUS_G1 = _oc.g1_neg(_oc.g1_generator())
_MG1_X = fq.int_to_limbs(_MINUS_G1[0])
_MG1_Y = fq.int_to_limbs(_MINUS_G1[1])


def bucket(n: int, floor: int = 4) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _set_prologue(pk_agg, sig, scalars, valid):
    """Per-set checks + random scaling + masked signature sum: the G2
    subgroup check's |x| chain and the RLC scaling [r]Q share one windowed
    ladder (curve.scale_u64_with_fixed)."""
    accs = curve.scale_u64_with_fixed(2, sig, scalars, (-BLS_X,))
    sig_scaled, abs_x_sig = accs[0], accs[1]
    sig_grp = curve.point_eq(2, g2.psi(sig), curve.point_neg(2, abs_x_sig))
    set_ok = ~valid | (sig_grp & ~g1.is_inf(pk_agg) & ~g2.is_inf(sig))
    pk_scaled = g1.scale_u64(pk_agg, scalars)
    sig_sum = g2.psum(sig_scaled, valid)
    return set_ok, pk_scaled, sig_sum


def aggregate_stage(pts, mask):
    """[n, k_pad, 3, 25] pubkey points + [n, k_pad] mask -> [n, 3, 25]
    per-set sums (the masked tree of ``curve.point_sum``)."""
    return curve.point_sum(1, pts.movedim(1, 0), mask.movedim(1, 0))


def prologue_stage(pk_agg, sig, scalars, valid):
    """The security prologue (subgroup checks, random scaling, masked
    signature sum), ending in affine coordinates for the pairing stage."""
    set_ok, pk_scaled, sig_acc = _set_prologue(pk_agg, sig, scalars, valid)
    pkx, pky = g1.to_affine(pk_scaled)
    sax, say = g2.to_affine(sig_acc)
    return pkx, pky, sax, say, set_ok


def h2c_stage(u0, u1):
    """Stage 1: SSWU + isogeny + cofactor clearing + affine message points."""
    return g2.to_affine(h2c.map_to_g2(u0, u1))


def prep_stage(cache, idx, mask, sxc0, sxc1, s_flag, sig_wf, scalars, valid):
    """Stage 2: decompression + cache gather + masked aggregation + the
    security prologue, ending in affine coordinates for the pairing."""
    x_mont = raw_to_mont(torch.stack([sxc0, sxc1], dim=-2))
    sig, on_curve = g2.decompress(x_mont, s_flag)
    pk_agg = aggregate_stage(cache[idx], mask)  # cache[idx]: [n, k, 3, 25]
    pkx, pky, sax, say, set_ok = prologue_stage(pk_agg, sig, scalars, valid)
    set_ok = set_ok & (~valid | (sig_wf & on_curve & torch.any(mask, dim=1)))
    return pkx, pky, sax, say, set_ok


def pair_inputs(pkx, pky, sax, say, mxa, mya, valid):
    """The Miller product's pairs: each set's (key, message) and (-G1, the
    signature sum); returns (px, py, qx, qy, pair_valid)."""
    px = torch.cat([pkx[:, 0, :], fq.dconst(_MG1_X, pkx)[None]], dim=0)
    py = torch.cat([pky[:, 0, :], fq.dconst(_MG1_Y, pkx)[None]], dim=0)
    qx = torch.cat([mxa, sax[None]], dim=0)
    qy = torch.cat([mya, say[None]], dim=0)
    pair_valid = torch.cat([valid, torch.ones(1, dtype=torch.bool, device=valid.device)])
    return px, py, qx, qy, pair_valid


def pair_stage(pkx, pky, sax, say, mxa, mya, set_ok, valid):
    """Stage 3: one shared Miller product + ONE final exponentiation, its
    |x| powers on Karabina squaring when ``bls.set_backend`` turned it on."""
    from .. import bls

    ok = pairing.multi_pairing_is_one(
        *pair_inputs(pkx, pky, sax, say, mxa, mya, valid), compressed=bls.get_karabina()
    )
    return ok & torch.all(set_ok) & torch.any(valid)


def draw_scalars(n: int) -> np.ndarray:
    """Unpredictable nonzero 64-bit RLC scalars (the reference's draw): the
    RLC is only sound with scalars an attacker cannot predict."""
    return np.array([secrets.randbits(RAND_BITS) or 1 for _ in range(n)], dtype=np.uint64)


def scalars_to_torch(scalars: np.ndarray, device) -> torch.Tensor:
    """uint64 scalars -> int64 tensor of the same 64-bit patterns (values
    >= 2^63 become negative; curve.scale_u64_with_fixed reads them by mask)."""
    a = np.ascontiguousarray(np.asarray(scalars, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def _scalars(scalars, n_pad: int, n: int, device) -> torch.Tensor:
    """Injected RLC scalars ([n_pad] uint64) checked, or fresh ones drawn."""
    if scalars is None:
        scalars = draw_scalars(n_pad)
    scalars = np.asarray(scalars, dtype=np.uint64)
    if scalars.shape != (n_pad,):
        raise ValueError(f"scalars must have shape ({n_pad},) for {n} sets")
    return scalars_to_torch(scalars, device)


def prepare_batch(items, scalars=None, device=None, *, n_pad: int | None = None) -> dict:
    """The host half: bucket padding, hash_to_field, signature parsing, RLC
    scalars. ``items`` is a list of (validator_indices, message, sig_bytes);
    ``n_pad`` (default ``bucket(len(items))``) is the padded row count.
    Returns the stage inputs as tensors on ``device``."""
    dev = resolve_device(device)
    n = len(items)
    n_pad = n_pad or bucket(n)
    k_pad = bucket(max((len(ix) for ix, _, _ in items), default=1))
    idx = np.zeros((n_pad, k_pad), dtype=np.int64)
    mask = np.zeros((n_pad, k_pad), dtype=bool)
    sig_bytes = np.zeros((n_pad, 96), dtype=np.uint8)
    msgs = []
    for i, (indices, msg, sb) in enumerate(items):
        k = len(indices)
        if k > 0:
            idx[i, :k] = np.asarray(indices, dtype=np.int64)
            mask[i, :k] = True
        msgs.append(msg)
        sig_bytes[i] = np.frombuffer(sb, dtype=np.uint8)
    parsed = parse_g2_bytes(sig_bytes)
    sig_wf = parsed["wf_ok"] & ~parsed["is_inf"]
    u0, u1 = h2c.hash_to_field_batch(msgs, DST, dev)
    if n_pad > n:  # pad by broadcast, not by hashing dummy messages
        u0 = torch.cat([u0, u0[:1].expand((n_pad - n,) + u0.shape[1:])])
        u1 = torch.cat([u1, u1[:1].expand((n_pad - n,) + u1.shape[1:])])
    valid = np.arange(n_pad) < n

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return {
        "u0": u0, "u1": u1, "idx": t(idx), "mask": t(mask),
        "sxc0": t(parsed["x_c0"]), "sxc1": t(parsed["x_c1"]),
        "s_flag": t(parsed["s_flag"]), "sig_wf": t(sig_wf),
        "scalars": _scalars(scalars, n_pad, n, dev), "valid": t(valid),
    }


def run_batch(cache, b: dict):
    """The three device stages on prepared inputs -> bool tensor verdict."""
    mxa, mya = h2c_stage(b["u0"], b["u1"])
    pkx, pky, sax, say, set_ok = prep_stage(
        cache, b["idx"], b["mask"], b["sxc0"], b["sxc1"], b["s_flag"], b["sig_wf"],
        b["scalars"], b["valid"],
    )
    return pair_stage(pkx, pky, sax, say, mxa, mya, set_ok, b["valid"])


def verify_indexed_sets_device(cache, items, *, scalars=None, device=None) -> bool:
    """Verify signature sets given as (validator_indices, message, sig_bytes)
    triples against the device-resident pubkey cache ``[N, 3, 25]``.

    ``scalars`` ([n_pad] uint64, n_pad = bucket(len(items))) injects the RLC
    scalars (tests give both sides the same ones); None draws them with
    ``secrets``. ``device`` defaults to CUDA and raises without it; the cache
    must live on that device. Malformed signature bytes or empty index lists
    fail the batch."""
    dev = resolve_device(device)
    if cache.device.type != dev.type:
        raise ValueError(f"pubkey cache is on {cache.device}, verifying on {dev}")
    if not items:
        return False
    return bool(run_batch(cache, prepare_batch(items, scalars, dev)))


def aggregate_pubkeys_device(pts: list, k_pad: int | None = None):
    """List over sets of [k_i, 3, 25] pubkey points (one device) -> [n, 3, 25]
    per-set aggregates: the sets padded to ``k_pad`` (default
    bucket(max k_i)) with masked zeros, then ``aggregate_stage``."""
    n = len(pts)
    k_pad = k_pad or bucket(max((p.shape[0] for p in pts), default=1))
    dev = pts[0].device
    buf = torch.zeros((n, k_pad, 3, fq.NLIMBS), dtype=torch.int64, device=dev)
    mask = np.zeros((n, k_pad), dtype=bool)
    for i, p in enumerate(pts):
        buf[i, : p.shape[0]] = p
        mask[i, : p.shape[0]] = True
    return aggregate_stage(buf, torch.from_numpy(mask).to(dev))


def verify_signature_sets_device(pk_agg, sig, msg_x, msg_y, n_real: int, *, scalars=None) -> bool:
    """pk_agg [n, 3, 25], sig [n, 6, 25] (projective), message points affine
    msg_x/msg_y [n, 2, 25], all on one device; the first ``n_real`` entries
    are real. ``scalars`` ([n] uint64) injects the RLC scalars; None draws
    them."""
    n = pk_agg.shape[0]
    if n_real == 0:
        return False
    dev = pk_agg.device
    valid = torch.arange(n, device=dev) < n_real
    pkx, pky, sax, say, set_ok = prologue_stage(pk_agg, sig, _scalars(scalars, n, n_real, dev), valid)
    # the batch's one verdict read
    return bool(pair_stage(pkx, pky, sax, say, msg_x, msg_y, set_ok, valid))  # lint: allow(host-sync)


def verify_signature_sets_device_h2c(pk_agg, sig, u0, u1, n_real: int, *, scalars=None) -> bool:
    """``verify_signature_sets_device`` with the h2c stage in front: takes the
    messages' hash_to_field residues u0/u1 [n, 2, 25]."""
    if n_real == 0:
        return False
    mx, my = h2c_stage(u0, u1)
    return verify_signature_sets_device(pk_agg, sig, mx, my, n_real, scalars=scalars)
