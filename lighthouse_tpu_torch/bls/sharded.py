"""Batched signature-set verification data-parallel over a serving mesh: the
port of the sharded half of ``lighthouse_tpu/bls/tpu_backend.py``
(:376-828).

The mesh is a list of ``torch.device``s (``bls/mesh.py``); shard ``s`` owns
rows ``[s*cap, (s+1)*cap)`` and runs on ``devices[s]``, every launch under
that device's context (``mesh.device_context``). Where the reference maps a
shard-local body over a ``sets`` axis with ``shard_map``, the port loops
over the shards, launching each shard's stages on its device, and reads the
results once after the loop, so shards on distinct cards overlap.

Two serving shapes:

* **combined** (``verify_indexed_sets_sharded``,
  ``verify_signature_sets_sharded[_h2c]``): each shard emits its G2
  signature partial sum, its Miller partial and its set checks; the combine
  on ``devices[0]`` adds the partials, multiplies the Miller partials, runs
  one Miller loop against -g1 and ONE final exponentiation: one verdict.
* **per shard** (``stage_indexed_shards`` -> ``put_staged`` ->
  ``verify_staged_pershard``): each shard runs its own pairing check
  (``local_pair_verdict``), so a poisoned or faulted shard condemns only its
  own sub-batch (the firehose's ``MeshVerifier``).

The shard-local bodies run the single-device stages of ``bls.backend`` at
the shard's row count, on the same hand kernels; the reference's sharded
h2c stage (:376) is ``backend.h2c_stage`` on each shard's rows. Every
entry point takes ``scalars=`` (the RLC scalars, one per padded row) so
tests give both packages the same ones; None draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bls import fq, g1, g2, h2c, pairing, tower
from ..oracle.ciphersuite import DST
from . import backend
from .backend import bucket
from .mesh import device_context, replicate
from .serde import parse_g2_bytes, raw_to_mont


def _karabina() -> bool:
    from .. import bls

    return bls.get_karabina()


def _mesh_pad(n: int, n_dev: int) -> int:
    """The power-of-two row bucket of ``n`` (at least one row a shard),
    rounded up to a multiple of the mesh size."""
    return ((bucket(max(n, n_dev)) + n_dev - 1) // n_dev) * n_dev


def _caches(cache, devices) -> list:
    return replicate(cache, devices) if isinstance(cache, torch.Tensor) else list(cache)


def _scalars(scalars, n_pad: int) -> torch.Tensor:
    """[n_pad] int64 CPU tensor of the RLC scalars' bit patterns."""
    if scalars is None:
        scalars = backend.draw_scalars(n_pad)
    scalars = np.asarray(scalars, dtype=np.uint64)
    if scalars.shape != (n_pad,):
        raise ValueError(f"scalars must have shape ({n_pad},)")
    return backend.scalars_to_torch(scalars, "cpu")


# --------------------------------------------------------------------------------------
# Shard-local bodies
# --------------------------------------------------------------------------------------


def local_prep_partials(cache, idx, mask, sxc0, sxc1, s_flag, sig_wf, scalars, valid):
    """One shard's prep (reference ``_local_prep_partials`` :393):
    signature decompression, cache gather, masked aggregation and the
    security prologue over the shard's rows. Returns the scaled affine
    pubkeys, the shard's G2 signature partial sum ``[1, 6, 25]`` and its
    combined set check ``[1]``."""
    x_mont = raw_to_mont(torch.stack([sxc0, sxc1], dim=-2))
    sig, on_curve = g2.decompress(x_mont, s_flag)
    pk_agg = backend.aggregate_stage(cache[idx], mask)
    set_ok, pk_scaled, sig_part = backend._set_prologue(pk_agg, sig, scalars, valid)
    set_ok = set_ok & (~valid | (sig_wf & on_curve & torch.any(mask, dim=1)))
    pkx, pky = g1.to_affine(pk_scaled)
    return pkx, pky, sig_part[None], torch.all(set_ok)[None]


def local_array_prologue(pk_agg, sig, scalars, valid):
    """One shard's prologue over pre-aggregated keys and decompressed
    signatures (reference ``_sharded_array_prologue_stage`` :432)."""
    set_ok, pk_scaled, sig_part = backend._set_prologue(pk_agg, sig, scalars, valid)
    pkx, pky = g1.to_affine(pk_scaled)
    return pkx, pky, sig_part[None], torch.all(set_ok)[None]


def local_miller_partial(pkx, pky, mxa, mya, valid):
    """One shard's Miller product over its pairs ``[1, 12, 25]`` and whether
    it holds a real row ``[1]`` (reference ``_sharded_miller_stage`` :449)."""
    f = pairing.miller_loop_product(pkx[:, 0, :], pky[:, 0, :], mxa, mya, valid)
    return f[None], torch.any(valid)[None]


def fq12_prod(fs):
    """Product over the leading axis by a halving tree (pads with one)."""
    n = fs.shape[0]
    while n > 1:
        if n % 2:
            fs = torch.cat([fs, tower.one_like(12, fs[:1])])
            n += 1
        fs = tower.fq12_mul(fs[: n // 2], fs[n // 2 :])
        n //= 2
    return fs[0]


def combine_partials(partial_f, partial_sig, ok_parts, any_parts):
    """The cross-shard epilogue (reference ``_sharded_combine_stage`` :471):
    the G2 sum of the shards' signature partials, the Fq12 product of their
    Miller partials, one Miller loop of the sum against -g1 and ONE final
    exponentiation -> the combined verdict (0-d bool tensor)."""
    sig_acc = g2.psum(partial_sig)
    f_all = fq12_prod(partial_f)
    sx, sy = g2.to_affine(sig_acc)
    mgx = fq.dconst(backend._MG1_X, sx)[None]
    mgy = fq.dconst(backend._MG1_Y, sx)[None]
    f_last = pairing.miller_loop_product(mgx, mgy, sx[None], sy[None])
    f = tower.fq12_mul(f_all, f_last)
    ok = tower.fq12_is_one(pairing.final_exponentiation(f, compressed=_karabina()))
    return ok & torch.all(ok_parts) & torch.any(any_parts)


def local_pair_verdict(pkx, pky, mxa, mya, sig_part, ok_part, valid):
    """One shard's own pairing check (reference ``_local_pair_verdict``
    :575): its Miller product with the (-g1, signature partial) pair folded
    in and its OWN final exponentiation, so its verdict stands alone.
    ``sig_part`` is the shard's projective signature sum ``[6, 25]``,
    ``ok_part`` its set check; returns a 0-d bool tensor (False for a shard
    with no real row)."""
    sax, say = g2.to_affine(sig_part)
    return backend.pair_stage(pkx, pky, sax, say, mxa, mya, ok_part, valid)


# --------------------------------------------------------------------------------------
# Combined verdict over the mesh
# --------------------------------------------------------------------------------------


def _combine_over(devices, shard_fn) -> bool:
    """Run ``shard_fn(s, dev) -> (partial_f, partial_sig, ok, any)`` for
    every shard under its device's context, then the combine on
    ``devices[0]``; one host read."""
    parts = []
    for s, dev in enumerate(devices):
        with device_context(dev):
            parts.append(shard_fn(s, dev))
    dev0 = devices[0]
    with device_context(dev0):
        f, sig, ok, anyv = (torch.cat([p[i].to(dev0) for p in parts]) for i in range(4))
        return bool(combine_partials(f, sig, ok, anyv))  # lint: allow(host-sync) the verdict read


def verify_indexed_sets_sharded(cache, items, devices, *, scalars=None) -> bool:
    """``verify_indexed_sets_device`` over the mesh (reference :518): the
    batch padded to a mesh multiple, shard ``s`` verifying its contiguous
    rows on ``devices[s]`` against its replica of the pubkey cache
    (``cache``: one tensor, replicated once per distinct device, or one per
    shard); one combined verdict."""
    n = len(items)
    if n == 0:
        return False
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    n_pad = _mesh_pad(n, n_dev)
    b = backend.prepare_batch(items, scalars, "cpu", n_pad=n_pad)
    caches = _caches(cache, devices)
    cap = n_pad // n_dev

    def shard(s, dev):
        r = {k: v[s * cap:(s + 1) * cap].to(dev) for k, v in b.items()}
        mxa, mya = backend.h2c_stage(r["u0"], r["u1"])
        pkx, pky, sig_part, ok_part = local_prep_partials(
            caches[s], r["idx"], r["mask"], r["sxc0"], r["sxc1"], r["s_flag"], r["sig_wf"],
            r["scalars"], r["valid"],
        )
        f, any_part = local_miller_partial(pkx, pky, mxa, mya, r["valid"])
        return f, sig_part, ok_part, any_part

    return _combine_over(devices, shard)


def _pad_rows(a, n_pad: int, broadcast: bool):
    n = a.shape[0]
    if n_pad == n:
        return a
    fill = a[:1].expand((n_pad - n,) + a.shape[1:]) if broadcast else \
        torch.zeros((n_pad - n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return torch.cat([a, fill])


def _verify_arrays(pk_agg, sig, msgs, n_real: int, devices, scalars, h2c_in: bool) -> bool:
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    n_pad = _mesh_pad(pk_agg.shape[0], n_dev)
    arrs = [_pad_rows(a, n_pad, broadcast=h2c_in) for a in (pk_agg, sig, *msgs)]
    sc = _scalars(scalars, n_pad)
    valid = torch.arange(n_pad) < n_real
    cap = n_pad // n_dev

    def shard(s, dev):
        pk, sg, m0, m1 = (a[s * cap:(s + 1) * cap].to(dev) for a in arrs)
        v = valid[s * cap:(s + 1) * cap].to(dev)
        mx, my = backend.h2c_stage(m0, m1) if h2c_in else (m0, m1)
        pkx, pky, sig_part, ok_part = local_array_prologue(
            pk, sg, sc[s * cap:(s + 1) * cap].to(dev), v)
        f, any_part = local_miller_partial(pkx, pky, mx, my, v)
        return f, sig_part, ok_part, any_part

    return _combine_over(devices, shard)


def verify_signature_sets_sharded(pk_agg, sig, msg_x, msg_y, n_real: int, devices, *,
                                  scalars=None) -> bool:
    """Sharded ``verify_signature_sets_device`` (reference :762): pk_agg
    [n, 3, 25], sig [n, 6, 25], affine messages [n, 2, 25]; padded with
    zero rows (masked) to a mesh multiple; one combined verdict."""
    if n_real == 0:
        return False
    return _verify_arrays(pk_agg, sig, (msg_x, msg_y), n_real, devices, scalars, False)


def verify_signature_sets_sharded_h2c(pk_agg, sig, u0, u1, n_real: int, devices, *,
                                      scalars=None) -> bool:
    """Sharded ``verify_signature_sets_device_h2c`` (reference :796), the
    ``bls.verify_signature_sets`` mesh arm: the h2c stage runs per shard;
    rows re-padded by broadcast to a mesh multiple."""
    if n_real == 0:
        return False
    return _verify_arrays(pk_agg, sig, (u0, u1), n_real, devices, scalars, True)


# --------------------------------------------------------------------------------------
# Per-shard verdicts (the firehose's MeshVerifier)
# --------------------------------------------------------------------------------------


def stage_indexed_shards(shard_items, shard_cap: int, k_pad: int | None = None, *,
                         scalars=None) -> dict:
    """Host stage of the per-shard path (reference :615): one fixed-shape
    sub-batch per shard, each padded to ``shard_cap`` rows (padding per
    SHARD, not per mesh), from lists of (indices, message, sig_bytes).

    Entirely host work (SHA-256 hash_to_field, signature parsing, index and
    mask packing, the RLC scalars), so the firehose prep thread stages tick
    N+1 while the device thread verifies tick N. Returns numpy arrays at
    n_pad = len(shard_items) * shard_cap rows, shard s owning rows
    [s*cap, (s+1)*cap); padded rows hash as the first real message."""
    n_shards = len(shard_items)
    n_pad = n_shards * shard_cap
    k_pad = k_pad or bucket(max((len(ix) for sh in shard_items for ix, _, _ in sh), default=1))
    idx = np.zeros((n_pad, k_pad), dtype=np.int64)
    mask = np.zeros((n_pad, k_pad), dtype=bool)
    sig_bytes = np.zeros((n_pad, 96), dtype=np.uint8)
    valid = np.zeros((n_pad,), dtype=bool)
    msgs, rows = [], []
    for s, sh in enumerate(shard_items):
        if len(sh) > shard_cap:
            raise ValueError(f"shard {s} holds {len(sh)} items > cap {shard_cap}")
        for j, (indices, msg, sb) in enumerate(sh):
            r = s * shard_cap + j
            k = len(indices)
            if k > 0:
                idx[r, :k] = np.asarray(indices, dtype=np.int64)
                mask[r, :k] = True
            sig_bytes[r] = np.frombuffer(sb, dtype=np.uint8)
            valid[r] = True
            msgs.append(msg)
            rows.append(r)
    parsed = parse_g2_bytes(sig_bytes)
    u_shape = (n_pad, 2, fq.NLIMBS)
    if msgs:
        # CPU tensors (host SHA-256): no device read
        ur0, ur1 = (u.numpy() for u in h2c.hash_to_field_batch(msgs, DST, "cpu"))  # lint: allow(host-sync)
        u0 = np.broadcast_to(ur0[:1], u_shape).copy()
        u1 = np.broadcast_to(ur1[:1], u_shape).copy()
        u0[rows], u1[rows] = ur0, ur1
    else:
        u0 = np.zeros(u_shape, dtype=np.int64)
        u1 = np.zeros(u_shape, dtype=np.int64)
    if scalars is None:
        scalars = backend.draw_scalars(n_pad)
    scalars = np.asarray(scalars, dtype=np.uint64)
    if scalars.shape != (n_pad,):
        raise ValueError(f"scalars must have shape ({n_pad},)")
    return {
        "n_pad": n_pad, "k_pad": k_pad, "idx": idx, "mask": mask, "u0": u0, "u1": u1,
        "x_c0": np.asarray(parsed["x_c0"]), "x_c1": np.asarray(parsed["x_c1"]),
        "s_flag": np.asarray(parsed["s_flag"]),
        "sig_wf": np.asarray(parsed["wf_ok"] & ~parsed["is_inf"]),
        "scalars": scalars, "valid": valid,
    }


_STAGED_SET_KEYS = ("idx", "mask", "u0", "u1", "x_c0", "x_c1", "s_flag", "sig_wf", "valid")


def put_staged(staged: dict, devices) -> dict:
    """Upload one staged sub-batch family: shard s's rows to ``devices[s]``
    (reference :694). The copies (from pageable host memory, not
    ``non_blocking``) are enqueued on each device's current stream, the
    stream the device thread's kernels launch on, so a tick staged on the
    firehose prep thread is resident before any kernel reads it: stream
    order is the handoff, no event is needed while neither thread switches
    to a side stream."""
    devices = [torch.device(d) for d in devices]
    cap = staged["n_pad"] // len(devices)
    sc = backend.scalars_to_torch(staged["scalars"], "cpu")
    shards = []
    for s, dev in enumerate(devices):
        rows = slice(s * cap, (s + 1) * cap)
        with device_context(dev):
            sh = {k: torch.from_numpy(np.ascontiguousarray(staged[k][rows])).to(dev)
                  for k in _STAGED_SET_KEYS}
            sh["scalars"] = sc[rows].to(dev)
        sh["real"] = bool(staged["valid"][rows].any())
        shards.append(sh)
    return {"n_pad": staged["n_pad"], "k_pad": staged["k_pad"], "cap": cap, "shards": shards}


def verify_staged_pershard(cache, staged: dict, devices) -> np.ndarray:
    """The per-shard pipeline (h2c, prep, ``local_pair_verdict``) on a
    ``put_staged`` family (reference :708). Returns the ``[n_shards]`` bool
    verdict vector, read once after every shard has launched: shard s's
    bool covers exactly its own ``cap`` rows. A shard with no real row is
    False without a launch (its check would be False by ``any(valid)``)."""
    devices = [torch.device(d) for d in devices]
    caches = _caches(cache, devices)
    oks = []
    for s, dev in enumerate(devices):
        sh = staged["shards"][s]
        if not sh["real"]:
            oks.append(torch.zeros((), dtype=torch.bool, device=dev))
            continue
        with device_context(dev):
            mxa, mya = backend.h2c_stage(sh["u0"], sh["u1"])
            pkx, pky, sig_part, ok_part = local_prep_partials(
                caches[s], sh["idx"], sh["mask"], sh["x_c0"], sh["x_c1"], sh["s_flag"],
                sh["sig_wf"], sh["scalars"], sh["valid"],
            )
            oks.append(local_pair_verdict(pkx, pky, mxa, mya, sig_part[0], ok_part[0],
                                          sh["valid"]))
    with device_context(devices[0]):  # the verdicts gathered onto devices[0], read once
        return torch.stack([o.to(devices[0]) for o in oks]).cpu().numpy()  # lint: allow(host-sync)


def verify_indexed_shards_pershard(cache, shard_items, devices, *, scalars=None) -> np.ndarray:
    """Stage, upload and verify in one call (reference :728): the
    non-pipelined form the tests and the ladder's re-staging rungs use.
    ``shard_items`` holds one list of (indices, message, sig_bytes) per
    device, padded per shard to a shared power-of-two cap."""
    if len(shard_items) != len(devices):
        raise ValueError(f"{len(shard_items)} shards for a {len(devices)}-device mesh")
    cap = bucket(max((len(sh) for sh in shard_items), default=1))
    staged = put_staged(stage_indexed_shards(shard_items, cap, scalars=scalars), devices)
    return verify_staged_pershard(cache, staged, devices)
