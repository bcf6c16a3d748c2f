"""Device-batched light-client serving engine: the port of
``lighthouse_tpu/light_client/engine.py``.

``verify_light_client_update`` runs one host pairing per session; this
engine folds a whole batch of heterogeneous sessions (distinct periods,
bitfields, attested roots) into ONE device dispatch (see ``ops/lc/verify``
for the math) behind the backend seam ``set_lc_backend``:

* ``device`` — the default: the batched check on ``set_lc_backend``'s
  ``device`` (default CUDA, raising without it; pass ``device="cpu"`` to run
  the kernels' plain versions on the CPU). Bitfield-masked committee
  aggregation over a device-resident per-period pubkey cache, device h2c for
  the signing roots, one shared-accumulator Miller product and one final
  exponentiation per batch, every field multiply on the hand kernels.
* ``host``   — the per-session ``verify_light_client_update`` loop, taken
  only when selected.

Unlike the reference there is no ``auto`` backend and no environment
variable, and no branch depends on how many cards are visible: a batch is
one dispatch on the engine's device. The reference splits period groups into
shards when several devices are visible, but runs every shard on the same
device, so the split adds checks and uses no second card.

The device path runs under the ``lc_device`` fault domain (stage
``lc.batch_verify``): ``device_full`` -> ``device_reduced`` (split halves,
fresh scalars). With the engine on the CPU a ``cpu_oracle`` rung (the host
loop) follows, as in the reference; with the engine on a card there is none
— a card's fault is never handed to the CPU — and a fully faulted ladder
reports every session unverified: light-client service FAILS CLOSED, a
broken device can never vouch for a session.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls.backend import bucket
from ..device import resolve_device
from ..resilience import SupervisedFault, lc_supervisor
from .verify import precheck_update, sync_signing_root, verify_light_client_update

_BACKEND = "device"
_DEVICE = None  # None: CUDA (device.resolve_device)


def set_lc_backend(name: str, *, device=None) -> None:
    """Select the light-client backend; ``device`` is where ``"device"``
    runs."""
    global _BACKEND, _DEVICE
    if name not in ("device", "host"):
        raise ValueError(f"unknown lc backend {name!r}")
    _BACKEND = name
    _DEVICE = device


def get_lc_backend() -> str:
    return _BACKEND


def get_lc_device():
    return _DEVICE


def device_backend_active() -> bool:
    return _BACKEND == "device"


# --------------------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------------------


class LcEngine:
    """Committee cache and the batched check for one chain spec's geometry
    on one device.

    Committee pubkeys are decompressed ONCE per sync committee (keyed by the
    committee's hash tree root) into host projective limb rows; the device
    cache ``[P_pad, C, 3, 25]`` stacks every known committee so a batch
    mixing periods gathers different rows in the same dispatch."""

    def __init__(self, spec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.committee_size = int(spec.preset.SYNC_COMMITTEE_SIZE)
        self._rows: dict[bytes, int] = {}    # committee root -> cache row
        self._host_rows: list[np.ndarray] = []
        self._cache = None                   # device [P_pad, C, 3, 25]
        self._cache_rows = 0

    # -- committee cache ----------------------------------------------------

    def committee_row(self, committee) -> int:
        """Cache row for a sync committee, decompressing its pubkeys on
        first sight (bls.PublicKey validates encodings + subgroup)."""
        key = bytes(type(committee).hash_tree_root(committee))
        row = self._rows.get(key)
        if row is None:
            from .. import bls
            from ..ops.bls import g1

            pts = [bls.PublicKey.from_bytes(bytes(pk)).point for pk in committee.pubkeys]
            row = len(self._host_rows)
            self._rows[key] = row
            self._host_rows.append(g1.oracle_limbs(pts))
            self._cache = None               # rebuilt (padded) on next use
        return row

    def cache_arr(self):
        """The device committee cache, padded to ``bucket(p)`` rows (a power
        of two, at least 4; zero rows: no session gathers them)."""
        p = len(self._host_rows)
        p_pad = bucket(p)
        if self._cache is None or self._cache_rows != p_pad:
            stacked = np.stack(self._host_rows)
            if p_pad > p:
                pad = np.zeros((p_pad - p,) + stacked.shape[1:], stacked.dtype)
                stacked = np.concatenate([stacked, pad])
            self._cache = torch.from_numpy(stacked).to(self.device)
            self._cache_rows = p_pad
            from ..utils import metrics

            metrics.LC_COMMITTEE_CACHE_BYTES.set(stacked.nbytes)
        return self._cache

    def cache_bytes(self) -> int:
        c = self._cache
        return 0 if c is None else c.numel() * c.element_size()

    # -- marshalling --------------------------------------------------------

    def marshal(self, sessions, genesis_validators_root: bytes, n_pad: int, scalars=None) -> dict:
        """(update, committee) pairs -> padded stage inputs on the engine's
        device. Signing roots and committee rows are host work; pad rows
        broadcast row 0's hash residues (never hash dummy messages) and
        carry valid=False. ``scalars`` ([n_pad] uint64) injects the random
        weights; None draws them."""
        from ..bls.backend import draw_scalars, scalars_to_torch
        from ..bls.serde import parse_g2_bytes
        from ..ops.bls import h2c
        from ..oracle.ciphersuite import DST

        n, c, dev = len(sessions), self.committee_size, self.device
        pidx = np.zeros(n_pad, dtype=np.int64)
        bits = np.zeros((n_pad, c), dtype=bool)
        sig_bytes = np.zeros((n_pad, 96), dtype=np.uint8)
        roots = []
        rows: dict[int, int] = {}  # sessions share committee objects: one root hash each
        for i, (update, committee) in enumerate(sessions):
            row = rows.get(id(committee))
            if row is None:
                row = rows[id(committee)] = self.committee_row(committee)
            pidx[i] = row
            bits[i] = np.asarray(update.sync_aggregate.sync_committee_bits, dtype=bool)
            sig_bytes[i] = np.frombuffer(
                bytes(update.sync_aggregate.sync_committee_signature), dtype=np.uint8
            )
            roots.append(sync_signing_root(self.spec, update, genesis_validators_root))
        parsed = parse_g2_bytes(sig_bytes)
        sig_wf = parsed["wf_ok"] & ~parsed["is_inf"]
        u0, u1 = h2c.hash_to_field_batch(roots, DST, dev)
        if n_pad > n:  # pad by broadcast, not by hashing dummy messages
            u0 = torch.cat([u0, u0[:1].expand((n_pad - n,) + u0.shape[1:])])
            u1 = torch.cat([u1, u1[:1].expand((n_pad - n,) + u1.shape[1:])])
        if scalars is None:
            scalars = draw_scalars(n_pad)
        scalars = np.asarray(scalars, dtype=np.uint64)
        if scalars.shape != (n_pad,):
            raise ValueError(f"scalars must have shape ({n_pad},) for {n} sessions")

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return {
            "pidx": t(pidx), "bits": t(bits), "u0": u0, "u1": u1,
            "sxc0": t(parsed["x_c0"]), "sxc1": t(parsed["x_c1"]),
            "s_flag": t(parsed["s_flag"]), "sig_wf": t(sig_wf),
            "scalars": scalars_to_torch(scalars, dev), "valid": t(np.arange(n_pad) < n),
        }

    # -- verify -------------------------------------------------------------

    def run(self, b: dict):
        """The three stages on marshalled inputs -> bool tensor verdict."""
        from ..ops.lc import verify

        cache = self.cache_arr()
        mxa, mya = verify.lc_h2c(b["u0"], b["u1"])
        pkx, pky, sax, say, set_ok = verify.lc_prep(
            cache, b["pidx"], b["bits"], b["sxc0"], b["sxc1"], b["s_flag"], b["sig_wf"],
            b["scalars"], b["valid"],
        )
        return verify.lc_pair(pkx, pky, sax, say, mxa, mya, set_ok, b["valid"])

    def verify_batch(self, sessions, genesis_validators_root: bytes, *, scalars=None) -> bool:
        """ONE combined pairing check for the whole batch of ``(update,
        committee)`` sessions, padded to a power-of-two row count (at least
        4) — signature verdict only; the host prechecks (participation
        floor, merkle branches) are the dispatch layer's job."""
        n = len(sessions)
        if n == 0:
            return True
        b = self.marshal(sessions, genesis_validators_root, bucket(n), scalars)
        return bool(self.run(b))

    # -- instrumentation ----------------------------------------------------

    def compile_probe(self, batch: int, periods: int = 4) -> dict:
        """Run one batch of the given shape (n_pad = bucket(batch) rows
        against a ``periods``-row committee cache of infinity points) on the
        engine's device and report what it ran, from ``PROBE`` deltas:
        pairing checks per batch, pairs per check, masked aggregation sums.
        The reference lowers its graph instead; a torch program is its
        run, so the counts are the same property."""
        from ..ops.bls import curve
        from ..ops.lc import verify

        n_pad, c, dev = bucket(batch), self.committee_size, self.device
        z25 = torch.zeros((n_pad, 25), dtype=torch.int64, device=dev)
        u = torch.zeros((n_pad, 2, 25), dtype=torch.int64, device=dev)
        cache = curve.inf_point(1, (periods, c), dev).contiguous()
        ones = torch.ones(n_pad, dtype=torch.bool, device=dev)
        before = dict(verify.PROBE)
        mxa, mya = verify.lc_h2c(u, u)
        pre = verify.lc_prep(
            cache, torch.zeros(n_pad, dtype=torch.int64, device=dev),
            torch.ones((n_pad, c), dtype=torch.bool, device=dev), z25, z25,
            torch.zeros(n_pad, dtype=torch.int64, device=dev), ones,
            torch.ones(n_pad, dtype=torch.int64, device=dev), ones,
        )
        verify.lc_pair(*pre[:4], mxa, mya, pre[4], ones)
        checks = verify.PROBE["pairing_checks"] - before["pairing_checks"]
        return {
            "batch": n_pad,
            "committee_size": c,
            "pairing_checks_per_batch_trace": checks,
            "pairs_per_check": (verify.PROBE["pairs"] - before["pairs"]) // max(1, checks),
            "agg_sums_per_batch_trace": verify.PROBE["agg_sums"] - before["agg_sums"],
            "conv_impl": "fused_mul" if dev.type == "cuda" else "plain",
        }


# --------------------------------------------------------------------------------------
# Module-level dispatch (the seam the serving tier calls)
# --------------------------------------------------------------------------------------

_engines: dict = {}


def get_engine(spec, device=None) -> LcEngine:
    """The engine of ``spec``'s preset on ``device`` (default: the backend's
    device, CUDA when none is set), built once per (preset, device)."""
    dev = resolve_device(_DEVICE if device is None else device)
    key = (spec.preset.name, str(dev))
    eng = _engines.get(key)
    if eng is None:
        eng = _engines[key] = LcEngine(spec, dev)
    return eng


def _device_verdicts(eng, sessions, gvr, pre_ok):
    """Per-session verdicts through the batched engine: host prechecks
    first (sessions failing them are False without touching the device),
    then one combined check over the rest; a failing batch bisects so one
    bad session cannot take honest neighbours down with it."""
    verdicts = list(pre_ok)
    live = [i for i, ok in enumerate(pre_ok) if ok]
    if not live:
        return verdicts

    def descend(idxs):
        if eng.verify_batch([sessions[i] for i in idxs], gvr):
            for i in idxs:
                verdicts[i] = True
            return
        if len(idxs) == 1:
            verdicts[idxs[0]] = False
            return
        mid = len(idxs) // 2
        descend(idxs[:mid])
        descend(idxs[mid:])

    descend(live)
    return verdicts


def verify_update_batch(
    spec, sessions, genesis_validators_root: bytes, finality_required: bool = False,
) -> list[bool]:
    """Backend-dispatched batch verification — THE serving entry point.
    ``sessions`` is a list of ``(update, sync_committee)`` pairs; returns one
    verdict per session. Host backend: the per-session oracle loop. Device
    backend: the batched engine under the ``lc_device`` ladder, the device
    resolved (and a missing card raised) before the supervised region; a
    fully faulted ladder FAILS CLOSED (every session reported unverified)."""
    gvr = bytes(genesis_validators_root)
    n = len(sessions)
    if n == 0:
        return []
    if not device_backend_active():
        return [
            verify_light_client_update(spec, u, c, gvr, finality_required)
            for u, c in sessions
        ]
    eng = get_engine(spec)
    pre_ok = [precheck_update(spec, u, finality_required) for u, _ in sessions]

    def device_full():
        return _device_verdicts(eng, sessions, gvr, pre_ok)

    def device_reduced():
        # halved batches, fresh scalars: a size-dependent fault on the full
        # shape doesn't take the device path down with it
        mid = max(1, n // 2)
        out = []
        for lo, hi in ((0, mid), (mid, n)):
            if lo == hi:
                continue
            out.extend(_device_verdicts(eng, sessions[lo:hi], gvr, pre_ok[lo:hi]))
        return out

    rungs = [("device_full", device_full), ("device_reduced", device_reduced)]
    if eng.device.type == "cpu":
        # a card's fault is never handed to the CPU: with the engine on a
        # card the ladder ends at device_reduced and fails closed
        rungs.append(("cpu_oracle", lambda: [
            verify_light_client_update(spec, u, c, gvr, finality_required)
            for u, c in sessions
        ]))
    try:
        return list(lc_supervisor().run_ladder("lc.batch_verify", rungs))
    except SupervisedFault:
        return [False] * n  # fail CLOSED: never a false-verified session
