"""Device-resident slasher engine: whole-network surveillance as one sweep.

The port of ``lighthouse_tpu/slasher/engine.py``. Three layers, host-side
glue only (the sweep itself lives in ``kernels.py``, PyTorch on the span
store's device):

* ``sweep_numpy`` — the field-for-field numpy twin of the reference's
  ``kernels.sweep`` and of ``kernels.sweep_``: same outputs, same
  window/scatter/scan/flag semantics. It is the parity
  oracle, the ``numpy`` backend's serving path, and the demotion target when
  the device faults.
* ``SpanStore`` — the ``[n_validators, history_length]`` min/max distance +
  vote-tag planes, resident on the store's device across ticks (CUDA by
  default; ``device="cpu"`` runs the same torch sweep on the CPU). Epoch
  advance is a shift + neutral fill inside the sweep. Runs under the
  ``slasher_device`` fault domain: a faulted sweep restores the last host
  checkpoint and replays the pair journal through the numpy twin —
  demotion never drops evidence, and it is loud (``note_fallback(rung=
  "numpy")``, ``demotions`` in ``stats()``, the supervisor snapshot) — and
  the supervisor's probation logic re-promotes the device planes later.
  Until the first checkpoint the host copy of fresh planes is only their
  shape (``_Fresh``): a 2^20 x 4096 store allocates its 32 GiB on the
  device and nothing on the host.
* ``EngineSlasher`` — the serving surface (same edges as the seed
  ``Slasher``: accept / process_queued / harvest / prune) built on the
  span store. The sweep only flags; every flagged pair is re-confirmed
  against the fetched attestation record before an ``AttesterSlashing`` is
  emitted ("One For All": the aggregate proves the set signed, the record
  proves which prior vote conflicts), so a demoted or even faulted sweep
  can never emit an unconfirmed slashing. Intake is bounded in PAIRS; any
  evidence shed (overflow, exhausted retries) is counted on the
  ``slasher_surveillance_gap`` metric — loud, never silent.

The reference's ``validator_sharding`` (planes split over a device mesh)
is the span store's ``mesh_devices``: an explicit device list (None or one
entry: off) over which the ``[V, N]`` planes are split into validator row
blocks, each tick's pairs going to their rows' block. No branch depends on
the number of visible cards.
"""

from __future__ import annotations

import threading

import numpy as np

from ..device import resolve_device
from ..utils.metrics import (
    SLASHER_PAIRS_SWEPT,
    SLASHER_SURVEILLANCE_GAP,
)
from .config import MAX_DISTANCE, SlasherConfig

_INT_INF = np.int64(2**31 - 1)
_VOTE_NONE = np.uint32(0xFFFFFFFF)
_MAX_EPOCH = 1 << 24  # kernels.MAX_EPOCH


# =============================================================================
# numpy twin of kernels.sweep (field-for-field)
# =============================================================================


def empty_planes_np(n_validators_pad: int, history_length: int):
    """Neutral (min_d, max_d, vote_h) planes on the host, at the
    reference's widths."""
    v, n = n_validators_pad, history_length
    return (
        np.full((v, n), MAX_DISTANCE, dtype=np.uint16),
        np.zeros((v, n), dtype=np.uint16),
        np.zeros((v, n), dtype=np.uint32),
    )


def sweep_numpy(min_d, max_d, vote_h, delta, vidx, src, tgt, vh, valid, cur, n):
    """Pure-numpy twin of the reference's ``kernels.sweep`` — its signature
    (``n`` positional) and outputs, which ``kernels.sweep_`` gives in place
    on biased planes. Pure function: input planes are never mutated."""
    dl = int(min(max(int(delta), 0), n))
    if dl:
        min_d = np.roll(min_d, -dl, axis=1)
        max_d = np.roll(max_d, -dl, axis=1)
        vote_h = np.roll(vote_h, -dl, axis=1)
        min_d[:, n - dl:] = MAX_DISTANCE
        max_d[:, n - dl:] = 0
        vote_h[:, n - dl:] = 0
    else:
        min_d, max_d, vote_h = min_d.copy(), max_d.copy(), vote_h.copy()

    base = int(cur) - (n - 1)
    e = base + np.arange(n, dtype=np.int64)
    old_min_t = e[None, :] + min_d.astype(np.int64)
    old_max_t = e[None, :] + max_d.astype(np.int64)
    v_cap = min_d.shape[0]
    vidx = np.asarray(vidx, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    tgt = np.asarray(tgt, dtype=np.int64)
    vh = np.asarray(vh, dtype=np.uint32)
    valid = np.asarray(valid, dtype=bool)
    vi = np.clip(vidx, 0, v_cap - 1)

    def hits(col):
        return np.nonzero(valid & (col >= 0) & (col < n))[0]

    col_min = src - 1 - base
    col_max = src + 1 - base
    col_t = tgt - base

    scat_min = np.full((v_cap, n), _INT_INF, np.int64)
    k = hits(col_min)
    np.minimum.at(scat_min, (vi[k], col_min[k]), tgt[k])
    scat_max = np.full((v_cap, n), -_INT_INF, np.int64)
    k = hits(col_max)
    np.maximum.at(scat_max, (vi[k], col_max[k]), tgt[k])

    suff_min = np.minimum.accumulate(scat_min[:, ::-1], axis=1)[:, ::-1]
    pref_max = np.maximum.accumulate(scat_max, axis=1)
    new_min_t = np.minimum(old_min_t, suff_min)
    new_max_t = np.maximum(old_max_t, pref_max)
    new_min_d = np.clip(new_min_t - e[None, :], 0, MAX_DISTANCE).astype(np.uint16)
    new_max_d = np.clip(new_max_t - e[None, :], 0, MAX_DISTANCE).astype(np.uint16)

    col_t_c = np.clip(col_t, 0, n - 1)
    in_w = (col_t >= 0) & (col_t < n)
    pre = np.where(in_w, vote_h[vi, col_t_c], np.uint32(0))
    smin = np.full((v_cap, n), _VOTE_NONE, np.uint32)
    k = hits(col_t)
    np.minimum.at(smin, (vi[k], col_t[k]), vh[k])
    smax = np.zeros((v_cap, n), np.uint32)
    np.maximum.at(smax, (vi[k], col_t[k]), vh[k])
    new_vote_h = np.where(
        vote_h != 0, vote_h, np.where(smin != _VOTE_NONE, smin, np.uint32(0))
    )
    dbl_flag = valid & in_w & (
        ((pre != 0) & (pre != vh)) | (smin[vi, col_t_c] != smax[vi, col_t_c])
    )

    col_s = np.clip(src - base, 0, n - 1)
    min_target = new_min_d[vi, col_s].astype(np.int64) + e[col_s]
    max_target = new_max_d[vi, col_s].astype(np.int64) + e[col_s]
    min_flag = valid & (tgt > min_target)
    max_flag = valid & (tgt < max_target)
    return (
        new_min_d, new_max_d, new_vote_h,
        min_target.astype(np.int32), max_target.astype(np.int32),
        min_flag, max_flag, dbl_flag,
    )


# =============================================================================
# the device-resident span store
# =============================================================================


class _Fresh:
    """The host copy of neutral planes, by shape only: materialized the
    first time the host needs the arrays (a regrow, a demotion, a read)."""

    def __init__(self, n_validators_pad: int, history_length: int):
        self.shape = (n_validators_pad, history_length)


class SpanStore:
    """Whole-registry span planes with backend seam + fault-domain glue.

    Planes live on the device across ticks on the device backend (host
    checkpoints every ``checkpoint_every`` sweeps + a pair journal make
    demotion lossless); on the numpy backend they are plain host arrays.
    One ``apply`` = one sweep (window advance included).
    """

    def __init__(
        self,
        history_length: int,
        use_device: bool | None = None,
        device=None,
        checkpoint_every: int = 32,
        pair_floor: int = 256,
        validator_floor: int = 256,
        mesh_devices=None,
    ):
        # the distance encoding stores at most n-1 (saturating at the
        # MAX_DISTANCE sentinel like the reference), so the full reference
        # bound MAX_HISTORY_LENGTH = 65536 is representable
        if not 0 < history_length <= MAX_DISTANCE + 1:
            raise ValueError(f"span store: bad history_length {history_length}")
        from . import device_backend_active, get_device

        if use_device is None:
            use_device = device_backend_active()
        self.n_hist = history_length
        self.use_device = bool(use_device)
        # resolved up front: a missing card raises here, never inside the
        # supervised region where it would pass for a fault and demote
        from ..bls.mesh import mesh_devices as _mesh_of

        # the planes' row blocks, block s on mesh[s] (None: one device)
        self.mesh = _mesh_of(mesh_devices) if self.use_device else None
        self.device = (
            (self.mesh[0] if self.mesh else
             resolve_device(get_device() if device is None else device))
            if self.use_device else None
        )
        self.checkpoint_every = max(1, checkpoint_every)
        self.pair_floor = pair_floor
        self.validator_floor = validator_floor
        self.mode = "device" if self.use_device else "host"
        self.n = 0          # validators covered so far
        self.n_pad = 0      # plane height (power-of-two bucket)
        self.epoch = 0      # epoch of the planes' last column
        self.host = None    # authoritative planes (host mode) / checkpoint
        self.ckpt_epoch = 0
        self.dev = None     # live device planes (device mode), biased torch
        self.journal: list = []  # (vidx, src, tgt, vh, valid, epoch) since ckpt
        # counters (single-threaded caller: the slasher tick)
        self.sweeps = 0
        self.pairs_swept = 0
        self.demotions = 0
        self.promotions = 0
        self.checkpoints = 0

    # -- capacity ----------------------------------------------------------

    def _host_arrays(self) -> list:
        """The host planes as numpy arrays (materializing fresh ones)."""
        if isinstance(self.host, _Fresh):
            self.host = list(empty_planes_np(*self.host.shape))
        return self.host

    def ensure_capacity(self, n_validators: int) -> None:
        n = max(int(n_validators), 1)
        if self.host is not None and n <= self.n_pad:
            self.n = max(self.n, n)
            return
        new_pad = _bucket(n, self.validator_floor)
        if self.host is not None:
            if self.mode == "device":
                # rare: sync device truth before regrow. A device fault here
                # must demote (checkpoint + journal replay reconstruct the
                # host truth losslessly), never escape unsupervised
                try:
                    self._checkpoint()
                except Exception as e:  # noqa: BLE001 — device fault
                    from ..resilience import faults

                    faults.record_fault(
                        "slasher.checkpoint", e, domain="slasher_device"
                    )
                    self._demote_and_replay()
        if self.host is None or isinstance(self.host, _Fresh):
            self.host = _Fresh(new_pad, self.n_hist)
        else:
            planes = empty_planes_np(new_pad, self.n_hist)
            for new, old in zip(planes, self.host):
                new[: self.n_pad] = old
            self.host = list(planes)
        self.dev = None
        self.n = max(self.n, n)
        self.n_pad = new_pad
        self.ckpt_epoch = self.epoch
        self.journal.clear()
        if self.mode == "device" and not self._try_upload():
            self.mode = "host"
            self.demotions += 1

    # -- device plumbing ---------------------------------------------------

    def _upload(self) -> None:
        from . import kernels

        if self.mesh is None:
            blocks = [(self.device, slice(None))]
        else:
            b = self.n_pad // len(self.mesh)
            blocks = [(d, slice(s * b, (s + 1) * b)) for s, d in enumerate(self.mesh)]
        if isinstance(self.host, _Fresh):
            rows = self.host.shape[0] // len(blocks)
            dev = [kernels.empty_planes(rows, self.n_hist, d) for d, _ in blocks]
        else:
            dev = [kernels.planes_to_device(*(a[r] for a in self.host), d) for d, r in blocks]
        self.dev = dev[0] if self.mesh is None else dev
        from ..utils import metrics

        metrics.SLASHER_SPAN_PLANE_BYTES.set(
            sum(p.numel() * p.element_size() for planes in dev for p in planes)
        )

    def _planes_from_device(self) -> tuple:
        from .kernels import planes_from_device

        if self.mesh is None:
            return planes_from_device(self.dev)
        blocks = [planes_from_device(planes) for planes in self.dev]
        return tuple(np.concatenate(p) for p in zip(*blocks))

    def _try_upload(self) -> bool:
        """Upload with the fault recorded instead of raised (regrow /
        promotion paths: the host planes stay authoritative on failure)."""
        try:
            self._upload()
            return True
        except Exception as e:  # noqa: BLE001 — device fault
            from ..resilience import faults

            faults.record_fault("slasher.upload", e, domain="slasher_device")
            self.dev = None
            return False

    def _checkpoint(self) -> None:
        """Adopt the device planes as the host checkpoint (device->host
        sync); clears the journal. Raises on a device fault — callers
        demote-and-replay, so a failed checkpoint loses nothing."""
        self.host = list(self._planes_from_device())
        self.ckpt_epoch = self.epoch
        self.journal.clear()
        self.checkpoints += 1

    def _sup(self):
        from ..resilience import slasher_supervisor

        return slasher_supervisor()

    def _demote_and_replay(self) -> None:
        """Device planes are no longer trusted: restore the last host
        checkpoint and replay the journaled pair batches through the numpy
        twin. Every journaled batch is reconstructed exactly — demotion
        never drops evidence."""
        self.mode = "host"
        self.dev = None
        self.demotions += 1
        planes = [a.copy() for a in self._host_arrays()]
        epoch = self.ckpt_epoch
        for vidx, src, tgt, vh, valid, ep in self.journal:
            out = sweep_numpy(
                planes[0], planes[1], planes[2],
                max(0, ep - epoch), vidx, src, tgt, vh, valid, ep, self.n_hist,
            )
            planes = list(out[:3])
            epoch = ep
        self.host = planes
        self.ckpt_epoch = epoch
        self.journal.clear()

    def _promote(self) -> bool:
        """Try to move the host planes back onto the device (probation
        probe / recovery). Returns True when the store is in device mode."""
        self._checkpointless_sync()
        if not self._try_upload():
            return False
        self.mode = "device"
        self.promotions += 1
        return True

    def _checkpointless_sync(self) -> None:
        self.ckpt_epoch = self.epoch
        self.journal.clear()

    # -- the sweep ---------------------------------------------------------

    def _pad_batch(self, vidx, src, tgt, vh):
        n_real = len(vidx)
        p = _bucket(max(1, n_real), self.pair_floor)
        pv = np.zeros(p, dtype=np.int32)
        ps = np.zeros(p, dtype=np.int32)
        pt = np.zeros(p, dtype=np.int32)
        ph = np.zeros(p, dtype=np.uint32)
        pm = np.zeros(p, dtype=bool)
        pv[:n_real] = vidx
        ps[:n_real] = src
        pt[:n_real] = tgt
        ph[:n_real] = vh
        pm[:n_real] = True
        return pv, ps, pt, ph, pm

    def _device_thunk(self, pv, ps, pt, ph, pm, delta, cur):
        from .kernels import PlanesIndeterminate, sweep_

        if self.mesh is None:
            parts = [(np.arange(len(pv)), sweep_(self.dev, delta, pv, ps, pt, ph, pm, cur,
                                                 n=self.n_hist))]
        else:
            # each block sweeps its own rows' pairs (a row's update reads
            # only that row), and every block advances its window
            from ..bls.mesh import device_context

            b = self.n_pad // len(self.mesh)
            parts = []
            for s, d in enumerate(self.mesh):
                q = np.nonzero(pm & (pv // b == s))[0]
                with device_context(d):
                    parts.append((q, sweep_(self.dev[s], delta, pv[q] - s * b, ps[q], pt[q],
                                            ph[q], pm[q], cur, n=self.n_hist)))
        # materialize INSIDE the supervised region: an asynchronous device
        # fault surfaces here, after the planes were written in place
        try:
            outs = [np.zeros(len(pv), dtype=d) for d in (np.int32, np.int32, bool, bool, bool)]
            for q, res in parts:
                for o, r in zip(outs, res):
                    o[q] = r.cpu().numpy()
            return tuple(outs)
        except Exception as e:
            raise PlanesIndeterminate(f"slasher sweep: {e!r}") from e

    def apply(self, vidx, src, tgt, vh, current_epoch: int) -> dict:
        """One sweep: window advance + batch update + candidate flags. Pair
        arrays are flattened (attestation x validator) rows; returns
        per-pair ``min_target/max_target/min_flag/max_flag/dbl_flag`` numpy
        arrays trimmed to the input length."""
        current_epoch = int(current_epoch)
        if current_epoch >= _MAX_EPOCH:
            raise ValueError(f"slasher: epoch {current_epoch} out of range")
        n_real = len(vidx)
        if n_real:
            self.ensure_capacity(int(np.max(vidx)) + 1)
        elif self.host is None:
            self.ensure_capacity(1)
        cur = max(current_epoch, self.epoch)
        delta = cur - self.epoch
        pv, ps, pt, ph, pm = self._pad_batch(vidx, src, tgt, vh)

        pair_res = None
        if self.use_device:
            sup = self._sup()
            if self.mode == "host" and sup.device_allowed():
                self._promote()
            if self.mode == "device":
                from ..resilience import SupervisedFault

                try:
                    pair_res = sup.run(
                        "slasher.sweep",
                        lambda: self._device_thunk(pv, ps, pt, ph, pm, delta, cur),
                    )
                except SupervisedFault:
                    self._demote_and_replay()
                else:
                    self.epoch = cur
                    self.journal.append((pv, ps, pt, ph, pm, cur))
                    if len(self.journal) >= self.checkpoint_every:
                        try:
                            self._checkpoint()
                        except Exception as e:  # noqa: BLE001 — device fault
                            from ..resilience import faults

                            faults.record_fault(
                                "slasher.checkpoint", e, domain="slasher_device"
                            )
                            # journal already holds this sweep: the replay
                            # reconstructs it — nothing is lost
                            self._demote_and_replay()
            if pair_res is None:
                sup.note_fallback(rung="numpy")
        if pair_res is None:
            host = self._host_arrays()
            out = sweep_numpy(
                host[0], host[1], host[2],
                delta, pv, ps, pt, ph, pm, cur, self.n_hist,
            )
            self.host = list(out[:3])
            self.ckpt_epoch = cur
            pair_res = out[3:]
            self.epoch = cur
        self.sweeps += 1
        self.pairs_swept += n_real
        SLASHER_PAIRS_SWEPT.inc(n_real, backend=self.mode)
        names = ("min_target", "max_target", "min_flag", "max_flag", "dbl_flag")
        return {k: np.asarray(v)[:n_real] for k, v in zip(names, pair_res)}

    # -- introspection -----------------------------------------------------

    def planes(self):
        """Current (min_d, max_d, vote_h) as host numpy arrays at the
        reference's widths (parity tests, checkpoints; device mode syncs)."""
        if self.mode == "device":
            return self._planes_from_device()
        return tuple(a.copy() for a in self._host_arrays())

    def stats(self) -> dict:
        return {
            "backend": "device" if self.use_device else "numpy",
            "mode": self.mode,
            "device": None if self.device is None else str(self.device),
            "mesh": None if self.mesh is None else [str(d) for d in self.mesh],
            "n_validators": self.n,
            "n_pad": self.n_pad,
            "history_length": self.n_hist,
            "epoch": self.epoch,
            "sweeps": self.sweeps,
            "pairs_swept": self.pairs_swept,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "checkpoints": self.checkpoints,
            "journal_depth": len(self.journal),
        }


def _bucket(x: int, floor: int = 1) -> int:
    b = max(1, floor)
    while b < x:
        b *= 2
    return b


# =============================================================================
# the engine-backed slasher (seed-Slasher surface)
# =============================================================================


class EngineSlasher:
    """Slasher on the device-resident span store. Same edges as the seed
    ``Slasher`` (accept_attestation / accept_block_header / process_queued /
    get_*_slashings / prune_database), so ``SlasherService`` drives either.

    Record state is an in-memory columnar index — ``{target_epoch: {v:
    att_id}}`` plus the attestation table — pruned with the window; the
    vote plane is its device shadow. Host work per batch is O(pairs) dict
    upkeep + O(flags) confirmation; all detection math is the one sweep.
    """

    MAX_BATCH_RETRIES = 3

    def __init__(
        self,
        store=None,
        types=None,
        config: SlasherConfig | None = None,
        backend: str | None = None,
        device=None,
        intake_capacity_pairs: int = 1 << 17,
        checkpoint_every: int = 32,
        validator_floor: int = 256,
        mesh_devices=None,
    ):
        self.config = config or SlasherConfig()
        self.config.validate()
        self.store = store  # KV store for checkpoint persistence (optional)
        self.types = types
        use_device = None  # None: the backend seam (slasher.set_backend)
        if backend is not None:
            if backend not in ("device", "numpy"):
                raise ValueError(f"unknown slasher backend {backend!r}")
            use_device = backend == "device"
        self.span = SpanStore(
            self.config.history_length,
            use_device=use_device,
            device=device,
            checkpoint_every=checkpoint_every,
            validator_floor=validator_floor,
            mesh_devices=mesh_devices,
        )
        self.intake_capacity_pairs = intake_capacity_pairs
        self._att_queue: list = []
        self._queued_pairs = 0
        self._block_queue: list = []
        self._lock = threading.Lock()
        self._attester_slashings: dict[bytes, object] = {}
        self._proposer_slashings: dict[bytes, object] = {}
        # record index: the host truth behind the vote plane's candidates
        self._atts: dict[int, object] = {}          # att_id -> IndexedAttestation
        self._att_root: dict[int, bytes] = {}       # att_id -> data root
        self._root_to_id: dict[bytes, int] = {}     # att htr -> att_id
        self._id_to_root: dict[int, bytes] = {}     # att_id -> att htr
        self._records: dict[int, dict[int, int]] = {}  # target -> {v: att_id}
        # EVERY indexed attestation by target epoch — including ones whose
        # record slots were all already claimed — so pruning can never leak
        self._ids_by_target: dict[int, set[int]] = {}
        self._proposals: dict[tuple, object] = {}   # (slot, proposer) -> header
        self._next_id = 1
        self._batch_retries = 0
        self.shed_pairs = 0

    # -- ingest (seed surface) ---------------------------------------------

    def accept_attestation(self, indexed_attestation) -> None:
        k = max(1, len(indexed_attestation.attesting_indices))
        with self._lock:
            if self._queued_pairs + k > self.intake_capacity_pairs:
                self.shed_pairs += k
                SLASHER_SURVEILLANCE_GAP.inc(k, reason="intake_overflow")
                return
            self._att_queue.append(indexed_attestation)
            self._queued_pairs += k

    def accept_block_header(self, signed_header) -> None:
        with self._lock:
            self._block_queue.append(signed_header)

    # -- harvest -----------------------------------------------------------

    def get_attester_slashings(self) -> list:
        with self._lock:
            out = list(self._attester_slashings.values())
            self._attester_slashings.clear()
        return out

    def get_proposer_slashings(self) -> list:
        with self._lock:
            out = list(self._proposer_slashings.values())
            self._proposer_slashings.clear()
        return out

    # -- processing --------------------------------------------------------

    def process_queued(self, current_epoch: int) -> dict:
        with self._lock:
            blocks, self._block_queue = self._block_queue, []
            atts, self._att_queue = self._att_queue, []
            self._queued_pairs = 0

        n_prop = self._process_blocks(blocks)
        try:
            stats = self._process_attestations(atts, current_epoch)
            self._batch_retries = 0
        except Exception as e:  # noqa: BLE001 — evidence is never silently lost
            from ..resilience import faults

            faults.record_fault(
                "slasher.process", e, domain="slasher_device"
            )
            self._batch_retries += 1
            with self._lock:
                # deferred attestations were already re-queued inside
                # _process_attestations — re-prepend only what is not
                # queued yet, or pair accounting inflates and sheds
                # honest intake early
                queued = {id(a) for a in self._att_queue}
                fresh = [a for a in atts if id(a) not in queued]
                n_pairs = sum(len(a.attesting_indices) for a in fresh)
                if self._batch_retries <= self.MAX_BATCH_RETRIES:
                    self._att_queue[:0] = fresh  # retried ahead of new work
                    self._queued_pairs += n_pairs
                else:
                    self.shed_pairs += n_pairs
            if self._batch_retries > self.MAX_BATCH_RETRIES:
                SLASHER_SURVEILLANCE_GAP.inc(n_pairs, reason="batch_exhausted")
                self._batch_retries = 0
            stats = {
                "attestations_processed": len(atts),
                "attestations_valid": 0,
                "attestations_deferred": 0,
                "attestations_dropped": 0,
                "double_vote_slashings": 0,
                "surround_slashings": 0,
                "error": str(e),
            }
        stats["blocks_processed"] = len(blocks)
        stats["proposer_slashings"] = n_prop
        return stats

    def _process_blocks(self, blocks) -> int:
        from ..types.containers import ProposerSlashing

        found = 0
        for header in blocks:
            # per-header isolation: one malformed header must not discard
            # the rest of the tick's evidence (the queues were already
            # popped); the loss is one header, recorded and counted
            try:
                msg = header.message
                key = (int(msg.slot), int(msg.proposer_index))
                existing = self._proposals.get(key)
                if existing is None:
                    self._proposals[key] = header
                    continue
                if existing == header:
                    continue
                slashing = ProposerSlashing(
                    signed_header_1=existing, signed_header_2=header
                )
                root = ProposerSlashing.hash_tree_root(slashing)
            except Exception as e:  # noqa: BLE001 — loud, never silent
                from ..resilience import faults

                faults.record_fault(
                    "slasher.block", e, domain="slasher_device"
                )
                SLASHER_SURVEILLANCE_GAP.inc(1, reason="block_error")
                continue
            with self._lock:
                self._proposer_slashings.setdefault(root, slashing)
            found += 1
        return found

    def _validate(self, atts, current_epoch: int):
        """(keep, deferred, dropped) — drop window keyed on SOURCE epoch
        like the seed / reference (slasher.rs:350-352)."""
        keep, defer, dropped = [], [], 0
        for att in atts:
            src = int(att.data.source.epoch)
            tgt = int(att.data.target.epoch)
            if src > tgt or src + self.config.history_length <= current_epoch:
                dropped += 1
            elif tgt > current_epoch:
                defer.append(att)
            else:
                keep.append(att)
        return keep, defer, dropped

    def _dedup(self, keep) -> list:
        """Read-only dedup against the index and within the batch. Returns
        [(att, att_root, data_root)] — NOTHING is committed yet, so a
        faulted sweep can re-queue the batch and a later retry re-processes
        it in full (evidence is never silently skipped)."""
        from ..types.containers import AttestationData

        t = self.types.IndexedAttestation
        batch, seen = [], set()
        for att in keep:
            root = t.hash_tree_root(att)
            if root in self._root_to_id or root in seen:
                continue
            seen.add(root)
            batch.append((att, root, AttestationData.hash_tree_root(att.data)))
        return batch

    def _commit(self, batch) -> None:
        """Adopt a swept batch into the record index (ids, record slots,
        prune index). Runs AFTER the sweep succeeded — the transactional
        commit point of one tick."""
        for att, root, data_root in batch:
            att_id = self._next_id
            self._next_id += 1
            self._root_to_id[root] = att_id
            self._id_to_root[att_id] = root
            self._atts[att_id] = att
            self._att_root[att_id] = data_root
            tgt = int(att.data.target.epoch)
            self._ids_by_target.setdefault(tgt, set()).add(att_id)
            rec = self._records.setdefault(tgt, {})
            for v in att.attesting_indices:
                rec.setdefault(int(v), att_id)

    @staticmethod
    def _vote_tag(data_root: bytes) -> int:
        """Nonzero 32-bit tag of an attestation-data root (the vote plane's
        cell value; full roots are compared at confirmation time)."""
        return int.from_bytes(data_root[:4], "big") or 1

    def _process_attestations(self, atts, current_epoch: int) -> dict:
        keep, deferred, dropped = self._validate(atts, current_epoch)
        if deferred:
            with self._lock:
                self._att_queue.extend(deferred)
                self._queued_pairs += sum(
                    len(a.attesting_indices) for a in deferred
                )

        batch = self._dedup(keep)

        # flatten (attestation x validator) pairs for the one fused sweep
        vidx, src, tgt, vh, owner = [], [], [], [], []
        for att, _, data_root in batch:
            s = int(att.data.source.epoch)
            t = int(att.data.target.epoch)
            h = self._vote_tag(data_root)
            for v in att.attesting_indices:
                vidx.append(int(v))
                src.append(s)
                tgt.append(t)
                vh.append(h)
                owner.append((att, data_root))

        n_double = n_surround = 0
        if vidx:
            res = self.span.apply(
                np.asarray(vidx, dtype=np.int64),
                np.asarray(src, dtype=np.int64),
                np.asarray(tgt, dtype=np.int64),
                np.asarray(vh, dtype=np.uint32),
                current_epoch,
            )
            # commit BETWEEN sweep and confirmation: confirmation looks up
            # this batch's own records (intra-batch doubles/surrounds)
            self._commit(batch)
            n_double, n_surround = self._confirm(
                owner, vidx, src, tgt, res
            )
        elif self.span.host is not None or self.span.dev is not None:
            # no pairs this tick: still roll the window forward
            self.span.apply(
                np.asarray([], dtype=np.int64), np.asarray([], dtype=np.int64),
                np.asarray([], dtype=np.int64), np.asarray([], dtype=np.uint32),
                current_epoch,
            )
        return {
            "attestations_processed": len(atts),
            "attestations_valid": len(keep),
            "attestations_deferred": len(deferred),
            "attestations_dropped": dropped,
            "double_vote_slashings": n_double,
            "surround_slashings": n_surround,
        }

    # -- confirmation (the kernel flags, the record proves) ----------------

    def _lookup(self, v: int, target_epoch: int):
        att_id = self._records.get(int(target_epoch), {}).get(int(v))
        if att_id is None:
            return None, None
        return self._atts.get(att_id), self._att_root.get(att_id)

    def _emit(self, first, second) -> None:
        """attestation_1 must be the surrounding/existing attestation for
        the slashing to validate on chain (ref lib.rs:52-92)."""
        from ..utils.logging import get_logger

        get_logger("slasher").info(
            "Found attester slashing",
            target=int(second.data.target.epoch),
        )
        t = self.types.AttesterSlashing
        slashing = t(attestation_1=first, attestation_2=second)
        key = t.hash_tree_root(slashing)
        with self._lock:
            self._attester_slashings.setdefault(key, slashing)

    def _confirm(self, owner, vidx, src, tgt, res) -> tuple[int, int]:
        """Re-check every flagged pair against the fetched record. A flag
        alone is only a candidate (batch supersets, same-target doubles on
        the surround planes, tag conflicts): the record comparison is what
        authorizes emission."""
        n_double = n_surround = 0
        flagged = np.nonzero(
            res["min_flag"] | res["max_flag"] | res["dbl_flag"]
        )[0]
        for q in map(int, flagged):
            try:
                d, sr = self._confirm_pair(owner, vidx, src, tgt, res, q)
            except Exception as e:  # noqa: BLE001 — one bad pair must not
                # kill the rest of the batch's confirmations, and (since
                # the batch is committed by now) a retry would skip it —
                # count the loss loudly instead
                from ..resilience import faults

                faults.record_fault(
                    "slasher.confirm", e, domain="slasher_device"
                )
                SLASHER_SURVEILLANCE_GAP.inc(1, reason="confirm_error")
                continue
            n_double += d
            n_surround += sr
        return n_double, n_surround

    def _confirm_pair(self, owner, vidx, src, tgt, res, q) -> tuple[int, int]:
        n_double = n_surround = 0
        att, data_root = owner[q]
        v = vidx[q]
        s = src[q]
        if res["dbl_flag"][q]:
            existing, existing_root = self._lookup(v, tgt[q])
            if (
                existing is not None
                and existing_root != data_root
                and int(existing.data.target.epoch) == tgt[q]
            ):
                self._emit(existing, att)  # double: existing first
                n_double += 1
        if res["min_flag"][q]:
            existing, _ = self._lookup(v, int(res["min_target"][q]))
            if existing is not None and s < int(existing.data.source.epoch):
                self._emit(att, existing)  # att surrounds existing
                n_surround += 1
        if res["max_flag"][q]:
            existing, _ = self._lookup(v, int(res["max_target"][q]))
            if existing is not None and int(existing.data.source.epoch) < s:
                self._emit(existing, att)  # att is surrounded
                n_surround += 1
        return n_double, n_surround

    # -- pruning -----------------------------------------------------------

    def prune_database(self, current_epoch: int, slots_per_epoch: int) -> int:
        min_epoch = max(0, current_epoch - self.config.history_length + 1)
        dropped = 0
        # keyed on the full per-target id index, not the record slots: an
        # attestation whose slots were all claimed by an earlier one must
        # still age out of _atts/_root_to_id with its window
        for epoch in [e for e in self._ids_by_target if e < min_epoch]:
            for att_id in self._ids_by_target.pop(epoch):
                self._atts.pop(att_id, None)
                self._att_root.pop(att_id, None)
                root = self._id_to_root.pop(att_id, None)
                if root is not None:
                    self._root_to_id.pop(root, None)
                dropped += 1
            self._records.pop(epoch, None)
        min_slot = min_epoch * slots_per_epoch
        for key in [k for k in self._proposals if k[0] < min_slot]:
            del self._proposals[key]
            dropped += 1
        return dropped

    # -- persistence (restart-from-disk) ------------------------------------

    PERSIST_KEY = b"engine_v1"

    def persist(self, store=None) -> bool:
        """Checkpoint the record index + span planes into the KV store as
        ONE atomic write (``SlasherMeta`` column, the reference's slasher
        database tables collapsed into a compressed document).

        This closes the restart window the ROADMAP flagged: pre-restart
        votes used to live only in memory, so a determined equivocator
        could vote once, wait for a restart, and vote again unseen. With
        the checkpoint, the whole surveillance window (records + distance
        planes + pending, unharvested slashings) survives a kill at any
        persistence barrier. Planes are dense (8 B/validator-epoch before
        compression) — the same sizing note as ``make_slasher``'s window
        applies; the planes' bytes are the reference's (``kernels.
        planes_from_device``), so either package restores the other's
        checkpoint.
        """
        import base64
        import json as _json
        import zlib as _zlib

        store = store if store is not None else self.store
        if store is None:
            return False
        if self.span.host is None and self.span.dev is None:
            # nothing swept yet (a service tick before the first batch):
            # there are no planes to checkpoint, and treating the None as
            # a device fault would demote a healthy engine
            return False
        # snapshot the index under the intake lock...
        with self._lock:
            t_att = self.types.IndexedAttestation
            atts = {
                str(i): t_att.encode(a).hex() for i, a in self._atts.items()
            }
            records = {
                str(t): {str(v): i for v, i in rec.items()}
                for t, rec in self._records.items()
            }
            proposals = [
                type(h).encode(h).hex() for h in self._proposals.values()
            ]
            att_slashings = [
                type(s).encode(s).hex()
                for s in self._attester_slashings.values()
            ]
            prop_slashings = [
                type(s).encode(s).hex()
                for s in self._proposer_slashings.values()
            ]
            next_id = self._next_id
        # ...but sync the span planes OUTSIDE it (device mode copies the
        # device planes to the host — a device call under the intake lock
        # would stall the gossip observers)
        try:
            planes = self.span.planes()
        except Exception as e:  # noqa: BLE001 — device fault during sync:
            # demote-and-replay reconstructs the host truth losslessly
            from ..resilience import faults

            faults.record_fault("slasher.checkpoint", e, domain="slasher_device")
            self.span._demote_and_replay()
            planes = self.span.planes()
        doc = {
            "version": 1,
            "history_length": self.config.history_length,
            "next_id": next_id,
            "atts": atts,
            "records": records,
            "proposals": proposals,
            "attester_slashings": att_slashings,
            "proposer_slashings": prop_slashings,
            "span": {
                "n": self.span.n,
                "epoch": self.span.epoch,
                "planes": [
                    {
                        "dtype": str(p.dtype),
                        "shape": list(p.shape),
                        "data": base64.b64encode(p.tobytes()).decode(),
                    }
                    for p in planes
                ],
            },
        }
        blob = _zlib.compress(_json.dumps(doc).encode(), 1)
        from ..resilience.crashpoints import maybe_crash
        from ..store.kv import DBColumn

        maybe_crash("persist.slasher", owner=getattr(store, "owner", None))
        store.put(DBColumn.SlasherMeta, self.PERSIST_KEY, blob)
        return True

    def restore(self, store=None) -> bool:
        """Rehydrate the record index + span planes from a ``persist``
        checkpoint. Derived maps (data roots, id<->root, per-target ids)
        are recomputed from the decoded attestations, so the checkpoint
        carries no redundant — and thus no possibly-inconsistent — state.
        Returns False (untouched engine) when no/incompatible checkpoint
        exists."""
        import base64
        import json as _json
        import zlib as _zlib

        import numpy as _np

        from ..store.kv import DBColumn
        from ..types.containers import AttestationData

        store = store if store is not None else self.store
        if store is None:
            return False
        blob = store.get(DBColumn.SlasherMeta, self.PERSIST_KEY)
        if blob is None:
            return False
        try:
            doc = _json.loads(_zlib.decompress(blob))
        except Exception:  # noqa: BLE001 — corrupt checkpoint: fresh start
            from ..utils.logging import get_logger

            get_logger("slasher").warning("Slasher checkpoint unreadable")
            return False
        if doc.get("history_length") != self.config.history_length:
            # window resize invalidates the planes' distance encoding
            return False
        t_att = self.types.IndexedAttestation
        from ..types.containers import ProposerSlashing, SignedBeaconBlockHeader

        # Decode the WHOLE checkpoint into locals before touching any engine
        # state: one record failing to decode (schema drift, truncated blob)
        # must leave the engine untouched per the contract above, not
        # half-populated with ids no record/plane state references.
        try:
            atts = {}
            for sid, hexed in doc["atts"].items():
                att_id = int(sid)
                att = t_att.decode(bytes.fromhex(hexed))
                atts[att_id] = (
                    att,
                    t_att.hash_tree_root(att),
                    AttestationData.hash_tree_root(att.data),
                )
            records = {
                int(tgt): {int(v): int(i) for v, i in rec.items()}
                for tgt, rec in doc["records"].items()
            }
            proposals = {}
            for hexed in doc["proposals"]:
                h = SignedBeaconBlockHeader.decode(bytes.fromhex(hexed))
                proposals[
                    (int(h.message.slot), int(h.message.proposer_index))
                ] = h
            att_slashings = {}
            for hexed in doc["attester_slashings"]:
                s = self.types.AttesterSlashing.decode(bytes.fromhex(hexed))
                att_slashings[self.types.AttesterSlashing.hash_tree_root(s)] = s
            prop_slashings = {}
            for hexed in doc["proposer_slashings"]:
                s = ProposerSlashing.decode(bytes.fromhex(hexed))
                prop_slashings[ProposerSlashing.hash_tree_root(s)] = s
            next_id = int(doc["next_id"])
            span_doc = doc["span"]
            planes = [
                _np.frombuffer(
                    base64.b64decode(p["data"]), dtype=_np.dtype(p["dtype"])
                ).reshape(p["shape"]).copy()
                for p in span_doc["planes"]
            ]
            n_pad = planes[0].shape[0]
            span_n, span_epoch = int(span_doc["n"]), int(span_doc["epoch"])
        except Exception:  # noqa: BLE001 — undecodable checkpoint: fresh start
            from ..utils.logging import get_logger

            get_logger("slasher").warning("Slasher checkpoint undecodable")
            return False
        with self._lock:
            for att_id, (att, root, data_root) in atts.items():
                self._atts[att_id] = att
                self._att_root[att_id] = data_root
                self._root_to_id[root] = att_id
                self._id_to_root[att_id] = root
                self._ids_by_target.setdefault(
                    int(att.data.target.epoch), set()
                ).add(att_id)
            self._records.update(records)
            self._proposals.update(proposals)
            self._attester_slashings.update(att_slashings)
            self._proposer_slashings.update(prop_slashings)
            self._next_id = max(self._next_id, next_id)
        span = self.span
        span.host = planes
        span.n = span_n
        span.n_pad = n_pad
        span.epoch = span_epoch
        span.ckpt_epoch = span.epoch
        span.journal.clear()
        span.dev = None
        if span.use_device:
            span.mode = "device" if span._try_upload() else "host"
        else:
            span.mode = "host"
        return True

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        snap = self.span.stats()
        snap.update(
            attestations_indexed=len(self._atts),
            shed_pairs=self.shed_pairs,
        )
        return snap
