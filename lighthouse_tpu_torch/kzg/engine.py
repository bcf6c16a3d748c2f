"""Device-batched KZG cell-proof engine: the port of
``lighthouse_tpu/kzg/engine.py``.

``CellContext.verify_cell_kzg_proof_batch`` runs one host pairing per cell;
this engine folds a whole batch into ONE combined pairing check on the
device (see ``ops/kzg/verify`` for the math) behind the backend seam
``set_kzg_backend``:

* ``device`` — the default: the batched check on ``set_kzg_backend``'s
  ``device`` (default CUDA, raising without it; pass ``device="cpu"`` to run
  the kernels' plain versions on the CPU). Fr limb math in PyTorch, the
  coset tables compiled as ``chain_plans`` fixed-scalar chains, one
  ``scale_bits`` ladder for every scalar multiply, one Miller product and
  one final exponentiation, all curve and field multiplies on the hand
  kernels.
* ``host``   — the ``CellContext`` per-cell loop, taken only when selected.

Unlike the reference there is no ``auto`` backend and no environment
variable, and no branch depends on how many cards are visible (column
sharding across cards is not ported).

The device path runs under the ``kzg_device`` fault domain (stage
``kzg.cell_batch_verify``): ``device_full`` -> ``device_reduced`` (split
halves, fresh transcripts). With the engine on the CPU a ``cpu_oracle`` rung
(the host loop) follows, as in the reference; with the engine on a card
there is none — a card's fault is never handed to the CPU — and a fully
faulted ladder returns ``False``: data availability FAILS CLOSED, a broken
device can never mark a column verified.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..oracle.fields import R
from ..resilience import SupervisedFault, kzg_supervisor
from .cells import CellContext
from .kzg import Kzg, KzgError

TRANSCRIPT_TAG = b"LHTPU_KZG_CELL_BATCH_V1"

_BACKEND = "device"
_DEVICE = None  # None: CUDA (device.resolve_device)


def set_kzg_backend(name: str, *, device=None) -> None:
    """Select the KZG backend; ``device`` is where ``"device"`` runs."""
    global _BACKEND, _DEVICE
    if name not in ("device", "host"):
        raise ValueError(f"unknown kzg backend {name!r}")
    _BACKEND = name
    _DEVICE = device


def get_kzg_backend() -> str:
    return _BACKEND


def get_kzg_device():
    return _DEVICE


def device_backend_active() -> bool:
    return _BACKEND == "device"


def _bucket(n: int, floor: int = 1) -> int:
    """The smallest power-of-two multiple of ``floor`` >= n (the reference's
    ``firehose/sharding._bucket``)."""
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------------------
# Host-side marshalling
# --------------------------------------------------------------------------------------


class _PointCache:
    """Bytes-keyed bounded LRU over ``Kzg._parse_g1`` (columns repeat the
    same commitments every slot; proofs are one-shot but cheap to keep)."""

    def __init__(self, maxsize: int = 4096):
        self._store: OrderedDict[bytes, object] = OrderedDict()
        self._maxsize = maxsize

    def parse(self, data: bytes, what: str):
        hit = self._store.get(data)
        if hit is not None:
            self._store.move_to_end(data)
            return hit[0]
        pt = Kzg._parse_g1(data, what)  # raises KzgError on bad encodings
        self._store[data] = (pt,)
        if len(self._store) > self._maxsize:
            self._store.popitem(last=False)
        return pt


def _affine_limbs(pts, pad: int):
    """Oracle affine points (None = infinity) plus ``pad`` infinity rows ->
    int64 x, y limbs [n, 25] and the infinity mask [n]."""
    from ..ops.bls import fq

    inf = np.array([p is None for p in pts] + [True] * pad, dtype=bool)
    x = fq.ints_to_limbs([0 if p is None else p[0] for p in pts] + [0] * pad)
    y = fq.ints_to_limbs([0 if p is None else p[1] for p in pts] + [0] * pad)
    return x, y, inf


# --------------------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------------------


class CellEngine:
    """Device tables and the batched check for one ``CellContext`` geometry
    on one device.

    The batch tables — the coset permutation, the shared inverse-NTT
    matrix, descale/shift rows and the setup points — are built once, on the
    first device verify; the chain-plans ``[tau^k - d_i]G2`` table, which
    only the single-cell check reads, once on its first use."""

    def __init__(self, ctx: CellContext, device=None):
        self.ctx = ctx
        self.device = resolve_device(device)
        self._tables = None
        self._z2_tab = None
        self._d_ints: list[int] = []
        self._points = _PointCache()
        self.table_build_s: float | None = None
        self.z2_build_s: float | None = None

    # -- table construction (once) ------------------------------------------

    def tables(self):
        if self._tables is not None:
            return self._tables
        from ..oracle import curves as oc
        from ..ops.bls import g1 as dg1, g2 as dg2
        from ..ops.kzg import frops
        from ..ops.kzg.verify import VerifyTables
        from ..utils import metrics

        t0 = time.perf_counter()
        ctx, k, dev = self.ctx, self.ctx.k, self.device
        # chunk order -> natural coset order must be the SAME static
        # permutation for every coset (brp within the chunk); validate it
        # against the context geometry for every cell index
        order = {m: j for j, m in enumerate(ctx._mu_pows)}
        perm = None
        bases = []
        for i in range(ctx.cells):
            pts = ctx.coset_points(i)
            c = ctx._coset_base(pts)
            bases.append(c)
            inv_c = pow(c, R - 2, R)
            js = [order[p * inv_c % R] for p in pts]
            pm = np.zeros(k, dtype=np.int64)
            pm[js] = np.arange(k)
            if perm is None:
                perm = pm
            elif not np.array_equal(perm, pm):
                raise KzgError("coset chunk order is not uniform")

        inv_k = pow(k, R - 2, R)
        inv_mu = pow(ctx.mu, R - 2, R)
        idft = frops.fr_to_limbs(
            [pow(inv_mu, j * t, R) * inv_k % R for t in range(k) for j in range(k)]
        ).reshape(k, k, 25)
        cinv = frops.fr_to_limbs(
            [pow(c, (R - 2) * t, R) for c in bases for t in range(k)]
        ).reshape(ctx.cells, k, 25)
        self._d_ints = [pow(c, k, R) for c in bases]
        dtab = frops.fr_to_limbs(self._d_ints)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        setup = dg1.from_oracle_batch(ctx.kzg.setup.g1_monomial[:k], dev)
        g2_gen = dg2.from_oracle(oc.g2_generator(), dev)
        t2 = dg2.from_oracle(ctx.kzg.setup.g2_monomial[k], dev)
        tables = VerifyTables(
            perm=up(perm), idft=up(idft), cinv=up(cinv), dtab=up(dtab), setup=setup,
            g2x=g2_gen[0:2], g2y=g2_gen[2:4], t2x=t2[0:2], t2y=t2[2:4],
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._tables = tables
        self.table_build_s = time.perf_counter() - t0
        metrics.KZG_TABLE_BYTES.set(self.table_bytes())
        return tables

    def table_bytes(self) -> int:
        tabs = list(self._tables or ()) + ([] if self._z2_tab is None else [self._z2_tab])
        return sum(t.numel() * t.element_size() for t in tabs)

    @property
    def z2_tab(self):
        """The coset-shift table [tau^k - d_i]G2 [cells, 6, 25], built (and
        timed) on first use as ONE chain-plans fixed-scalar schedule: the d_i
        are host-known setup constants, so all ``cells`` chains share a joint
        odd-multiple table and one walk."""
        if self._z2_tab is not None:
            return self._z2_tab
        from ..oracle import curves as oc
        from ..ops.bls import chain_plans, curve, g2 as dg2
        from ..utils import metrics

        self.tables()
        t0 = time.perf_counter()
        ctx, dev = self.ctx, self.device
        schedule = chain_plans.compile_chains(tuple(-d for d in self._d_ints))
        g2_gen = dg2.from_oracle(oc.g2_generator(), dev)
        gens = g2_gen.expand((ctx.cells,) + tuple(g2_gen.shape)).contiguous()
        neg_d_g2 = chain_plans.run_point_chains(2, gens, schedule)
        t2 = dg2.from_oracle(ctx.kzg.setup.g2_monomial[ctx.k], dev)
        self._z2_tab = curve.point_add(2, t2.expand(neg_d_g2.shape), neg_d_g2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.z2_build_s = time.perf_counter() - t0
        metrics.KZG_TABLE_BYTES.set(self.table_bytes())
        return self._z2_tab

    # -- transcript ---------------------------------------------------------

    def _rlc_weights(self, commitments, cell_indices, cells, proofs):
        """Fiat-Shamir batch weights: one transcript hash over the whole
        claim, then per-item field derivations (nonzero by construction — a
        zero weight would let its cell escape the check). The same tag and
        bytes as the reference, so both packages draw the same weights."""
        from .fr import hash_to_bls_field

        h = hashlib.sha256()
        h.update(TRANSCRIPT_TAG)
        h.update(self.ctx.cells.to_bytes(8, "little"))
        h.update(self.ctx.k.to_bytes(8, "little"))
        h.update(len(cells).to_bytes(8, "little"))
        for c, i, cell, p in zip(commitments, cell_indices, cells, proofs):
            h.update(c)
            h.update(int(i).to_bytes(8, "little"))
            h.update(cell)
            h.update(p)
        seed = h.digest()
        return [
            hash_to_bls_field(seed + j.to_bytes(8, "little")) or 1
            for j in range(len(cells))
        ]

    # -- marshalling --------------------------------------------------------

    def marshal(self, commitments, cell_indices, cells, proofs, n_pad: int):
        """Host lists -> padded int64 tensors on the engine's device (v, r,
        idx, cx, cy, cinf, qx, qy, qinf). Raises KzgError on any malformed
        input (the caller maps that to a False verdict, like the oracle).
        Pad rows carry (r = 0, v = 0, C = Q = inf): both sides of the
        combined check see the identity."""
        from ..ops.kzg import frops

        ctx, n = self.ctx, len(cells)
        r_ints = self._rlc_weights(commitments, cell_indices, cells, proofs)
        vals: list[int] = []
        c_pts, q_pts = [], []
        for c, cell, p in zip(commitments, cells, proofs):
            vals.extend(ctx._cell_to_fields(cell))
            c_pts.append(self._points.parse(c, "commitment"))
            q_pts.append(self._points.parse(p, "proof"))

        pad = n_pad - n
        v = np.zeros((n_pad, ctx.k, 25), dtype=np.int64)
        v[:n] = frops.fr_to_limbs(vals).reshape(n, ctx.k, 25)
        r = np.zeros((n_pad, 25), dtype=np.int64)
        r[:n] = frops.fr_to_limbs(r_ints)
        idx = np.zeros(n_pad, dtype=np.int64)
        idx[:n] = np.asarray(cell_indices, dtype=np.int64)
        arrays = (v, r, idx) + _affine_limbs(c_pts, pad) + _affine_limbs(q_pts, pad)
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    # -- verify -------------------------------------------------------------

    def _check_shapes(self, commitments, cell_indices, cells, proofs) -> bool:
        if not (len(commitments) == len(cell_indices) == len(cells) == len(proofs)):
            return False
        return all(0 <= int(i) < self.ctx.cells for i in cell_indices)

    def verify_batch(self, commitments, cell_indices, cells, proofs) -> bool:
        """ONE combined pairing check for the whole batch, padded to a
        power-of-two row count (at least 4)."""
        from ..ops.kzg import verify

        if not self._check_shapes(commitments, cell_indices, cells, proofs):
            return False
        n = len(cells)
        if n == 0:
            return True
        try:
            arrays = self.marshal(commitments, cell_indices, cells, proofs, _bucket(n, floor=4))
        except KzgError:
            return False
        return bool(verify.cell_batch_check(self.tables(), *arrays))

    def verify_cell(self, commitment: bytes, cell_index: int, cell: bytes, proof: bytes) -> bool:
        """Single-cell device check through the chain-plans coset table."""
        from ..ops.kzg import frops, verify

        if not 0 <= int(cell_index) < self.ctx.cells:
            return False
        try:
            vals = self.ctx._cell_to_fields(cell)
            c_pt = self._points.parse(commitment, "commitment")
            q_pt = self._points.parse(proof, "proof")
        except KzgError:
            return False
        tables = self.tables()
        arrays = (
            frops.fr_to_limbs(vals).reshape(1, self.ctx.k, 25),
            frops.fr_to_limbs([1]),
            np.asarray([cell_index], dtype=np.int64),
        ) + _affine_limbs([c_pt], 0) + _affine_limbs([q_pt], 0)
        v, one, idx, cx, cy, cinf, qx, qy, qinf = (
            torch.from_numpy(a).to(self.device) for a in arrays
        )
        return bool(verify.cell_single_check(
            self.z2_tab, v, one, idx, cx, cy, cinf, qx, qy, qinf, tables=tables
        ))


# --------------------------------------------------------------------------------------
# Module-level dispatch (the seam everything above the kzg package calls)
# --------------------------------------------------------------------------------------

_engines: dict = {}


def get_engine(ctx: CellContext) -> CellEngine:
    """The engine of ``ctx`` on the backend's device (``set_kzg_backend``;
    CUDA when none is set), built once per (context, device)."""
    dev = resolve_device(_DEVICE)
    key = (id(ctx), str(dev))
    entry = _engines.get(key)
    if entry is None:
        entry = (ctx, CellEngine(ctx, dev))  # the entry pins ctx: its id stays unique
        _engines[key] = entry
    return entry[1]


def verify_cell_proof_batch(ctx: CellContext, commitments, cell_indices, cells, proofs) -> bool:
    """Backend-dispatched batch verification — THE entry point for data
    availability. Host backend: the per-cell oracle loop. Device backend:
    the batched engine under the ``kzg_device`` ladder, the device resolved
    (and a missing card raised) before the supervised region; a fully
    faulted ladder FAILS CLOSED (returns False, the column stays
    unverified)."""
    if not (len(commitments) == len(cell_indices) == len(cells) == len(proofs)):
        return False
    if not device_backend_active():
        return ctx.verify_cell_kzg_proof_batch(commitments, cell_indices, cells, proofs)
    eng = get_engine(ctx)

    def device_full():
        return eng.verify_batch(commitments, cell_indices, cells, proofs)

    def device_reduced():
        # halved batches, fresh transcripts: a size-dependent fault on the
        # full shape doesn't take the device path down with it
        mid = max(1, len(cells) // 2)
        for lo, hi in ((0, mid), (mid, len(cells))):
            if lo == hi:
                continue
            if not eng.verify_batch(
                commitments[lo:hi], cell_indices[lo:hi], cells[lo:hi], proofs[lo:hi]
            ):
                return False
        return True

    rungs = [("device_full", device_full), ("device_reduced", device_reduced)]
    if eng.device.type == "cpu":
        # a card's fault is never handed to the CPU: with the engine on a
        # card the ladder ends at device_reduced and fails closed
        rungs.append(("cpu_oracle", lambda: ctx.verify_cell_kzg_proof_batch(
            commitments, cell_indices, cells, proofs
        )))
    try:
        return bool(kzg_supervisor().run_ladder("kzg.cell_batch_verify", rungs))
    except SupervisedFault:
        return False  # fail CLOSED: never available off a faulted ladder
